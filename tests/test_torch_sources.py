"""Source guards for the PyTorch/CUDA port, by AST (no CUDA, nvcc or triton
needed): the port stays independent of JAX and of the JAX package, builds
for sm_90a, never hides a kernel launch or build behind an ``except``
(the runtime-kernel facility ``rtc`` and its NVRTC bindings included),
counts every kernel's launches, loads no CUDA library at import, and keeps
its build output out of git; and ``chip_smoke.py`` fails without a card or
without the package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "mxnet_tpu_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
KERNEL_WRAPPERS = sorted(p for p in (PKG / "ops" / "cuda").glob("*.py")
                         if p.name != "__init__.py")


def _tree(path):
    return ast.parse(path.read_text(), filename=str(path))


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "jaxlib" \
        or name == "mxnet_tpu" or name.startswith("mxnet_tpu.")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    # depth of the module's package below the repo root: a relative import
    # may not climb out of mxnet_tpu_torch
    depth = len(path.relative_to(ROOT).parts) - 1
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Import):
            for a in node.names:
                assert not _forbidden(a.name), f"{path}: import {a.name}"
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                assert not _forbidden(node.module or ""), \
                    f"{path}: from {node.module} import ..."
            else:
                assert node.level <= depth, \
                    f"{path}: relative import climbs out of the package"


def test_port_import_loads_no_jax():
    code = ("import pkgutil, importlib, sys\n"
            "import mxnet_tpu_torch, chip_smoke\n"
            "for m in pkgutil.walk_packages(mxnet_tpu_torch.__path__, "
            "'mxnet_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_build_targets_sm90a():
    consts = {n.value for n in ast.walk(_tree(PKG / "ops" / "_build.py"))
              if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert "arch=compute_90a,code=sm_90a" in consts


@pytest.mark.parametrize(
    "path", KERNEL_WRAPPERS + [PKG / "ops" / "_build.py", PKG / "rtc.py",
                               PKG / "ops" / "_nvrtc.py"],
    ids=lambda p: p.name)
def test_no_except_around_a_launch_or_build(path):
    """A CUDA tensor reaches its kernel or raises: no handler may catch a
    failed build or launch and fall back to another path."""
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Try) and node.handlers:
            calls = [c for stmt in node.body for c in ast.walk(stmt)
                     if isinstance(c, ast.Call)]
            assert not calls, (f"{path}:{node.lineno}: try/except around "
                               "calls in a kernel module")


@pytest.mark.parametrize("path", KERNEL_WRAPPERS, ids=lambda p: p.name)
def test_every_kernel_wrapper_counts_launches(path):
    tree = _tree(path)
    init = [n for n in tree.body if isinstance(n, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == "launches"
                    for t in n.targets)
            and isinstance(n.value, ast.Constant) and n.value.value == 0]
    assert init, f"{path}: no module-level `launches = 0`"
    bumps = [n for n in ast.walk(tree) if isinstance(n, ast.AugAssign)
             and isinstance(n.target, ast.Name) and n.target.id == "launches"]
    assert bumps, f"{path}: `launches` is never incremented"
    assert any(isinstance(n, ast.Global) and "launches" in n.names
               for n in ast.walk(tree)), \
        f"{path}: `launches` is bumped but not declared global"


def _counted_in_one_wrapper(module, counter):
    tree = _tree(PKG / "ops" / "cuda" / module)
    assert any(isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant)
               and n.value.value == 0
               and any(isinstance(t, ast.Name) and t.id == counter
                       for t in n.targets) for n in tree.body), counter
    bumpers = [f.name for f in tree.body if isinstance(f, ast.FunctionDef)
               and any(isinstance(n, ast.AugAssign)
                       and isinstance(n.target, ast.Name)
                       and n.target.id == counter for n in ast.walk(f))]
    assert len(bumpers) == 1, (counter, bumpers)
    fn = next(f for f in tree.body if isinstance(f, ast.FunctionDef)
              and f.name == bumpers[0])
    assert any(isinstance(n, ast.Global) and counter in n.names
               for n in ast.walk(fn)), counter
    return bumpers[0]


@pytest.mark.parametrize("counter", ["launches", "launches_dq",
                                     "launches_dkv"])
def test_flash_attention_counts_each_kernel(counter):
    """K1, K2 and K3 each have a counter of their own: initialized to 0 at
    module level, declared global and bumped in exactly one wrapper."""
    _counted_in_one_wrapper("flash_attention.py", counter)


def test_fused_conv1x1_counts_its_kernel_in_one_wrapper():
    """K4's counter is bumped in ``conv1x1_bn_act`` alone (its plain
    version and the CPU route never count)."""
    assert _counted_in_one_wrapper("fused_conv1x1.py",
                                   "launches") == "conv1x1_bn_act"


@pytest.mark.parametrize("module", ["optimizer/optimizer.py",
                                    "parallel/mesh.py",
                                    "parallel/train_step.py",
                                    "ops/nn.py",
                                    "ops/cuda/fused_conv1x1.py",
                                    "gluon/loss.py",
                                    "gluon/nn/conv_layers.py",
                                    "gluon/nn/basic_layers.py",
                                    "gluon/model_zoo/carrier.py",
                                    "gluon/model_zoo/vision/__init__.py",
                                    "gluon/model_zoo/vision/resnet.py"])
def test_training_modules_are_guarded(module):
    """The training slices' modules (BERT's and ResNet-50's) are among the
    files the import guards read (so they import neither jax nor
    mxnet_tpu)."""
    assert PKG / module in PORT_FILES
    test_port_imports_neither_jax_nor_the_jax_package(PKG / module)


RTC_MODULES = ["ndarray/ndarray.py", "ndarray/__init__.py",
               "ndarray/random.py", "random.py", "autograd.py", "rtc.py",
               "ops/_nvrtc.py", "tools/rtc_examples.py"]


@pytest.mark.parametrize("module", RTC_MODULES)
def test_rtc_slice_modules_are_guarded(module):
    """The imperative path's and the runtime-kernel facility's modules are
    among the files the import guards read."""
    assert PKG / module in PORT_FILES
    test_port_imports_neither_jax_nor_the_jax_package(PKG / module)


GENERATE_MODULES = ["config.py", "serving/errors.py", "serving/stats.py",
                    "serving/bucketing.py", "serving/router.py",
                    "serving/server.py", "serving/__init__.py",
                    "serving/generate/__init__.py",
                    "serving/generate/kv_cache.py",
                    "serving/generate/stats.py",
                    "serving/generate/streams.py",
                    "serving/generate/engine.py",
                    "serving/generate/scheduler.py",
                    "gluon/model_zoo/bert.py", "gluon/model_zoo/carrier.py",
                    "ops/cuda/flash_attention.py"]


@pytest.mark.parametrize("module", GENERATE_MODULES)
def test_generate_slice_modules_are_guarded(module):
    """The generative serving path's modules (the decode engine, scheduler,
    paged KV pool and streams, TransformerLM, the flags they read and
    single_query_attention's module) are among the files the import guards
    read."""
    assert PKG / module in PORT_FILES
    test_port_imports_neither_jax_nor_the_jax_package(PKG / module)


def test_rtc_counts_launches_in_cuda_kernel_launch_alone():
    """``rtc.launches`` starts at 0 at module level and is bumped in
    ``CudaKernel.launch`` and nowhere else."""
    tree = _tree(PKG / "rtc.py")
    assert any(isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant)
               and n.value.value == 0
               and any(isinstance(t, ast.Name) and t.id == "launches"
                       for t in n.targets) for n in tree.body)
    bumpers = []
    for cls in (n for n in tree.body if isinstance(n, ast.ClassDef)):
        for fn in (f for f in cls.body if isinstance(f, ast.FunctionDef)):
            if any(isinstance(n, ast.AugAssign)
                   and isinstance(n.target, ast.Name)
                   and n.target.id == "launches" for n in ast.walk(fn)):
                bumpers.append((cls.name, fn.name, fn))
    top = [f.name for f in tree.body if isinstance(f, ast.FunctionDef)
           and any(isinstance(n, ast.AugAssign) for n in ast.walk(f))]
    assert [(c, f) for c, f, _ in bumpers] == [("CudaKernel", "launch")]
    assert not top, top
    assert any(isinstance(n, ast.Global) and "launches" in n.names
               for n in ast.walk(bumpers[0][2]))


def test_importing_the_rtc_slice_loads_no_cuda_library():
    """NVRTC and the driver are loaded at the first CudaModule, never when
    a module is imported."""
    code = ("import mxnet_tpu_torch, mxnet_tpu_torch.rtc, "
            "mxnet_tpu_torch.tools.rtc_examples\n"
            "from mxnet_tpu_torch.ops import _nvrtc\n"
            "assert not _nvrtc._libs, _nvrtc._libs\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert 'libnvrtc' not in maps and 'libcuda.so' not in maps\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted((PKG / "csrc" / "rtc").glob("*.cu")),
                         ids=lambda p: p.name)
def test_rtc_sources_include_no_library(path):
    """The runtime-compiled kernels include only the bf16 type header and
    stdint.h: no library of finished kernels."""
    includes = {ln.split()[1] for ln in path.read_text().splitlines()
                if ln.startswith("#include")}
    assert includes <= {"<cuda_bf16.h>", "<stdint.h>"}, includes


CSRC_FILES = sorted((PKG / "csrc").glob("*.cu")) + \
    sorted((PKG / "csrc").glob("*.cuh"))


@pytest.mark.parametrize("path", CSRC_FILES, ids=lambda p: p.name)
def test_kernel_sources_do_their_own_products(path):
    """Each kernel multiplies on the tensor cores in code of the repo: the
    flash-attention kernels (K1, K2, K3) and the fused 1x1 convolution (K4)
    with wgmma, through the PTX wrappers of hopper.cuh, the one header they
    include; none with mma.sync. No source includes a library of finished
    kernels (cuBLAS, CUTLASS, cuDNN, PyTorch); the shared header alone
    includes the driver API's header, for the tensor-map type and its
    encode's signature."""
    src = path.read_text()
    allowed = {"<cuda_bf16.h>", "<cuda_runtime.h>", "<stdint.h>"}
    if path.name == "hopper.cuh":
        assert "wgmma.mma_async.sync.aligned" in src
        allowed.add("<cuda.h>")
    else:
        assert path.name.startswith("flash_attention") or \
            path.name == "fused_conv1x1.cu", path.name
        assert "wgmma_" in _code(path)
        assert "mma.sync" not in _code(path)
        allowed = {'"hopper.cuh"'}
    includes = {ln.split()[1] for ln in src.splitlines()
                if ln.startswith("#include")}
    assert includes <= allowed, includes


def _code(path):
    """A CUDA source without its comments."""
    import re
    src = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", src)


def test_k1_bf16_is_the_hopper_design():
    """K1's bf16 forward loads through TMA into an mbarrier ring, runs both
    products on wgmma (P V with P from registers and V transposed), takes
    128-row q-tiles, and no longer uses mma.sync; its tensor maps are
    encoded through the driver's entry point, not a libcuda link. The PTX
    wrappers and the encoder are in the header K1 includes."""
    code = _code(PKG / "csrc" / "flash_attention_fwd.cu") + \
        _code(PKG / "csrc" / "hopper.cuh")
    for needle in ("cp.async.bulk.tensor.4d.shared::cluster.global."
                   "mbarrier::complete_tx",
                   "cp.async.bulk.tensor.4d.global.shared::cta",
                   "mbarrier.try_wait.parity", "mbarrier.arrive.expect_tx",
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                   "setmaxnreg.inc", "setmaxnreg.dec",
                   "constexpr int kBQ = 128;",
                   "cudaGetDriverEntryPoint", "cuTensorMapEncodeTiled",
                   "__grid_constant__ CUtensorMap"):
        assert needle in code, needle
    assert "mma.sync" not in code
    # the register-A form: {a0..a3} then the B descriptor, transpose-B set
    assert "\"{%32, %33, %34, %35}, %36, p, 1, 1, 1;" in code
    assert "-lcuda" not in (PKG / "ops" / "_build.py").read_text()


def test_k4_bf16_is_the_hopper_design():
    """K4 is persistent and warp-specialised: a producer loads x, w, scale
    and shift by TMA (2-D and 1-D tensor maps, encoded through the driver's
    entry point) into an mbarrier ring; the consumers apply the BatchNorm
    prologue in registers to fragments read with ldmatrix and multiply
    with wgmma, A from registers and w transposed (N-major) from shared
    memory; y leaves by TMA store; the moments meet without float atomics
    (a ticket per column strip); no mma.sync route is left."""
    code = _code(PKG / "csrc" / "fused_conv1x1.cu")
    header = _code(PKG / "csrc" / "hopper.cuh")
    kernel = _body(code, "conv1x1_bn_act_kernel")
    for needle in ("tma_load_2d(", "tma_load_1d(", "tma_store_2d(",
                   "mbar_wait(", "mbar_expect_tx(", "wgmma_rs<BN>(",
                   "prologue<XT>(", "setmaxnreg.dec", "setmaxnreg.inc",
                   "atomicAdd(tickets + strip",
                   "__grid_constant__ CUtensorMap"):
        assert needle in kernel or needle in code[:code.index(kernel)][-1500:], \
            needle
    assert "ldmatrix.sync.aligned.m8n8.x4.shared.b16" in code
    assert "affine2(" in _body(code, "prologue")
    assert "fmaf(" in _body(code, "affine2")
    for n in (64, 128, 256):
        assert f"wgmma_rs_n{n}(" in _body(code, "wgmma_rs")
        ptx = f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16"
        body = _body(header, f"wgmma_rs_n{n}")
        assert ptx in body and "p, 1, 1, 1;" in body, n
    for helper, ptx in (("tma_load_2d", "cp.async.bulk.tensor.2d.shared::"
                                        "cluster.global.mbarrier::complete_tx"),
                        ("tma_load_1d", "cp.async.bulk.tensor.1d.shared::"
                                        "cluster.global.mbarrier::complete_tx"),
                        ("tma_store_2d", "cp.async.bulk.tensor.2d.global."
                                         "shared::cta")):
        assert ptx in _body(header, helper), helper
    assert "encode_matrix(" in code and "encode_vector(" in code
    assert "atomicAdd(float" not in code and "red.global.add.f32" not in code
    assert "mma.sync" not in code


def _body(code, name):
    """The brace-balanced body of the function ``name`` defined in
    ``code``."""
    i = code.index("{", code.index(f" {name}("))
    depth = 0
    for j in range(i, len(code)):
        depth += {"{": 1, "}": -1}.get(code[j], 0)
        if depth == 0:
            return code[i:j + 1]
    raise AssertionError(f"unbalanced body of {name}")


@pytest.mark.parametrize("kernel", ["flash_bwd_dq_bf16_kernel",
                                    "flash_bwd_dkv_bf16_kernel"])
def test_k2_k3_bf16_are_the_hopper_design(kernel):
    """K2's and K3's bf16 kernels are persistent and warp-specialised:
    TMA loads (cp.async.bulk.tensor) through mbarriers into shared memory,
    every product on wgmma (the score products from shared memory, the
    accumulating ones with A from registers), TMA stores; no mma.sync. K2
    computes delta itself and writes it for K3."""
    code = _code(PKG / "csrc" / "flash_attention_bwd.cu")
    header = _code(PKG / "csrc" / "hopper.cuh")
    body = _body(code, kernel)
    for needle in ("tma_load(", "mbar_wait(", "mbar_expect_tx(",
                   "issue_scores<", "issue_accumulate<", "store_staged<",
                   "setmaxnreg.dec", "setmaxnreg.inc",
                   "__grid_constant__ CUtensorMap"):
        assert needle in body or needle in code[:code.index(body)][-2000:], \
            needle
    assert "wgmma_ss<" in _body(code, "issue_scores")
    assert "wgmma_rs<" in _body(code, "issue_accumulate")
    for helper, ptx in (("tma_load", "cp.async.bulk.tensor.4d.shared::cluster"
                                     ".global.mbarrier::complete_tx"),
                        ("tma_store", "cp.async.bulk.tensor.4d.global"
                                      ".shared::cta"),
                        ("wgmma_ss_n128", "wgmma.mma_async.sync.aligned."
                                          "m64n128k16.f32.bf16.bf16"),
                        ("wgmma_ss_n64", "wgmma.mma_async.sync.aligned."
                                         "m64n64k16.f32.bf16.bf16"),
                        ("wgmma_rs_n64", "wgmma.mma_async.sync.aligned."
                                         "m64n64k16.f32.bf16.bf16")):
        assert ptx in _body(header, helper), helper
    assert "mma.sync" not in code
    if kernel == "flash_bwd_dq_bf16_kernel":
        assert "delta[(size_t)bh * S + r0 + r] = acc;" in body


def _function(module, name):
    tree = _tree(PKG / "ops" / "cuda" / module)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and \
                node.name == name:
            return node
    raise AssertionError(name)


def _calls(node, attr):
    return [c for c in ast.walk(node) if isinstance(c, ast.Call)
            and isinstance(c.func, ast.Attribute) and c.func.attr == attr]


def test_cuda_backward_computes_no_delta_and_copies_nothing_unconditionally():
    """The CUDA branch of FlashAttention.backward (and the composed
    backward it calls) computes no delta in Python and makes no
    unconditional .contiguous(): the one copy is of an output gradient TMA
    cannot address."""
    cls = _function("flash_attention.py", "FlashAttention")
    backward = next(f for f in cls.body if isinstance(f, ast.FunctionDef)
                    and f.name == "backward")
    branch = next(n for n in ast.walk(backward) if isinstance(n, ast.If)
                  and "_on_cpu" in ast.unparse(n.test))
    cuda = ast.Module(body=branch.orelse, type_ignores=[])
    guarded = [n for n in ast.walk(cuda) if isinstance(n, ast.If)
               and ast.unparse(n.test) == "not tma_addressable(dout)"]
    assert len(guarded) == 1 and \
        ast.unparse(guarded[0].body[0]) == "dout = dout.contiguous()"
    assert len(_calls(cuda, "contiguous")) == 1
    composed = _function("flash_attention.py", "flash_attention_bwd")
    for node in (cuda, composed):
        assert not _calls(node, "contiguous") or node is cuda
        assert not _calls(node, "sum") and not _calls(node, "float")
        assert not any(isinstance(n, ast.BinOp) for n in ast.walk(node))


@pytest.mark.parametrize("counter,wrapper", [
    ("launches", "flash_attention_fwd"),
    ("launches_dq", "flash_attention_bwd_dq"),
    ("launches_dkv", "flash_attention_bwd_dkv")])
def test_each_flash_attention_wrapper_keeps_its_counter(counter, wrapper):
    """Each kernel's counter is bumped in its own wrapper, the one that
    launches it, and nowhere else."""
    assert _counted_in_one_wrapper("flash_attention.py", counter) == wrapper


def test_gitignore_lists_the_build_directory():
    lines = {ln.strip() for ln in (ROOT / ".gitignore").read_text().splitlines()}
    assert "build/" in lines or "/build/" in lines


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_package(where, tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when there is
    no CUDA card, and when the directory holds nothing else of the repo."""
    cwd = ROOT
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(
            (ROOT / "chip_smoke.py").read_text())
        cwd = tmp_path
    proc = _run_smoke(cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("tool,variant", [
    (tool, name) for tool in ("k1_ablation", "bwd_ablation", "k4_compare")
    for name in __import__(f"mxnet_tpu_torch.tools.{tool}",
                           fromlist=["VARIANTS"]).VARIANTS])
def test_ablation_variants_still_match_the_kernel_sources(tool, variant):
    """Each ablation variant's text substitutions still find their anchors
    in the kernel source (the tools stop on the card otherwise)."""
    mod = __import__(f"mxnet_tpu_torch.tools.{tool}", fromlist=["_source"])
    subs = mod.VARIANTS[variant][0]
    src = mod._source(subs)   # SystemExit if an anchor is missing
    assert all(new in src for _, new in subs)
