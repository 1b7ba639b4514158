"""Source guards for the PyTorch/CUDA port, by AST (no CUDA, nvcc or triton
needed): the port stays independent of JAX and of the JAX package, builds
for sm_90a, never hides a kernel launch or build behind an ``except``
(the runtime-kernel facility ``rtc`` and its NVRTC bindings included),
counts every kernel's launches, loads no CUDA library at import, and keeps
its build output out of git; and ``chip_smoke.py`` fails without a card or
without the package."""
import ast
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "mxnet_tpu_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
KERNEL_WRAPPERS = sorted(p for p in (PKG / "ops" / "cuda").glob("*.py")
                         if p.name != "__init__.py")


@functools.lru_cache(maxsize=None)
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
                               PKG / "ops" / "_nvrtc.py",
                               PKG / "parallel" / "ring_attention.py"],
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


GLUON_MODULES = ["base.py", "initializer.py", "init.py",
                 "optimizer/__init__.py", "optimizer/optimizer.py",
                 "optimizer/lr_scheduler.py", "ndarray/utils.py",
                 "gluon/__init__.py", "gluon/parameter.py", "gluon/block.py",
                 "gluon/trainer.py", "gluon/utils.py", "gluon/nn/__init__.py",
                 "gluon/nn/basic_layers.py", "gluon/nn/conv_layers.py",
                 "gluon/loss.py"]


@pytest.mark.parametrize("module", GLUON_MODULES)
def test_gluon_slice_modules_are_guarded(module):
    """The Gluon training surface's modules (Block, Parameter, Trainer, the
    initializers, optimizers and schedulers, the .params writer) are among
    the files the import guards read."""
    assert PKG / module in PORT_FILES
    test_port_imports_neither_jax_nor_the_jax_package(PKG / module)


OPS_SLICE_MODULES = ["config.py", "ops/__init__.py", "ops/registry.py",
                     "ops/elemwise.py", "ops/tensor.py", "ops/nn.py",
                     "ops/random_ops.py", "ndarray/__init__.py",
                     "ndarray/ndarray.py", "ndarray/random.py",
                     "gluon/nn/__init__.py", "gluon/nn/basic_layers.py",
                     "gluon/nn/conv_layers.py", "gluon/loss.py",
                     "gluon/rnn/__init__.py", "gluon/rnn/rnn_layer.py",
                     "gluon/rnn/rnn_cell.py", "gluon/model_zoo/__init__.py",
                     "gluon/model_zoo/lstm_lm.py",
                     "gluon/model_zoo/carrier.py"]


@pytest.mark.parametrize("module", OPS_SLICE_MODULES)
def test_ops_slice_modules_are_guarded(module):
    """The op registry, the four op families, the generated ``nd``, the
    recurrent layers and cells and the LSTM language model are among the
    files the import guards read."""
    assert PKG / module in PORT_FILES
    test_port_imports_neither_jax_nor_the_jax_package(PKG / module)


_SAMPLING_CALLS = {"rand", "randn", "randint", "randperm", "multinomial",
                   "poisson", "_standard_gamma", "exponential_",
                   "bernoulli", "normal_", "uniform_",
                   # numpy's
                   "choice", "uniform", "normal", "permutation", "shuffle",
                   "random_sample"}


def _random_states(tree):
    """Names bound to a ``RandomState(seed)`` in a module."""
    return {t.id for node in ast.walk(tree) if isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and getattr(node.value.func, "attr", None) == "RandomState"
            for t in node.targets if isinstance(t, ast.Name)}


CONTRIB_SLICE_MODULES = ["ops/contrib.py", "ndarray/contrib.py",
                         "gluon/model_zoo/vision/ssd.py", "test_utils.py"]


@pytest.mark.parametrize("module", ["ops/random_ops.py", "ops/nn.py",
                                    "ops/tensor.py", "ops/elemwise.py",
                                    "gluon/nn/basic_layers.py",
                                    "gluon/rnn/rnn_cell.py",
                                    "embedding/table.py",
                                    "embedding/planner.py",
                                    "embedding/feed.py",
                                    "embedding/workload.py", "resource.py"]
                         + CONTRIB_SLICE_MODULES)
def test_every_draw_names_its_generator(module):
    """Every sampling call in the op, layer and data modules names its
    generator: a torch draw passes ``generator=`` (draws come from
    ``random.generator(ctx)``, never from PyTorch's global generator), a
    numpy draw is a method of a ``RandomState(seed)`` the module made
    (never numpy's global state)."""
    tree = _tree(PKG / module)
    states = _random_states(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr in _SAMPLING_CALLS:
            recv = node.func.value
            assert any(k.arg == "generator" for k in node.keywords) or (
                isinstance(recv, ast.Name) and recv.id in states), \
                f"{module}:{node.lineno}: {node.func.attr} without generator"


@pytest.mark.parametrize("module", CONTRIB_SLICE_MODULES)
def test_contrib_slice_modules_are_guarded(module):
    """The contrib ops, ``nd.contrib``, the SSD model and the detection
    data are among the files the import guards read."""
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
        allowed |= {"<cuda.h>", "<cuda_fp16.h>"}
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


def _instantiations(header, name):
    """{element type: PTX text} of hopper.cuh's product wrapper ``name``:
    its macro's text with the type put in, for each type its body
    expands the macro with ("bf16", "f16")."""
    import re
    macro = f"MXT_{name.upper()}"
    lines = []
    for line in header[header.index(f"#define {macro}(TY)"):].splitlines():
        lines.append(line.rstrip().rstrip("\\"))
        if not line.rstrip().endswith("\\"):
            break
    text = "\n".join(lines)
    assert '." TY "." TY " "' in text, name
    return {ty: text.replace('" TY "." TY "', f"{ty}.{ty}")
            for ty in re.findall(rf'{macro}\("(\w+)"\)', _body(header, name))}


def test_k1_bf16_is_the_hopper_design():
    """K1's bf16 forward loads through TMA into an mbarrier ring, runs both
    products on wgmma (P V with P from registers and V transposed), takes
    128-row q-tiles, and no longer uses mma.sync; its tensor maps are
    encoded through the driver's entry point, not a libcuda link. The PTX
    wrappers and the encoder are in the header K1 includes."""
    header = _code(PKG / "csrc" / "hopper.cuh")
    code = _code(PKG / "csrc" / "flash_attention_fwd.cu") + header
    for name, n in (("wgmma_ss_n128", 128), ("wgmma_rs_n64", 64)):
        assert (f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16"
                in _instantiations(header, name)["bf16"])
    for needle in ("cp.async.bulk.tensor.4d.shared::cluster.global."
                   "mbarrier::complete_tx",
                   "cp.async.bulk.tensor.4d.global.shared::cta",
                   "mbarrier.try_wait.parity", "mbarrier.arrive.expect_tx",
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
        body = _instantiations(header, f"wgmma_rs_n{n}")["bf16"]
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


# the kernels are templated on the element type (bf16, fp16): the ids are
# the names the bf16-only kernels had
@pytest.mark.parametrize("kernel", [
    pytest.param("flash_bwd_dq_kernel", id="flash_bwd_dq_bf16_kernel"),
    pytest.param("flash_bwd_dkv_kernel", id="flash_bwd_dkv_bf16_kernel")])
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
                                      ".shared::cta")):
        assert ptx in _body(header, helper), helper
    for helper, n in (("wgmma_ss_n128", 128), ("wgmma_ss_n64", 64),
                      ("wgmma_rs_n64", 64)):
        assert (f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16"
                in _instantiations(header, helper)["bf16"]), helper
    assert "mma.sync" not in code
    if kernel == "flash_bwd_dq_kernel":
        assert "delta[(size_t)bh * S + r0 + r] = acc;" in body


@pytest.mark.parametrize("source", ["flash_attention_fwd.cu",
                                    "flash_attention_bwd.cu"])
def test_k1_k3_fp16_are_the_hopper_design(source):
    """F4: K1, K2 and K3 have fp16 instances of the same kernels: each
    kernel is a template on the element type E, instantiated for
    __nv_bfloat16 and __half by the dtype dispatch; its tensor maps are
    encoded with E's data type (FLOAT16 for __half); every product wrapper
    it calls expands its wgmma PTX for both types (.f32.f16.f16 for fp16,
    with the register-A and transposed-B operands of the bf16 form); P,
    dS and the outputs are packed by pack2<E>; no mma.sync anywhere."""
    header = _code(PKG / "csrc" / "hopper.cuh")
    code = _code(PKG / "csrc" / source)
    kernels = ["flash_fwd_kernel"] if "fwd" in source else \
        ["flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"]
    for k in kernels:
        i = code.index(f" {k}(")
        assert "template <int D, typename E>" in code[i - 120:i], k
        assert "tma_load(" in _body(code, k) or "tma_load(" in code
    for name in ("wgmma_ss_n128", "wgmma_ss_n64", "wgmma_rs_n32",
                 "wgmma_rs_n64"):
        inst = _instantiations(header, name)
        assert set(inst) == {"bf16", "f16"}, name
        assert ".f32.f16.f16 " in inst["f16"], name
        assert inst["f16"].replace("f16.f16", "bf16.bf16") == inst["bf16"]
    assert "__half" in code and "__nv_bfloat16" in code
    assert "Elem<E>::kMap" in code and "pack2<E>(" in code
    assert "struct Elem<__half> {\n  static constexpr bool kHalf = true;\n" \
        "  static constexpr CUtensorMapDataType kMap = " \
        "CU_TENSOR_MAP_DATA_TYPE_FLOAT16;" in header
    assert "__floats2half2_rn" in _body(header, "pack2")
    assert "mma.sync" not in code and "mma.sync" not in header
    assert "pack_bf16(" not in code and "is_bf16" not in code


def test_the_dtype_code_is_one_abi():
    """The C entries' dtype code (0 = f32, 1 = bf16, 2 = fp16) is one
    thing in the wrapper's _DTYPES, in hopper.cuh's constants and in both
    sources' dispatch."""
    import re
    import torch
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    header = _code(PKG / "csrc" / "hopper.cuh")
    consts = {name: int(v) for name, v in
              re.findall(r"constexpr int (kDtype\w+) = (\d+);", header)}
    assert consts == {"kDtypeF32": 0, "kDtypeBf16": 1, "kDtypeF16": 2}
    assert fa._DTYPES == {torch.float32: consts["kDtypeF32"],
                          torch.bfloat16: consts["kDtypeBf16"],
                          torch.float16: consts["kDtypeF16"]}
    for source in ("flash_attention_fwd.cu", "flash_attention_bwd.cu"):
        text = (PKG / "csrc" / source).read_text()
        assert "0 = f32, 1 = bf16, 2 = fp16" in text, source
        code = _code(PKG / "csrc" / source)
        assert "int dtype" in code and "is_bf16" not in code, source
        assert "kDtypeBf16" in code and "kDtypeF16" in code, source


AMP_SPARSE_MODULES = ["amp/__init__.py", "amp/lists.py",
                      "amp/loss_scaler.py", "sparse/__init__.py",
                      "ops/optimizer_ops.py", "gluon/trainer.py",
                      "gluon/parameter.py", "autograd.py",
                      "ndarray/utils.py"]


@pytest.mark.parametrize("module", AMP_SPARSE_MODULES)
def test_amp_sparse_slice_modules_are_guarded(module):
    """AMP, the loss scaler, sparse storage, the optimizer ops and the
    modules the row-sparse gradient runs through are among the files the
    import guards read."""
    assert PKG / module in PORT_FILES
    test_port_imports_neither_jax_nor_the_jax_package(PKG / module)


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
    """The CUDA route of FlashAttention.backward (the backward pair that
    ``block_ops`` hands it, and the composed backward) computes no delta in
    Python and makes no unconditional .contiguous(): the one copy is of an
    output gradient TMA cannot address."""
    cls = _function("flash_attention.py", "FlashAttention")
    backward = next(f for f in cls.body if isinstance(f, ast.FunctionDef)
                    and f.name == "backward")
    assert "block_ops(q)" in ast.unparse(backward)
    in_place = _function("flash_attention.py", "_in_place")
    copy = next(n for n in ast.walk(in_place) if isinstance(n, ast.IfExp))
    assert ast.unparse(copy) == \
        "dout if tma_addressable(dout) else dout.contiguous()"
    assert len(_calls(in_place, "contiguous")) == 1
    route = [backward] + [_function("flash_attention.py", name) for name in (
        "_bwd_dq_in_place", "_bwd_dkv_in_place", "flash_attention_bwd")]
    for node in route:
        assert not _calls(node, "contiguous")
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


# ---------------------------------------------------------------------------
# the data path
# ---------------------------------------------------------------------------
DATA_SLICE_MODULES = ["recordio.py", "engine.py", "native/__init__.py",
                      "ops/image_ops.py", "ndarray/image.py", "image.py",
                      "io.py", "random.py", "config.py",
                      "gluon/data/__init__.py", "gluon/data/dataset.py",
                      "gluon/data/sampler.py", "gluon/data/dataloader.py",
                      "gluon/data/vision/__init__.py",
                      "gluon/data/vision/datasets.py",
                      "gluon/data/vision/transforms.py"]


@pytest.mark.parametrize("module", DATA_SLICE_MODULES)
def test_data_slice_modules_are_guarded(module):
    """RecordIO, the native library's loader, the engine, the image ops,
    ``nd.image``, ``image``, ``io`` and ``gluon.data`` are among the files
    the import guards read."""
    assert PKG / module in PORT_FILES
    test_port_imports_neither_jax_nor_the_jax_package(PKG / module)


# the draws of Python's random.Random besides the numpy and torch ones
_DATA_SAMPLING_CALLS = _SAMPLING_CALLS | {"random", "randint", "randrange",
                                          "getrandbits", "gauss", "sample"}
# calls that give a stream the port owns
_OWNED = {"python_rng", "numpy_rng", "Random", "RandomState"}


def _calls_owned(node):
    return any(isinstance(c, ast.Call) and (
        getattr(c.func, "attr", None) in _OWNED
        or getattr(c.func, "id", None) in _OWNED) for c in ast.walk(node))


def _owned_names(tree):
    """Names and ``self`` attributes assigned a stream the port owns, and
    functions that return one."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and _calls_owned(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                elif isinstance(t, ast.Attribute):
                    names.add(t.attr)
        elif isinstance(node, ast.FunctionDef) and any(
                isinstance(r, ast.Return) and r.value is not None
                and _calls_owned(r.value) for r in ast.walk(node)):
            names.add(node.name)
    return names


@pytest.mark.parametrize("module", DATA_SLICE_MODULES)
def test_every_data_path_draw_names_its_stream(module):
    """Every sampling call of the data path, Python's ``random.Random``
    methods included, draws from a stream the port owns: a torch draw
    passes ``generator=``; any other draws from ``random.python_rng()``,
    ``random.numpy_rng()`` or a ``Random``/``RandomState`` the module made
    (a name, an attribute or a function that returns one), never from
    Python's or numpy's global generator."""
    tree = _tree(PKG / module)
    owned = _owned_names(tree)
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func,
                                                          ast.Attribute)
                and node.func.attr in _DATA_SAMPLING_CALLS):
            continue
        recv = node.func.value
        ok = any(k.arg == "generator" for k in node.keywords) \
            or _calls_owned(recv) \
            or (isinstance(recv, ast.Name) and recv.id in owned) \
            or (isinstance(recv, ast.Attribute) and recv.attr in owned) \
            or (isinstance(recv, ast.Call)
                and getattr(recv.func, "attr", getattr(recv.func, "id", None))
                in owned)
        assert ok, f"{module}:{node.lineno}: {node.func.attr} without a " \
                   "stream of its own"


def _module_scope_imports(tree):
    """Import statements outside every function body."""
    out, todo = [], list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.append(node)
        todo.extend(ast.iter_child_nodes(node))
    return out


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_decoder_is_imported_at_module_scope(path):
    """PIL and OpenCV are optional: the port imports them inside the
    functions that decode or encode, never when a module is imported."""
    for node in _module_scope_imports(_tree(path)):
        names = [a.name for a in node.names] if isinstance(node, ast.Import) \
            else [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in ("PIL", "cv2"), \
                f"{path}:{node.lineno}: module-scope import of {name}"


def _docstrings(tree):
    return {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_is_loaded_from_the_jax_package(path):
    """No code of the port names the JAX package's native directory or its
    library file, and no ``CDLL`` is handed a path into the JAX package:
    the port builds and loads its own (``tests/test_torch_native.py``
    checks the process's mapped files too)."""
    tree = _tree(path)
    docs = _docstrings(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            assert not re.search(r"mxnet_tpu/native|libmxtpu_native\.so\b",
                                 node.value), f"{path}:{node.lineno}"
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "CDLL", "LoadLibrary", "PyDLL"):
            for c in ast.walk(node):
                assert not (isinstance(c, ast.Constant)
                            and isinstance(c.value, str)
                            and re.search(r"mxnet_tpu(?!_torch)", c.value)), \
                    f"{path}:{node.lineno}"


def test_the_native_library_builds_inside_the_port():
    from mxnet_tpu_torch import native
    assert native.BUILD_DIR == ROOT / "build" / "mxnet_tpu_torch"
    for src in (*native.SOURCES, native.IMAGE_SOURCE):
        assert (PKG / "native" / src).is_file()
    consts = {n.value for n in ast.walk(_tree(PKG / "native" / "__init__.py"))
              if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert "g++" in consts and "-std=c++17" in consts


TRAINING_UTILITY_MODULES = [
    "metric.py", "callback.py", "visualization.py", "operator.py",
    "library.py", "gluon/contrib/__init__.py", "gluon/contrib/nn.py",
    "gluon/contrib/cnn.py", "gluon/contrib/rnn.py",
    "gluon/contrib/estimator/__init__.py",
    "gluon/contrib/estimator/estimator.py",
    "gluon/contrib/estimator/event_handler.py",
    "gluon/model_zoo/vision/simple_nets.py",
    "gluon/model_zoo/vision/dense_nets.py"]


@pytest.mark.parametrize("module", TRAINING_UTILITY_MODULES)
def test_training_utility_modules_are_guarded(module):
    """The metrics, callbacks, visualization, gluon.contrib with the
    Estimator, the custom ops, the external libraries and the new zoo
    families are among the files the import guards read."""
    assert PKG / module in PORT_FILES
    test_port_imports_neither_jax_nor_the_jax_package(PKG / module)


def test_library_loads_only_the_path_it_is_given():
    """``library.load`` hands ``CDLL`` the caller's path, made absolute,
    and nothing else: no constant and no path into the JAX package."""
    tree = _tree(PKG / "library.py")
    cdll = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", None) == "CDLL"]
    assert len(cdll) == 1
    arg = cdll[0].args[0]
    assert isinstance(arg, ast.Call) and \
        getattr(arg.func, "attr", None) == "abspath" and \
        [a.id for a in arg.args] == ["path"]
    test_no_library_is_loaded_from_the_jax_package(PKG / "library.py")


def test_variational_dropout_draws_from_an_owned_generator():
    """Every mask VariationalDropoutCell draws goes through the Dropout op
    with ``generator=mask_generator(...)``: its own ``generator``, else
    ``random.generator`` of the input's context, never PyTorch's global
    one."""
    tree = _tree(PKG / "gluon" / "contrib" / "rnn.py")
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
               and n.name == "VariationalDropoutCell")
    draws = [n for n in ast.walk(cls) if isinstance(n, ast.Call)
             and any(isinstance(a, ast.Constant) and a.value == "Dropout"
                     for a in n.args)]
    assert draws
    for call in draws:
        gen = [k.value for k in call.keywords if k.arg == "generator"]
        assert gen and isinstance(gen[0], ast.Call) and \
            getattr(gen[0].func, "id", None) == "mask_generator"
    test_every_draw_names_its_generator("gluon/contrib/rnn.py")


QUANT_KVSTORE_MODULES = ["ops/quantization.py", "contrib/__init__.py",
                         "contrib/quantization.py", "kvstore/__init__.py",
                         "kvstore/base.py",
                         "kvstore/gradient_compression.py",
                         "gluon/trainer.py"]


@pytest.mark.parametrize("module", QUANT_KVSTORE_MODULES)
def test_quantization_kvstore_slice_modules_are_guarded(module):
    """The quantization ops, ``quantize_net``, the kvstore and gradient
    compression import neither JAX nor the JAX package, and no handler
    catches a failed int8 product (or anything else they call) to take
    another route."""
    assert PKG / module in PORT_FILES
    test_port_imports_neither_jax_nor_the_jax_package(PKG / module)
    test_no_except_around_a_launch_or_build(PKG / module)


_FLOAT_ROUTES = {"float", "half", "bfloat16", "float16", "float32",
                 "float64", "double", "matmul", "mm_", "linear", "conv1d",
                 "conv2d", "conv3d", "unfold", "einsum", "bmm", "addmm"}


@pytest.mark.parametrize("name", ["int8_matmul", "int8_conv", "_im2col"])
def test_the_int8_products_take_no_float_route(name):
    """The int8 products and their im2col move and multiply integer codes
    only: the card's route is ``torch._int_mm``, the CPU's an int32
    ``torch.mm``; no float type or float product appears in them."""
    tree = _tree(PKG / "ops" / "quantization.py")
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == name)
    used = {n.attr for n in ast.walk(fn) if isinstance(n, ast.Attribute)}
    used |= {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
    assert not used & _FLOAT_ROUTES, sorted(used & _FLOAT_ROUTES)
    if name == "int8_matmul":
        assert {"_int_mm", "int32"} <= used
    if name == "int8_conv":
        assert "int8_matmul" in used


# ---------------------------------------------------------------------------
# the multi-process slice: collectives, meshes, kvstores, the launcher
# ---------------------------------------------------------------------------
COLLECTIVES = PKG / "parallel" / "collectives.py"
FRONTDOOR = PKG / "serving" / "fabric" / "frontdoor.py"
MESH = PKG / "parallel" / "mesh.py"
PORT_TESTS = sorted((ROOT / "tests").glob("test_torch_*.py")) + \
    sorted((ROOT / "tests").glob("torch_*.py"))
#: the tape-aware collectives: each returns through its autograd Function
TAPE_AWARE = ("all_reduce", "all_gather", "reduce_scatter", "ppermute",
              "all_to_all", "copy_to_axis", "reduce_from_axis",
              "gather_from_axis", "scatter_to_axis")


def _dist_uses(path):
    """(line, what) of every use of ``torch.distributed`` in ``path``:
    imports of it, and ``torch.distributed.X`` attribute chains."""
    out = []
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names
                    if a.name.startswith("torch.distributed")]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                (node.module or "").startswith("torch.distributed"):
            out.append((node.lineno, node.module))
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module == "torch" and \
                any(a.name == "distributed" for a in node.names):
            out.append((node.lineno, "torch.distributed"))
        elif isinstance(node, ast.Attribute) and node.attr == "distributed" \
                and isinstance(node.value, ast.Name) and \
                node.value.id == "torch":
            out.append((node.lineno, "torch.distributed"))
    return out


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_torch_distributed_only_in_collectives(path):
    """collectives.py is the one module that calls torch.distributed;
    mesh.py imports it for new_group alone."""
    uses = _dist_uses(path)
    if path == COLLECTIVES:
        return
    if path == MESH:
        called = {n.attr for n in ast.walk(_tree(path))
                  if isinstance(n, ast.Attribute) and
                  isinstance(n.value, ast.Name) and n.value.id == "dist"}
        assert called == {"new_group"}, called
        return
    assert not uses, f"{path}: torch.distributed at {uses}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_new_group_only_in_mesh(path):
    calls = [n.lineno for n in ast.walk(_tree(path))
             if isinstance(n, ast.Call) and
             isinstance(n.func, ast.Attribute) and n.func.attr == "new_group"]
    assert not calls or path == MESH, f"{path}: new_group at {calls}"


def _collective_call(call):
    f = call.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return f.value.id in ("dist", "collectives") or \
            f.attr == "init_process_group"
    return isinstance(f, ast.Name) and f.id.startswith(("_raw_", "world_"))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_except_around_a_collective(path):
    """No handler catches a failed init_process_group or collective (to
    switch the backend or carry on alone)."""
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Try) and node.handlers:
            calls = [c for stmt in node.body for c in ast.walk(stmt)
                     if isinstance(c, ast.Call) and _collective_call(c)]
            assert not calls, f"{path}:{node.lineno}: except around a " \
                "collective"


def test_collectives_and_mesh_have_no_handlers():
    for path in (COLLECTIVES, MESH):
        assert not [n for n in ast.walk(_tree(path))
                    if isinstance(n, ast.Try) and n.handlers], path


def test_every_process_group_has_a_timeout():
    calls = [n for path in PORT_FILES for n in ast.walk(_tree(path))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and n.func.attr == "init_process_group"]
    assert calls and all(any(k.arg == "timeout" for k in c.keywords)
                         for c in calls)


@pytest.mark.parametrize("name", TAPE_AWARE)
def test_collectives_needing_a_gradient_are_tape_aware(name):
    """Each in-program collective returns through an autograd Function's
    ``apply``, and no module outside collectives.py calls a raw one."""
    fn = next(n for n in _tree(COLLECTIVES).body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    applies = [c for c in ast.walk(fn) if isinstance(c, ast.Call) and
               isinstance(c.func, ast.Attribute) and c.func.attr == "apply"]
    assert applies, name
    for path in PORT_FILES:
        if path == COLLECTIVES:
            continue
        raw = [n.attr for n in ast.walk(_tree(path))
               if isinstance(n, ast.Attribute) and
               isinstance(n.value, ast.Name) and n.value.id == "collectives"
               and n.attr.startswith("_")]
        assert not raw, f"{path}: {raw}"


@pytest.mark.parametrize("path", PORT_FILES + PORT_TESTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_the_repos_launcher(path):
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Import):
            assert not [a.name for a in node.names
                        if a.name.split(".")[0] == "tools"], path
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            assert (node.module or "").split(".")[0] != "tools", path


@pytest.mark.parametrize("path", PORT_FILES + PORT_TESTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_every_subprocess_has_a_timeout(path):
    """A port test or chip_smoke.py cannot hang on a child: every
    subprocess.run/call/check_* has a timeout, and only the launcher (which
    kills its workers at its deadline) and the front door (whose host
    agents exit at their deadline, and are killed and reaped on stop)
    start a Popen."""
    for node in ast.walk(_tree(path)):
        if not (isinstance(node, ast.Call) and
                isinstance(node.func, ast.Attribute) and
                isinstance(node.func.value, ast.Name) and
                node.func.value.id == "subprocess"):
            continue
        if node.func.attr == "Popen":
            assert path in (PKG / "tools" / "launch.py", FRONTDOOR), \
                f"{path}:{node.lineno}: Popen"
        elif node.func.attr in ("run", "call", "check_call", "check_output"):
            assert any(k.arg == "timeout" for k in node.keywords), \
                f"{path}:{node.lineno}: subprocess.{node.func.attr} " \
                "without a timeout"


# ---------------------------------------------------------------------------
# ring attention, the embedding subsystem, the thin top-level modules
# ---------------------------------------------------------------------------
SLICE17_MODULES = ["parallel/ring_attention.py", "parallel/__init__.py",
                   "embedding/__init__.py", "embedding/table.py",
                   "embedding/planner.py", "embedding/feed.py",
                   "embedding/workload.py", "gluon/model_zoo/dlrm.py",
                   "runtime.py", "error.py", "libinfo.py", "log.py",
                   "registry.py", "resource.py", "context.py",
                   "tensor_inspector.py", "util.py", "contrib/autograd.py",
                   "contrib/io.py", "contrib/ndarray.py"]


@pytest.mark.parametrize("module", SLICE17_MODULES)
def test_slice17_modules_are_guarded(module):
    """Ring attention's, the embedding subsystem's, DLRM's and the thin
    top-level modules are among the files the import guards read."""
    assert PKG / module in PORT_FILES
    test_port_imports_neither_jax_nor_the_jax_package(PKG / module)


def test_the_ring_runs_k1_to_k3_through_the_wrappers():
    """Every block of the ring calls K1, K2 and K3 through
    ``flash_attention.block_ops`` (the wrappers' module attributes, so
    their launch counters move), the one place that picks the plain
    versions by device and head dim for the ring and for FlashAttention,
    with no handler anywhere in the ring's module."""
    tree = _tree(PKG / "parallel" / "ring_attention.py")
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    named = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
             and isinstance(n.value, ast.Name) and n.value.id == "fa"}
    assert "block_ops" in named
    assert not {a for a in named if a.startswith("flash_attention_")
                or a.startswith("_")}
    fa_tree = _tree(PKG / "ops" / "cuda" / "flash_attention.py")
    fn = next(n for n in fa_tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "block_ops")
    called = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
    assert {"flash_attention_fwd", "_bwd_dq_in_place", "_bwd_dkv_in_place",
            "_on_cpu"} <= called
    for name, kernel in (("_bwd_dq_in_place", "flash_attention_bwd_dq"),
                         ("_bwd_dkv_in_place", "flash_attention_bwd_dkv")):
        fn = next(n for n in fa_tree.body if isinstance(n, ast.FunctionDef)
                  and n.name == name)
        assert kernel in {n.id for n in ast.walk(fn)
                          if isinstance(n, ast.Name)}
    cls = next(n for n in fa_tree.body if isinstance(n, ast.ClassDef)
               and n.name == "FlashAttention")
    assert "block_ops" in {n.id for n in ast.walk(cls)
                           if isinstance(n, ast.Name)}


# ---------------------------------------------------------------------------
# resilience
# ---------------------------------------------------------------------------
RESILIENCE_MODULES = sorted(
    str(p.relative_to(PKG)) for p in (PKG / "resilience").glob("*.py")) + \
    ["tools/replay_step.py"]


@pytest.mark.parametrize("module", RESILIENCE_MODULES)
def test_resilience_modules_are_guarded(module):
    """Every module under ``resilience/`` and the replay tool import
    neither jax nor the JAX package."""
    assert PKG / module in PORT_FILES
    test_port_imports_neither_jax_nor_the_jax_package(PKG / module)


def _fault_sites():
    """(path, line, site) of every ``faults.check(...)`` call in the port
    and chip_smoke.py."""
    out = []
    for path in PORT_FILES:
        for n in ast.walk(_tree(path)):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "check" \
                    and isinstance(n.func.value, ast.Name) \
                    and n.func.value.id in ("faults", "_faults"):
                arg = n.args[0] if n.args else None
                out.append((path, n.lineno,
                            arg.value if isinstance(arg, ast.Constant)
                            else None))
    return out


def test_every_fault_site_is_a_known_site():
    """Each ``faults.check`` names its site with a literal from ``SITES``,
    and the training, checkpoint, numerics, embedding and decode paths each
    have theirs."""
    tree = _tree(PKG / "resilience" / "faults.py")
    sites = next(ast.literal_eval(n.value) for n in tree.body
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "SITES")
    found = _fault_sites()
    for path, line, site in found:
        assert site in sites, f"{path}:{line}: fault site {site!r}"
    named = {site for _, _, site in found}
    assert {"train_step", "compile", "checkpoint_write", "preemption",
            "numerics", "sdc", "decode", "emb_dispatch"} <= named


# the functions a guarded training step runs every step: nothing in them
# may read the device (the guard reads once a window, in ``_read``)
GUARDED_PATH = {"parallel/train_step.py": ("_compute", "_step_impl"),
                "resilience/numerics.py": ("intercept", "observe",
                                           "_current_batch_pos")}


@pytest.mark.parametrize("module", sorted(GUARDED_PATH))
def test_guarded_step_reads_nothing_from_the_device(module):
    tree = _tree(PKG / module)
    fns = {n.name: n for n in ast.walk(tree)
           if isinstance(n, ast.FunctionDef)}
    for name in GUARDED_PATH[module]:
        for n in ast.walk(fns[name]):
            if isinstance(n, ast.Attribute):
                assert n.attr not in ("item", "cpu", "synchronize",
                                      "tolist", "numpy"), \
                    f"{module}:{n.lineno}: {name} calls .{n.attr}"
    if "_read" in fns:
        assert "cpu" in {n.attr for n in ast.walk(fns["_read"])
                         if isinstance(n, ast.Attribute)}


# ---------------------------------------------------------------------------
# the pipelined multi-tenant server (S16): no fallback, no device-wide sync
# ---------------------------------------------------------------------------
SERVING_CORE = ["serving/server.py", "serving/pipeline.py",
                "serving/autoscaler.py", "serving/supervisor.py",
                "serving/endpoint.py", "serving/batcher.py",
                "serving/router.py", "serving/tailguard.py",
                "telemetry/slo.py"]
#: the calls that run the model (and so launch K1)
_MODEL_CALLS = {"execute", "_forward", "run_batch", "forward", "block",
                "prepare", "prepare_batch"}


@pytest.mark.parametrize("module", SERVING_CORE)
def test_serving_core_modules_are_guarded(module):
    assert PKG / module in PORT_FILES
    test_port_imports_neither_jax_nor_the_jax_package(PKG / module)


def _called_names(node):
    for c in ast.walk(node):
        if isinstance(c, ast.Call):
            f = c.func
            yield f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", None)


@pytest.mark.parametrize("module", SERVING_CORE)
def test_no_handler_runs_the_model_again(module):
    """A failed step (K1 included) reaches the retry policy and the
    breaker as an error: no except handler in the serving core calls the
    model, so none can fall back to another forward."""
    for node in ast.walk(_tree(PKG / module)):
        if isinstance(node, ast.Try):
            for h in node.handlers:
                bad = _MODEL_CALLS & set(_called_names(h))
                assert not bad, f"{module}:{h.lineno}: handler calls {bad}"


def test_the_step_path_has_no_handler():
    """prepare/execute and the forward they run catch nothing."""
    tree = _tree(PKG / "serving" / "endpoint.py")
    fns = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    for name in ("_forward", "staging_buffers", "prepare", "execute",
                 "run_batch", "_slot"):
        assert not any(isinstance(n, ast.Try) for n in ast.walk(fns[name])), \
            name


@pytest.mark.parametrize("module", SERVING_CORE)
def test_serving_never_synchronizes_the_device(module):
    """The step waits on events behind its own work: a device-wide
    ``torch.cuda.synchronize()`` would also wait for the next batch's copy
    on the prep stream and remove the overlap."""
    for n in ast.walk(_tree(PKG / module)):
        if isinstance(n, ast.Attribute) and n.attr == "synchronize":
            owner = n.value
            assert not (isinstance(owner, ast.Attribute)
                        and owner.attr == "cuda"), \
                f"{module}:{n.lineno}: torch.cuda.synchronize"


# ---------------------------------------------------------------------------
# the executable cache and the serving fabric (S17)
# ---------------------------------------------------------------------------
SLICE20_MODULES = ["cache/__init__.py", "cache/executable_cache.py",
                   "serving/fabric/__init__.py", "serving/fabric/slices.py",
                   "serving/fabric/sharded.py", "serving/fabric/frontdoor.py"]
#: the calls that build a kernel binary (nvcc or NVRTC)
_BUILD_CALLS = {"build", "_compile", "compile_cubin", "CudaModule",
                "nvcc_version", "nvrtc_version"}


@pytest.mark.parametrize("module", SLICE20_MODULES)
def test_slice20_modules_are_guarded(module):
    """The cache and the fabric import no JAX and every subprocess call in
    them has a timeout."""
    assert PKG / module in PORT_FILES
    test_port_imports_neither_jax_nor_the_jax_package(PKG / module)
    test_every_subprocess_has_a_timeout(PKG / module)


@pytest.mark.parametrize(
    "module", SLICE20_MODULES + ["ops/_build.py", "ops/_nvrtc.py", "rtc.py"])
def test_no_handler_carries_on_after_a_failed_build(module):
    """A failed nvcc or NVRTC build raises through the cache: no try block
    around a build has a handler (the cache's only fallback is to build
    the same kernel again)."""
    for node in ast.walk(_tree(PKG / module)):
        if isinstance(node, ast.Try) and node.handlers:
            bad = _BUILD_CALLS & {n for stmt in node.body
                                  for n in _called_names(stmt)}
            assert not bad, f"{module}:{node.lineno}: handler around {bad}"


def _agent_source():
    tree = _tree(FRONTDOOR)
    (src,) = [n.value.value for n in tree.body if isinstance(n, ast.Assign)
              and any(isinstance(t, ast.Name) and t.id == "_HOST_AGENT_SRC"
                      for t in n.targets)]
    return src


def test_the_host_agent_runs_the_port_only():
    """The front door's agent subprocess imports the port and names no
    module of the JAX package and no jax."""
    src = _agent_source()
    assert not re.search(r"\bjax\b|\bmxnet_tpu\b(?!_torch)", src), src
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    assert not any(_forbidden(n) for n in names), names
    assert "mxnet_tpu_torch" in names


def test_every_host_agent_has_a_deadline():
    """An agent exits at its deadline or when its parent is gone, and the
    front door waits for a killed agent with a timeout."""
    src = _agent_source()
    assert "FABRIC_AGENT_MAX_S" in src and "getppid" in src
    for node in ast.walk(_tree(FRONTDOOR)):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr in ("wait", "communicate"):
            assert any(k.arg == "timeout" for k in node.keywords), \
                f"frontdoor.py:{node.lineno}: {node.func.attr} without " \
                "a timeout"


# ---------------------------------------------------------------------------
# the telemetry core and the profiler (S18)
# ---------------------------------------------------------------------------
TELEMETRY_MODULES = sorted(
    str(p.relative_to(PKG)) for p in (PKG / "telemetry").glob("*.py")) + \
    ["profiler.py"]
#: modules whose recording runs on the serving and training paths: they
#: may not wait for the card
RECORDING_MODULES = ["telemetry/metrics.py", "telemetry/tracing.py",
                     "telemetry/flight.py", "telemetry/perf_sentinel.py",
                     "serving/stats.py", "serving/generate/stats.py",
                     "telemetry/goodput.py", "telemetry/fleet.py",
                     "telemetry/debug_server.py"]


@pytest.mark.parametrize("module", TELEMETRY_MODULES)
def test_telemetry_modules_are_guarded(module):
    assert PKG / module in PORT_FILES
    test_port_imports_neither_jax_nor_the_jax_package(PKG / module)


@pytest.mark.parametrize("module", RECORDING_MODULES)
def test_recording_never_reads_the_device(module):
    """No ``torch.cuda.synchronize()``, ``.item()``, ``.cpu()`` or
    ``.tolist()``: a count, a span or an event never waits for the card."""
    for n in ast.walk(_tree(PKG / module)):
        if isinstance(n, ast.Attribute):
            assert n.attr not in ("synchronize", "item", "cpu", "tolist"), \
                f"{module}:{n.lineno}: .{n.attr}"


def test_whole_port_registers_linted_families():
    """After importing every module of the port, every registered family
    matches ``METRIC_NAME_RE`` and ``lint_names()`` is empty."""
    code = ("import pkgutil, importlib\n"
            "import mxnet_tpu_torch\n"
            "for m in pkgutil.walk_packages(mxnet_tpu_torch.__path__, "
            "'mxnet_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "from mxnet_tpu_torch import telemetry\n"
            "from mxnet_tpu_torch.telemetry.metrics import METRIC_NAME_RE\n"
            "names = telemetry.REGISTRY.names()\n"
            "assert telemetry.lint_names() == [], telemetry.lint_names()\n"
            "bad = [n for n in names if not METRIC_NAME_RE.match(n)]\n"
            "assert not bad, bad\n"
            "assert not set(names) & set(telemetry.NOT_REGISTERED)\n"
            "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 118


# ---------------------------------------------------------------------------
# goodput, the fleet pane and the debug server (S19)
# ---------------------------------------------------------------------------
#: what reads the card's memory counters (torch.cuda.memory_stats)
_DEVICE_MEMORY_READS = ("sample_device_memory", "memory_stats",
                        "_device_stats", "_refresh_memory_gauges")


def _called_names(node):
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            yield f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", None)


@pytest.mark.parametrize("module", ["telemetry/goodput.py",
                                    "telemetry/fleet.py"])
def test_goodput_and_fleet_never_sample_device_memory(module):
    """Attribution and merging are arithmetic on snapshots: neither reads
    the card's memory counters (the live registry's snapshot is
    ``REGISTRY.snapshot()``, which samples nothing)."""
    tree = _tree(PKG / module)
    assert not set(_called_names(tree)) & set(_DEVICE_MEMORY_READS), module
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom):
            assert not {a.name for a in n.names} & \
                set(_DEVICE_MEMORY_READS), f"{module}:{n.lineno}"


def test_only_the_scrape_pages_sample_device_memory():
    """In the debug server, device memory is read on a scrape only: by
    ``statusz`` and ``memz`` (which sample it themselves) and by the
    handler's ``/metricsz`` (``snapshot``/``prometheus_text``, which
    refresh it); no other function reads it."""
    tree = _tree(PKG / "telemetry" / "debug_server.py")
    readers = set()
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and \
                set(_called_names(fn)) & set(_DEVICE_MEMORY_READS):
            readers.add(fn.name)
    assert readers == {"statusz", "memz"}, readers
    (handler,) = [n for n in tree.body if isinstance(n, ast.ClassDef)
                  and n.name == "_Handler"]
    imported = {a.name for n in ast.walk(handler)
                if isinstance(n, ast.ImportFrom) for a in n.names}
    assert imported == {"snapshot", "prometheus_text"}, imported


def _http_calls_are_proxyless_with_timeouts(path):
    """No ``urlopen`` (it follows ``http_proxy`` from the environment);
    every ``build_opener`` is given ``ProxyHandler({})``, every ``.open``
    of such an opener and every ``HTTPConnection`` a timeout."""
    tree = _tree(path)
    openers = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) and \
                getattr(n.value.func, "attr", None) == "build_opener":
            openers |= {t.id for t in n.targets if isinstance(t, ast.Name)}
    for n in ast.walk(tree):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            getattr(f, "id", None)
        where = f"{path.name}:{n.lineno}"
        assert name != "urlopen", f"{where}: urlopen follows proxies"
        if name == "build_opener":
            assert any(isinstance(a, ast.Call) and
                       getattr(a.func, "attr", getattr(a.func, "id", None))
                       == "ProxyHandler" and a.args and
                       isinstance(a.args[0], ast.Dict) and
                       not a.args[0].keys for a in n.args), \
                f"{where}: an opener without ProxyHandler({{}})"
        if name in ("HTTPConnection", "HTTPSConnection") or (
                name == "open" and isinstance(f, ast.Attribute) and
                isinstance(f.value, ast.Name) and f.value.id in openers):
            assert any(k.arg == "timeout" for k in n.keywords), \
                f"{where}: {name} without a timeout"


@pytest.mark.parametrize("path", PORT_FILES + PORT_TESTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_every_http_fetch_is_proxyless_with_a_timeout(path):
    _http_calls_are_proxyless_with_timeouts(path)


def test_the_http_guard_catches_what_it_forbids(tmp_path):
    """The guard above fails on each thing it forbids."""
    bad = {
        "urlopen": "import urllib.request\n"
                   "urllib.request.urlopen('http://x', timeout=1)\n",
        "proxy": "import urllib.request as u\n"
                 "o = u.build_opener()\no.open('http://x', timeout=1)\n",
        "open": "import urllib.request as u\n"
                "o = u.build_opener(u.ProxyHandler({}))\no.open('http://x')\n",
        "conn": "import http.client\n"
                "http.client.HTTPConnection('127.0.0.1', 80)\n"}
    for what, src in bad.items():
        p = tmp_path / f"bad_{what}.py"
        p.write_text(src)
        with pytest.raises(AssertionError):
            _http_calls_are_proxyless_with_timeouts(p)
    good = tmp_path / "good.py"
    good.write_text("import urllib.request as u\n"
                    "o = u.build_opener(u.ProxyHandler({}))\n"
                    "o.open('http://x', timeout=3)\n")
    _http_calls_are_proxyless_with_timeouts(good)


def test_the_fleet_modules_are_wired_at_the_references_sites():
    """A started server, a pool and an autoscaler attach themselves to the
    debug pages; the package starts the debug server from its knob."""
    def calls(path):
        return set(_called_names(_tree(path)))
    assert "attach" in calls(PKG / "serving" / "server.py")
    assert {"attach_pool", "attach_autoscaler"} <= \
        calls(PKG / "serving" / "autoscaler.py")
    assert "_autostart" in calls(PKG / "__init__.py")
    assert "debug_server._autostart()" in (PKG / "__init__.py").read_text()


# ---------------------------------------------------------------------------
# the symbolic API (S20)
# ---------------------------------------------------------------------------
SYMBOL_MODULES = ["name.py", "attribute.py", "symbol/__init__.py",
                  "symbol/symbol.py", "symbol/executor.py",
                  "contrib/symbol.py", "subgraph.py", "model.py",
                  "module/__init__.py", "module/module.py", "monitor.py",
                  "callback.py", "visualization.py", "tools/symbol_bert.py"]
#: the calls that make a tensor with storage
_TENSOR_FACTORIES = {"empty", "zeros", "ones", "full", "rand", "randn",
                     "randint", "tensor", "as_tensor", "arange",
                     "empty_strided", "from_numpy"}
#: the functions of shape inference
_INFERENCE = ("_infer_shapes", "_meta_outputs", "_param_shape_hook",
              "_array_slots")


@pytest.mark.parametrize("module", SYMBOL_MODULES)
def test_symbol_modules_are_guarded(module):
    """The symbolic frontend imports no JAX and no module of the JAX
    package (``tools/symbol_bert.py`` imports neither symbol module: it is
    handed one), and no handler surrounds a call in the executor's or the
    partitioner's evaluation."""
    assert PKG / module in PORT_FILES
    test_port_imports_neither_jax_nor_the_jax_package(PKG / module)
    if module == "tools/symbol_bert.py":
        assert not [n for n in ast.walk(_tree(PKG / module))
                    if isinstance(n, (ast.Import, ast.ImportFrom))
                    and n.module != "__future__"]


def _functions(path, names):
    return [n for n in ast.walk(_tree(path))
            if isinstance(n, ast.FunctionDef) and n.name in names]


def test_shape_inference_makes_only_meta_tensors():
    """``_infer_shapes`` and what it calls make every tensor on the meta
    device (no storage, nothing launched), move none and call no kernel
    wrapper; ``_META`` is the meta device; the attention wrappers send a
    meta tensor to their plain versions, which count nothing."""
    path = PKG / "symbol" / "executor.py"
    fns = _functions(path, _INFERENCE)
    assert sorted(f.name for f in fns) == sorted(_INFERENCE)
    made = 0
    for fn in fns:
        for c in ast.walk(fn):
            if not isinstance(c, ast.Call) or not isinstance(
                    c.func, ast.Attribute):
                continue
            if c.func.attr in _TENSOR_FACTORIES and \
                    getattr(c.func.value, "id", None) == "torch":
                made += 1
                dev = [k.value for k in c.keywords if k.arg == "device"]
                assert dev and getattr(dev[0], "id", None) == "_META", \
                    f"executor.py:{c.lineno}: a tensor off the meta device"
            assert c.func.attr not in ("to", "cuda", "cpu", "copy_",
                                       "_set_data", "data_ptr"), \
                f"executor.py:{c.lineno}: {c.func.attr} in shape inference"
    assert made >= 1
    called = {n for fn in fns for n in _called_names(fn)}
    assert not called & {"flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv", "conv1x1_bn_act",
                         "_kernel", "_bwd_kernels", "launch"}, called
    meta = [n for n in _tree(path).body if isinstance(n, ast.Assign)
            and any(getattr(t, "id", None) == "_META" for t in n.targets)]
    assert meta and ast.unparse(meta[0].value) == "torch.device('meta')"
    fa_path = PKG / "ops" / "cuda" / "flash_attention.py"
    (route,) = _functions(fa_path, ("_shape_only",))
    assert "'meta'" in ast.unparse(route)
    (ops,) = _functions(fa_path, ("block_ops",))
    assert "_shape_only" in set(_called_names(ops))


def test_the_executor_and_partitioner_evaluate_without_handlers():
    """A bound graph's evaluation reaches the kernels or raises: no
    handler surrounds a call in ``Executor``'s forward or backward or in a
    region's body (shape inference alone turns an op's failure into the
    reference's MXNetError)."""
    for path, names in ((PKG / "symbol" / "executor.py",
                         ("_eval", "_eval_graph", "forward", "backward")),
                        (PKG / "subgraph.py", ("_CachedSubgraph",))):
        fns = _functions(path, names)
        assert len(fns) == len(names), path
        for fn in fns:
            assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)
                        and n.handlers], f"{path.name}: {fn.name}"
