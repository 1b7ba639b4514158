"""The port's executable cache (``mxnet_tpu_torch.cache``) on the CPU,
against the reference's ``mxnet_tpu.cache.executable_cache``.

The payloads are the port's compiled kernel binaries: an nvcc library
(``ops/_build.py``) or an NVRTC cubin (``rtc.CudaModule``). Here there is no
nvcc and no NVRTC, so the compile steps are stubbed: the library "compiler"
builds a real shared library from C source with the host's g++ (so ``dlopen``
runs on the cached bytes), the cubin "compiler" returns seeded bytes. Covers:
the reference's canonical digest, a miss for any change of the key, the
refused manifest of another key, corrupt payloads and the ``cache_poison``
drill, LRU eviction against the reference's ``_evict``, writers racing in
threads and in processes, and a second process loading both kinds of binary
without calling the compiler.
"""
import concurrent.futures
import json
import logging
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest
import torch

from mxnet_tpu.cache import executable_cache as jx

from mxnet_tpu_torch import MXNetError, config, rtc
from mxnet_tpu_torch.cache import executable_cache as xc
from mxnet_tpu_torch.ops import _build, _nvrtc
from mxnet_tpu_torch.resilience import faults

ROOT = Path(__file__).resolve().parents[1]
C_SOURCE = "int answer(void) { return 42; }\n"


@pytest.fixture(autouse=True)
def _store(tmp_path):
    xc.reset_stats()
    config.set("MXNET_EXEC_CACHE_DIR", str(tmp_path / "xcache"))
    yield tmp_path / "xcache"
    config.set("MXNET_EXEC_CACHE_DIR", "")
    config.set("MXNET_EXEC_CACHE_MAX_BYTES", 1 << 30)
    xc.reset_stats()


def _key(**over):
    key = xc.build_key("f" * 64, {"nvcc": "V12.9.86"}, {"library": "k1"})
    key.update(over)
    return key


def test_exports_and_flags_are_the_references():
    import mxnet_tpu.cache as jcache
    from mxnet_tpu import config as jcfg
    import mxnet_tpu_torch.cache as pcache
    assert pcache.__all__ == jcache.__all__
    assert xc.__all__ == jx.__all__
    for flag in ("MXNET_EXEC_CACHE_DIR", "MXNET_EXEC_CACHE_MAX_BYTES"):
        assert config._REGISTRY[flag]["default"] == \
            jcfg._REGISTRY[flag]["default"]
    assert not xc.enabled() or xc.cache_dir()
    config.set("MXNET_EXEC_CACHE_DIR", "")
    assert not xc.enabled() and xc.load(_key()) is None
    assert not xc.store(_key(), b"x")


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------
KEYS = [
    {"fingerprint": "a" * 64},
    {"fingerprint": "b" * 64, "platform": "gpu",
     "device_kind": "NVIDIA H100 80GB HBM3", "capability": "9.0",
     "versions": {"torch": "2.8.0", "cuda": "12.9"},
     "toolchain": {"nvcc": "V12.9.86"}, "extra": {"library": "k1"}},
    {"extra": {"b": "2", "a": "1"}, "fingerprint": "c" * 64,
     "versions": {"jax": "0.9.0", "jaxlib": "0.9.0"}, "device_count": 8},
]


@pytest.mark.parametrize("key", KEYS, ids=range(len(KEYS)))
def test_key_digest_equals_the_reference(key):
    assert xc.key_digest(key) == jx.key_digest(key)
    assert xc.key_digest(json.loads(json.dumps(key))) == xc.key_digest(key)


def test_build_key_fields_and_never_a_device_index():
    k1 = xc.build_key("f" * 64, {"nvrtc": "12.9"},
                      {"module": "rtc.cu", "exports": "a"})
    k2 = xc.build_key("f" * 64, {"nvrtc": "12.9"},
                      {"exports": "a", "module": "rtc.cu"})
    assert xc.key_digest(k1) == xc.key_digest(k2)
    assert k1["versions"] == {"torch": torch.__version__,
                              "cuda": str(torch.version.cuda)}
    assert k1["platform"] == ("gpu" if torch.cuda.is_available() else "cpu")
    assert not any("index" in f or f == "device" for f in k1)


@pytest.mark.parametrize("field,value", [
    ("fingerprint", "0" * 64), ("toolchain", {"nvcc": "V12.8.93"}),
    ("versions", {"torch": "0.0.1", "cuda": "12.9"}),
    ("platform", "gpu"), ("device_kind", "NVIDIA A100"),
    ("capability", "8.0"), ("extra", {"library": "k2"})])
def test_a_change_of_any_field_is_an_absent_miss(field, value):
    key = _key()
    assert xc.store(key, b"library bytes")
    changed = dict(key, **{field: value})
    assert xc.key_digest(changed) != xc.key_digest(key)
    assert xc.load(changed) is None
    s = xc.stats()
    assert s["misses_by_reason"]["absent"] == 1 and s["hits"] == 0
    assert xc.load(key) == b"library bytes"


def test_manifest_key_mismatch_refused(_store):
    key = _key()
    assert xc.store(key, b"payload")
    man_path = _store / f"ent-{xc.key_digest(key)}.json"
    man = json.loads(man_path.read_text())
    man["key"] = dict(man["key"], fingerprint="0" * 64)
    man_path.write_text(json.dumps(man))
    assert xc.load(key) is None
    s = xc.stats()
    assert s["hits"] == 0 and s["misses_by_reason"]["key_mismatch"] == 1


def test_on_disk_format_is_the_references(_store):
    key = _key()
    assert xc.store(key, b"\x7fELF binary", meta={"lowered": {"k": "_Z1k"}})
    digest = xc.key_digest(key)
    assert sorted(os.listdir(_store)) == [f"ent-{digest}.bin",
                                          f"ent-{digest}.json"]
    man = json.loads((_store / f"ent-{digest}.json").read_text())
    assert man["key"] == key and man["payload_bytes"] == 11
    assert man["payload_sha256"] == __import__("hashlib").sha256(
        b"\x7fELF binary").hexdigest()
    (ent,) = xc.entries()
    assert ent["digest"] == digest
    assert xc.load(key, with_meta=True) == (b"\x7fELF binary",
                                            {"lowered": {"k": "_Z1k"}})
    assert xc.stats()["bytes"] == 11
    xc.clear()
    assert os.listdir(_store) == []


# ---------------------------------------------------------------------------
# corruption
# ---------------------------------------------------------------------------
def test_corrupt_payload_warns_deletes_and_misses(_store, caplog):
    key = _key()
    assert xc.store(key, bytes(range(256)) * 4)
    bin_path = _store / f"ent-{xc.key_digest(key)}.bin"
    blob = bytearray(bin_path.read_bytes())
    blob[100] ^= 0x01
    bin_path.write_bytes(bytes(blob))
    with caplog.at_level(logging.WARNING, logger="mxnet_tpu_torch.cache"):
        assert xc.load(key) is None
    assert "corrupt" in caplog.text
    assert not bin_path.exists()
    assert xc.stats()["misses_by_reason"]["corrupt"] == 1
    assert xc.load(key) is None        # gone: now absent
    assert xc.stats()["misses_by_reason"]["absent"] == 1


def test_cache_poison_leaves_real_corruption_on_disk(_store):
    key = _key()
    payload = b"x" * 1000
    assert xc.store(key, payload)
    bin_path = _store / f"ent-{xc.key_digest(key)}.bin"
    with faults.inject("cache_poison", at=(1,)) as inj:
        xc._consume_poison_fault(str(bin_path))
    assert inj.fires == 1
    assert bin_path.stat().st_size == 500      # truncated to half on disk
    assert xc.load(key) is None
    assert xc.stats()["misses_by_reason"]["corrupt"] == 1
    # the drill through load itself: poisoned, caught, deleted, stored again
    assert xc.store(key, payload)
    with faults.inject("cache_poison", at=(1,)):
        assert xc.load(key) is None
        assert xc.load(key) is None            # deleted by the first
    assert xc.stats()["misses_by_reason"] == {
        "absent": 1, "corrupt": 2, "key_mismatch": 0, "error": 0}
    assert xc.store(key, payload) and xc.load(key) == payload


# ---------------------------------------------------------------------------
# LRU eviction
# ---------------------------------------------------------------------------
def _fill(d, sizes):
    os.makedirs(d)
    for i, size in enumerate(sizes):
        digest = f"{i:064x}"
        with open(os.path.join(d, f"ent-{digest}.bin"), "wb") as f:
            f.write(b"\0" * size)
        with open(os.path.join(d, f"ent-{digest}.json"), "w") as f:
            f.write("{}")
        mtime = 1_700_000_000 + (7 * i) % len(sizes)   # shuffled recency
        os.utime(os.path.join(d, f"ent-{digest}.bin"), (mtime, mtime))


@pytest.mark.parametrize("budget", [0, 1, 250, 600, 1000, 10_000])
def test_lru_eviction_equals_the_references(tmp_path, budget):
    sizes = [100, 300, 50, 200, 400, 150, 250]
    _fill(tmp_path / "port", sizes)
    _fill(tmp_path / "ref", sizes)
    n_port = xc._evict(str(tmp_path / "port"), budget)
    n_ref = jx._evict(str(tmp_path / "ref"), budget)
    assert n_port == n_ref
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref"))


def test_store_evicts_oldest_first_under_the_byte_cap():
    config.set("MXNET_EXEC_CACHE_MAX_BYTES", 2500)
    keys = [_key(fingerprint=f"{i}" * 64) for i in range(4)]
    for i, k in enumerate(keys):
        assert xc.store(k, bytes([i]) * 1000)
        path = os.path.join(xc.cache_dir(), f"ent-{xc.key_digest(k)}.bin")
        os.utime(path, (1_700_000_000 + i, 1_700_000_000 + i))
    assert xc.stats()["evictions"] == 2
    assert xc.load(keys[0]) is None and xc.load(keys[1]) is None
    assert xc.load(keys[3]) == b"\x03" * 1000


# ---------------------------------------------------------------------------
# concurrent writers
# ---------------------------------------------------------------------------
def test_writers_in_threads_race_benignly(_store):
    """More writers than cores, switching threads as often as the
    interpreter allows: every store succeeds and the entry is whole."""
    key = _key()
    payload = os.urandom(1 << 16)
    writers = 2 * (os.cpu_count() or 4)
    barrier = threading.Barrier(writers)

    def write():
        barrier.wait(timeout=30)
        return all(xc.store(key, payload) for _ in range(5))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(writers) as pool:
            assert all(pool.map(lambda _: write(), range(writers),
                                timeout=60))
    finally:
        sys.setswitchinterval(switch)
    assert xc.load(key) == payload
    assert xc.stats()["stores"] == 5 * writers
    assert sorted(os.listdir(_store)) == sorted(
        f"ent-{xc.key_digest(key)}{ext}" for ext in (".bin", ".json"))


def _python(script, env_extra, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **env_extra)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_writers_in_two_processes_race_benignly(_store):
    script = """
        import os, sys
        from mxnet_tpu_torch import config
        from mxnet_tpu_torch.cache import executable_cache as xc
        config.set("MXNET_EXEC_CACHE_DIR", os.environ["STORE"])
        key = xc.build_key("e" * 64, {"nvcc": "V0"}, {"library": "race"})
        payload = bytes(range(256)) * 4096
        ok = all(xc.store(key, payload) for _ in range(20))
        print("OK" if ok and xc.load(key) == payload else "BAD")
    """
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        procs = list(pool.map(lambda _: _python(script,
                                                {"STORE": str(_store)}),
                              range(2)))
    for p in procs:
        assert p.returncode == 0 and p.stdout.strip() == "OK", p.stderr
    key = xc.build_key("e" * 64, {"nvcc": "V0"}, {"library": "race"})
    assert xc.load(key) == bytes(range(256)) * 4096
    assert not [n for n in os.listdir(_store) if n.startswith(".tmp-")]


# ---------------------------------------------------------------------------
# the kernel libraries (ops/_build.py) and the cubins (rtc.CudaModule)
# ---------------------------------------------------------------------------
_STUBS = """
    import os, subprocess
    from pathlib import Path
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.cache import executable_cache as xc
    from mxnet_tpu_torch.ops import _build, _nvrtc
    config.set("MXNET_EXEC_CACHE_DIR", os.environ["STORE"])
    _build.BUILD_DIR = Path(os.environ["BUILD"])
    if "KEEP_TOOLKIT" not in os.environ:
        _build.nvcc_version = lambda: "0.0-test"
    _nvrtc.nvrtc_version = lambda: (0, 0)
    calls = []

    def gxx(name, sources, out):
        calls.append(name)
        xc.note_compile("nvcc")
        subprocess.run(["g++", "-shared", "-fPIC", "-x", "c", "-o", str(out),
                        *sources], check=True, timeout=120)
        _build.note_release(out, "0.0-test")
        _build._LOGS[name] = {"path": str(out), "source": "nvcc"}
        return out

    def nvrtc(source, name, options=(), exports=()):
        calls.append("nvrtc")
        xc.note_compile("nvrtc")
        return (b"cubin:" + source.encode(),
                {e: "_Z" + e for e in exports}, 0.25)

    _build._compile = gxx
    _nvrtc.compile_cubin = nvrtc
"""


def _run_stubbed(body, store, build, timeout=120):
    proc = _python(textwrap.dedent(_STUBS) + textwrap.dedent(body),
                   {"STORE": str(store), "BUILD": str(build)},
                   timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_second_process_loads_the_library_without_the_compiler(
        _store, tmp_path):
    src = tmp_path / "answer.c"
    src.write_text(C_SOURCE)
    body = f"""
        import json
        lib = _build.load("answer", [{str(src)!r}])
        print(json.dumps({{"answer": lib.answer(), "calls": calls,
                          "source": _build.build_log("answer")["source"],
                          "stats": xc.stats()}}))
    """
    first = _run_stubbed(body, _store, tmp_path / "build1")
    assert first["answer"] == 42 and first["calls"] == ["answer"]
    assert first["source"] == "nvcc"
    assert first["stats"]["stores"] == 1
    assert first["stats"]["misses_by_reason"]["absent"] == 1
    assert first["stats"]["compiles"] == {"nvcc": 1, "nvrtc": 0}
    # a fresh build directory: nothing to reuse but the cache
    second = _run_stubbed(body, _store, tmp_path / "build2")
    assert second["answer"] == 42 and second["calls"] == []
    assert second["source"] == "exec_cache"
    assert second["stats"]["hits"] == 1
    assert second["stats"]["compiles"] == {"nvcc": 0, "nvrtc": 0}
    assert second["stats"]["load_s"] > 0
    # an empty store over the first build directory: build/'s file is
    # reused, then stored
    xc.clear()
    third = _run_stubbed(body, _store, tmp_path / "build1")
    assert third["calls"] == [] and third["source"] == "build_dir"
    assert third["stats"]["stores"] == 1


_NO_NVCC = """
    def no_nvcc():
        raise AssertionError("nvcc was looked for")

    _build._nvcc = _build._find_nvcc = no_nvcc
"""


def test_a_hit_needs_no_nvcc(_store, tmp_path):
    """The key's toolchain comes from the toolkit's version.json: a process
    where looking for nvcc raises still loads the stored library."""
    src = tmp_path / "answer.c"
    src.write_text(C_SOURCE)
    body = f"""
        import json
        lib = _build.load("answer", [{str(src)!r}])
        print(json.dumps({{"answer": lib.answer(), "calls": calls,
                          "source": _build.build_log("answer")["source"],
                          "release": _build.nvcc_version(),
                          "stats": xc.stats()}}))
    """
    first = _run_stubbed(body, _store, tmp_path / "build1")
    assert first["calls"] == ["answer"] and first["stats"]["stores"] == 1
    home = tmp_path / "cuda"
    home.mkdir()
    (home / "version.json").write_text(json.dumps(
        {"cuda": {"name": "CUDA SDK", "version": "0.0.1"},
         "cuda_nvcc": {"name": "CUDA NVCC", "version": "0.0-test"}}))
    proc = _python(textwrap.dedent(_STUBS) + textwrap.dedent(_NO_NVCC) +
                   textwrap.dedent(body),
                   {"STORE": str(_store), "BUILD": str(tmp_path / "build2"),
                    "CUDA_HOME": str(home), "KEEP_TOOLKIT": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    second = json.loads(proc.stdout.strip().splitlines()[-1])
    assert second["release"] == "0.0-test"
    assert second["answer"] == 42 and second["calls"] == []
    assert second["source"] == "exec_cache"
    assert second["stats"]["hits"] == 1
    assert second["stats"]["compiles"] == {"nvcc": 0, "nvrtc": 0}


def test_without_a_toolkit_build_dirs_library_loads_as_before(_store,
                                                              tmp_path):
    """No version.json and no nvcc: the cache is passed by, and the library
    build/ holds loads as it did without the cache."""
    src = tmp_path / "answer.c"
    src.write_text(C_SOURCE)
    body = f"""
        import json
        lib = _build.load("answer", [{str(src)!r}])
        print(json.dumps({{"answer": lib.answer(), "calls": calls,
                          "source": _build.build_log("answer")["source"],
                          "release": _build.nvcc_version(),
                          "stats": xc.stats()}}))
    """
    first = _run_stubbed(body, _store, tmp_path / "build1")
    assert first["calls"] == ["answer"]
    xc.clear()
    proc = _python(textwrap.dedent(_STUBS) + textwrap.dedent(
        _NO_NVCC.replace("raise AssertionError(\"nvcc was looked for\")",
                         "return None")) + textwrap.dedent(body),
                   {"STORE": str(_store), "BUILD": str(tmp_path / "build1"),
                    "CUDA_HOME": str(tmp_path / "no_toolkit"),
                    "KEEP_TOOLKIT": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    again = json.loads(proc.stdout.strip().splitlines()[-1])
    assert again["release"] is None
    assert again["answer"] == 42 and again["calls"] == []
    assert again["source"] == "build_dir"
    # the file's note names the nvcc that built it: stored under that one
    assert again["stats"]["misses"] == 0 and again["stats"]["stores"] == 1


def test_a_second_process_loads_the_cubin_without_nvrtc(_store, tmp_path):
    body = """
        import json
        from mxnet_tpu_torch import rtc
        mod = rtc.CudaModule("template <typename T> __global__ void k(T *x)"
                             " {}", options=("-DX=1",), exports=["k<float>"])
        print(json.dumps({"cubin": mod._cubin.decode(), "calls": calls,
                          "lowered": mod._lowered, "hit": mod.cache_hit,
                          "seconds": mod.compile_seconds,
                          "stats": xc.stats()}))
    """
    first = _run_stubbed(body, _store, tmp_path / "b")
    assert first["calls"] == ["nvrtc"] and not first["hit"]
    assert first["stats"]["compiles"]["nvrtc"] == 1
    second = _run_stubbed(body, _store, tmp_path / "b")
    assert second["calls"] == [] and second["hit"]
    assert second["cubin"] == first["cubin"]
    assert second["lowered"] == first["lowered"] == {"k<float>": "_Zk<float>"}
    assert second["seconds"] == 0.0
    assert second["stats"]["compiles"] == {"nvcc": 0, "nvrtc": 0}
    # another option is another key: compiled
    other = _run_stubbed(body.replace("-DX=1", "-DX=2"), _store,
                         tmp_path / "b")
    assert other["calls"] == ["nvrtc"] and not other["hit"]


@pytest.fixture
def stub_build(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_version", lambda: "0.0-test")
    calls = []

    def gxx(name, sources, out):
        calls.append(name)
        subprocess.run(["g++", "-shared", "-fPIC", "-x", "c", "-o", str(out),
                        *sources], check=True, timeout=120)
        _build.note_release(out, "0.0-test")
        _build._LOGS[name] = {"path": str(out), "source": "nvcc"}
        return out

    monkeypatch.setattr(_build, "_compile", gxx)
    src = tmp_path / "answer.c"
    src.write_text(C_SOURCE)
    yield calls, [str(src)]
    _build._LIBS.pop("answer", None)
    _build._LOGS.pop("answer", None)


def test_a_payload_that_does_not_load_is_an_error_miss_then_built(
        stub_build):
    calls, sources = stub_build
    key = _build.cache_key("answer", sources)
    assert xc.store(key, b"not a shared library")
    lib = _build.load("answer", sources)
    assert lib.answer() == 42 and calls == ["answer"]
    s = xc.stats()
    assert s["misses_by_reason"]["error"] == 1 and s["stores"] == 2
    assert xc.load(key)[:4] == b"\x7fELF"      # the built library now


def test_a_failed_build_raises_through_the_cache(stub_build, monkeypatch):
    calls, sources = stub_build

    def broken(name, sources, out):
        raise MXNetError("nvcc failed for answer (exit 1)")

    monkeypatch.setattr(_build, "_compile", broken)
    with pytest.raises(MXNetError, match="nvcc failed"):
        _build.load("answer", sources)
    assert xc.stats()["stores"] == 0 and "answer" not in _build._LIBS


def test_only_a_library_noted_with_its_nvcc_release_is_stored(stub_build):
    """A library in build/ is stored under the release of the nvcc that
    built it, never under this process's toolkit, and not at all without a
    note of that release."""
    calls, sources = stub_build
    path = _build.build("answer", sources)
    assert calls == ["answer"] and _build.built_by(path) == "0.0-test"
    path.with_suffix(".nvcc").unlink()
    assert _build.load("answer", sources).answer() == 42
    assert xc.stats()["stores"] == 0 and xc.entries() == []
    _build._LIBS.pop("answer")
    _build.note_release(path, "9.9-other")
    assert _build.load("answer", sources).answer() == 42
    (entry,) = xc.entries()
    assert entry["key"] == _build.cache_key("answer", sources, "9.9-other")
    assert entry["key"]["toolchain"] == {"nvcc": "9.9-other"}
    # this process's toolkit still misses, and builds nothing
    _build._LIBS.pop("answer")
    assert _build.load("answer", sources).answer() == 42
    assert calls == ["answer"]
    assert xc.stats()["misses_by_reason"]["absent"] == 3


def test_disabled_cache_builds_as_before(stub_build):
    config.set("MXNET_EXEC_CACHE_DIR", "")
    calls, sources = stub_build
    assert _build.load("answer", sources).answer() == 42
    assert calls == ["answer"]
    assert xc.stats()["misses"] == 0 and xc.stats()["stores"] == 0
    assert _build.build_log("answer")["source"] == "nvcc"


def test_cudamodule_key_covers_source_options_and_exports(monkeypatch):
    monkeypatch.setattr(_nvrtc, "nvrtc_version", lambda: (12, 9))
    base = rtc.cache_key("src", ("-DX=1",), ("k",))
    assert base["toolchain"] == {"nvrtc": "12.9"}
    for other in (rtc.cache_key("src2", ("-DX=1",), ("k",)),
                  rtc.cache_key("src", ("-DX=2",), ("k",)),
                  rtc.cache_key("src", ("-DX=1",), ("j",))):
        assert xc.key_digest(other) != xc.key_digest(base)
