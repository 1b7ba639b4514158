"""The port's native host library (``mxnet_tpu_torch.native``): the C++
sources copied from the JAX package, built by the port with g++ into
``build/mxnet_tpu_torch/``. The engine's ordering, read/write exclusion,
exception, lane, priority and counter cases of tests/test_native.py; a
build from the sources into an empty directory; the C++ unit suite linked
against the port's library; RecordIO written by the C++ writer read by
both packages' Python readers and the other way round; and the native
image pipeline giving bitwise the JAX package's batches at one seed (the
same C++ over the same file). All comparisons exact."""
import ctypes
import io as _io
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as onp
import pytest

from mxnet_tpu import recordio as jrec

from mxnet_tpu_torch import native
from mxnet_tpu_torch import recordio as trec

ROOT = Path(__file__).resolve().parents[1]


def test_library_builds_under_build_and_not_from_the_jax_package():
    """In a fresh process (pytest's workers also run the JAX package's
    tests, which load its library): the port's library is built under
    ``build/mxnet_tpu_torch/`` and loaded from there, and the data path
    loads nothing of the JAX package's."""
    code = (
        "import sys\n"
        "from mxnet_tpu_torch import engine, io, native\n"
        "assert native.available(), native.build_error()\n"
        "eng = engine.get_engine()\n"
        "assert isinstance(eng, native.NativeEngine)\n"
        "v = eng.new_var(); eng.push(lambda: None, write_vars=[v])\n"
        "eng.wait_all()\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert str(native.lib_path()) in maps\n"
        "assert 'mxnet_tpu/native/' not in maps\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'mxnet_tpu')]\n"
        "print(native.lib_path())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    path = Path(proc.stdout.strip())
    assert path.parent == ROOT / "build" / "mxnet_tpu_torch"
    assert path.name.startswith("libmxtpu_native-")


def test_build_from_the_sources_into_an_empty_directory(tmp_path):
    out = native.build(tmp_path)
    assert out.parent == tmp_path and out.exists()
    lib = ctypes.CDLL(str(out))
    for sym in ("mxtpu_engine_create", "mxtpu_recio_write",
                "mxtpu_recio_read"):
        assert hasattr(lib, sym), sym
    assert hasattr(lib, "mxtpu_impipe_create") == (native._opencv()
                                                   is not None)
    assert native.build(tmp_path) == out       # reused, not rebuilt


def test_cpp_unit_suite_against_the_port_library(tmp_path):
    assert native.available(), native.build_error()
    lib = native.lib_path()
    src = ROOT / "mxnet_tpu_torch" / "native" / "tests" / "native_unit_test.cc"
    exe = tmp_path / "native_unit_test"
    r = subprocess.run(["g++", "-O2", "-std=c++17", str(src), "-o", str(exe),
                        str(lib), f"-Wl,-rpath,{lib.parent}"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    r = subprocess.run([str(exe), str(tmp_path)], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    assert "ALL NATIVE UNIT TESTS PASSED" in r.stdout


@pytest.fixture
def eng():
    e = native.NativeEngine(num_workers=4)
    yield e
    e.close()


def test_engine_writes_to_one_var_run_in_push_order(eng):
    v = eng.new_var()
    out = []
    for i in range(32):
        eng.push((lambda i=i: out.append(i)), write_vars=[v])
    eng.wait_for_var(v)
    assert out == list(range(32))


def test_engine_readers_see_the_write_before_them(eng):
    v = eng.new_var()
    state = {"val": 0}
    reads = []
    eng.push(lambda: state.update(val=1), write_vars=[v])
    for _ in range(8):
        eng.push(lambda: reads.append(state["val"]), read_vars=[v])
    eng.push(lambda: state.update(val=2), write_vars=[v])
    eng.wait_all()
    assert reads == [1] * 8


def test_engine_runs_tasks_without_vars(eng):
    out = []
    for i in range(8):
        eng.push(lambda i=i: out.append(i))
    eng.wait_all()
    assert sorted(out) == list(range(8))


def test_engine_raises_a_task_error_at_the_sync_point(eng):
    v = eng.new_var()

    def boom():
        raise ValueError("async failure")

    eng.push(boom, write_vars=[v])
    with pytest.raises(RuntimeError, match="async failure"):
        eng.wait_all()
    eng.push(lambda: None, write_vars=[v])     # the error was cleared
    eng.wait_all()


def test_engine_lanes_are_isolated_and_priority_orders_a_pool():
    eng = native.NativeEngine(num_workers=1)
    gate = threading.Event()
    copy_done = threading.Event()
    eng.push(lambda: gate.wait(10))
    eng.push(copy_done.set, lane=native.NativeEngine.LANE_COPY)
    assert copy_done.wait(5), "copy lane starved by a blocked normal lane"
    gate.set()
    eng.wait_all()
    order = []
    hold, started = threading.Event(), threading.Event()
    eng.push(lambda: (started.set(), hold.wait(10)), device=1)
    assert started.wait(5)
    for name, prio in (("low", 0), ("high", 5), ("mid", 2)):
        eng.push(lambda n=name: order.append(n), device=1, priority=prio)
    hold.set()
    eng.wait_all()
    assert order == ["high", "mid", "low"], order
    eng.close()


def test_engine_counters():
    eng = native.NativeEngine(num_workers=2)
    s0 = eng.stats()
    assert s0["pushed"] == 0 and s0["pending"] == 0 and s0["pools"] >= 1
    for _ in range(5):
        eng.push(lambda: None)
    eng.push(lambda: None, lane=native.NativeEngine.LANE_COPY)
    eng.wait_all()
    s = eng.stats()
    assert s["pushed"] == 6 and s["completed"] == 6 and s["pending"] == 0
    assert s["pools"] >= 2
    eng.close()


def test_engine_type_follows_the_config(monkeypatch):
    from mxnet_tpu_torch import config, engine
    assert isinstance(engine.Engine(), native.NativeEngine)
    monkeypatch.setitem(config._OVERRIDES, "MXNET_ENGINE_TYPE", "NaiveEngine")
    e = engine.Engine()
    assert type(e).__name__ == "_PythonEngine"
    out = []
    e.push(lambda: out.append(1))
    e.push(lambda: 1 / 0)
    with pytest.raises(RuntimeError, match="division"):
        e.wait_all()
    assert out == [1]


PAYLOADS = [b"hello", b"x" * 33, b""]


@pytest.mark.parametrize("reader", [trec, jrec], ids=["port", "jax"])
def test_cpp_records_read_by_python_and_back(tmp_path, reader):
    lib = native.get_lib()
    path = str(tmp_path / "a.rec")
    w = lib.mxtpu_recio_writer_open(path.encode())
    for p in PAYLOADS:
        assert lib.mxtpu_recio_write(w, p, len(p)) >= 0
    lib.mxtpu_recio_writer_close(w)
    r = reader.MXRecordIO(path, "r")
    assert [r.read() for _ in PAYLOADS] == PAYLOADS
    assert r.read() is None
    r.close()
    path2 = str(tmp_path / "b.rec")
    w2 = reader.MXRecordIO(path2, "w")
    for p in PAYLOADS:
        w2.write(p)
    w2.close()
    r2 = lib.mxtpu_recio_reader_open(path2.encode())
    buf = ctypes.c_char_p()
    for p in PAYLOADS:
        n = lib.mxtpu_recio_read(r2, ctypes.byref(buf))
        assert n == len(p) and ctypes.string_at(buf, n) == p
    assert lib.mxtpu_recio_read(r2, ctypes.byref(buf)) == -1
    lib.mxtpu_recio_reader_close(r2)


def write_jpeg_rec(path, n, hw=(32, 32), corrupt=()):
    """A RecordIO file of ``n`` seeded JPEGs (PIL, quality 95), labels
    i % 3; records in ``corrupt`` hold bytes no decoder takes."""
    from PIL import Image
    w = trec.MXRecordIO(str(path), "w")
    rng = onp.random.RandomState(0)
    for i in range(n):
        arr = rng.randint(0, 255, hw + (3,), dtype=onp.uint8)
        if i in corrupt:
            body = b"not a jpeg"
        else:
            bio = _io.BytesIO()
            Image.fromarray(arr).save(bio, format="JPEG", quality=95)
            body = bio.getvalue()
        w.write(trec.pack(trec.IRHeader(0, float(i % 3), i, 0), body))
    w.close()
    return str(path)


def need_pipeline():
    """Skip where the library was built without OpenCV (decided in the
    test, never at import: pytest-xdist's workers must collect the same
    tests)."""
    if not native.has_image_pipeline():
        pytest.skip("the native library was built without OpenCV's headers")


def _batches(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


@pytest.mark.parametrize("shuffle", [False, True],
                         ids=["in_order", "shuffled"])
def test_native_pipeline_bitwise_the_jax_package(tmp_path, shuffle):
    need_pipeline()
    from mxnet_tpu import native as jnative
    if not (jnative.available()
            and hasattr(jnative.get_lib(), "mxtpu_impipe_create")):
        pytest.skip("the JAX package's native pipeline did not build")
    from mxnet_tpu.io import NativeImageRecordIter as Ref
    from mxnet_tpu_torch.io import NativeImageRecordIter as Port
    path = write_jpeg_rec(tmp_path / "imgs.rec", 10)
    kw = dict(batch_size=4, shuffle=shuffle, mean=(10.0, 20.0, 30.0),
              std=(2.0, 3.0, 4.0), seed=5, preprocess_threads=2)
    got = _batches(Port(path, (3, 16, 16), **kw))
    want = _batches(Ref(path, (3, 16, 16), **kw))
    assert len(got) == len(want) == 3
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        onp.testing.assert_array_equal(gd, wd)
        onp.testing.assert_array_equal(gl, wl)
        assert gp == wp
    assert got[-1][2] == 2


def test_native_pipeline_mirror_by_outcome(tmp_path):
    """The augment threads seed their generators from their thread ids in
    both packages, so a mirror is checked by outcome: each image equals
    the unmirrored one or its mirror, and both occur."""
    need_pipeline()
    from mxnet_tpu_torch.io import NativeImageRecordIter
    path = write_jpeg_rec(tmp_path / "imgs.rec", 16)
    kw = dict(batch_size=4, preprocess_threads=2)
    plain = onp.concatenate([d for d, _, _ in _batches(
        NativeImageRecordIter(path, (3, 16, 16), **kw))])
    got = onp.concatenate([d for d, _, _ in _batches(
        NativeImageRecordIter(path, (3, 16, 16), rand_mirror=True,
                              rand_crop=True, **kw))])
    same = [onp.array_equal(g, p) for g, p in zip(got, plain)]
    flipped = [onp.array_equal(g, p[:, :, ::-1]) for g, p in zip(got, plain)]
    assert all(a or b for a, b in zip(same, flipped))
    assert any(same) and any(flipped)


def test_native_pipeline_skips_a_corrupt_batch_and_small_prefetch(tmp_path):
    need_pipeline()
    from mxnet_tpu_torch.io import NativeImageRecordIter
    path = write_jpeg_rec(tmp_path / "bad.rec", 12, hw=(16, 16),
                          corrupt=range(4, 8))
    it = NativeImageRecordIter(path, (3, 16, 16), batch_size=4,
                               preprocess_threads=2)
    assert sum(4 - b.pad for b in it) == 8
    path = write_jpeg_rec(tmp_path / "ok.rec", 24, hw=(16, 16))
    it = NativeImageRecordIter(path, (3, 16, 16), batch_size=4, shuffle=True,
                               seed=7, prefetch_buffer=1,
                               preprocess_threads=4)
    for _ in range(2):
        it.reset()
        assert sum(4 - b.pad for b in it) == 24
