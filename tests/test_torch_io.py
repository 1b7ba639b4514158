"""The port's data iterators (``mxnet_tpu_torch.io``) against the JAX
package's, on the CPU: ``NDArrayIter`` under each ``last_batch_handle``
and a seeded shuffle, ``MNISTIter`` from written files, ``CSVIter``,
``LibSVMIter`` (the reference's ``tests/test_sparse.py`` case, and
``round_batch=False``), ``ImageRecordIter`` on both of its paths (the
native OpenCV pipeline, and ``ImageIter`` under ``PrefetchingIter``),
``PrefetchingIter`` on the engine (order, reset, errors; the
reference's ``tests/test_native.py`` case) and ``ResizeIter``. Batches
are ``cpu()`` NDArrays. Every comparison is exact."""
import gzip
import io as _io
import random
import struct

import numpy as onp
import pytest

from mxnet_tpu import io as jio

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import native
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.sparse import CSRNDArray


def seed_both(s):
    random.seed(s)
    onp.random.seed(s)
    mt.random.seed(s)


def _batches(it):
    return [([d.asnumpy() for d in b.data],
             [lab.asnumpy() for lab in (b.label or [])], b.pad) for b in it]


def _same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for g, w in zip(gd + gl, wd + wl):
            assert str(g.dtype) == str(w.dtype)
            onp.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches(handle, shuffle):
    x = onp.arange(30, dtype=onp.float32).reshape(10, 3)
    y = onp.arange(10, dtype=onp.float32)
    seed_both(4)
    ref = jio.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                          last_batch_handle=handle)
    want = [_batches(ref)]
    ref.reset()
    want.append(_batches(ref))
    seed_both(4)
    it = tio.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                         last_batch_handle=handle)
    got = [_batches(it)]
    it.reset()
    got.append(_batches(it))
    for g, w in zip(got, want):
        _same(g, w)
    assert it.provide_data == [("data", (4, 3))]
    assert it.provide_label[0].name == "softmax_label"
    assert next(iter(tio.NDArrayIter(x, y, 4))).data[0].context == mt.cpu()


def test_ndarray_iter_takes_several_named_arrays():
    x = onp.ones((6, 2), onp.float32)
    it = tio.NDArrayIter({"a": x, "b": x * 2}, batch_size=3)
    b = next(it)
    assert [d.shape for d in b.data] == [(3, 2), (3, 2)]
    assert [desc.name for desc in it.provide_data] == ["a", "b"]
    assert tio.DataDesc.get_batch_axis("TNC") == 1


def test_mnist_iter_matches(tmp_path):
    rng = onp.random.RandomState(2)
    n = 10
    with gzip.open(tmp_path / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28)
                + rng.randint(0, 256, (n, 28, 28)).astype(onp.uint8).tobytes())
    with gzip.open(tmp_path / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, n)
                + rng.randint(0, 10, n).astype(onp.uint8).tobytes())
    image = str(tmp_path / "train-images-idx3-ubyte")
    for flat in (False, True):
        seed_both(1)
        want = _batches(jio.MNISTIter(image=image, batch_size=4, flat=flat))
        seed_both(1)
        got = _batches(tio.MNISTIter(image=image, batch_size=4, flat=flat))
        _same(got, want)


def test_csv_iter_matches(tmp_path):
    data = onp.random.RandomState(0).rand(7, 6).astype(onp.float32)
    onp.savetxt(tmp_path / "d.csv", data, delimiter=",")
    onp.savetxt(tmp_path / "l.csv", onp.arange(7), delimiter=",")
    kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
              label_csv=str(tmp_path / "l.csv"), batch_size=3)
    got = tio.CSVIter(**kw)
    _same(_batches(got), _batches(jio.CSVIter(**kw)))
    got.reset()
    assert got.iter_next()


def test_libsvm_iter(tmp_path):
    """tests/test_sparse.py's test_libsvm_iter on the port, then every
    batch against the reference's."""
    f = tmp_path / "train.libsvm"
    f.write_text("1 0:1.5 3:2.0\n0 1:0.5\n1 2:3.0 3:1.0\n")
    it = tio.LibSVMIter(str(f), data_shape=(4,), batch_size=2)
    batches = list(it)
    assert len(batches) == 2
    b0 = batches[0]
    assert isinstance(b0.data[0], CSRNDArray)
    assert b0.data[0].context == mt.cpu()
    want = onp.zeros((2, 4), "float32")
    want[0, 0], want[0, 3], want[1, 1] = 1.5, 2.0, 0.5
    onp.testing.assert_allclose(b0.data[0].todense().asnumpy(), want)
    onp.testing.assert_allclose(b0.label[0].asnumpy(), [1.0, 0.0])
    assert batches[1].pad == 1
    it.reset()
    assert len(list(it)) == 2
    (tmp_path / "labels.libsvm").write_text("7\n8\n9\n")
    for kw in (dict(), dict(round_batch=False),
               dict(label_libsvm=str(tmp_path / "labels.libsvm"))):
        got = tio.LibSVMIter(str(f), data_shape=(4,), batch_size=2, **kw)
        ref = jio.LibSVMIter(str(f), data_shape=(4,), batch_size=2, **kw)
        for g, r in zip(got, ref):
            assert g.pad == r.pad
            onp.testing.assert_array_equal(g.data[0].todense().asnumpy(),
                                           r.data[0].todense().asnumpy())
            onp.testing.assert_array_equal(g.label[0].asnumpy(),
                                           r.label[0].asnumpy())
    (tmp_path / "short.libsvm").write_text("1\n")
    with pytest.raises(ValueError, match="labels"):
        tio.LibSVMIter(str(f), (4,), label_libsvm=str(tmp_path /
                                                      "short.libsvm"))


def _jpeg_rec(path, n):
    from PIL import Image
    w = trec.MXIndexedRecordIO(str(path.with_suffix(".idx")), str(path), "w")
    rng = onp.random.RandomState(0)
    for i in range(n):
        bio = _io.BytesIO()
        Image.fromarray(rng.randint(0, 256, (20, 24, 3)).astype(onp.uint8)
                        ).save(bio, format="JPEG", quality=90)
        w.write_idx(i, trec.pack(trec.IRHeader(0, float(i % 4), i, 0),
                                 bio.getvalue()))
    w.close()
    return str(path)


KW = dict(data_shape=(3, 16, 16), batch_size=4, mean_r=120.0, mean_g=110.0,
          mean_b=100.0, std_r=50.0, std_g=60.0, std_b=70.0,
          preprocess_threads=2)


def test_image_record_iter_native_path_matches(tmp_path):
    if not native.has_image_pipeline():   # decided here, not at import
        pytest.skip("the native library was built without OpenCV")
    path = _jpeg_rec(tmp_path / "a.rec", 10)
    got = tio.ImageRecordIter(path_imgrec=path, **KW)
    assert isinstance(got, tio.NativeImageRecordIter)
    from mxnet_tpu import native as jnative
    if not (jnative.available()
            and hasattr(jnative.get_lib(), "mxtpu_impipe_create")):
        pytest.skip("the JAX package's native pipeline did not build")
    _same(_batches(got), _batches(jio.ImageRecordIter(path_imgrec=path,
                                                      **KW)))


def test_image_record_iter_python_path_matches(tmp_path, monkeypatch):
    """Without the native pipeline both packages run ``ImageIter`` (centre
    crop, normalize) under ``PrefetchingIter``: equal batches."""
    from mxnet_tpu import native as jnative
    path = _jpeg_rec(tmp_path / "a.rec", 10)
    monkeypatch.setattr(native, "has_image_pipeline", lambda: False)
    monkeypatch.setattr(jnative, "available", lambda: False)
    got = tio.ImageRecordIter(path_imgrec=path, **KW)
    assert isinstance(got, tio.PrefetchingIter)
    want = jio.ImageRecordIter(path_imgrec=path, **KW)
    g, w = [], []
    for it, out in ((got, g), (want, w)):
        for _ in range(2):
            out.append(it.next())
    _same(_batches(g), _batches(w))
    assert g[0].data[0].context == mt.cpu()


def test_prefetching_iter_on_the_engine():
    data = onp.arange(40, dtype="float32").reshape(20, 2)
    labels = onp.arange(20, dtype="float32")
    pf = tio.PrefetchingIter(tio.NDArrayIter(data, labels, batch_size=4),
                             prefetch=3)
    assert [b.data[0].asnumpy()[0, 0] for b in pf] == [0.0, 8.0, 16.0, 24.0,
                                                        32.0]
    pf.reset()
    assert float(next(iter(pf)).data[0].asnumpy()[0, 0]) == 0.0

    class Boom(tio.NDArrayIter):
        def getdata(self):
            raise ValueError("boom")
    pf2 = tio.PrefetchingIter(Boom(data, labels, batch_size=4), prefetch=2)
    with pytest.raises(ValueError, match="boom"):
        pf2.next()
    from mxnet_tpu_torch import engine
    assert isinstance(engine.get_engine(), native.NativeEngine)


def test_resize_iter_matches():
    x = onp.arange(20, dtype=onp.float32).reshape(10, 2)
    for size in (2, 5):
        got = tio.ResizeIter(tio.NDArrayIter(x, batch_size=4), size)
        want = jio.ResizeIter(jio.NDArrayIter(x, batch_size=4), size)
        _same(_batches(got), _batches(want))
        got.reset()
        assert len(_batches(got)) == size
