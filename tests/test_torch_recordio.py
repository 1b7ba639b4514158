"""The port's RecordIO (``mxnet_tpu_torch.recordio``) against the JAX
package's, on the CPU: files written by either package read back by the
other, ``.rec`` and ``.idx`` byte-identical for the same records, the
IRHeader packing with scalar and vector labels, and ``pack_img``/
``unpack_img`` (cv2 encodes, the decoder decodes) equal in both. Every
comparison is exact."""
import numpy as onp
import pytest

from mxnet_tpu import recordio as jrec

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import recordio as trec

PAYLOADS = [b"hello", b"x" * 33, b"", bytes(range(256)) * 3, b"abc"]


def _write(mod, path, payloads, indexed=False):
    if indexed:
        w = mod.MXIndexedRecordIO(str(path) + ".idx", str(path), "w")
        for i, p in enumerate(payloads):
            w.write_idx(i * 7, p)
    else:
        w = mod.MXRecordIO(str(path), "w")
        for p in payloads:
            w.write(p)
    w.close()


@pytest.mark.parametrize("indexed", [False, True])
def test_files_are_byte_identical(tmp_path, indexed):
    _write(jrec, tmp_path / "ref.rec", PAYLOADS, indexed)
    _write(trec, tmp_path / "port.rec", PAYLOADS, indexed)
    assert (tmp_path / "port.rec").read_bytes() == \
        (tmp_path / "ref.rec").read_bytes()
    if indexed:
        assert (tmp_path / "port.rec.idx").read_bytes() == \
            (tmp_path / "ref.rec.idx").read_bytes()


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)],
                         ids=["jax_to_port", "port_to_jax"])
def test_either_package_reads_the_other(tmp_path, writer, reader):
    path = tmp_path / "a.rec"
    _write(writer, path, PAYLOADS)
    r = reader.MXRecordIO(str(path), "r")
    assert [r.read() for _ in PAYLOADS] == PAYLOADS
    assert r.read() is None
    r.reset()
    assert r.read() == PAYLOADS[0]
    r.close()
    _write(writer, path, PAYLOADS, indexed=True)
    r = reader.MXIndexedRecordIO(str(path) + ".idx", str(path), "r")
    assert r.keys == [i * 7 for i in range(len(PAYLOADS))]
    for i in reversed(range(len(PAYLOADS))):
        assert r.read_idx(i * 7) == PAYLOADS[i]
    r.close()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0]],
                         ids=["scalar", "vector"])
def test_pack_unpack_match(label):
    header = (0, label, 17, 3)
    s = trec.pack(header, b"payload")
    assert s == jrec.pack(header, b"payload")
    h, body = trec.unpack(s)
    rh, rbody = jrec.unpack(s)
    assert body == rbody == b"payload"
    assert (h.flag, h.id, h.id2) == (rh.flag, rh.id, rh.id2)
    onp.testing.assert_array_equal(onp.asarray(h.label), onp.asarray(rh.label))


@pytest.mark.parametrize("fmt", [".png", ".jpg"])
def test_pack_img_and_unpack_img_match(fmt):
    pytest.importorskip("cv2")
    img = onp.random.RandomState(0).randint(0, 255, (12, 10, 3), onp.uint8)
    header = trec.IRHeader(0, 2.0, 5, 0)
    s = trec.pack_img(header, img, quality=9 if fmt == ".png" else 90,
                      img_fmt=fmt)
    assert s == jrec.pack_img(header, img, quality=9 if fmt == ".png" else 90,
                              img_fmt=fmt)
    h, got = trec.unpack_img(s)
    _, want = jrec.unpack_img(s)
    assert h.label == 2.0
    assert got.context.device_type == "cpu"
    onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    if fmt == ".png":     # lossless: the BGR pixels cv2 was given
        onp.testing.assert_array_equal(got.asnumpy(), img)


def test_bad_magic_and_flag_raise(tmp_path):
    path = tmp_path / "bad.rec"
    path.write_bytes(b"\x00" * 16)
    r = trec.MXRecordIO(str(path), "r")
    with pytest.raises(MXNetError, match="magic"):
        r.read()
    with pytest.raises(MXNetError, match="invalid flag"):
        trec.MXRecordIO(str(path), "a")
