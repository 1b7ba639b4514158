"""RecordIO of the port (the counterpart of ``mxnet_tpu/recordio.py``):
``MXRecordIO``, ``MXIndexedRecordIO``, ``IRHeader``, ``pack``/``unpack`` and
``pack_img``/``unpack_img``.

Files are byte-identical with the JAX package's (and dmlc's): records
framed as [kMagic:u32][lrec:u32][data][pad to 4 bytes], kMagic 0xced7230a,
the continuation flag in the top 3 bits of lrec; an ``.idx`` sidecar of
"key\toffset" lines. ``IRHeader`` is {flag, label, id, id2} with an
optional float32 label vector after it. ``pack_img`` needs OpenCV (cv2)
and ``unpack_img`` a decoder (PIL or cv2), both imported when called.
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple

import numpy as onp

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img"]

_KMAGIC = 0xced7230a

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def _pad4(n):
    return (4 - n % 4) % 4


class MXRecordIO:
    """Sequential RecordIO reader/writer."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.record = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"invalid flag {self.flag}")
        self.pid = os.getpid()

    def close(self):
        if self.record is not None:
            self.record.close()
            self.record = None

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        self.close()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["record"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()

    def _check_pid(self):
        # reopen after a fork (a handle per process)
        if self.pid != os.getpid():
            self.open()

    def write(self, buf):
        assert self.writable
        self._check_pid()
        lrec = len(buf)
        self.record.write(struct.pack("<II", _KMAGIC, lrec))
        self.record.write(buf)
        self.record.write(b"\x00" * _pad4(lrec))

    def tell(self):
        return self.record.tell()

    def seek(self, pos):
        self.record.seek(pos)

    def read(self):
        assert not self.writable
        self._check_pid()
        head = self.record.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _KMAGIC:
            raise MXNetError("invalid record magic; corrupt file?")
        length = lrec & ((1 << 29) - 1)
        data = self.record.read(length)
        self.record.read(_pad4(length))
        return data


class MXIndexedRecordIO(MXRecordIO):
    """RecordIO with a ``.idx`` key -> offset sidecar."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if self.record is None:
            return
        if self.writable:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write(f"{key}\t{self.idx[key]}\n")
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


IndexedRecordIO = MXIndexedRecordIO


def pack(header, s):
    """Pack a header and a byte payload into a record payload."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        hdr = struct.pack(_IR_FORMAT, 0, float(header.label), header.id, header.id2)
    else:
        label = onp.asarray(header.label, dtype=onp.float32)
        hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2) \
            + label.tobytes()
    return hdr + s


def unpack(s):
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = onp.frombuffer(s[:flag * 4], dtype=onp.float32)
        s = s[flag * 4:]
    header = IRHeader(flag, label, id_, id2)
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image array (HWC, BGR as cv2 takes it) encoded as
    ``img_fmt``; needs cv2."""
    try:
        import cv2
    except ImportError as e:
        raise MXNetError("pack_img requires opencv (cv2)") from e
    if hasattr(img, "asnumpy"):  # an NDArray, as the image functions return
        img = img.asnumpy()
    img = onp.ascontiguousarray(img)
    encode_params = None
    if img_fmt in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    if not ret:
        raise MXNetError("failed to encode image")
    return pack(header, buf.tobytes())


def unpack_img(s, iscolor=-1):
    header, s = unpack(s)
    from . import image
    img = image.imdecode(s, iscolor if iscolor != -1 else 1, to_rgb=False)
    return header, img
