"""Data iterators of the port (the counterpart of ``mxnet_tpu/io.py``):
``DataDesc``, ``DataBatch``, ``DataIter``, ``NDArrayIter``, ``MNISTIter``,
``CSVIter``, ``LibSVMIter`` (CSR batches), ``NativeImageRecordIter`` (the
native OpenCV pipeline), ``ImageRecordIter``, ``PrefetchingIter`` (batch
fetches as host tasks on the dependency engine) and ``ResizeIter``.

Batches are ``cpu()`` NDArrays; the training loop moves them to the card.
``ImageRecordIter`` returns a ``NativeImageRecordIter`` where the native
library holds the image pipeline (OpenCV's headers were found at its
build), else the Python ``image.ImageIter`` under a ``PrefetchingIter``:
the type it returns says which ran. Shuffles draw from
``random.numpy_rng()``, where the JAX package draws from numpy's global
generator.
"""
from __future__ import annotations

import collections
import os
from collections import namedtuple

import numpy as onp
import torch

from . import random as _random
from .base import MXNetError, cpu
from .ndarray.ndarray import NDArray, _wrap

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "MNISTIter",
           "CSVIter", "LibSVMIter", "ImageRecordIter", "PrefetchingIter",
           "ResizeIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    def __new__(cls, name, shape, dtype="float32", layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    def __init__(self, data, label=None, pad=0, index=None, bucket_key=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Base iterator."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    if data is None:
        return []
    if isinstance(data, (onp.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        data = {f"{default_name}{'_' + str(i) if i else ''}": d
                for i, d in enumerate(data)} if len(data) > 1 \
            else ({default_name: data[0]} if data else {})
    out = []
    for k, v in data.items():
        if not isinstance(v, NDArray):
            v = NDArray(onp.asarray(v), ctx=cpu())
        out.append((k, v))
    return out


class NDArrayIter(DataIter):
    """Batches of in-memory arrays, on their context; the last short
    batch padded from the start (``"pad"``), dropped (``"discard"``) or
    left for the next epoch (``"roll_over"``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data", label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        self._shuffle = shuffle
        self._last_batch_handle = last_batch_handle
        self._order = onp.arange(self.num_data)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], str(v.dtype))
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], str(v.dtype))
                for k, v in self.label]

    def reset(self):
        if self._shuffle:
            _random.numpy_rng().shuffle(self._order)
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self._last_batch_handle == "roll_over":
            return self.cursor + self.batch_size <= self.num_data
        if self._last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _slice(self, arrays):
        out = []
        idx = self._order[self.cursor:self.cursor + self.batch_size]
        pad = self.getpad()
        if pad:
            idx = onp.concatenate([idx, self._order[:pad]])
        for _, v in arrays:
            out.append(_wrap(v.data[torch.from_numpy(idx).to(v.data.device)],
                             v.context))
        return out

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self):
        if self._last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class MNISTIter(NDArrayIter):
    """MNIST batches from its idx files under ``image``'s directory, else
    the warned synthetic set (nothing is downloaded)."""

    def __init__(self, image=None, label=None, batch_size=128, shuffle=True,
                 flat=False, silent=False, seed=None, input_shape=None, **kwargs):
        from .gluon.data.vision.datasets import MNIST
        train = image is None or "train" in str(image)
        root = os.path.dirname(os.path.expanduser(image)) if image \
            else os.path.join("~", ".mxnet", "datasets", "mnist")
        ds = MNIST(root=root, train=train)
        data = ds._data.asnumpy().astype(onp.float32) / 255.0
        labels = ds._label
        if flat:
            data = data.reshape(len(data), -1)
        else:
            data = data.transpose(0, 3, 1, 2)
        super().__init__(data, labels.astype(onp.float32), batch_size, shuffle)


class CSVIter(DataIter):
    """Batches of the rows of a CSV file (and of a label CSV)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = onp.loadtxt(data_csv, delimiter=",", dtype=onp.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = onp.loadtxt(label_csv, delimiter=",", dtype=onp.float32) \
            if label_csv else onp.zeros(len(data), onp.float32)
        self._inner = NDArrayIter(data, label, batch_size)

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


class LibSVMIter(DataIter):
    """Batches of a LibSVM file (``label idx:val idx:val ...`` a line) as
    ``CSRNDArray`` data on ``cpu()``; a short last batch wraps around to
    the first rows (``round_batch``) or stays short."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=(1,), batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        self._feature_dim = int(data_shape[0]) if hasattr(data_shape, "__len__") \
            else int(data_shape)
        vals, idxs, ptr, labels = [], [], [0], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                for tok in parts[1:]:
                    i, v = tok.split(":")
                    idxs.append(int(i))
                    vals.append(float(v))
                ptr.append(len(idxs))
        self._vals = onp.asarray(vals, onp.float32)
        self._idxs = onp.asarray(idxs, onp.int32)
        self._ptr = onp.asarray(ptr, onp.int64)
        self._labels = onp.asarray(labels, onp.float32)
        if label_libsvm:
            # the label file is LibSVM too: its first token a line
            lab = []
            with open(label_libsvm) as f:
                for line in f:
                    parts = line.split()
                    if parts:
                        lab.append(float(parts[0]))
            self._labels = onp.asarray(lab, onp.float32)
        if len(self._labels) != len(self._ptr) - 1:
            raise ValueError(
                f"LibSVMIter: {len(self._ptr) - 1} data rows but "
                f"{len(self._labels)} labels")
        self._round_batch = round_batch
        self._n = len(self._labels)
        self._cursor = 0
        self.provide_data = [DataDesc("data", (batch_size, self._feature_dim))]
        self.provide_label = [DataDesc("softmax_label", (batch_size,))]

    def reset(self):
        self._cursor = 0

    def iter_next(self):
        return self._cursor < self._n

    def next(self):
        from .sparse import CSRNDArray
        if not self.iter_next():
            raise StopIteration
        b = self.batch_size
        lo = self._cursor
        hi = min(lo + b, self._n)
        pad = b - (hi - lo)
        if pad and not self._round_batch:
            b = hi - lo  # round_batch=False: the short final batch
            pad = 0
        rows = list(range(lo, hi)) + list(range(pad))  # wrap from the start
        ptr = [0]
        vals, idxs = [], []
        for r in rows:
            s, e = self._ptr[r], self._ptr[r + 1]
            vals.append(self._vals[s:e])
            idxs.append(self._idxs[s:e])
            ptr.append(ptr[-1] + (e - s))
        csr = CSRNDArray(onp.concatenate(vals) if vals else onp.zeros(0),
                         onp.concatenate(idxs) if idxs else onp.zeros(0),
                         onp.asarray(ptr, onp.int64),
                         (b, self._feature_dim), ctx=cpu())
        label = NDArray(self._labels[[min(r, self._n - 1) for r in rows]],
                        ctx=cpu())
        self._cursor = hi
        return DataBatch(data=[csr], label=[label], pad=pad)


class NativeImageRecordIter(DataIter):
    """The native decode, augment, batch and prefetch threads over a
    RecordIO file of encoded images (``native/image_pipeline.cc``, built
    only where OpenCV's headers are found)."""

    def __init__(self, path_imgrec, data_shape, batch_size, shuffle=False,
                 rand_crop=False, rand_mirror=False, mean=None, std=None,
                 preprocess_threads=4, label_width=1, seed=0, prefetch_buffer=4,
                 data_name="data", label_name="softmax_label"):
        super().__init__(batch_size)
        import ctypes
        from . import native
        lib = native.get_lib()
        if lib is None or not hasattr(lib, "mxtpu_impipe_create"):
            raise MXNetError("native image pipeline unavailable: "
                             f"{native.build_error()}")
        self._lib = lib
        c, h, w = data_shape
        mean_arr = (ctypes.c_float * 3)(*(mean if mean is not None
                                          else (0.0, 0.0, 0.0)))
        std_arr = (ctypes.c_float * 3)(*(std if std is not None
                                         else (1.0, 1.0, 1.0)))
        self._h = lib.mxtpu_impipe_create(
            str(path_imgrec).encode(), batch_size, c, h, w, int(shuffle),
            preprocess_threads, int(rand_mirror), int(rand_crop), mean_arr,
            std_arr, label_width, seed, prefetch_buffer)
        if not self._h:
            raise MXNetError(f"could not open {path_imgrec}")
        self._shape = (batch_size,) + tuple(data_shape)
        self._label_width = label_width
        self._data_name, self._label_name = data_name, label_name
        self.provide_data = [DataDesc(data_name, self._shape)]
        lshape = (batch_size,) if label_width == 1 else (batch_size, label_width)
        self.provide_label = [DataDesc(label_name, lshape)]

    def reset(self):
        self._lib.mxtpu_impipe_reset(self._h)

    def next(self):
        import ctypes
        data = onp.zeros(self._shape, "float32")
        label = onp.zeros((self._shape[0], self._label_width), "float32")
        n = self._lib.mxtpu_impipe_next(
            self._h, data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            label.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if n == 0:
            raise StopIteration
        lab = label[:, 0] if self._label_width == 1 else label
        return DataBatch(data=[NDArray(data, ctx=cpu())],
                         label=[NDArray(lab, ctx=cpu())],
                         pad=self._shape[0] - n)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.mxtpu_impipe_destroy(self._h)
                self._h = None
        except (AttributeError, OSError):
            pass


def ImageRecordIter(path_imgrec=None, data_shape=(3, 224, 224), batch_size=128,
                    shuffle=False, rand_crop=False, rand_mirror=False, mean_r=0,
                    mean_g=0, mean_b=0, std_r=1, std_g=1, std_b=1,
                    preprocess_threads=None, prefetch_buffer=4, seed=0,
                    **kwargs):
    """RecordIO decode, augment and batch with prefetch: the native
    pipeline where the library holds it, else ``image.ImageIter`` under a
    ``PrefetchingIter``. ``preprocess_threads`` defaults to
    ``MXNET_CPU_PRIORITY_NTHREADS``."""
    from . import config
    if preprocess_threads is None:
        preprocess_threads = config.get("MXNET_CPU_PRIORITY_NTHREADS")
    mean = onp.array([mean_r, mean_g, mean_b]) if (mean_r or mean_g or mean_b) \
        else None
    std = onp.array([std_r, std_g, std_b]) if (std_r != 1 or std_g != 1
                                               or std_b != 1) else None
    from . import native
    if native.has_image_pipeline():
        return NativeImageRecordIter(
            path_imgrec, data_shape, batch_size, shuffle=shuffle,
            rand_crop=rand_crop, rand_mirror=rand_mirror, mean=mean, std=std,
            preprocess_threads=preprocess_threads, seed=seed,
            prefetch_buffer=prefetch_buffer,
            label_width=kwargs.get("label_width", 1))
    from .image import ImageIter, CreateAugmenter
    aug = CreateAugmenter(data_shape, rand_crop=rand_crop, rand_mirror=rand_mirror,
                          mean=mean, std=std)
    inner = ImageIter(batch_size, data_shape, path_imgrec=path_imgrec,
                      shuffle=shuffle, aug_list=aug,
                      seed=seed if shuffle else None, **kwargs)
    return PrefetchingIter(inner, prefetch=prefetch_buffer)


class PrefetchingIter(DataIter):
    """Batches fetched ahead on the dependency engine.

    Each fetch is a host task pushed to the engine (``native/engine.cc``'s
    worker pool, or the Python engine) with two write vars: its slot's
    var, which ``next()`` waits on, and the iterator's var, whose FIFO
    write order serializes the inner iterator across the pool, so batches
    keep their order. An error in a fetch is raised at its ``next()``."""

    def __init__(self, iters, rename_data=None, rename_label=None, prefetch=2):
        super().__init__()
        from . import engine as engine_mod
        self._iter = iters if not isinstance(iters, list) else iters[0]
        self._prefetch = max(1, prefetch)
        self._engine = engine_mod.get_engine()
        self._slots = None
        self._iter_var = self._engine.new_var()
        # a fixed ring of slot vars reused in turn (engine vars live as long
        # as the engine); a slot is only rescheduled after next() waited on
        # it
        self._slot_vars = [self._engine.new_var()
                           for _ in range(self._prefetch)]
        self._next_slot = 0
        self._done = False
        self.reset()

    def _schedule(self):
        if self._done:
            return
        var = self._slot_vars[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slot_vars)
        cell = {}

        def task(cell=cell):
            try:
                cell["batch"] = self._iter.next()
            except StopIteration:
                cell["end"] = True
            except Exception as e:  # noqa: BLE001 — raised at next()
                cell["error"] = e

        self._engine.push(task, write_vars=(var, self._iter_var))
        self._slots.append((var, cell))

    def reset(self):
        if self._slots:
            # drain the fetches in flight before touching the inner iterator
            self._engine.wait_for_var(self._iter_var)
        self._iter.reset()
        self._done = False
        self._slots = collections.deque()
        for _ in range(self._prefetch):
            self._schedule()

    def next(self):
        if not self._slots:
            raise StopIteration
        var, cell = self._slots.popleft()
        self._engine.wait_for_var(var)
        if "error" in cell:
            self._done = True
            raise cell["error"]
        if "end" in cell:
            self._done = True
            raise StopIteration
        self._schedule()
        return cell["batch"]


class ResizeIter(DataIter):
    """An iterator cut or cycled to ``size`` batches an epoch."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration
