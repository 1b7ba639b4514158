"""Vision datasets of the port (the counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``): MNIST, FashionMNIST,
CIFAR10/100, ``ImageRecordDataset`` and ``ImageFolderDataset``.

Nothing is downloaded. MNIST and CIFAR read their canonical files under
``root`` (by default under ``MXNET_HOME``); where the files are absent they
warn and use the JAX package's deterministic synthetic set (the same
``RandomState`` seeds, so the same samples). Samples are ``cpu()``
NDArrays: the data path stays on the host.
"""
from __future__ import annotations

import gzip
import os
import struct
import warnings

import numpy as onp

from ....base import cpu
from ....ndarray.ndarray import NDArray
from ..dataset import Dataset


def _mx_home():
    """The datasets' root, ``MXNET_HOME``."""
    from .... import config
    return config.get("MXNET_HOME")

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100", "ImageRecordDataset",
           "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        if not os.path.isdir(self._root):
            os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _synthetic(shape, num_classes, n, seed):
    warnings.warn("dataset files not found; using deterministic synthetic data "
                  "(nothing is downloaded)")
    rng = onp.random.RandomState(seed)
    data = (rng.rand(n, *shape) * 255).astype(onp.uint8)
    label = rng.randint(0, num_classes, n).astype(onp.int32)
    return data, label


class MNIST(_DownloadedDataset):
    """MNIST from its idx-ubyte files (gzipped or not)."""

    def __init__(self, root=os.path.join(_mx_home(), "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        self._train_data = ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
        self._test_data = ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")
        self._num_synthetic = 2048
        super().__init__(root, transform)

    def _get_data(self):
        data_file, label_file = self._train_data if self._train else self._test_data
        data_path = os.path.join(self._root, data_file)
        label_path = os.path.join(self._root, label_file)
        raw_data_path = data_path[:-3]
        raw_label_path = label_path[:-3]
        if os.path.exists(data_path) or os.path.exists(raw_data_path):
            data = self._read_idx(data_path if os.path.exists(data_path)
                                  else raw_data_path, images=True)
            label = self._read_idx(label_path if os.path.exists(label_path)
                                   else raw_label_path, images=False)
        else:
            data, label = _synthetic((28, 28), 10, self._num_synthetic,
                                     seed=42 if self._train else 43)
        self._data = NDArray(data.reshape(-1, 28, 28, 1), ctx=cpu())
        self._label = label.astype(onp.int32)

    @staticmethod
    def _read_idx(path, images):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            if images:
                magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
                data = onp.frombuffer(f.read(), dtype=onp.uint8)
                return data.reshape(num, rows, cols)
            magic, num = struct.unpack(">II", f.read(8))
            return onp.frombuffer(f.read(), dtype=onp.uint8)

    def __getitem__(self, idx):
        item = self._data[idx], self._label[idx]
        if self._transform is not None:
            return self._transform(*item)
        return item

    def __len__(self):
        return len(self._label)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join(_mx_home(), "datasets",
                                         "fashion-mnist"), train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    def __init__(self, root=os.path.join(_mx_home(), "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        self._num_synthetic = 2048
        super().__init__(root, transform)

    def _get_data(self):
        files = [f"data_batch_{i}.bin" for i in range(1, 6)] if self._train \
            else ["test_batch.bin"]
        paths = [os.path.join(self._root, "cifar-10-batches-bin", f) for f in files]
        if all(os.path.exists(p) for p in paths):
            datas, labels = [], []
            for p in paths:
                raw = onp.fromfile(p, dtype=onp.uint8).reshape(-1, 3073)
                labels.append(raw[:, 0])
                datas.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            data = onp.concatenate(datas)
            label = onp.concatenate(labels)
        else:
            data, label = _synthetic((32, 32, 3), 10, self._num_synthetic,
                                     seed=44 if self._train else 45)
        self._data = NDArray(data, ctx=cpu())
        self._label = label.astype(onp.int32)

    def __getitem__(self, idx):
        item = self._data[idx], self._label[idx]
        if self._transform is not None:
            return self._transform(*item)
        return item

    def __len__(self):
        return len(self._label)


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join(_mx_home(), "datasets", "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        f = "train.bin" if self._train else "test.bin"
        p = os.path.join(self._root, "cifar-100-binary", f)
        if os.path.exists(p):
            raw = onp.fromfile(p, dtype=onp.uint8).reshape(-1, 3074)
            label = raw[:, 1] if self._fine_label else raw[:, 0]
            data = raw[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        else:
            data, label = _synthetic((32, 32, 3), 100 if self._fine_label else 20,
                                     self._num_synthetic, seed=46)
        self._data = NDArray(data, ctx=cpu())
        self._label = label.astype(onp.int32)


class ImageRecordDataset(Dataset):
    """Images in an indexed RecordIO file (``IRHeader`` + encoded image),
    decoded by ``image.imdecode``."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import image, recordio
        record = self._record[idx]
        header, img = recordio.unpack(record)
        img = image.imdecode(img, self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self._record)


class ImageFolderDataset(Dataset):
    """A dataset for loading image files stored class-per-folder."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".bmp"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from .... import image
        with open(self.items[idx][0], "rb") as f:
            img = image.imdecode(f.read(), self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
