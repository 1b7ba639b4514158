"""``gluon.data`` of the port (the counterpart of ``mxnet_tpu/gluon/data``):
datasets, samplers, the DataLoader and the vision datasets and
transforms. Every stage makes ``cpu()`` NDArrays; the training loop moves
a batch to the card."""
from .dataset import Dataset, SimpleDataset, ArrayDataset, RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
from .dataloader import DataLoader, default_batchify_fn
from . import vision
