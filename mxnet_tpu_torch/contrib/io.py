"""``contrib.io`` (the counterpart of ``mxnet_tpu/contrib/io.py``):
``DataLoaderIter``, a Gluon DataLoader behind the legacy DataIter
interface."""
from ..base import MXNetError
from ..io import DataBatch, DataDesc, DataIter

__all__ = ["DataLoaderIter"]


class DataLoaderIter(DataIter):
    """Iterate a Gluon DataLoader as a DataIter.

    The loader must be re-iterable (``iter(loader)`` starts again from the
    top, as a DataLoader does): construction takes one probe batch for the
    shapes and dtypes, then starts again. A one-shot generator would lose
    its first batch, so it is refused.
    """

    def __init__(self, loader, data_name="data", label_name="softmax_label"):
        first = next(iter(loader), None)
        if first is None:
            raise MXNetError("DataLoaderIter: the loader is empty (no batch "
                             "to infer shapes from)")
        if iter(loader) is iter(loader):
            raise MXNetError(
                "DataLoaderIter needs a re-iterable loader (a gluon "
                "DataLoader); a one-shot generator would lose the probe "
                "batch taken for shape inference")
        data, label = first[0], first[1] if len(first) > 1 else None
        # a DataLoader has no batch_size attribute: a real batch's leading
        # dim is the truth
        super().__init__(batch_size=int(data.shape[0]))
        self._loader = loader
        self._iter = iter(loader)
        self._data_name = data_name
        self._label_name = label_name
        self.provide_data = [DataDesc(data_name, tuple(data.shape),
                                      data.dtype)]
        self.provide_label = [DataDesc(label_name, tuple(label.shape),
                                       label.dtype)] if label is not None \
            else []

    def reset(self):
        self._iter = iter(self._loader)

    def next(self):
        batch = next(self._iter)  # StopIteration at the end
        data, label = batch[0], batch[1] if len(batch) > 1 else None
        return DataBatch(data=[data],
                         label=[label] if label is not None else None)
