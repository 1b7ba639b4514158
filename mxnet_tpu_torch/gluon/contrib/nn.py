"""gluon.contrib.nn of the port (the counterpart of
``mxnet_tpu/gluon/contrib/nn.py``): ``Concurrent``/``HybridConcurrent``/
``Identity``, the ``PixelShuffle`` family, ``SparseEmbedding`` (over the
``_contrib_SparseEmbedding`` op) and ``BatchNormReLU``. The containers
take NDArrays or tensors, as ``Sequential`` does; the layers compute on
tensors."""
from __future__ import annotations

from ... import amp as _amp
from ...ndarray.ndarray import NDArray
from ..block import HybridBlock
from ..nn.basic_layers import BatchNorm, Embedding, HybridSequential, \
    Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "PixelShuffle1D", "PixelShuffle2D", "PixelShuffle3D",
           "BatchNormReLU"]


def concat_outputs(outs, axis):
    """The children's outputs joined on ``axis``: NDArrays by ``nd.concat``
    (recorded by autograd), tensors by the ``concat`` op."""
    if isinstance(outs[0], NDArray):
        from ... import ndarray as nd
        return nd.concat(*outs, dim=axis)
    return _amp.call("concat", *outs, dim=axis)


class Concurrent(Sequential):
    """Feeds the input to every child and concatenates their outputs on
    ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return concat_outputs([block(x) for block in self._modules.values()],
                              self.axis)


class HybridConcurrent(HybridSequential):
    """The hybrid ``Concurrent``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x, *args):
        return concat_outputs([block(x) for block in self._modules.values()],
                              self.axis)


class Identity(HybridBlock):
    """The input, unchanged (the residual branch of a ``Concurrent``)."""

    _io = None

    def forward(self, x):
        return x


class SparseEmbedding(Embedding):
    """Embedding whose weight gradient is row-sparse: the
    ``_contrib_SparseEmbedding`` op."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(input_dim, output_dim, dtype=dtype,
                         weight_initializer=weight_initializer,
                         sparse_grad=True, **kwargs)

    def forward(self, x):
        return _amp.call("_contrib_SparseEmbedding", x, self._t("weight"),
                         input_dim=self._input_dim,
                         output_dim=self._output_dim)


class BatchNormReLU(BatchNorm):
    """BatchNorm, then ReLU."""

    def forward(self, x):
        return _amp.call("relu", super().forward(x))


class _PixelShuffle(HybridBlock):
    _io = "tensor"

    def __init__(self, factor, ndim):
        super().__init__()
        try:
            self._factors = (int(factor),) * ndim
        except TypeError:
            self._factors = tuple(int(f) for f in factor)
            if len(self._factors) != ndim:
                raise ValueError(f"expected {ndim} factors, got "
                                 f"{len(self._factors)}") from None

    def __repr__(self):
        f = self._factors
        return f"{type(self).__name__}({f[0] if len(set(f)) == 1 else f})"


class PixelShuffle1D(_PixelShuffle):
    """(N, f*C, W) -> (N, C, f*W)."""

    def __init__(self, factor):
        super().__init__(factor, 1)

    def forward(self, x):
        (f,) = self._factors
        n, fc, w = x.shape
        c = fc // f
        return x.reshape(n, c, f, w).permute(0, 1, 3, 2).reshape(n, c, w * f)


class PixelShuffle2D(_PixelShuffle):
    """(N, f1*f2*C, H, W) -> (N, C, f1*H, f2*W)."""

    def __init__(self, factor):
        super().__init__(factor, 2)

    def forward(self, x):
        f1, f2 = self._factors
        n, fc, h, w = x.shape
        c = fc // (f1 * f2)
        x = x.reshape(n, c, f1, f2, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c, h * f1, w * f2)


class PixelShuffle3D(_PixelShuffle):
    """(N, f1*f2*f3*C, D, H, W) -> (N, C, f1*D, f2*H, f3*W)."""

    def __init__(self, factor):
        super().__init__(factor, 3)

    def forward(self, x):
        f1, f2, f3 = self._factors
        n, fc, d, h, w = x.shape
        c = fc // (f1 * f2 * f3)
        x = x.reshape(n, c, f1, f2, f3, d, h, w).permute(
            0, 1, 5, 2, 6, 3, 7, 4)
        return x.reshape(n, c, d * f1, h * f2, w * f3)

