"""Basic layers of the port as Gluon blocks over ``torch.nn.Module``: the
counterparts of ``Sequential``, ``HybridSequential``, ``Dense``,
``Dropout``, ``BatchNorm``, ``LayerNorm``, ``Embedding``, ``Flatten``,
``Activation``, ``Lambda``, ``HybridLambda`` and the rest in
``mxnet_tpu/gluon/nn/basic_layers.py``, with its constructor arguments,
parameter names and layouts (Dense weight (out, in); BatchNorm gamma, beta,
running_mean, running_var) and deferred shapes (``in_units=0``,
``in_channels=0``: known at the first forward).

The layers compute on tensors (``_io = "tensor"``) with the registered ops
of ``ops/nn.py``, each called by its registered name through AMP's
cast-policy point (``amp.call``), as the reference's layers call
``F.<op>``; called with NDArrays they follow Gluon's autograd rules
(``block.py``). BatchNorm's running statistics are float32 buffers,
written in place in training mode. ``RMSNorm``, ``GroupNorm``,
``InstanceNorm``, ``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU`` and
``Swish`` are the reference's too. ``SyncBatchNorm`` takes its moments
over the current mesh's ``dp`` axis.
"""
from __future__ import annotations

import math

import torch

from ... import amp as _amp
from ... import random as _random
from ...base import MXNetError
from ...ndarray.ndarray import _context_of
from ..block import Block, HybridBlock, gluon_context

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "SyncBatchNorm", "LayerNorm", "RMSNorm", "GroupNorm",
           "InstanceNorm", "Embedding", "Flatten", "Lambda", "HybridLambda", "Activation", "LeakyReLU",
           "PReLU", "ELU", "SELU", "GELU", "Swish"]


def _init_by_name(init):
    from ... import initializer
    return initializer.create(init) if isinstance(init, str) else init


class _Sequence:
    """What the two sequential containers share: ``add``, the forward
    through every child in order, indexing and iteration."""

    _io = None

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        layers = list(self._modules.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_Sequence, Block):
    """Blocks run in order; children named "0", "1", ..."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)


class HybridSequential(_Sequence, HybridBlock):
    """Hybrid blocks run in order; children named "0", "1", ..."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)


class Dense(HybridBlock):
    """Fully-connected layer: y = act(x W^T + b), weight (units,
    in_units); ``in_units=0`` is inferred from the first input
    (``flatten``: everything after the batch axis, else the last axis)."""

    _io = "tensor"

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._act_type = activation
        with self.name_scope():
            self.weight = self.params.get("weight", shape=(units, in_units),
                                          init=weight_initializer,
                                          dtype=dtype,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,),
                    init=_init_by_name(bias_initializer), dtype=dtype,
                    allow_deferred_init=True)
            else:
                self.bias = None

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def forward(self, x):
        out = _amp.call("FullyConnected", x, self._t("weight"),
                        self._t("bias"), flatten=self._flatten)
        return _amp.call("Activation", out, act_type=self._act_type) \
            if self._act_type else out


def mask_generator(gen, x):
    """The generator a mask over ``x`` is drawn from: ``gen`` when the
    caller set one, else, in a Gluon (NDArray) call, ``random.generator``
    of x's context; never PyTorch's global one."""
    if gen is not None:
        return gen
    if gluon_context() is None:
        raise MXNetError("a random mask in training mode needs a "
                         "torch.Generator (set .generator); it never draws "
                         "from the global RNG")
    return _random.generator(_context_of(x))


class Dropout(HybridBlock):
    """Dropout with rate ``rate``: in training mode each element (each
    slice along ``axes``, which share a mask) is kept with probability
    1 - rate and divided by 1 - rate (``ops.nn.dropout``); the identity in
    eval mode (serving) and at rate 0.

    The mask is drawn from ``self.generator`` when a caller set one
    (``ParallelTrainStep`` gives every Dropout of its block the one it
    owns), else, in a Gluon (NDArray) call, from ``random.generator`` of
    the input's context; never from PyTorch's global RNG. Training mode on
    tensors without a generator raises."""

    _io = "tensor"

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = float(rate)
        self._axes = tuple(axes)
        #: the ``torch.Generator`` masks are drawn from (set by the caller)
        self.generator = None

    def forward(self, x):
        if not self.training or self._rate <= 0:
            return x
        return _amp.call("Dropout", x, p=self._rate, axes=self._axes,
                         training=True,
                         generator=mask_generator(self.generator, x))


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis`` (channels of NCHW by default).

    ``gamma`` and ``beta`` are parameters (``scale=False`` means fix_gamma:
    gamma is taken as 1 and not trained; ``center=False`` leaves beta
    untrained). ``running_mean`` and ``running_var`` are float32 buffers
    (``grad_req="null"`` parameters): in training mode every forward writes
    the updated moving stats back into them, in place and without gradient
    (the reference's aux states). ``cast`` and a module cast to a half type
    leave all four in float32, as ``BatchNorm.cast`` in the reference."""

    _io = "tensor"

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=_init_by_name(gamma_initializer),
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=_init_by_name(beta_initializer),
                allow_deferred_init=True, differentiable=center)
            for name, init in (("running_mean", running_mean_initializer),
                               ("running_var", running_variance_initializer)):
                p = self.params.get(name, grad_req="null",
                                    shape=(in_channels,),
                                    init=_init_by_name(init),
                                    allow_deferred_init=True,
                                    differentiable=False)
                p._buffer = True
                setattr(self, name, p)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)

    def cast(self, dtype):
        if str(dtype) in ("float16", "bfloat16"):
            dtype = "float32"
        super().cast(dtype)

    def _apply(self, fn, recurse=True):
        def keep_f32(t):
            out = fn(t)
            return out.float() if out.dtype in (torch.bfloat16,
                                                torch.float16) else out
        return super()._apply(keep_f32, recurse)

    def _op(self):
        """The registered op this layer calls, and its attributes."""
        return "BatchNorm", self._kwargs

    def forward(self, x):
        running_mean, running_var = self._t("running_mean"), \
            self._t("running_var")
        op, attrs = self._op()
        out, new_mean, new_var = _amp.call(
            op, x, self._t("gamma"), self._t("beta"), running_mean,
            running_var, training=self.training, **attrs)
        if self.training and not self._kwargs["use_global_stats"]:
            with torch.no_grad():
                running_mean.copy_(new_mean)
                running_var.copy_(new_var)
        return out


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm (``basic_layers.py`` ``SyncBatchNorm``,
    ``contrib/sync_batch_norm.cc``): BatchNorm over axis 1 whose training
    moments, while a mesh with a ``dp`` axis larger than 1 is current
    (``with mesh:``, or inside ``ParallelTrainStep``), are averaged over
    that axis's ranks (the ``SyncBatchNorm`` op's form); one rank's batch
    otherwise. ``num_devices`` is kept for the reference's signature."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(1, momentum, epsilon, center, scale,
                         use_global_stats, beta_initializer,
                         gamma_initializer, running_mean_initializer,
                         running_variance_initializer, in_channels, **kwargs)

    def _op(self):
        from ...parallel.mesh import current_mesh
        mesh = current_mesh()
        if mesh is None or mesh.axis_size("dp") == 1:
            return super()._op()
        attrs = {k: v for k, v in self._kwargs.items() if k != "axis"}
        return "SyncBatchNorm", dict(attrs, axis_name="dp")


class LayerNorm(HybridBlock):
    """LayerNorm over ``axis`` with ``gamma`` (ones) and ``beta`` (zeros),
    statistics in f32."""

    _io = "tensor"

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=_init_by_name(gamma_initializer),
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=_init_by_name(beta_initializer),
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def forward(self, x):
        return _amp.call("LayerNorm", x, self._t("gamma"), self._t("beta"),
                         axis=self._axis, eps=self._epsilon)


class _AffineNorm(HybridBlock):
    """A normalization with a per-channel ``gamma`` (and ``beta``) whose
    size is the input's ``axis`` dimension (deferred until the first
    forward)."""

    _io = "tensor"

    def __init__(self, axis, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels, use_beta=True, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=_init_by_name(gamma_initializer),
                allow_deferred_init=True)
            if use_beta:
                self.beta = self.params.get(
                    "beta", grad_req="write" if center else "null",
                    shape=(in_channels,),
                    init=_init_by_name(beta_initializer),
                    allow_deferred_init=True)

    def infer_shape(self, x, *args):
        for p in self._reg_params.values():
            p.shape = (x.shape[self._axis],)


class RMSNorm(_AffineNorm):
    """x / sqrt(mean(x^2) + eps) * gamma over ``axis``, f32 statistics."""

    def __init__(self, axis=-1, epsilon=1e-6, in_channels=0, **kwargs):
        super().__init__(axis, epsilon, True, True, "zeros", "ones",
                         in_channels, use_beta=False, **kwargs)

    def forward(self, x):
        return _amp.call("RMSNorm", x, self._t("gamma"), axis=self._axis,
                         eps=self._epsilon)


class GroupNorm(_AffineNorm):
    """Normalization over each group of ``num_groups`` channel groups
    (and the spatial axes), then gamma and beta per channel."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(1, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, **kwargs)
        self._num_groups = num_groups

    def forward(self, x):
        return _amp.call("GroupNorm", x, self._t("gamma"), self._t("beta"),
                         num_groups=self._num_groups, eps=self._epsilon)


class InstanceNorm(_AffineNorm):
    """Normalization of each sample's channel over the spatial axes;
    gamma is not trained by default (``scale=False``), as the reference."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(1, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, **kwargs)

    def forward(self, x):
        return _amp.call("InstanceNorm", x, self._t("gamma"),
                         self._t("beta"), eps=self._epsilon)


class Embedding(HybridBlock):
    """Lookup table with weight (input_dim, output_dim). With
    ``sparse_grad=True`` the weight's gradient is row-sparse
    (``grad_stype="row_sparse"``: ``weight.grad()`` is a
    ``RowSparseNDArray`` holding the looked-up rows only)."""

    _io = "tensor"

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = sparse_grad
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                grad_stype="row_sparse" if sparse_grad else "default")

    def forward(self, x):
        return _amp.call("Embedding", x, self._t("weight"),
                         input_dim=self._input_dim,
                         output_dim=self._output_dim,
                         sparse_grad=self._sparse_grad)


class Flatten(HybridBlock):
    """(N, ...) -> (N, prod(...))."""

    _io = "tensor"

    def forward(self, x):
        return _amp.call("flatten", x)


class Activation(HybridBlock):
    """Elementwise activation by name (``ops.nn.activation``)."""

    _io = "tensor"

    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act_type = activation

    def _alias(self):
        # called before _act_type is set, as in the reference
        return self._act_type if hasattr(self, "_act_type") else "activation"

    def forward(self, x):
        return _amp.call("Activation", x, act_type=self._act_type)


class LeakyReLU(HybridBlock):
    """x for x >= 0, alpha * x below."""

    _io = "tensor"

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return _amp.call("leaky_relu", x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope ``alpha`` per channel (0.25
    initially)."""

    _io = "tensor"

    def __init__(self, alpha_initializer=None, in_channels=1, **kwargs):
        super().__init__(**kwargs)
        from ... import initializer
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(in_channels,),
                init=alpha_initializer or initializer.Constant(0.25))

    def forward(self, x):
        return _amp.call("prelu", x, self._t("alpha"))


class ELU(HybridBlock):
    """x for x >= 0, alpha * (exp(x) - 1) below."""

    _io = "tensor"

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return _amp.call("leaky_relu", x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled ELU with the self-normalizing constants."""

    _io = "tensor"

    def forward(self, x):
        return _amp.call("leaky_relu", x, act_type="selu")


class GELU(HybridBlock):
    """GELU, erf-exact or (``approximation="tanh"``) the tanh form."""

    _io = "tensor"

    def __init__(self, approximation="erf", **kwargs):
        super().__init__(**kwargs)
        self._approx = approximation

    def forward(self, x):
        return _amp.call("gelu_tanh" if self._approx == "tanh" else "gelu", x)


class Swish(HybridBlock):
    """x * sigmoid(beta * x)."""

    _io = "tensor"

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def forward(self, x):
        return x * _amp.call("sigmoid", self._beta * x)


class Lambda(Block):
    """A function of NDArrays as a block: a callable, or the name of one
    in ``nd``."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd_mod
            function = getattr(nd_mod, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """``function(F, *args)`` as a hybrid block, or the name of a function
    in ``nd``."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd_mod
            fn = getattr(nd_mod, function)
            self._func = lambda F, *args: fn(*args)
        else:
            self._func = function

    def hybrid_forward(self, F, *args):
        return self._func(F, *args)
