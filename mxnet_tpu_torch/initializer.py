"""Weight initializers of the port (the counterpart of
``mxnet_tpu/initializer.py``): the registry, ``InitDesc``, the
``Initializer`` base with its dispatch by name suffix, and ``Uniform``,
``Normal``, ``Constant``, ``Zero``, ``One``, ``Xavier``, ``MSRAPrelu``,
``Orthogonal``, ``Bilinear``, ``LSTMBias``, ``Load``, ``Mixed`` and
``FusedRNN``.

An initializer writes an NDArray in place of its data. Random ones draw
from ``random.generator(ctx)`` of the array's context, on its device, in
float32, then cast to the array's dtype; PyTorch's global generator is
never used. The bits are not the JAX package's (it draws a numpy
``RandomState`` from a JAX key); the distributions are, and the same
``mx.random.seed`` gives the same draws within the port.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from . import random as _random
from .base import MXNetError, Registry

__all__ = ["Initializer", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "FusedRNN", "Constant", "Zero", "One", "Bilinear",
           "LSTMBias", "Load", "Mixed", "register", "create", "InitDesc"]

_REG = Registry("initializer")
register = _REG.register


class InitDesc(str):
    """A parameter's name with its attributes, as handed to initializers."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _set(arr, value):
    """Write ``value`` (a tensor or numpy array) into the NDArray ``arr``,
    cast to its dtype and device."""
    t = torch.as_tensor(value)
    arr._set_data(t.to(device=arr._data.device, dtype=arr._data.dtype))


def _draw(arr, sampler):
    """``sampler(tensor, generator)`` fills a float32 tensor of ``arr``'s
    shape on its device from its context's generator; the result is cast
    into ``arr``."""
    t = torch.empty(arr.shape, dtype=torch.float32, device=arr._data.device)
    sampler(t, _random.generator(arr.context))
    _set(arr, t)


class Initializer:
    """Base initializer. Called with a name (or :class:`InitDesc`) and an
    NDArray, it sends names ending in ``weight`` to :meth:`_init_weight`,
    ``bias`` and ``beta`` and the running means to zero, ``gamma`` and the
    running variances to one, and anything else to
    :meth:`_init_default`. An ``__init__`` attribute on the descriptor (a
    :meth:`dumps` payload) overrides the initializer."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(desc)
        init = desc.attrs.get("__init__", "")
        if init:
            klass, kwargs = json.loads(init)
            _REG.get(klass)(**kwargs)._init_impl(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_one(desc, arr)
        elif name.endswith("beta"):
            self._init_zero(desc, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(desc, arr)
        else:
            self._init_default(desc, arr)

    def _init_impl(self, desc, arr):
        self._init_weight(desc, arr)

    def _init_zero(self, desc, arr):
        _set(arr, torch.zeros(arr.shape))

    def _init_one(self, desc, arr):
        _set(arr, torch.ones(arr.shape))

    def _init_bias(self, desc, arr):
        _set(arr, torch.zeros(arr.shape))

    def _init_weight(self, desc, arr):
        raise NotImplementedError

    def _init_default(self, desc, arr):
        self._init_weight(desc, arr)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._kwargs})"


@register("uniform")
class Uniform(Initializer):
    """Weights uniform in [-scale, scale]."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, arr):
        _draw(arr, lambda t, g: t.uniform_(-self.scale, self.scale,
                                           generator=g))


@register("normal")
class Normal(Initializer):
    """Weights from N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, arr):
        _draw(arr, lambda t, g: t.normal_(0.0, self.sigma, generator=g))


@register("constant")
class Constant(Initializer):
    """Every element (weights and the default case) set to ``value``."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, arr):
        _set(arr, torch.as_tensor(np.full(arr.shape, self.value)))

    _init_default = _init_weight


@register("zeros")
class Zero(Constant):
    def __init__(self):
        Initializer.__init__(self)
        self.value = 0.0


@register("ones")
class One(Constant):
    def __init__(self):
        Initializer.__init__(self)
        self.value = 1.0


def _fans(shape):
    hw = 1
    for s in shape[2:]:
        hw *= s
    fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw
    fan_out = shape[0] * hw
    return fan_in, fan_out


@register("xavier")
class Xavier(Initializer):
    """Xavier/Glorot: scale sqrt(magnitude / factor) with factor the mean
    of fan-in and fan-out (``avg``), fan-in (``in``) or fan-out (``out``);
    uniform in [-scale, scale] or N(0, scale^2) (``rnd_type``)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr):
        fan_in, fan_out = _fans(arr.shape)
        factors = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                   "out": fan_out}
        if self.factor_type not in factors:
            raise MXNetError("invalid factor_type")
        scale = math.sqrt(self.magnitude / max(factors[self.factor_type], 1.0))
        if self.rnd_type == "uniform":
            _draw(arr, lambda t, g: t.uniform_(-scale, scale, generator=g))
        elif self.rnd_type == "gaussian":
            _draw(arr, lambda t, g: t.normal_(0.0, scale, generator=g))
        else:
            raise MXNetError("invalid rnd_type")


@register("msraprelu")
class MSRAPrelu(Xavier):
    """He initialization for PReLU units: Gaussian Xavier with magnitude
    2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register("orthogonal")
class Orthogonal(Initializer):
    """``scale`` times an orthonormal (nout, prod(rest)) matrix: the SVD
    factor of a uniform (``rand_type="uniform"``) or normal draw that has
    the weight's shape, computed in float64."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, desc, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        tmp = torch.empty((nout, nin), dtype=torch.float32,
                          device=arr._data.device)
        g = _random.generator(arr.context)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=g)
        else:
            tmp.normal_(0.0, 1.0, generator=g)
        u, _, v = torch.linalg.svd(tmp.double(), full_matrices=False)
        q = u if u.shape == tmp.shape else v
        _set(arr, self.scale * q.reshape(arr.shape))


@register("bilinear")
class Bilinear(Initializer):
    """Bilinear upsampling kernels for a (C, 1, kh, kw) deconvolution."""

    def _init_weight(self, desc, arr):
        shape = arr.shape
        weight = np.zeros(int(np.prod(shape)))
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(weight.size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        _set(arr, torch.from_numpy(weight.reshape(shape)))


@register("lstmbias")
class LSTMBias(Initializer):
    """An LSTM's (4 H,) bias: the forget gate's quarter ``forget_bias``,
    the rest 0."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        b = np.zeros(arr.shape)
        n = arr.shape[0] // 4
        b[n:2 * n] = self.forget_bias
        _set(arr, torch.from_numpy(b))

    _init_bias = _init_weight


class Load:
    """Initialize from a dict of loaded arrays (``arg:``/``aux:`` prefixes
    dropped), falling back to ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k.replace("arg:", "").replace("aux:", ""): v
                      for k, v in param.items()}
        self.default_init = default_init

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            _set(arr, src._data if hasattr(src, "_data") else
                 torch.as_tensor(np.asarray(src)))
        elif self.default_init is not None:
            self.default_init(name, arr)
        else:
            raise MXNetError(f"Cannot init {name}: not found and no "
                             "default_init")


class Mixed:
    """The first initializer whose pattern matches the name (``re.match``)
    initializes it."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise MXNetError(f"parameter {name} did not match any pattern")


def create(init, **kwargs):
    """An initializer from an instance (returned as is), a registry name
    (``"xavier"``, with ``kwargs``) or a :meth:`Initializer.dumps`
    payload."""
    if isinstance(init, (Initializer, Load, Mixed)):
        return init
    try:
        name, saved = json.loads(init)
    except (ValueError, TypeError):
        return _REG.get(init)(**kwargs)
    return _REG.get(name)(**saved)


_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


@register("fusedrnn")  # class-name key: what Initializer.dumps() emits
@register("fused_rnn")
class FusedRNN(Initializer):
    """A fused RNN's flat parameter vector, sub-matrix by sub-matrix: the
    inner initializer sees each W_i2h / W_h2h with its 2-D shape, biases
    are 0 (an LSTM's forget-gate biases ``forget_bias / 2`` each). Layout:
    per layer and direction W_i2h (G H, in), W_h2h (G H, H), then all the
    biases (``rnn-inl.h``'s flat order)."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            init = create(init)
        super().__init__(init=init.dumps() if hasattr(init, "dumps")
                         else type(init).__name__.lower(),
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._h = num_hidden
        self._layers = num_layers
        self._mode = mode
        self._bi = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from .ndarray import zeros
        g, h = _GATES[self._mode], self._h
        d = 2 if self._bi else 1
        rest = d * (self._layers - 1) * (g * h * h * d + g * h * h) \
            if self._layers > 1 else 0
        bias_sz = self._layers * d * 2 * g * h
        in_sz = (arr.size - rest - bias_sz) // (d * g * h) - h
        parts = []
        for layer in range(self._layers):
            cur_in = in_sz if layer == 0 else h * d
            for _ in range(d):
                for shape in ((g * h, cur_in), (g * h, h)):
                    sub = zeros(shape, ctx=arr.context)
                    self._init(InitDesc(str(desc) + "_weight"), sub)
                    parts.append(sub._data.float().reshape(-1))
        for _ in range(self._layers * d * 2):
            b = torch.zeros(g * h, device=arr._data.device)
            if self._mode == "lstm":
                b[h:2 * h] = self._forget_bias / 2.0
            parts.append(b)
        _set(arr, torch.cat(parts).reshape(arr.shape))
