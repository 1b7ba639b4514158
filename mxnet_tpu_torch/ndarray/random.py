"""``nd.random``: the samplers of the registry (``ops/random_ops.py``) with
the JAX package's signatures (the counterpart of
``mxnet_tpu/ndarray/random.py``). Each draws on ``ctx`` (default
:func:`current_context`, or the context of its array parameters) from that
context's own generator, ``random.generator(ctx)``."""
from __future__ import annotations

from .. import random as _rng
from ..base import DTypes, current_context
from ..ops.registry import apply_op as _apply_op
from .ndarray import NDArray

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial", "randint",
           "multinomial", "shuffle", "bernoulli", "dirichlet", "seed",
           "sample_uniform", "sample_normal", "sample_gamma",
           "sample_exponential", "sample_poisson", "sample_negative_binomial",
           "sample_generalized_negative_binomial", "uniform_like",
           "normal_like", "gamma_like", "exponential_like", "poisson_like",
           "negative_binomial_like", "generalized_negative_binomial_like"]

seed = _rng.seed


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _draw(op, ctx, out, dtype, **attrs):
    """``op`` run on ``ctx``; written into ``out`` when given."""
    with ctx or current_context():
        res = _apply_op(op, dtype=DTypes.canonical(dtype), **attrs)
    if out is not None:
        out._set_data(res._data)
        return out
    return res


def uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None, out=None,
            **kwargs) -> NDArray:
    return _draw("_random_uniform", ctx, out, dtype, low=float(low),
                 high=float(high), shape=_shape(shape))


def normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None,
           **kwargs) -> NDArray:
    return _draw("_random_normal", ctx, out, dtype, loc=float(loc),
                 scale=float(scale), shape=_shape(shape))


def randn(*shape, loc=0.0, scale=1.0, dtype=None, ctx=None,
          **kwargs) -> NDArray:
    return normal(loc=loc, scale=scale, shape=shape, dtype=dtype, ctx=ctx)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype=None, ctx=None, out=None,
          **kwargs) -> NDArray:
    return _draw("_random_gamma", ctx, out, dtype, alpha=float(alpha),
                 beta=float(beta), shape=_shape(shape))


def exponential(scale=1.0, shape=None, dtype=None, ctx=None, out=None,
                **kwargs) -> NDArray:
    return _draw("_random_exponential", ctx, out, dtype,
                 lam=1.0 / float(scale), shape=_shape(shape))


def poisson(lam=1.0, shape=None, dtype=None, ctx=None, out=None,
            **kwargs) -> NDArray:
    return _draw("_random_poisson", ctx, out, dtype, lam=float(lam),
                 shape=_shape(shape))


def negative_binomial(k=1, p=1.0, shape=None, dtype=None, ctx=None,
                      out=None, **kwargs) -> NDArray:
    return _draw("_random_negative_binomial", ctx, out, dtype, k=k,
                 p=float(p), shape=_shape(shape))


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None, dtype=None,
                                  ctx=None, out=None, **kwargs) -> NDArray:
    return _draw("_random_generalized_negative_binomial", ctx, out, dtype,
                 mu=float(mu), alpha=float(alpha), shape=_shape(shape))


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None,
            **kwargs) -> NDArray:
    """Integers in [low, high); shape defaults to (1,), as the reference."""
    return _draw("_random_randint", ctx, out, dtype, low=int(low),
                 high=int(high), shape=_shape(shape) or (1,))


def bernoulli(prob=0.5, shape=None, dtype=None, ctx=None,
              **kwargs) -> NDArray:
    return _draw("_random_bernoulli", ctx, None, dtype, p=float(prob),
                 shape=_shape(shape))


def _as_nd(x, dtype="float32"):
    return x if isinstance(x, NDArray) else NDArray(x, dtype=dtype)


def dirichlet(alpha, shape=None, dtype=None, ctx=None, out=None,
              **kwargs) -> NDArray:
    with ctx or current_context():
        res = _apply_op("_random_dirichlet", _as_nd(alpha),
                        shape=_shape(shape), dtype=DTypes.canonical(dtype))
    if out is not None:
        out._set_data(res._data)
        return out
    return res


def multinomial(data, shape=(), get_prob=False, dtype="int32", **kwargs):
    return _apply_op("_sample_multinomial", data,
                     shape=_shape(shape) if shape else (), get_prob=get_prob,
                     dtype=DTypes.canonical(dtype))


def shuffle(data, **kwargs):
    return _apply_op("_shuffle", data)


# ---------------------------------------------------------------------------
# array-parameter samplers: output shape param.shape + shape
# ---------------------------------------------------------------------------
def _sample(op, params, shape, dtype):
    return _apply_op(op, *[_as_nd(p) for p in params], shape=_shape(shape),
                     dtype=DTypes.canonical(dtype))


def sample_uniform(low, high, shape=(), dtype=None):
    return _sample("_sample_uniform", (low, high), shape, dtype)


def sample_normal(mu, sigma, shape=(), dtype=None):
    return _sample("_sample_normal", (mu, sigma), shape, dtype)


def sample_gamma(alpha, beta, shape=(), dtype=None):
    return _sample("_sample_gamma", (alpha, beta), shape, dtype)


def sample_exponential(lam, shape=(), dtype=None):
    return _sample("_sample_exponential", (lam,), shape, dtype)


def sample_poisson(lam, shape=(), dtype=None):
    return _sample("_sample_poisson", (lam,), shape, dtype)


def sample_negative_binomial(k, p, shape=(), dtype=None):
    return _sample("_sample_negative_binomial", (k, p), shape, dtype)


def sample_generalized_negative_binomial(mu, alpha, shape=(), dtype=None):
    return _sample("_sample_generalized_negative_binomial", (mu, alpha),
                   shape, dtype)


# ---------------------------------------------------------------------------
# *_like samplers: the shape and context of an existing array
# ---------------------------------------------------------------------------
def _like(sampler, data, **params):
    return sampler(shape=tuple(data.shape), ctx=data.context, **params)


def uniform_like(data, low=0.0, high=1.0, **kwargs):
    return _like(uniform, data, low=low, high=high)


def normal_like(data, loc=0.0, scale=1.0, **kwargs):
    return _like(normal, data, loc=loc, scale=scale)


def gamma_like(data, alpha=1.0, beta=1.0, **kwargs):
    return _like(gamma, data, alpha=alpha, beta=beta)


def exponential_like(data, lam=1.0, **kwargs):
    return _like(exponential, data, scale=1.0 / lam)


def poisson_like(data, lam=1.0, **kwargs):
    return _like(poisson, data, lam=lam)


def negative_binomial_like(data, k=1, p=1.0, **kwargs):
    return _like(negative_binomial, data, k=k, p=p)


def generalized_negative_binomial_like(data, mu=1.0, alpha=1.0, **kwargs):
    return _like(generalized_negative_binomial, data, mu=mu, alpha=alpha)
