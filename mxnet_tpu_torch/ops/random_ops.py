"""Random samplers of the port (the counterpart of
``mxnet_tpu/ops/random_ops.py``).

Each sampler is registered with ``random=True``: ``invoke`` hands it the
context's own ``torch.Generator`` (``random.generator(ctx)``) and device,
where the JAX package threads a threefry key; PyTorch's global generator is
never used. Floating draws are made in float32 and cast to ``dtype``
(float32 by default, integer samplers int32). The ``_sample_*`` forms draw
``shape`` values for every element of their parameter arrays (output shape
``param.shape + shape``). The bits cannot be JAX's: the same seed gives the
same numbers within the port, not across packages.
"""
from __future__ import annotations

import torch

from ..base import DTypes
from .registry import register


def _dt(dtype):
    return DTypes.torch(dtype or "float32")


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _gamma(alpha, generator):
    """Gamma(alpha, 1) draws, one per element of the f32 tensor ``alpha``."""
    return torch._standard_gamma(alpha, generator=generator)


def _poisson(lam, generator):
    return torch.poisson(lam, generator=generator)


def _full(shape, value, device):
    return torch.full(_shape(shape), float(value), dtype=torch.float32,
                      device=device)


@register("_random_uniform", differentiable=False, random=True)
def random_uniform(*, low=0.0, high=1.0, shape=(), dtype=None,
                   generator=None, device=None):
    t = torch.rand(_shape(shape), generator=generator, device=device)
    return (t * (float(high) - float(low)) + float(low)).to(_dt(dtype))


@register("_random_normal", differentiable=False, random=True)
def random_normal(*, loc=0.0, scale=1.0, shape=(), dtype=None,
                  generator=None, device=None):
    t = torch.randn(_shape(shape), generator=generator, device=device)
    return (t * float(scale) + float(loc)).to(_dt(dtype))


@register("_random_gamma", differentiable=False, random=True)
def random_gamma(*, alpha=1.0, beta=1.0, shape=(), dtype=None,
                 generator=None, device=None):
    g = _gamma(_full(shape, alpha, device), generator)
    return (g * float(beta)).to(_dt(dtype))


def _exponential(shape, generator, device):
    return torch.empty(shape, device=device).exponential_(
        1.0, generator=generator)


@register("_random_exponential", differentiable=False, random=True)
def random_exponential(*, lam=1.0, shape=(), dtype=None, generator=None,
                       device=None):
    return (_exponential(_shape(shape), generator, device) /
            float(lam)).to(_dt(dtype))


@register("_random_poisson", differentiable=False, random=True)
def random_poisson(*, lam=1.0, shape=(), dtype=None, generator=None,
                   device=None):
    return _poisson(_full(shape, lam, device), generator).to(_dt(dtype))


def _neg_binomial(k, p, generator):
    """Gamma(k)-Poisson mixture with mean k (1 - p) / p."""
    return _poisson(_gamma(k, generator) * (1 - p) / p, generator)


@register("_random_negative_binomial", differentiable=False, random=True)
def random_negative_binomial(*, k=1, p=1.0, shape=(), dtype=None,
                             generator=None, device=None):
    return _neg_binomial(_full(shape, k, device), float(p),
                         generator).to(_dt(dtype))


def _gen_neg_binomial(mu, alpha, generator):
    """Gamma-Poisson mixture with mean mu and dispersion alpha."""
    r = 1.0 / torch.clamp(alpha, min=1e-12)
    return _poisson(_gamma(r, generator) * (mu * alpha), generator)


@register("_random_generalized_negative_binomial", differentiable=False,
          random=True)
def random_generalized_negative_binomial(*, mu=1.0, alpha=1.0, shape=(),
                                         dtype=None, generator=None,
                                         device=None):
    return _gen_neg_binomial(_full(shape, mu, device),
                             _full(shape, alpha, device),
                             generator).to(_dt(dtype))


@register("_random_randint", differentiable=False, random=True)
def random_randint(*, low=0, high=1, shape=(), dtype="int32",
                   generator=None, device=None):
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=generator, device=device,
                         dtype=DTypes.torch(dtype))


@register("_random_bernoulli", differentiable=False, random=True)
def random_bernoulli(*, p=0.5, shape=(), dtype=None, generator=None,
                     device=None):
    u = torch.rand(_shape(shape), generator=generator, device=device)
    return (u < float(p)).to(_dt(dtype))


@register("_random_dirichlet", differentiable=False, random=True)
def random_dirichlet(alpha, *, shape=(), dtype=None, generator=None,
                     device=None):
    """Dirichlet draws of shape ``shape + alpha.shape``."""
    a = alpha.float().expand(_shape(shape) + tuple(alpha.shape))
    g = _gamma(a.contiguous(), generator)
    return (g / g.sum(-1, keepdim=True)).to(_dt(dtype))


@register("_sample_multinomial", differentiable=False, random=True)
def sample_multinomial(data, *, shape=(), get_prob=False, dtype="int32",
                       generator=None, device=None):
    """Class indices drawn from the rows of ``data`` (probabilities, not
    necessarily normalised); ``get_prob`` also returns each draw's log
    probability."""
    n = shape if isinstance(shape, int) else (shape[0] if shape else 1)
    rows = data.reshape(-1, data.shape[-1]).float()
    out = torch.multinomial(rows, n, replacement=True, generator=generator)
    if data.dim() == 1:
        out = out[0]
    if isinstance(shape, tuple) and not shape:
        out = out[..., 0]
    out = out.to(DTypes.torch(dtype))
    if not get_prob:
        return out
    logp = torch.log_softmax(torch.log(torch.clamp(rows, min=1e-37)), -1)
    lp = torch.gather(logp, 1, out.reshape(rows.shape[0], -1).long())
    return out, lp.reshape(out.shape)


@register("_shuffle", differentiable=False, random=True)
def shuffle(data, *, generator=None, device=None):
    """``data`` with its first axis permuted."""
    perm = torch.randperm(data.shape[0], generator=generator,
                          device=data.device)
    return data[perm]


@register("_sample_unique_zipfian", differentiable=False, random=True)
def sample_unique_zipfian(*, range_max=1, shape=(), generator=None,
                          device=None):
    """Log-uniform (Zipfian) classes in [0, range_max), int32."""
    u = torch.rand(_shape(shape), generator=generator, device=device)
    out = (torch.exp(u * torch.log(torch.tensor(range_max + 1.0))) -
           1.0).to(torch.int32)
    return torch.clamp(out, max=range_max - 1)


# ---------------------------------------------------------------------------
# array-parameter samplers (multisample_op.cc): ``shape`` draws for every
# element of the parameter arrays
# ---------------------------------------------------------------------------
def _per_param(p, shape):
    """``p`` (float32) broadcast to ``p.shape + shape``."""
    s = _shape(shape)
    p = p.float()
    return p.reshape(tuple(p.shape) + (1,) * len(s)).expand(
        tuple(p.shape) + s).contiguous()


@register("_sample_uniform", differentiable=False, random=True)
def sample_uniform(low, high, *, shape=(), dtype=None, generator=None,
                   device=None):
    lo, hi = _per_param(low, shape), _per_param(high, shape)
    u = torch.rand(lo.shape, generator=generator, device=lo.device)
    return (lo + (hi - lo) * u).to(_dt(dtype))


@register("_sample_normal", differentiable=False, random=True)
def sample_normal(mu, sigma, *, shape=(), dtype=None, generator=None,
                  device=None):
    m, s = _per_param(mu, shape), _per_param(sigma, shape)
    z = torch.randn(m.shape, generator=generator, device=m.device)
    return (m + s * z).to(_dt(dtype))


@register("_sample_gamma", differentiable=False, random=True)
def sample_gamma(alpha, beta, *, shape=(), dtype=None, generator=None,
                 device=None):
    return (_gamma(_per_param(alpha, shape), generator) *
            _per_param(beta, shape)).to(_dt(dtype))


@register("_sample_exponential", differentiable=False, random=True)
def sample_exponential(lam, *, shape=(), dtype=None, generator=None,
                       device=None):
    lam = _per_param(lam, shape)
    return (_exponential(lam.shape, generator, lam.device) /
            lam).to(_dt(dtype))


@register("_sample_poisson", differentiable=False, random=True)
def sample_poisson(lam, *, shape=(), dtype=None, generator=None,
                   device=None):
    return _poisson(_per_param(lam, shape), generator).to(_dt(dtype))


@register("_sample_negative_binomial", differentiable=False, random=True)
def sample_negative_binomial(k, p, *, shape=(), dtype=None, generator=None,
                             device=None):
    return _neg_binomial(_per_param(k, shape), _per_param(p, shape),
                         generator).to(_dt(dtype))


@register("_sample_generalized_negative_binomial", differentiable=False,
          random=True)
def sample_generalized_negative_binomial(mu, alpha, *, shape=(), dtype=None,
                                         generator=None, device=None):
    return _gen_neg_binomial(_per_param(mu, shape), _per_param(alpha, shape),
                             generator).to(_dt(dtype))
