"""The optimizer update ops of the port (the counterpart of
``mxnet_tpu/ops/optimizer_ops.py``): every update rule as a registered op,
so ``nd.<name>`` applies an update without an ``Optimizer`` object.

Functional, as the reference's: each op returns the updated weight and
state tensors and changes none of its inputs. Plain PyTorch, in the
reference's order of operations (its ops are ``jnp``, op by op): the
gradient is rescaled, clipped, then (where the rule says so) weight decay
is added (``_prep``), and Python scalars enter each product as the
tensor's dtype. The ``multi_*`` forms take their tensors interleaved
(w0, g0, [state0,] w1, g1, ...) and update every group in one call, the
``preloaded_multi_*`` forms with the learning rates and weight decays as
two trailing tensors; each group's arithmetic is its single op's.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


def _prep(grad, rescale_grad, clip_gradient, wd=0.0, weight=None):
    """rescale, then clip, then add wd * weight (where given): the
    reference's order (``optimizer_op-inl.h`` get_grad_rescaled)."""
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    if wd and weight is not None:
        g = g + wd * weight
    return g


# ---------------------------------------------------------------------------
# SGD family (optimizer_op.cc sgd_update / sgd_mom_update / mp_* / nag)
# ---------------------------------------------------------------------------
@register("sgd_update", differentiable=False)
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    return weight - lr * g


@register("sgd_mom_update", differentiable=False)
def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    mom = momentum * mom - lr * g
    return weight + mom, mom


@register("mp_sgd_update", differentiable=False)
def mp_sgd_update(weight, grad, weight32, *, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """Multi-precision: grad/weight may be fp16/bf16, master weight32 fp32."""
    g = _prep(grad.float(), rescale_grad, clip_gradient, wd,
              weight32)
    w32 = weight32 - lr * g
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update", differentiable=False)
def mp_sgd_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    g = _prep(grad.float(), rescale_grad, clip_gradient, wd,
              weight32)
    mom = momentum * mom - lr * g
    w32 = weight32 + mom
    return w32.to(weight.dtype), mom, w32


@register("nag_mom_update", differentiable=False)
def nag_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    mom = momentum * mom + g
    return weight - lr * (g + momentum * mom), mom


@register("mp_nag_mom_update", differentiable=False)
def mp_nag_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad.float(), rescale_grad, clip_gradient, wd,
              weight32)
    mom = momentum * mom + g
    w32 = weight32 - lr * (g + momentum * mom)
    return w32.to(weight.dtype), mom, w32


@register("signsgd_update", differentiable=False)
def signsgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    return weight * (1 - lr * wd) - lr * torch.sign(g)


@register("signum_update", differentiable=False)
def signum_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    mom = momentum * mom - (1 - momentum) * g
    w = weight * (1 - lr * wd_lh) + lr * torch.sign(mom) - lr * wd * weight
    return w, mom


# ---------------------------------------------------------------------------
# Adam family (optimizer_op.cc adam_update; contrib/adamw.cc)
# ---------------------------------------------------------------------------
@register("adam_update", differentiable=False)
def adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    """No bias correction in the op — the reference python Optimizer folds the
    correction into lr before calling (optimizer_op.cc adam_update)."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    mean = beta1 * mean + (1 - beta1) * g
    var = beta2 * var + (1 - beta2) * torch.square(g)
    w = weight - lr * mean / (torch.sqrt(var) + epsilon)
    return w, mean, var


@register("adamw_update", differentiable=False)
def adamw_update(weight, grad, mean, var, *, lr, eta=1.0, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """Decoupled weight decay (contrib/adamw.cc): wd applies to the weight
    directly, never through the moments."""
    g = _prep(grad, rescale_grad, clip_gradient)
    mean = beta1 * mean + (1 - beta1) * g
    var = beta2 * var + (1 - beta2) * torch.square(g)
    w = weight - eta * (lr * mean / (torch.sqrt(var) + epsilon) + wd * weight)
    return w, mean, var


@register("mp_adamw_update", differentiable=False)
def mp_adamw_update(weight, grad, mean, var, weight32, *, lr, eta=1.0,
                    beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad.float(), rescale_grad, clip_gradient)
    mean = beta1 * mean + (1 - beta1) * g
    var = beta2 * var + (1 - beta2) * torch.square(g)
    w32 = weight32 - eta * (lr * mean / (torch.sqrt(var) + epsilon)
                            + wd * weight32)
    return w32.to(weight.dtype), mean, var, w32


# ---------------------------------------------------------------------------
# RMSProp / Ftrl / FTML (optimizer_op.cc)
# ---------------------------------------------------------------------------
@register("rmsprop_update", differentiable=False)
def rmsprop_update(weight, grad, n, *, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    n = gamma1 * n + (1 - gamma1) * torch.square(g)
    w = weight - lr * g / (torch.sqrt(n) + epsilon)
    if clip_weights is not None and clip_weights >= 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, n


@register("rmspropalex_update", differentiable=False)
def rmspropalex_update(weight, grad, n, g_avg, delta, *, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Graves' centered RMSProp (rmspropalex_update)."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    n = gamma1 * n + (1 - gamma1) * torch.square(g)
    g_avg = gamma1 * g_avg + (1 - gamma1) * g
    delta = gamma2 * delta - lr * g / torch.sqrt(n - torch.square(g_avg) + epsilon)
    w = weight + delta
    if clip_weights is not None and clip_weights >= 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, n, g_avg, delta


@register("ftrl_update", differentiable=False)
def ftrl_update(weight, grad, z, n, *, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    sigma = (torch.sqrt(n + torch.square(g)) - torch.sqrt(n)) / lr
    z = z + g - sigma * weight
    n = n + torch.square(g)
    w = torch.where(torch.abs(z) > lamda1,
                  -(z - torch.sign(z) * lamda1)
                  / ((beta + torch.sqrt(n)) / lr + wd),
                  0.0).to(weight.dtype)
    return w, z, n


@register("ftml_update", differentiable=False)
def ftml_update(weight, grad, d, v, z, *, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t, wd=0.0, rescale_grad=1.0,
                clip_grad=-1.0):
    g = _prep(grad, rescale_grad, clip_grad, wd, weight)
    v = beta2 * v + (1 - beta2) * torch.square(g)
    d_t = (1 - beta1 ** t) / lr * (torch.sqrt(v / (1 - beta2 ** t)) + epsilon)
    sigma = d_t - beta1 * d
    z = beta1 * z + (1 - beta1) * g - sigma * weight
    return -z / d_t, d_t, v, z


# ---------------------------------------------------------------------------
# LAMB two-phase (contrib lamb; reference lamb_update_phase1/phase2)
# ---------------------------------------------------------------------------
@register("lamb_update_phase1", differentiable=False)
def lamb_update_phase1(weight, grad, mean, var, *, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """Phase 1: the raw layer-adaptive direction g' (norms taken by caller)."""
    g = _prep(grad, rescale_grad, clip_gradient)
    mean = beta1 * mean + (1 - beta1) * g
    var = beta2 * var + (1 - beta2) * torch.square(g)
    if bias_correction:
        mhat = mean / (1 - beta1 ** t)
        vhat = var / (1 - beta2 ** t)
    else:
        mhat, vhat = mean, var
    g_out = mhat / (torch.sqrt(vhat) + epsilon) + wd * weight
    return g_out, mean, var


@register("lamb_update_phase2", differentiable=False)
def lamb_update_phase2(weight, g, r1, r2, *, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    """Phase 2: apply trust ratio r1/r2 (r1=||w||, r2=||g'||)."""
    if lower_bound is not None and lower_bound >= 0:
        r1 = torch.clamp(r1, min=lower_bound)
    if upper_bound is not None and upper_bound >= 0:
        r1 = torch.clamp(r1, max=upper_bound)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, 1.0)
    return weight - lr * ratio * g


@register("mp_lamb_update_phase1", differentiable=False)
def mp_lamb_update_phase1(weight, grad, mean, var, weight32, *, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, t, bias_correction=True,
                          wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g_out, mean, var = lamb_update_phase1(
        weight32, grad.float(), mean, var, beta1=beta1,
        beta2=beta2, epsilon=epsilon, t=t, bias_correction=bias_correction,
        wd=wd, rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    return g_out, mean, var


@register("mp_lamb_update_phase2", differentiable=False)
def mp_lamb_update_phase2(weight, g, r1, r2, weight32, *, lr,
                          lower_bound=-1.0, upper_bound=-1.0):
    w32 = lamb_update_phase2(weight32, g, r1, r2, lr=lr,
                             lower_bound=lower_bound, upper_bound=upper_bound)
    return w32.to(weight.dtype), w32


# ---------------------------------------------------------------------------
# AdaGrad variants (contrib/optimizer_op.cc group_adagrad; optimizer_op.cc)
# ---------------------------------------------------------------------------
@register("group_adagrad_update", differentiable=False)
def group_adagrad_update(weight, grad, history, *, lr, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5):
    """Per-row (group) AdaGrad (contrib/optimizer_op-inl.h
    GroupAdagradDnsRspKernel): history[row] += mean(g_row^2), whole row
    divided by sqrt(history[row])."""
    g = _prep(grad, rescale_grad, clip_gradient)
    row_mean = torch.mean(torch.square(g).reshape(g.shape[0], -1), dim=1)
    history = history + row_mean.reshape(history.shape)
    denom = torch.sqrt(history).reshape((g.shape[0],) + (1,) * (g.ndim - 1))
    return weight - lr * g / (denom + epsilon), history


@register("sparse_adagrad_update", differentiable=False)
def sparse_adagrad_update(weight, grad_values, grad_indices, history, *, lr,
                          rescale_grad=1.0, clip_gradient=-1.0, epsilon=1e-7):
    """Row-sparse AdaGrad (optimizer_op.cc _sparse_adagrad_update): only rows
    named by grad_indices touch weight/history — gather-update-scatter, the
    lazy-update discipline of the sparse optimizer path."""
    idx = grad_indices.long()
    g = _prep(grad_values, rescale_grad, clip_gradient)
    hist_rows = history[idx] + torch.square(g)
    history = history.index_put((idx,), hist_rows)
    w_rows = weight[idx] - lr * g / (torch.sqrt(hist_rows) + epsilon)
    return weight.index_put((idx,), w_rows), history


# ---------------------------------------------------------------------------
# multi-tensor fused variants (optimizer_op.cc MultiSGDUpdate family,
# contrib/multi_lamb.cc, contrib/multi_lars.cc, contrib/adamw.cc multi)
# ---------------------------------------------------------------------------
def _chunks(arrays, n_groups, per_group):
    assert len(arrays) == n_groups * per_group, \
        f"expected {n_groups * per_group} tensors, got {len(arrays)}"
    return [arrays[i * per_group:(i + 1) * per_group]
            for i in range(n_groups)]


@register("multi_sgd_update", differentiable=False)
def multi_sgd_update(*arrays, lrs, wds, num_weights, rescale_grad=1.0,
                     clip_gradient=-1.0):
    """Interleaved (w0, g0, w1, g1, ...): every group in one call."""
    outs = []
    for i, (w, g) in enumerate(_chunks(arrays, num_weights, 2)):
        outs.append(sgd_update(w, g, lr=lrs[i], wd=wds[i],
                               rescale_grad=rescale_grad,
                               clip_gradient=clip_gradient))
    return tuple(outs)


@register("multi_sgd_mom_update", differentiable=False)
def multi_sgd_mom_update(*arrays, lrs, wds, num_weights, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0):
    outs = []
    for i, (w, g, m) in enumerate(_chunks(arrays, num_weights, 3)):
        nw, nm = sgd_mom_update(w, g, m, lr=lrs[i], momentum=momentum,
                                wd=wds[i], rescale_grad=rescale_grad,
                                clip_gradient=clip_gradient)
        outs.extend([nw, nm])
    return tuple(outs)


@register("multi_mp_sgd_update", differentiable=False)
def multi_mp_sgd_update(*arrays, lrs, wds, num_weights, rescale_grad=1.0,
                        clip_gradient=-1.0):
    outs = []
    for i, (w, g, w32) in enumerate(_chunks(arrays, num_weights, 3)):
        nw, nw32 = mp_sgd_update(w, g, w32, lr=lrs[i], wd=wds[i],
                                 rescale_grad=rescale_grad,
                                 clip_gradient=clip_gradient)
        outs.extend([nw, nw32])
    return tuple(outs)


@register("multi_mp_sgd_mom_update", differentiable=False)
def multi_mp_sgd_mom_update(*arrays, lrs, wds, num_weights, momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0):
    outs = []
    for i, (w, g, m, w32) in enumerate(_chunks(arrays, num_weights, 4)):
        nw, nm, nw32 = mp_sgd_mom_update(
            w, g, m, w32, lr=lrs[i], momentum=momentum, wd=wds[i],
            rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        outs.extend([nw, nm, nw32])
    return tuple(outs)


@register("preloaded_multi_sgd_update", differentiable=False)
def preloaded_multi_sgd_update(*arrays, num_weights, rescale_grad=1.0,
                               clip_gradient=-1.0):
    """lrs/wds ride as the two trailing TENSOR inputs (preloaded_multi_sgd.cc)
    so a LARS-computed lr vector feeds straight in without a host sync."""
    lrs, wds = arrays[-2], arrays[-1]
    outs = []
    for i, (w, g) in enumerate(_chunks(arrays[:-2], num_weights, 2)):
        outs.append(sgd_update(w, g, lr=lrs[i], wd=wds[i],
                               rescale_grad=rescale_grad,
                               clip_gradient=clip_gradient))
    return tuple(outs)


@register("preloaded_multi_sgd_mom_update", differentiable=False)
def preloaded_multi_sgd_mom_update(*arrays, num_weights, momentum=0.0,
                                   rescale_grad=1.0, clip_gradient=-1.0):
    lrs, wds = arrays[-2], arrays[-1]
    outs = []
    for i, (w, g, m) in enumerate(_chunks(arrays[:-2], num_weights, 3)):
        nw, nm = sgd_mom_update(w, g, m, lr=lrs[i], momentum=momentum,
                                wd=wds[i], rescale_grad=rescale_grad,
                                clip_gradient=clip_gradient)
        outs.extend([nw, nm])
    return tuple(outs)


@register("preloaded_multi_mp_sgd_update", differentiable=False)
def preloaded_multi_mp_sgd_update(*arrays, num_weights, rescale_grad=1.0,
                                  clip_gradient=-1.0):
    lrs, wds = arrays[-2], arrays[-1]
    outs = []
    for i, (w, g, w32) in enumerate(_chunks(arrays[:-2], num_weights, 3)):
        nw, nw32 = mp_sgd_update(w, g, w32, lr=lrs[i], wd=wds[i],
                                 rescale_grad=rescale_grad,
                                 clip_gradient=clip_gradient)
        outs.extend([nw, nw32])
    return tuple(outs)


@register("preloaded_multi_mp_sgd_mom_update", differentiable=False)
def preloaded_multi_mp_sgd_mom_update(*arrays, num_weights, momentum=0.0,
                                      rescale_grad=1.0, clip_gradient=-1.0):
    lrs, wds = arrays[-2], arrays[-1]
    outs = []
    for i, (w, g, m, w32) in enumerate(_chunks(arrays[:-2], num_weights, 4)):
        nw, nm, nw32 = mp_sgd_mom_update(
            w, g, m, w32, lr=lrs[i], momentum=momentum, wd=wds[i],
            rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        outs.extend([nw, nm, nw32])
    return tuple(outs)


@register("multi_lars", differentiable=False)
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, *, eta, eps,
               rescale_grad=1.0):
    """Layer-wise LARS rates over stacked per-tensor norms
    (contrib/multi_lars.cc): one op for the whole parameter set."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * rescale_grad
    coef = eta * w_norm / (g_norm + wds * w_norm + eps)
    return lrs * torch.where((w_norm > 0) & (g_norm > 0), coef, 1.0)


@register("multi_adamw_update", differentiable=False)
def multi_adamw_update(*arrays, lrs, etas, wds, num_weights, beta1=0.9,
                       beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                       clip_gradient=-1.0):
    outs = []
    for i, (w, g, m, v) in enumerate(_chunks(arrays, num_weights, 4)):
        nw, nm, nv = adamw_update(w, g, m, v, lr=lrs[i], eta=etas[i],
                                  beta1=beta1, beta2=beta2, epsilon=epsilon,
                                  wd=wds[i], rescale_grad=rescale_grad,
                                  clip_gradient=clip_gradient)
        outs.extend([nw, nm, nv])
    return tuple(outs)


@register("multi_lamb_update", differentiable=False)
def multi_lamb_update(*arrays, lrs, wds, num_weights, step_count, beta1=0.9,
                      beta2=0.999, epsilon=1e-6, bias_correction=True,
                      lower_bound=-1.0, upper_bound=-1.0, rescale_grad=1.0,
                      clip_gradient=-1.0):
    """Fused full LAMB (contrib/multi_lamb.cc): both phases per tensor, all
    tensors in one computation."""
    outs = []
    for i, (w, g, m, v) in enumerate(_chunks(arrays, num_weights, 4)):
        gp, nm, nv = lamb_update_phase1(
            w, g, m, v, beta1=beta1, beta2=beta2, epsilon=epsilon,
            t=step_count[i], bias_correction=bias_correction, wd=wds[i],
            rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        r1 = torch.linalg.vector_norm(w)
        r2 = torch.linalg.vector_norm(gp)
        nw = lamb_update_phase2(w, gp, r1, r2, lr=lrs[i],
                                lower_bound=lower_bound,
                                upper_bound=upper_bound)
        outs.extend([nw, nm, nv])
    return tuple(outs)


@register("lars_update", differentiable=False)
def lars_update(weight, grad, mom, *, lr, eta=0.001, momentum=0.9, wd=0.0,
                epsilon=1e-9, rescale_grad=1.0, clip_gradient=-1.0):
    """Single-tensor LARS step (LARS optimizer semantics over the multi_lars
    rate rule)."""
    g = _prep(grad, rescale_grad, clip_gradient)
    w_norm = torch.linalg.vector_norm(weight.float())
    g_norm = torch.linalg.vector_norm(g.float())
    local_lr = torch.where((w_norm > 0) & (g_norm > 0),
                         eta * w_norm / (g_norm + wd * w_norm + epsilon), 1.0)
    g = g + wd * weight
    mom = momentum * mom + (lr * local_lr).to(weight.dtype) * g
    return weight - mom, mom


@register("multi_mp_adamw_update", differentiable=False)
def multi_mp_adamw_update(*arrays, lrs, etas, wds, num_weights, beta1=0.9,
                          beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                          clip_gradient=-1.0):
    """Fused multi-tensor multi-precision AdamW (contrib/adamw.cc
    multi_mp_adamw_update): groups of (w16, g, m, v, w32)."""
    outs = []
    for i, (w, g, m, v, w32) in enumerate(_chunks(arrays, num_weights, 5)):
        nw, nm, nv, nw32 = mp_adamw_update(
            w, g, m, v, w32, lr=lrs[i], eta=etas[i], beta1=beta1, beta2=beta2,
            epsilon=epsilon, wd=wds[i], rescale_grad=rescale_grad,
            clip_gradient=clip_gradient)
        outs.extend([nw, nm, nv, nw32])
    return tuple(outs)


@register("multi_mp_lamb_update", differentiable=False)
def multi_mp_lamb_update(*arrays, lrs, wds, num_weights, step_count,
                         beta1=0.9, beta2=0.999, epsilon=1e-6,
                         bias_correction=True, lower_bound=-1.0,
                         upper_bound=-1.0, rescale_grad=1.0,
                         clip_gradient=-1.0):
    """Fused multi-tensor multi-precision LAMB (contrib/multi_lamb.cu mp
    path): groups of (w16, g, m, v, w32); the trust-ratio norms use the
    fp32 master weight."""
    outs = []
    for i, (w, g, m, v, w32) in enumerate(_chunks(arrays, num_weights, 5)):
        gp, nm, nv = lamb_update_phase1(
            w32, g.float(), m, v, beta1=beta1, beta2=beta2,
            epsilon=epsilon, t=step_count[i], bias_correction=bias_correction,
            wd=wds[i], rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        r1 = torch.linalg.vector_norm(w32)
        r2 = torch.linalg.vector_norm(gp)
        nw32 = lamb_update_phase2(w32, gp, r1, r2, lr=lrs[i],
                                  lower_bound=lower_bound,
                                  upper_bound=upper_bound)
        outs.extend([nw32.to(w.dtype), nm, nv, nw32])
    return tuple(outs)
