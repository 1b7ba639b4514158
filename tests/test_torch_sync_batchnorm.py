"""The port's SyncBatchNorm (the registry op with ``axis_name`` and the
Gluon layer under a {"dp": 2} mesh) on 2 ranks against the JAX package's
``batch_norm(axis_name=...)`` under ``shard_map`` over 2 CPU devices:
forward, the gradients of x, gamma and beta, and the moving statistics,
at 1e-5.

The ranks (tests/torch_dist_parallel_worker.py ``sync``, gloo on the CPU)
each take half of the global batch; the loss is sum(out * w) over the
global batch, so the reference's gamma and beta gradients are the sums of
the ranks' (each rank's gamma and beta are replicated).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
from jax.sharding import Mesh, PartitionSpec as PS

from mxnet_tpu.ops.contrib import sync_batch_norm as jax_sync_bn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops.registry import list_ops

from test_torch_parallel import run_workers

TOL = dict(rtol=1e-5, atol=1e-5)
N, C, H, W = 8, 3, 4, 5


def _reference(x, w, gamma, beta, mm, mv):
    mesh = Mesh(onp.asarray(jax.devices()[:2]), ("dp",))

    def local(x, gamma, beta, mm, mv):
        return jax_sync_bn(x, gamma, beta, mm, mv, eps=1e-3, fix_gamma=False,
                           axis_name="dp", training=True)

    bn = jax.shard_map(local, mesh=mesh,
                       in_specs=(PS("dp"), PS(), PS(), PS(), PS()),
                       out_specs=(PS("dp"), PS(), PS()), check_vma=False)

    def loss(x, gamma, beta):
        y, _, _ = bn(x, gamma, beta, mm, mv)
        return jnp.sum(y * w)

    y, nm, nv = bn(x, gamma, beta, mm, mv)
    dx, dg, db = jax.grad(loss, argnums=(0, 1, 2))(x, gamma, beta)
    return {"y": y, "dx": dx, "dgb": jnp.stack([dg, db]), "nm": nm,
            "nv": nv}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("sync")
    rng = onp.random.RandomState(4)
    inputs = {"sbn_x": (rng.randn(N, C, H, W) * 2 + 1).astype("float32"),
              "sbn_w": rng.randn(N, C, H, W).astype("float32"),
              "sbn_gamma": (1 + 0.1 * rng.randn(C)).astype("float32"),
              "sbn_beta": (0.1 * rng.randn(C)).astype("float32"),
              "sbn_mm": (0.1 * rng.randn(C)).astype("float32"),
              "sbn_mv": (1 + 0.1 * rng.rand(C)).astype("float32")}
    onp.savez(path / "inputs.npz", **inputs)
    ref = _reference(*(jnp.asarray(inputs[k]) for k in (
        "sbn_x", "sbn_w", "sbn_gamma", "sbn_beta", "sbn_mm", "sbn_mv")))
    return run_workers(2, "sync", path), {k: onp.asarray(v)
                                          for k, v in ref.items()}


@pytest.mark.parametrize("form", ["op", "layer"])
def test_forward_matches_shard_map(runs, form):
    outs, ref = runs
    y = onp.concatenate([o[f"{form}_y"] for o in outs])
    onp.testing.assert_allclose(y, ref["y"], **TOL)


@pytest.mark.parametrize("form", ["op", "layer"])
def test_gradients_match_shard_map(runs, form):
    outs, ref = runs
    dx = onp.concatenate([o[f"{form}_dx"] for o in outs])
    onp.testing.assert_allclose(dx, ref["dx"], **TOL)
    for o in outs:
        onp.testing.assert_allclose(o[f"{form}_dgb"], ref["dgb"], **TOL)


@pytest.mark.parametrize("form", ["op", "layer"])
def test_moving_statistics_match_shard_map(runs, form):
    outs, ref = runs
    for o in outs:
        onp.testing.assert_allclose(o[f"{form}_nm"], ref["nm"], **TOL)
        onp.testing.assert_allclose(o[f"{form}_nv"], ref["nv"], **TOL)
    onp.testing.assert_array_equal(outs[0][f"{form}_nm"],
                                   outs[1][f"{form}_nm"])


def test_sync_batchnorm_is_registered():
    from mxnet_tpu.ops.registry import list_ops as jax_list_ops
    assert "SyncBatchNorm" in list_ops() and len(list_ops()) == 369
    # less the _np_* ops the reference's mx.np registers on first use
    assert set(list_ops()) == {o for o in jax_list_ops()
                               if not o.startswith("_np_")}
    assert mt.gluon.nn.SyncBatchNorm(in_channels=3)._kwargs["axis"] == 1
