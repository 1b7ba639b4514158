"""The port's ring attention (``mxnet_tpu_torch.parallel.ring_attention``)
against the JAX package's ``parallel.ring_self_attention`` on its 8-device
CPU mesh.

The port runs one process per rank: ``mxnet_tpu_torch/tools/launch.py``
starts 2 or 4 workers (tests/torch_ring_attention_worker.py, gloo on the
CPU) over the same seeded numpy inputs, and each block of the ring goes
through the flash-attention kernels' plain versions. Cases: the oracle
shapes of tests/test_parallel.py (``test_ring_attention_matches_dense``
(2, 4, 32, 16) and ``test_ring_attention_causal`` (1, 2, 16, 8)) and
BERT-base's head dim D = 64, each with and without ``causal``. Forward
within 1e-5 and the gradients of ``(out * w).sum()`` within 1e-4 of
``jax.grad`` through the reference's ring (f32, sum order only: the ring
merges blocks by their log-sum-exp, the reference by a running max); every
rank holds the same output and gradients, bit for bit. With one rank the
ring is one ``flash_attention`` call, bitwise.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as onp
import pytest

from mxnet_tpu import parallel as jparallel

import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.ops.cuda import flash_attention as fa
from mxnet_tpu_torch.tools import launch

ra = sys.modules["mxnet_tpu_torch.parallel.ring_attention"]

torch.set_num_threads(2)
torch.exp(torch.zeros(1 << 18))      # prime the intra-op pool (SKILL.md)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ring_attention_worker.py")
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = {"dense": (2, 4, 32, 16), "causal": (1, 2, 16, 8),
          "d64": (1, 2, 32, 64)}
CASES = [f"{s}_{'causal' if c else 'full'}" for s in SHAPES
         for c in (False, True)]
SIZES = (2, 4)


def _inputs(name):
    shape, causal = SHAPES[name.rsplit("_", 1)[0]], name.endswith("causal")
    rng = onp.random.RandomState(sum(map(ord, name)))
    q, k, v, w = (rng.randn(*shape).astype("float32") for _ in range(4))
    return q, k, v, w, causal


def _reference(n, name):
    q, k, v, w, causal = _inputs(name)
    mesh = jparallel.make_mesh({"sp": n}, devices=jax.devices()[:n])

    def loss(q, k, v):
        out = jparallel.ring_self_attention(q, k, v, mesh, causal=causal)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return {"out": onp.asarray(out),
            **{f"d{t}": onp.asarray(g) for t, g in zip("qkv", grads)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per ring size: the port's ranks' outputs (list by rank) and the
    reference's, by case."""
    path = tmp_path_factory.mktemp("ring")
    arrays = {"names": onp.asarray(CASES)}
    for name in CASES:
        q, k, v, w, causal = _inputs(name)
        arrays.update({f"{name}_q": q, f"{name}_k": k, f"{name}_v": v,
                       f"{name}_w": w, f"{name}_causal": onp.asarray(causal)})
    onp.savez(path / "inputs.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=REPO, MXNET_DIST_TIMEOUT="60",
               OMP_NUM_THREADS="1")
    out = {}
    for n in SIZES:
        proc = launch.run(n, [sys.executable, WORKER, str(path)],
                          timeout=120, env=env)
        assert proc.returncode == 0, proc.stdout[-4000:] + \
            proc.stderr[-8000:]
        lines = [json.loads(ln) for ln in proc.stdout.splitlines()
                 if ln.startswith("{")]
        assert sorted(ln["rank"] for ln in lines) == list(range(n))
        assert all(ln["sp"] == n for ln in lines)
        ranks = [dict(onp.load(path / f"ring_r{r}.npz")) for r in range(n)]
        out[n] = (ranks, {name: _reference(n, name) for name in CASES})
    return out


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("n", SIZES)
def test_forward_matches_the_reference(runs, n, name):
    ranks, ref = runs[n]
    for r in ranks:
        onp.testing.assert_allclose(r[f"{name}_out"], ref[name]["out"],
                                    **FWD_TOL)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("n", SIZES)
def test_gradients_match_the_references_grad(runs, n, name):
    ranks, ref = runs[n]
    for r in ranks:
        for t in "qkv":
            onp.testing.assert_allclose(r[f"{name}_d{t}"],
                                        ref[name][f"d{t}"], **GRAD_TOL,
                                        err_msg=f"d{t}")


@pytest.mark.parametrize("n", SIZES)
def test_every_rank_holds_the_same_output_and_gradients(runs, n):
    ranks, _ = runs[n]
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        for key in r:
            onp.testing.assert_array_equal(r[key], ranks[0][key],
                                           err_msg=key)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64])
def test_one_rank_is_one_flash_attention_call_bitwise(d, causal):
    rng = onp.random.RandomState(d + causal)
    arrays = [rng.randn(2, 3, 24, d).astype("float32") for _ in range(4)]
    mesh = parallel.make_mesh({"sp": 1}, ctx=mt.cpu())

    def run(fn):
        q, k, v = (torch.tensor(a, requires_grad=True) for a in arrays[:3])
        out = fn(q, k, v)
        (out * torch.tensor(arrays[3])).sum().backward()
        return [out.detach()] + [t.grad for t in (q, k, v)]

    got = run(lambda q, k, v: parallel.ring_self_attention(
        q, k, v, mesh, causal=causal))
    want = run(lambda q, k, v: fa.flash_attention(q, k, v, causal=causal))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_causal_ring_skips_the_blocks_of_later_ranks(n):
    """The blocks a rank runs (K1, K2 and K3 launches a call): n each
    without ``causal``; with it r + 1 on rank r, the diagonal masked. The
    block at step t came from rank (r - t) mod n."""
    for r in range(n):
        assert ra._ring_masks(n, r, False) == [False] * n
        causal = ra._ring_masks(n, r, True)
        run = [((r - t) % n, m) for t, m in enumerate(causal)
               if m is not None]
        assert len(run) == r + 1
        assert run[0] == (r, True)
        assert all(m is False and s < r for s, m in run[1:])


def test_the_ring_on_the_cpu_takes_the_plain_versions():
    q = torch.zeros(1, 1, 8, 64)
    assert fa.block_ops(q) == (fa.flash_attention_fwd_reference,
                               fa.flash_attention_bwd_dq_reference,
                               fa.flash_attention_bwd_dkv_reference)
