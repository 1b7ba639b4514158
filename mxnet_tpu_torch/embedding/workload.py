"""The DLRM training step over a vocab-sharded embedding table (the
counterpart of ``mxnet_tpu/embedding/workload.py``).

Bottom MLP over the dense features, pairwise dot interactions of the
bottom MLP's output with the sparse fields' rows, top MLP over the
concatenation: the DLRM factorization, trained with plain SGD.

Two batch modes, matching the two lookups of :class:`ShardedEmbedding`:

  ``replicated``   every rank of the axis takes the whole batch; the lookup
                   is a masked local gather plus an all_reduce sum, and the
                   row gradients are applied to each rank's shard by an
                   ``index_add_``. Every rank computes the same forward and
                   backward on the same rows, so the step equals the
                   one-rank step bit for bit.
  ``sharded``      the batch is split over the axis (each rank its own
                   rows): a per-rank dedup, the all_to_all dispatch and
                   return of the ids and rows, the MLP's forward and
                   backward on the rank's rows, the MLP gradient averaged
                   over the axis, and each rank's 1/n-scaled row gradients
                   routed to their owners by the reverse all_to_all.

In both modes the sparse update stays on the ranks' devices: no kvstore
call is made (``tests/test_torch_embedding.py`` counts them), while the
table's ``exchange_bytes`` move. The gradient is taken with respect to the
*gathered rows* (``torch.autograd.grad`` of the loss over the MLP's
parameters and the rows), never a dense (V, D) gradient.

Each attempt runs at the ``emb_dispatch`` fault site (kind
``emb_exchange``), under ``retry=`` (a ``resilience.RetryPolicy``) when
given. The update is in place, so once the step's first write (the table's
``index_add_``) has begun a retry is refused: restore from the latest
checkpoint. ``shard_state_dict`` captures each rank's table shard as a
``resilience.sharding.ShardedLeaf``, written by that rank.
"""
from __future__ import annotations

from typing import Dict

import numpy as onp
import torch

from ..base import MXNetError
from ..parallel import collectives
from ..resilience import faults as _faults
from ..resilience.checkpoint import host_array
from ..resilience.sharding import ShardedLeaf
from .table import ShardedEmbedding, dedup_ids

__all__ = ["DLRMTrainStep", "init_mlp_params", "dlrm_forward", "bce_loss",
           "synthetic_dlrm_batches"]


# ----------------------------------------------------------------------
# model math (shared with gluon.model_zoo.dlrm)
# ----------------------------------------------------------------------
def init_mlp_params(dense_in: int, n_fields: int, embed_dim: int,
                    bot_hidden: int = 64, top_hidden: int = 64,
                    seed: int = 0) -> Dict[str, onp.ndarray]:
    """Host float32 parameters of the two towers (the reference's draws:
    N(0, 1/fan_in) weights, zero biases, from ``RandomState(seed)``)."""
    rng = onp.random.RandomState(seed)
    n_pairs = (n_fields + 1) * n_fields // 2
    top_in = embed_dim + n_pairs

    def lin(fan_in, fan_out):
        w = rng.normal(0.0, 1.0 / onp.sqrt(fan_in),
                       (fan_in, fan_out)).astype(onp.float32)
        return w, onp.zeros(fan_out, onp.float32)

    p = {}
    p["w_bot1"], p["b_bot1"] = lin(dense_in, bot_hidden)
    p["w_bot2"], p["b_bot2"] = lin(bot_hidden, embed_dim)
    p["w_top1"], p["b_top1"] = lin(top_in, top_hidden)
    p["w_top2"], p["b_top2"] = lin(top_hidden, 1)
    return p


def dlrm_forward(mlp, dense, emb_rows):
    """DLRM forward: ``(B, d_in)`` dense features and ``(B, F, D)``
    embedding rows -> ``(B,)`` logits. Bottom MLP, pairwise dot
    interactions over the F+1 feature vectors (lower triangle, diagonal
    excluded), top MLP. ``mlp`` maps the names of
    :func:`init_mlp_params` to tensors, weights as (in, out)."""
    bot = torch.relu(dense @ mlp["w_bot1"] + mlp["b_bot1"])
    bot = torch.relu(bot @ mlp["w_bot2"] + mlp["b_bot2"])        # (B, D)
    z = torch.cat([bot[:, None, :], emb_rows], dim=1)            # (B, F+1, D)
    zz = torch.bmm(z, z.transpose(1, 2))                         # (B,F+1,F+1)
    li, lj = (torch.as_tensor(a, device=z.device)
              for a in onp.tril_indices(z.shape[1], k=-1))
    inter = zz[:, li, lj]                                        # (B, pairs)
    top = torch.cat([bot, inter], dim=1)
    h = torch.relu(top @ mlp["w_top1"] + mlp["b_top1"])
    return (h @ mlp["w_top2"] + mlp["b_top2"])[:, 0]


def bce_loss(logit, y):
    """Sigmoid binary cross entropy with logits: mean(softplus(x) - y x)."""
    return torch.mean(torch.logaddexp(torch.zeros_like(logit), logit)
                      - y * logit)


def synthetic_dlrm_batches(n_batches: int, batch: int, dense_in: int,
                           n_fields: int, vocab: int, seed: int = 0,
                           hot_frac: float = 0.7):
    """Deterministic synthetic DLRM data, the reference's draws: dense
    normals, skewed sparse ids (``hot_frac`` of lookups land in the first
    vocab/16 rows, the hot head a frequency-sorted vocab would have) and
    Bernoulli labels. A list of host (dense, idx, y) tuples."""
    rng = onp.random.RandomState(seed)
    head = max(1, vocab // 16)
    out = []
    for _ in range(n_batches):
        dense = rng.normal(0, 1, (batch, dense_in)).astype(onp.float32)
        hot = rng.randint(0, head, (batch, n_fields))
        cold = rng.randint(0, vocab, (batch, n_fields))
        pick = rng.uniform(size=(batch, n_fields)) < hot_frac
        idx = onp.where(pick, hot, cold).astype(onp.int32)
        y = (rng.uniform(size=batch) < 0.5).astype(onp.float32)
        out.append((dense, idx, y))
    return out


# ----------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------
class DLRMTrainStep:
    """SGD training step of the DLRM workload over a ShardedEmbedding.

    Parameters
    ----------
    table : ShardedEmbedding
        The sparse feature table (owns the mesh, axis and placement).
    dense_in, n_fields : int
        Dense feature width and number of sparse fields per example.
    bot_hidden, top_hidden : int
        MLP widths.
    lr : float
        Plain SGD rate (no momentum or weight decay: ``w - lr * g``).
    mode : str
        ``replicated`` or ``sharded`` (needs a partitioned table with more
        than one shard; otherwise the two coincide and the step is
        ``replicated``).
    seed : int
        Seed of the MLP's initial draws (:func:`init_mlp_params`).
    retry : resilience.RetryPolicy, optional
        Attempts run under this policy at the ``emb_dispatch`` fault site.
    """

    def __init__(self, table: ShardedEmbedding, dense_in: int, n_fields: int,
                 bot_hidden: int = 64, top_hidden: int = 64, lr: float = 0.1,
                 mode: str = "replicated", seed: int = 0, retry=None):
        if mode not in ("replicated", "sharded"):
            raise MXNetError(f"unknown DLRM step mode {mode!r}")
        if mode == "sharded" and (table.placement != "partition"
                                  or table.n_shards <= 1):
            mode = "replicated"   # degenerate mesh: the paths coincide
        self.table = table
        self.dense_in = int(dense_in)
        self.n_fields = int(n_fields)
        self.lr = float(lr)
        self.mode = mode
        self._retry = retry
        self._writing = False       # the step's in-place update began
        self._t = 0
        self._device = table.mesh.device
        host = init_mlp_params(dense_in, n_fields, table.embed_dim,
                               bot_hidden, top_hidden, seed)
        self._mlp = {k: torch.from_numpy(v).to(self._device)
                     for k, v in host.items()}

    # -- staging ---------------------------------------------------------
    def _put(self, a, dtype):
        return torch.as_tensor(a).to(device=self._device, dtype=dtype)

    def stage(self, batch):
        """Stage one global host ``(dense, idx, y)`` batch on this rank's
        device (the DeviceFeed ``stage`` hook): ``replicated`` takes the
        whole batch and deduplicates its ids there; ``sharded`` takes this
        rank's rows of the batch (the batch must split evenly over the
        axis)."""
        dense, idx, y = batch
        n_ids = int(onp.prod(idx.shape))
        if self.mode == "sharded":
            n, i = self.table.n_shards, self.table.shard_index
            rows = int(idx.shape[0])
            if rows % n:
                raise MXNetError(f"a sharded DLRM step needs a batch that "
                                 f"splits over {n} ranks, got {rows} rows")
            b = rows // n
            dense, idx, y = (a[i * b:(i + 1) * b] for a in (dense, idx, y))
        staged = {"dense": self._put(dense, torch.float32),
                  "idx": self._put(idx, torch.int32),
                  "y": self._put(y, torch.float32), "n_ids": n_ids}
        if self.mode == "replicated":
            staged["uniq"], staged["inv"] = dedup_ids(
                staged["idx"], self.table.padded_vocab)
        return staged

    # -- the step --------------------------------------------------------
    def _loss_and_grads(self, batch, rows, inv):
        """The loss and its gradients with respect to the MLP's parameters
        and the gathered ``rows``."""
        leaves = {k: v.detach().requires_grad_() for k, v in
                  self._mlp.items()}
        rows = rows.detach().requires_grad_()
        with torch.enable_grad():
            logit = dlrm_forward(leaves, batch["dense"], rows[inv.long()])
            loss = bce_loss(logit, batch["y"])
            grads = torch.autograd.grad(loss, list(leaves.values()) + [rows])
        return loss.detach(), dict(zip(leaves, grads[:-1])), grads[-1]

    def _replicated(self, batch):
        uniq = batch["uniq"]
        loss, g_mlp, g_rows = self._loss_and_grads(
            batch, self.table.gather(uniq), batch["inv"])
        self._writing = True
        self.table.scatter_add(uniq, g_rows * (-self.lr))
        return loss, g_mlp

    def _sharded(self, batch):
        t = self.table
        uniq, inv = dedup_ids(batch["idx"], t.padded_vocab)
        loss, g_mlp, g_rows = self._loss_and_grads(
            batch, t.dispatch_gather(uniq), inv)
        # the global gradient is the mean of the ranks' (equal local
        # batches), one flat all_reduce
        flat = collectives.all_reduce(
            torch.cat([g.reshape(-1) for g in g_mlp.values()]), t.axis,
            "mean", mesh=t.mesh)
        g_mlp = dict(zip(g_mlp, torch.split(
            flat, [g.numel() for g in g_mlp.values()])))
        g_mlp = {k: g.view(self._mlp[k].shape) for k, g in g_mlp.items()}
        # reverse dispatch: each rank's 1/n-scaled row gradients go home
        self._writing = True
        t.dispatch_scatter_add(uniq, g_rows * (-self.lr / t.n_shards))
        loss = collectives.all_reduce(loss, t.axis, "mean", mesh=t.mesh)
        return loss, g_mlp

    def __call__(self, batch, idx=None, y=None):
        """Run one step on a global host ``(dense, idx, y)`` batch (or three
        positional arrays), or on a bundle :meth:`stage` made. Returns the
        loss (the mean over the ranks' rows in ``sharded`` mode) as a
        Python float."""
        if idx is not None:
            batch = (batch, idx, y)
        if not isinstance(batch, dict):
            batch = self.stage(batch)

        def attempt():
            _faults.check("emb_dispatch")
            with torch.no_grad():
                if self.mode == "replicated":
                    loss, g_mlp = self._replicated(batch)
                else:
                    loss, g_mlp = self._sharded(batch)
                for k, g in g_mlp.items():
                    self._mlp[k].sub_(g * self.lr)
            return loss

        def pre_retry(exc, attempt, delay_s):
            if self._writing:
                raise MXNetError(
                    "cannot retry DLRM step: its in-place table update had "
                    "begun when it failed; restore from the latest "
                    "checkpoint (resilience.CheckpointManager) "
                    "instead") from exc

        self._writing = False
        if self._retry is not None:
            loss = self._retry.run(attempt, site="emb_dispatch",
                                   on_retry=pre_retry)
        else:
            loss = attempt()
        self._t += 1
        self.table.record_exchange(batch["n_ids"],
                                   dispatch=(self.mode == "sharded"))
        return float(loss)

    @property
    def mlp(self) -> Dict[str, torch.Tensor]:
        return self._mlp

    # -- checkpoint surface ------------------------------------------------
    def state_dict(self) -> Dict:
        """Gathered host snapshot (every rank must call it). The table is
        saved in its STORED layout with its geometry, so a restore onto
        another shard count or layout rebuilds the logical rows exactly."""
        t = self.table
        return {"kind": "DLRMTrainStep", "version": 1, "t": int(self._t),
                "table_vocab": t.vocab_size, "table_dim": t.embed_dim,
                "table_shards": t.n_shards, "table_rps": t.rows_per_shard,
                "table_layout": t.layout,
                "table": host_array(t.stored_weight()),
                "mlp": {k: host_array(v) for k, v in self._mlp.items()}}

    def shard_state_dict(self) -> Dict:
        """:meth:`state_dict` with the stored table as each rank's shard (a
        ``ShardedLeaf`` written by the rank holding it) and the MLP whole,
        written by the rank at coordinate 0 of every axis: no rank gathers
        the table."""
        t = self.table
        mesh = t.mesh
        origin = {a: 0 for a in mesh.axis_names}
        if t.n_shards > 1:
            writers = [mesh._rank_of({**origin, t.axis: k})
                       for k in range(t.n_shards)]
            mine = mesh.rank == writers[t.shard_index]
            table = ShardedLeaf.split(host_array(t.weight), 0, writers,
                                      t.shard_index if mine else -1)
        else:
            table = ShardedLeaf.whole(host_array(t.weight), 0, mesh.rank)
        return {"kind": "DLRMTrainStep", "version": 1, "t": int(self._t),
                "table_vocab": t.vocab_size, "table_dim": t.embed_dim,
                "table_shards": t.n_shards, "table_rps": t.rows_per_shard,
                "table_layout": t.layout, "table": table,
                "mlp": {k: ShardedLeaf.whole(host_array(v), 0, mesh.rank)
                        for k, v in self._mlp.items()}}

    def load_state_dict(self, state: Dict):
        """Restore from a :meth:`state_dict` snapshot onto THIS step's mesh:
        the saving mesh's shard count and layout may differ (an elastic
        restore of a 2-rank cyclic table onto 1 rank rides this)."""
        if state.get("kind") != "DLRMTrainStep":
            raise MXNetError(
                f"not a DLRMTrainStep state: {state.get('kind')!r}")
        vocab = int(state["table_vocab"])
        if vocab != self.table.vocab_size:
            raise MXNetError(f"table vocab {vocab} != {self.table.vocab_size}")
        stored = onp.asarray(state["table"])
        rps, n = int(state["table_rps"]), int(state["table_shards"])
        if state["table_layout"] == "block":
            logical = stored[:vocab]          # a view: the rows in order
        else:
            ids = onp.arange(vocab)
            logical = stored[(ids % n) * rps + ids // n]
        self.table.set_weight(logical)
        self._mlp = {k: torch.from_numpy(onp.array(v, onp.float32)).to(
            self._device) for k, v in dict(state["mlp"]).items()}
        self._t = int(state["t"])

    def __repr__(self):
        return (f"DLRMTrainStep(mode={self.mode}, t={self._t}, "
                f"table={self.table!r})")
