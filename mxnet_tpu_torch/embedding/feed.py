"""Streaming device feed: a background stager ahead of the train or serve
step (the counterpart of ``mxnet_tpu/embedding/feed.py``).

For a DLRM-shaped step the consumer-side work between steps is the
expensive part: deduplicating the sparse index bundle and placing
everything on the device. ``DeviceFeed`` moves it off that path: a
background stager thread runs ahead of the consumer, applies a ``stage``
function to each batch (for the DLRM step: :meth:`DLRMTrainStep.stage`,
the batch moved to the card and its ids deduplicated there) and parks the
staged batches in a bounded buffer of ``MXNET_EMB_FEED_DEPTH`` (double
buffered by default). The consumer's ``next()`` then usually finds a batch
already staged.

Staging must not perturb resume: the stager *consumes ahead* of the
training loop, so the wrapped loader's own position counts batches still
in flight. :meth:`DeviceFeed.state_dict` reports the batches the CONSUMER
took, anchored to the loader's epoch and RNG accounting (its epoch-start
state, captured from the stager thread the moment the epoch starts), and
:meth:`DeviceFeed.load_state_dict` hands the loader exactly that position
through the DataLoader's positional resume: staged but unconsumed batches
replay instead of being dropped. A checkpoint carries it as the reference's
does, beside the train step: ``CheckpointManager.save(step,
train_step=ts, extra={"feed": feed.state_dict()})``, then
``feed.load_state_dict(state["extra"]["feed"])`` after the restore.

Telemetry: :attr:`DeviceFeed.lead` is the ``mxtpu_emb_stager_lead`` gauge
(the staged batches waiting when the consumer last asked),
:attr:`DeviceFeed.staged` the feed's share of
``mxtpu_emb_staged_batches_total``, and the consumer's wait in each
``next()`` lands in the bare loader's ``mxtpu_dataloader_wait_us``, so
staged and unstaged pipelines read on one series; :attr:`DeviceFeed.wait_us`
keeps the current (or last) epoch's waits as samples.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

from ..base import MXNetError
from .. import config as _config
from .. import telemetry as _telemetry
from ..gluon.data.dataloader import _WAIT as _DL_WAIT
from ..telemetry.metrics import Baseline

__all__ = ["DeviceFeed"]

_LEAD = _telemetry.gauge(
    "mxtpu_emb_stager_lead",
    "Staged batches resident on device when the consumer asked for the "
    "next one (0 = the chip waited on the stager).")
_STAGED = _telemetry.counter(
    "mxtpu_emb_staged_batches_total", "Batches staged ahead by DeviceFeed.")


class _StopStaging(Exception):
    """The consumer abandoned the feed; unwind the stager."""


class DeviceFeed:
    """Wrap a DataLoader with an ahead-running device stager.

    Parameters
    ----------
    loader : DataLoader
        The source pipeline. Its epoch, position and RNG accounting is the
        anchor for exact resume.
    stage : callable, optional
        ``stage(batch) -> staged`` runs in the stager thread; put the
        host-to-card copies and the index dedup here. Default: identity.
    depth : int, optional
        Staged-batch buffer size (default ``MXNET_EMB_FEED_DEPTH``).
    """

    def __init__(self, loader, stage: Optional[Callable] = None,
                 depth: Optional[int] = None):
        self.loader = loader
        self._stage = stage if stage is not None else (lambda b: b)
        self.depth = int(depth if depth is not None
                         else _config.get("MXNET_EMB_FEED_DEPTH"))
        if self.depth < 1:
            raise MXNetError("DeviceFeed depth must be >= 1")
        self._own = Baseline({"staged": _STAGED})
        #: microseconds the consumer waited in each next() of the current
        #: (or last) epoch
        self.wait_us: List[int] = []
        # resume accounting: entry anchor = loader state when the current
        # epoch's iteration was entered (carries the resume offset); live
        # anchor = loader state captured by the stager right after the
        # first batch (carries the epoch-start RNG of a fresh epoch);
        # consumed = batches the CONSUMER took since entry
        self._entry_anchor = loader.state_dict()
        self._live_anchor = None
        self._consumed = 0

    def __len__(self):
        return len(self.loader)

    @property
    def lead(self) -> int:
        """Staged batches waiting when the consumer last asked for one (0:
        the consumer waited on the stager)."""
        return int(_LEAD.value)

    @property
    def staged(self) -> int:
        """Batches this feed staged ahead, over its life."""
        return int(self._own["staged"])

    def __iter__(self):
        self._entry_anchor = self.loader.state_dict()
        self._live_anchor = None
        self._consumed = 0
        self.wait_us = []
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def _put(item):
            # bounded put that notices an abandoned consumer
            while True:
                try:
                    q.put(item, timeout=0.05)
                    return
                except queue.Full:
                    if stop.is_set():
                        raise _StopStaging()

        def _work():
            try:
                first = True
                for batch in self.loader:
                    if first:
                        # the loader has now captured its epoch-start RNG;
                        # snapshot it while it is live (pos is overridden
                        # by state_dict())
                        self._live_anchor = self.loader.state_dict()
                        first = False
                    _put(("data", self._stage(batch)))
                    _STAGED.inc()
                    if stop.is_set():
                        return
                _put(("end", None))
            except _StopStaging:
                pass
            except BaseException as e:  # surfaced in the consumer, promptly
                try:
                    _put(("error", e))
                except _StopStaging:
                    pass

        t = threading.Thread(target=_work, daemon=True,
                             name="mxnet-device-feed")
        t.start()
        try:
            while True:
                _LEAD.set(q.qsize())
                t0 = time.perf_counter_ns()
                kind, item = q.get()
                wait = (time.perf_counter_ns() - t0) // 1000
                _DL_WAIT.observe(wait)
                self.wait_us.append(wait)
                if kind == "data":
                    self._consumed += 1
                    yield item
                elif kind == "error":
                    raise item
                else:
                    # epoch complete: re-anchor at the loader's new epoch
                    self._entry_anchor = self.loader.state_dict()
                    self._live_anchor = None
                    self._consumed = 0
                    return
        finally:
            stop.set()
            t.join(timeout=5.0)

    # ------------------------------------------------------------------
    # checkpoint surface
    # ------------------------------------------------------------------
    def state_dict(self):
        """Exact-resume snapshot: the consumer's position (entry offset +
        batches taken) over the epoch's RNG anchor. Staged but unconsumed
        batches are not counted: they replay on resume."""
        base = self._live_anchor if self._live_anchor is not None \
            else self._entry_anchor
        st = dict(base)
        st["kind"] = "DeviceFeed"
        st["version"] = 1
        st["pos"] = int(self._entry_anchor.get("pos", 0)) + self._consumed
        if st["pos"] == 0:
            # a position-0 state must not carry a stale RNG snapshot: the
            # loader captures anew at the next epoch start
            for k in ("rng_name", "rng_keys", "rng_pos", "rng_has_gauss",
                      "rng_cached", "sample_seed"):
                st.pop(k, None)
        return st

    def load_state_dict(self, state):
        if state.get("kind") != "DeviceFeed":
            raise MXNetError(f"not a DeviceFeed state: {state.get('kind')!r}")
        inner = dict(state)
        inner["kind"] = "DataLoader"
        self.loader.load_state_dict(inner)
        self._entry_anchor = self.loader.state_dict()
        self._live_anchor = None
        self._consumed = 0
