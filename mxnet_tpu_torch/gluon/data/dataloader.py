"""DataLoader of the port (the counterpart of
``mxnet_tpu/gluon/data/dataloader.py``).

Workers are threads, as in the JAX package: ``num_workers`` threads fetch
and batchify up to ``prefetch`` batches ahead, delivered in order, and an
error raised by a worker is raised to the consumer at its batch.

Where the stages run: the dataset, its transforms and
``default_batchify_fn`` make ``cpu()`` NDArrays, so the workers never
touch the card; with ``pin_memory=True`` (on a host with CUDA) a batch's
tensors are moved to pinned memory in the worker, and the training loop's
``as_in_context(gpu(0))`` is then a non-blocking copy.

Randomness: each batch is fetched inside ``random.sample_stream(s)``,
with ``s`` derived from the epoch's seed and the batch's position, so the
random transforms of a batch (drawing from ``random.python_rng()`` and
``numpy_rng()``) make the same draws whichever worker runs it: batches do
not depend on ``num_workers``. The shuffle draws from
``random.numpy_rng()`` at the epoch's start and the epoch's seed from
``random.python_rng()``; ``state_dict`` keeps both, so a loader restored
mid-epoch yields bitwise the batches the first would have.

Telemetry: the time the consumer blocks in ``next()`` for each batch is
``mxtpu_dataloader_wait_us`` (the "is the card starving?" series), and
every yielded batch counts in ``mxtpu_dataloader_batches_total``.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as onp
import torch

from ... import random as _random
from ... import telemetry as _telemetry
from ...base import MXNetError, cpu
from ...ndarray.ndarray import NDArray, _wrap
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]

# the "is the card starving?" series: time the CONSUMER spends blocked in
# next() waiting for the input pipeline. A healthy prefetched loader keeps
# p95 near zero; wait times rivaling the train-step latency mean the input
# pipeline, not the card, is the bottleneck.
_WAIT = _telemetry.histogram(
    "mxtpu_dataloader_wait_us",
    "Time the training loop blocks waiting for the next batch "
    "(microseconds).")
_BATCHES = _telemetry.counter(
    "mxtpu_dataloader_batches_total", "Batches yielded by DataLoader.")


def _timed_iter(it):
    """Yield from ``it``, recording the consumer-visible wait per batch;
    closing this generator closes ``it`` (its prefetcher stops)."""
    try:
        while True:
            t0 = time.perf_counter_ns()
            try:
                item = next(it)
            except StopIteration:
                return
            _WAIT.observe((time.perf_counter_ns() - t0) // 1000)
            _BATCHES.inc()
            yield item
    finally:
        it.close()


def default_batchify_fn(data):
    """Stack samples into a batch: NDArrays stacked on their context,
    tuples batched field by field, anything else through numpy into a
    ``cpu()`` NDArray (float64 as float32)."""
    if isinstance(data[0], NDArray):
        return _wrap(torch.stack([d.data for d in data]), data[0].context)
    if isinstance(data[0], (tuple, list)):
        return tuple(default_batchify_fn(list(samples))
                     for samples in zip(*data))
    arr = onp.asarray(data)
    if arr.dtype == onp.float64:
        arr = arr.astype(onp.float32)
    return NDArray(arr, ctx=cpu())


default_mp_batchify_fn = default_batchify_fn


def _pinned(batch):
    """``batch`` with each CPU tensor moved to pinned memory."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_pinned(b) for b in batch)
    if isinstance(batch, NDArray) and batch.data.device.type == "cpu":
        return _wrap(batch.data.pin_memory(), batch.context)
    return batch


def _batch_seed(epoch_seed: int, epoch: int, pos: int) -> int:
    return int(onp.random.SeedSequence([epoch_seed, epoch, pos])
               .generate_state(1)[0])


class _Prefetcher:
    """Runs ``make_iter`` on a thread, at most ``num_prefetch`` items
    ahead; ``close`` stops it after the item it is making."""

    def __init__(self, make_iter, num_prefetch):
        self._make_iter = make_iter
        self._queue = queue.Queue(maxsize=max(1, num_prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self):
        it = self._make_iter()
        try:
            for item in it:
                if not self._put(("data", item)):
                    return
        except Exception as e:  # noqa: BLE001 — raised to the consumer
            self._put(("error", e))
            return
        finally:
            it.close()
        self._put(("end", None))

    def __iter__(self):
        while True:
            kind, item = self._queue.get()
            if kind == "data":
                yield item
            elif kind == "error":
                raise item
            else:
                return

    def close(self):
        self._stop.set()
        self._thread.join()


class DataLoader:
    """Mini-batches of a Dataset (``gluon.data.DataLoader``)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=False, timeout=120):
        self._dataset = dataset
        self._pin_memory = pin_memory and torch.cuda.is_available()
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * max(self._num_workers, 1))
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle must not be specified if sampler is")
            batch_sampler = BatchSampler(sampler, batch_size, last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise MXNetError("batch_size, shuffle, sampler and last_batch must "
                             "not be specified if batch_sampler is specified")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        # resume accounting: the epoch, the batches the consumer has
        # received in it (prefetch depth never counts), the numpy RNG state
        # at the epoch's start (the shuffle replays from it) and the
        # epoch's seed of the per-batch sample streams
        self._epoch = 0
        self._pos = 0
        self._resume_pos = 0
        self._epoch_rng = None
        self._epoch_seed = None
        # (epoch, batch index) pairs consumed from the sampler but never
        # yielded, so every other batch keeps its position
        self._quarantined = set()

    def _fetch_batch(self, indices, seed):
        with _random.sample_stream(seed):
            batch = self._batchify_fn([self._dataset[i] for i in indices])
        return _pinned(batch) if self._pin_memory else batch

    def _make_iter(self, skip: int, epoch: int, epoch_seed: int):
        it = iter(self._batch_sampler)
        # resume: skip consumed index batches without touching the dataset
        for _ in range(skip):
            if next(it, None) is None:
                return
        jobs = ((indices, _batch_seed(epoch_seed, epoch, pos))
                for pos, indices in enumerate(it, start=skip))
        if self._num_workers == 0:
            for indices, seed in jobs:
                yield self._fetch_batch(indices, seed)
            return
        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            pending = collections.deque()
            try:
                while True:
                    while len(pending) < max(1, self._prefetch):
                        job = next(jobs, None)
                        if job is None:
                            break
                        pending.append(pool.submit(self._fetch_batch, *job))
                    if not pending:
                        break
                    yield pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()

    def _epoch_iter(self):
        """The consumer's epoch, with resume accounting."""
        skip = self._resume_pos
        self._resume_pos = 0
        if skip and self._epoch_rng is not None:
            # mid-epoch resume: replay the shuffle from the epoch's start
            _random.numpy_rng().set_state(self._epoch_rng)
        elif not skip:
            self._epoch_rng = _random.numpy_rng().get_state()
            self._epoch_seed = None
        if self._epoch_seed is None:
            self._epoch_seed = _random.python_rng().getrandbits(31)
        self._pos = skip
        args = (skip, self._epoch, self._epoch_seed)
        prefetcher = None
        if self._num_workers > 0:
            prefetcher = _Prefetcher(lambda: self._make_iter(*args),
                                     self._prefetch)
            inner = iter(prefetcher)
        else:
            inner = self._make_iter(*args)
        try:
            for batch in inner:
                # counted before the yield: a batch the consumer holds is
                # consumed, and a state_dict taken now must not replay it
                self._pos += 1
                if (self._epoch, self._pos - 1) in self._quarantined:
                    continue
                yield batch
        finally:
            if prefetcher is not None:
                prefetcher.close()
        self._epoch += 1
        self._pos = 0
        self._epoch_rng = None
        self._epoch_seed = None

    def __iter__(self):
        return _timed_iter(self._epoch_iter())

    def __len__(self):
        return len(self._batch_sampler)

    # ------------------------------------------------------------------
    # resume and quarantine
    # ------------------------------------------------------------------
    def quarantine_batch(self, epoch: int, pos: int):
        """Exclude the batch that iteration of ``epoch`` yields at 0-based
        index ``pos``: it is consumed from the sampler, so every other
        batch keeps its position, but never yielded. Idempotent."""
        self._quarantined.add((int(epoch), int(pos)))

    @property
    def quarantined(self):
        return sorted(self._quarantined)

    def state_dict(self):
        """The iteration position: epoch, batches consumed in it, the
        epoch-start numpy RNG state (flattened to npz-friendly fields),
        the epoch's seed and the quarantined positions. After
        ``load_state_dict`` the next ``iter()`` yields exactly the
        batches the interrupted epoch had left."""
        st = {"kind": "DataLoader", "version": 1,
              "epoch": int(self._epoch), "pos": int(self._pos)}
        if self._quarantined:
            st["quarantined"] = onp.asarray(sorted(self._quarantined),
                                            dtype=onp.int64)
        if self._pos > 0 and self._epoch_rng is not None:
            name, keys, pos, has_gauss, cached = self._epoch_rng
            st.update(rng_name=str(name),
                      rng_keys=onp.asarray(keys, dtype=onp.uint32),
                      rng_pos=int(pos), rng_has_gauss=int(has_gauss),
                      rng_cached=float(cached),
                      sample_seed=int(self._epoch_seed))
        return st

    def load_state_dict(self, state):
        if state.get("kind") != "DataLoader":
            raise MXNetError(f"not a DataLoader state: {state.get('kind')!r}")
        self._epoch = int(state["epoch"])
        self._pos = int(state["pos"])
        self._resume_pos = self._pos
        if "rng_keys" in state:
            self._epoch_rng = (str(state["rng_name"]),
                               onp.asarray(state["rng_keys"], onp.uint32),
                               int(state["rng_pos"]),
                               int(state["rng_has_gauss"]),
                               float(state["rng_cached"]))
            # a state without one (the JAX package's) replays the order;
            # the transforms then draw from a fresh epoch seed
            seed = state.get("sample_seed")
            self._epoch_seed = None if seed is None else int(seed)
        else:
            self._epoch_rng = None
            self._epoch_seed = None
        q = state.get("quarantined")
        self._quarantined = set() if q is None else {
            (int(e), int(p)) for e, p in onp.asarray(q).reshape(-1, 2)}

    @property
    def epoch(self):
        return self._epoch
