"""ModelEndpoint: a loaded model served in shape buckets on one device (the
port of ``mxnet_tpu/serving/endpoint.py``).

The JAX endpoint AOT-compiles one executable per batch bucket. PyTorch runs
eagerly, so "compiling" a bucket is a no-op here; ``warmup`` still runs
every bucket once, so the first request of each size pays no first-use cost
(kernel build, library heuristics, allocator growth), and seeds the
scheduler's per-bucket step-cost EWMA.

**Slots.** A batch step is split into ``prepare`` (host half) and
``execute`` (device half). ``prepare`` writes the batch into the staging
slot of its (bucket, parity): pinned host buffers (their ``.numpy()``
views take the request rows, the padding tail is zeroed) and device input
buffers allocated once, filled by ``copy_(..., non_blocking=True)`` on the
caller's current stream (the server's prep stream), after which it records
an event. ``execute`` makes its own stream wait on that event, runs the
forward and waits on an event recorded behind it (never a device-wide
synchronize: that would also wait for the next batch's copy). A slot's
host buffers are rewritten only after its last event (the copy's, then the
forward's) completed, so a slot being written is never one a queued or
running batch still reads. On the CPU the same code runs without streams
or pinned memory.

**Hot swap.** ``save_checkpoint`` writes the weights in the reference's
``CheckpointManager`` format with a recorded probe (a seeded batch and the
outputs these weights give for it); ``load_swap_source`` verifies a
checkpoint (either package's) and reads its weights; ``stage_weights``
copies them to fresh device tensors; ``validate_and_commit`` points the
model's parameters at the staged tensors, runs the probe (bitwise equal to
the recorded outputs, or finite without a probe) and keeps them, or points
back at the old ones and raises :class:`~.errors.HotSwapError`. Inside a
running server the validation and cutover run on the worker between two
batches (``InferenceServer.hot_swap``).
"""
from __future__ import annotations

import os
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import Context, DTypes, MXNetError, current_context
from .. import telemetry as _telemetry
from ..telemetry import memstats as _memstats
from . import bucketing
from .batcher import now_us
from .errors import HotSwapError
from .router import StepCostEWMA
from .stats import EndpointStats

__all__ = ["ModelEndpoint", "StagedBatch", "get_endpoint", "list_endpoints",
           "unregister"]

_HOT_SWAPS = _telemetry.counter(
    "mxtpu_serving_hot_swaps_total",
    "Weight hot-swap attempts by outcome: ok (staged, probe-validated, "
    "committed) / rolled_back (probe validation failed; old weights kept) / "
    "rejected (corrupt or mismatched checkpoint, refused before staging).",
    labelnames=("outcome",))

# name -> endpoint: the registry behind serving.stats()
_ENDPOINTS: Dict[str, "ModelEndpoint"] = {}
_REG_LOCK = threading.Lock()


def _count_swap(outcome: str):
    _HOT_SWAPS.labels(outcome).inc()


def wait_stream(stream) -> None:
    """Block the host until the work queued so far on ``stream`` is done,
    through an event recorded behind it (None: the CPU, nothing to wait)."""
    if stream is not None:
        ev = torch.cuda.Event()
        ev.record(stream)
        ev.synchronize()


class _Slot:
    """The staging buffers of one (bucket, parity): host tensors (pinned on
    the card) and their numpy views ``host``, the device tensors they are
    copied to, and ``fence``, the event that must complete before the host
    buffers may be rewritten (None: free)."""

    __slots__ = ("host_t", "host", "device", "fence")

    def __init__(self, host_t, device):
        self.host_t = host_t
        self.host = tuple(h.numpy() for h in host_t)
        self.device = device
        self.fence = None

    def wait(self):
        if self.fence is not None:
            self.fence.synchronize()


class StagedBatch(NamedTuple):
    """A prepared batch: the device inputs (``bucket`` rows each), the
    event behind their copy (None on the CPU) and the slot that holds
    them."""
    inputs: Tuple[torch.Tensor, ...]
    bucket: int
    ready: Optional[object]
    slot: _Slot


class ModelEndpoint:
    """A named, servable model.

    Parameters
    ----------
    name : str
        The endpoint's name; ``InferenceServer.submit`` addresses it and
        ``serving.stats()`` reports under it.
    block : torch.nn.Module
        The model, moved to the endpoint's device and put in eval mode.
        Cast it (``block.to(torch.bfloat16)``) before serving in bf16.
    input_shapes : shape | sequence of shapes
        Per-example shape (without the batch axis) of each model input.
    dtype : str | sequence of str
        Host dtype of each input; requests are cast on the host.
    max_batch_size : int
        Largest served batch; also the largest bucket.
    buckets : sequence of int, optional
        Ascending batch-size buckets (default: powers of two).
    ctx : Context, optional
        Device to serve from; default :func:`current_context`, which is
        ``gpu(0)``. A GPU context without CUDA raises MXNetError.
    """

    #: devices one replica of this endpoint occupies (the weight
    #: ServingPool.submit divides queue load by)
    capacity = 1

    def __init__(self, name: str, block, input_shapes, dtype="float32",
                 max_batch_size: int = 32,
                 buckets: Optional[Sequence[int]] = None,
                 ctx: Optional[Context] = None):
        self.name = name
        self.ctx = ctx if ctx is not None else current_context()
        self.device = self.ctx.torch_device()
        self.max_batch_size = int(max_batch_size)
        if self.max_batch_size < 1:
            raise MXNetError("max_batch_size must be >= 1")
        self.buckets = bucketing.validate_buckets(
            buckets if buckets is not None
            else bucketing.pow2_buckets(self.max_batch_size),
            self.max_batch_size)
        if input_shapes and isinstance(input_shapes[0], int):
            input_shapes = (input_shapes,)
        self.input_shapes: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(int(d) for d in s) for s in input_shapes)
        dts = tuple(dtype) if isinstance(dtype, (list, tuple)) \
            else (dtype,) * len(self.input_shapes)
        if len(dts) != len(self.input_shapes):
            raise MXNetError("one dtype per input required")
        self.np_dtypes = tuple(DTypes.numpy(d) for d in dts)
        self.block = block.to(self.device).eval()
        self.stats = EndpointStats(name)
        self.step_cost = StepCostEWMA(name=name)
        self.prep_cost = StepCostEWMA()     # host prep per bucket (us)
        self._lock = threading.Lock()
        self._warm = set()
        self._slots: Dict[Tuple[int, int], _Slot] = {}
        self._weights_epoch = 0
        self._probe()
        # device-memory attribution: the served weights and the staging
        # slots' device buffers, sized live at every reconcile
        label = _memstats.device_label(self.device)
        _memstats.register(
            "serving", f"{self.name}.params", owner=self, device=label,
            sizer=lambda ep: _memstats.nbytes_of(
                [t for _, t in ep._weights()]))
        _memstats.register(
            "serving", f"{self.name}.parity_bufs", owner=self, device=label,
            sizer=lambda ep: _memstats.nbytes_of(
                [slot.device for slot in list(ep._slots.values())]))
        with _REG_LOCK:
            _ENDPOINTS[name] = self

    # ------------------------------------------------------------------
    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    def _stream(self):
        return torch.cuda.current_stream(self.device) if self._on_card() \
            else None

    def _zeros_batch(self, rows: int):
        return tuple(np.zeros((rows,) + s, dt)
                     for s, dt in zip(self.input_shapes, self.np_dtypes))

    def _forward(self, device_inputs) -> Tuple[torch.Tensor, ...]:
        with torch.inference_mode():
            out = self.block(*device_inputs)
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)

    def _probe(self):
        """One forward of a one-row zero batch: validates the input
        signature and records the output arity for per-request slicing."""
        outs = self._forward(self._place(self._zeros_batch(1)))
        wait_stream(self._stream())
        self.stats.bump("warmup_batches")
        for o in outs:
            if not (isinstance(o, torch.Tensor) and o.dim() and o.shape[0] == 1):
                raise MXNetError(
                    f"endpoint {self.name!r}: every model output must be "
                    "batch-major (leading axis = batch) so per-request rows "
                    f"can be sliced back out; got {getattr(o, 'shape', o)}")
        self.num_outputs = len(outs)

    def _place(self, arrays):
        """Host -> device copy of arrays outside the slots (probe, warm-up,
        hot-swap probes)."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in arrays)

    def warmup(self) -> int:
        """Run every not-yet-warm bucket once, timed into the step-cost
        EWMA and ``compiles``; returns how many ran."""
        n = 0
        for b in self.buckets:
            if b in self._warm:
                continue
            ins = self._place(self._zeros_batch(b))
            t0 = now_us()
            self._forward(ins)
            wait_stream(self._stream())
            dt = now_us() - t0
            self.step_cost.observe(b, dt)
            self.stats.record_compile(dt)
            self.stats.bump("warmup_batches")
            self._warm.add(b)
            n += 1
        return n

    # ------------------------------------------------------------------
    # prepare (host half) / execute (device half)
    # ------------------------------------------------------------------
    def _slot(self, bucket: int, parity: int) -> _Slot:
        key = (int(bucket), int(parity))
        with self._lock:
            slot = self._slots.get(key)
            if slot is None:
                pin = self._on_card()
                host = tuple(torch.zeros((bucket,) + s,
                                         dtype=torch.from_numpy(
                                             np.zeros(0, dt)).dtype,
                                         pin_memory=pin)
                             for s, dt in zip(self.input_shapes,
                                              self.np_dtypes))
                slot = self._slots[key] = _Slot(host,
                                                self._device_buffers(host))
            return slot

    def _device_buffers(self, host):
        """The device input buffers of a slot whose host tensors are
        ``host`` (a sharded endpoint keeps one set a context)."""
        return tuple(torch.empty_like(h, device=self.device) for h in host)

    def _upload(self, slot: _Slot):
        """Copy a slot's host tensors to its device buffers on the current
        stream; returns the event behind the copy (None on the CPU)."""
        for d, h in zip(slot.device, slot.host_t):
            d.copy_(h, non_blocking=True)
        if not self._on_card():
            return None
        ready = torch.cuda.Event()
        ready.record(self._stream())
        return ready

    def _wait_ready(self, staged: StagedBatch):
        """Make the forward's stream wait for the batch's copy."""
        if staged.ready is not None:
            self._stream().wait_event(staged.ready)

    def staging_buffers(self, bucket: int, parity: int):
        """The host staging arrays of one (bucket, parity) slot, once the
        slot's last batch no longer reads them: the prep stage writes
        request rows straight into them and zeroes the padding tail."""
        slot = self._slot(bucket, parity)
        slot.wait()
        return slot.host

    def prepare(self, host_inputs: Sequence[np.ndarray], rows: int,
                parity: int = 0) -> StagedBatch:
        """Host half of a batch step: put ``rows`` rows of each input into
        the (bucket, ``parity``) slot (in place when ``host_inputs`` are
        that slot's staging arrays, as the server's prep writes them; else,
        from :meth:`run_batch`, copied there with a zeroed tail) and copy
        the slot to its device buffers on the current stream."""
        bucket = bucketing.bucket_for(rows, self.buckets)
        slot = self._slot(bucket, parity)
        if any(h is not a for h, a in zip(slot.host, host_inputs)):
            slot.wait()
            for h, a in zip(slot.host, host_inputs):
                h[:rows] = a[:rows]
                h[rows:] = 0
        ready = self._upload(slot)
        if ready is not None:
            slot.fence = ready
        return StagedBatch(slot.device, bucket, ready, slot)

    def execute(self, staged: StagedBatch, rows: int):
        """Device half: one forward over a prepared slot on the current
        stream, waited for through an event behind it. Returns the outputs
        with ``bucket`` rows each."""
        stream = self._stream()
        # child of the caller's serving.batch span (same thread): the trace
        # id stamped at submit reaches the device step; its duration waits
        # for the forward's event, as the step does
        with _telemetry.span("serving.device_step", endpoint=self.name,
                             bucket=staged.bucket, rows=rows):
            t0 = now_us()
            self._wait_ready(staged)
            outs = self._forward(staged.inputs)
            if stream is not None:
                done = torch.cuda.Event()
                done.record(stream)
                staged.slot.fence = done
                done.synchronize()
            dt = now_us() - t0
        self.step_cost.observe(staged.bucket, dt)
        self.stats.record_step(dt)
        self.stats.bump("cache_hits")
        self.stats.bump("batches")
        self.stats.bump("real_rows", rows)
        self.stats.bump("padded_rows", staged.bucket - rows)
        return outs

    def run_batch(self, host_inputs: Sequence[np.ndarray], rows: int):
        """Serial prepare-then-execute on the current stream; returns
        ``(outputs, bucket)``."""
        staged = self.prepare(host_inputs, rows)
        return self.execute(staged, rows), staged.bucket

    # ------------------------------------------------------------------
    # zero-downtime weight hot swap
    # ------------------------------------------------------------------
    @property
    def weights_epoch(self) -> int:
        """Hot-swap generation of the weights being served."""
        return self._weights_epoch

    def _weights(self):
        """(name, tensor) of every weight, in the reference's positional
        order: ``collect_params()`` for a Gluon block, else parameters then
        buffers."""
        if hasattr(self.block, "collect_params"):
            return [(n, p.data()._data)
                    for n, p in self.block.collect_params().items()]
        return list(self.block.named_parameters()) + \
            list(self.block.named_buffers())

    def _probe_inputs(self, bucket: int, seed: int):
        """The probe batch: the reference's seeded standard-normal draw;
        integer inputs (token ids) take its sign bit, 0 or 1, ids every
        embedding holds."""
        rng = np.random.RandomState(seed & 0x7FFFFFFF)
        out = []
        for s, dt in zip(self.input_shapes, self.np_dtypes):
            a = rng.standard_normal((bucket,) + s)
            out.append((a > 0).astype(dt) if np.issubdtype(dt, np.integer)
                       else a.astype(dt))
        return tuple(out)

    def _host_outputs(self, outs):
        from ..resilience.checkpoint import host_array
        return [host_array(o) for o in outs]

    def save_checkpoint(self, manager, step: int, probe_seed: int = 0):
        """Write the served weights as a serving checkpoint
        (``CheckpointManager`` layout, the reference's ``model`` component)
        with a recorded probe: a seeded smallest-bucket batch and the
        outputs these weights give for it. Runs a forward on the caller's
        thread: call it on a stopped endpoint, or from the producer's own
        endpoint."""
        from ..resilience.checkpoint import host_array
        bucket = self.buckets[0]
        probe_in = self._probe_inputs(bucket, probe_seed)
        outs = self._forward(self._place(probe_in))
        wait_stream(self._stream())
        self.stats.bump("swap_probes")
        weights = self._weights()
        state = {
            "meta": {"format": 1},
            "model": {"n_params": len(weights),
                      "param_names": ",".join(n for n, _ in weights),
                      "params": {f"p{i}": host_array(t)
                                 for i, (_, t) in enumerate(weights)}},
            "serving": {
                "bucket": int(bucket), "probe_seed": int(probe_seed),
                "probe": {f"i{i}": a for i, a in enumerate(probe_in)},
                "expected": {f"o{i}": a for i, a in
                             enumerate(self._host_outputs(outs))}}}
        return manager.save(step, state=state)

    def load_swap_source(self, source):
        """Resolve a hot-swap source into ``(host_params, probe, label)``
        without touching the served weights. ``source`` is a checkpoint
        directory (one ``ckpt-*`` directory, or a CheckpointManager root:
        its newest intact checkpoint), every file checksum-verified, or a
        state tree. Raises HotSwapError on corruption or a model
        mismatch."""
        from ..resilience.checkpoint import verify_checkpoint_dir
        label = "<state>"
        state = None
        if isinstance(source, str):
            label = source
            try:
                if os.path.isfile(os.path.join(source, "MANIFEST.json")):
                    state = verify_checkpoint_dir(source)
                else:
                    names = sorted(n for n in os.listdir(source)
                                   if n.startswith("ckpt-"))
                    for name in reversed(names):
                        try:
                            state = verify_checkpoint_dir(
                                os.path.join(source, name))
                        except (MXNetError, OSError, ValueError):
                            continue
                        label = os.path.join(source, name)
                        break
            except (MXNetError, OSError, ValueError) as e:
                _count_swap("rejected")
                raise HotSwapError(
                    f"cannot read swap source {source!r}: {e}") from e
            if state is None:
                _count_swap("rejected")
                raise HotSwapError(
                    f"no intact checkpoint under {source!r}: every candidate "
                    "failed checksum verification")
        elif isinstance(source, dict):
            state = source
        else:
            raise HotSwapError(
                f"unsupported hot_swap source {type(source).__name__}; pass "
                "a checkpoint directory or a state tree")
        mod = state.get("model")
        if mod is None:
            _count_swap("rejected")
            raise HotSwapError(f"swap source {label} has no 'model' "
                               f"component (holds {sorted(state)})")
        weights = self._weights()
        try:
            n = int(mod["n_params"])
            if n != len(weights):
                raise HotSwapError(
                    f"checkpoint holds {n} params, endpoint {self.name!r} "
                    f"serves {len(weights)} ({mod.get('param_names')})")
            host = []
            for i, (_, t) in enumerate(weights):
                arr = np.asarray(mod["params"][f"p{i}"])
                if tuple(arr.shape) != tuple(t.shape):
                    raise HotSwapError(
                        f"checkpoint param {i} shape {arr.shape} != endpoint "
                        f"param shape {tuple(t.shape)}")
                host.append(arr)
        except (KeyError, TypeError, ValueError) as e:
            _count_swap("rejected")
            raise HotSwapError(f"malformed swap source {label}: {e!r}") from e
        except HotSwapError:
            _count_swap("rejected")
            raise
        return host, state.get("serving"), label

    def stage_weights(self, host_params):
        """Copy a weight set to fresh device tensors in the served dtypes
        (the served weights are untouched) and wait for the copy."""
        staged = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=t.dtype)
            for a, (_, t) in zip(host_params, self._weights()))
        wait_stream(self._stream())
        return staged

    def validate_and_commit(self, staged, probe=None) -> dict:
        """Point the model's weights at ``staged``, run the probe (outputs
        bitwise equal to the recorded ones; without a probe, finite) and
        keep them; on any failure point back at the old weights and raise
        HotSwapError. Call it between batches (the server's worker)."""
        if probe is not None:
            bucket = int(probe["bucket"])
            ins_h = [np.asarray(probe["probe"][f"i{i}"])
                     for i in range(len(self.input_shapes))]
            expected = [np.asarray(probe["expected"][f"o{i}"])
                        for i in range(self.num_outputs)]
            for i, a in enumerate(ins_h):
                if np.issubdtype(a.dtype, np.integer) and a.size and \
                        a.min() < 0:
                    # a negative id is no index here, and on the card an
                    # out-of-range gather poisons the CUDA context
                    _count_swap("rolled_back")
                    raise HotSwapError(
                        f"probe input {i} holds negative ids (a probe "
                        "recorded by another implementation); rolled back "
                        "(old weights keep serving)")
        else:
            bucket = self.buckets[0]
            ins_h = list(self._zeros_batch(bucket))
            expected = None
        tensors = [t for _, t in self._weights()]
        old = [t.data for t in tensors]
        for t, s in zip(tensors, staged):
            t.data = s
        try:
            outs_h = self._host_outputs(self._forward(self._place(ins_h)))
            self.stats.bump("swap_probes")
            if expected is not None:
                for i, (got, want) in enumerate(zip(outs_h, expected)):
                    if got.shape != want.shape or not np.array_equal(got,
                                                                     want):
                        raise HotSwapError(
                            f"probe output {i} does not match the recorded "
                            "outputs of the checkpointed weights; rolled "
                            "back (old weights keep serving)")
            else:
                for i, got in enumerate(outs_h):
                    if not np.all(np.isfinite(got)):
                        raise HotSwapError(
                            f"probe output {i} contains non-finite values; "
                            "rolled back (old weights keep serving)")
        except Exception as e:
            for t, o in zip(tensors, old):
                t.data = o
            _count_swap("rolled_back")
            if isinstance(e, HotSwapError):
                raise
            raise HotSwapError(
                f"staged weights failed the probe execution: {e}") from e
        self._weights_epoch += 1
        self.stats.bump("hot_swaps")
        _count_swap("ok")
        return {"endpoint": self.name, "weights_epoch": self._weights_epoch,
                "probe": "recorded" if probe is not None else "finite",
                "bucket": bucket}

    def hot_swap(self, source) -> dict:
        """Inline hot swap for an endpoint no running server serves: load
        and verify ``source``, stage, probe, cut over (HotSwapError rolls
        back). Inside a running InferenceServer use
        ``server.hot_swap(name, source)``."""
        host, probe, label = self.load_swap_source(source)
        report = self.validate_and_commit(self.stage_weights(host), probe)
        report["source"] = label
        return report

    def __repr__(self):
        return (f"ModelEndpoint({self.name!r}, inputs={self.input_shapes}, "
                f"buckets={self.buckets}, device={self.device})")


def get_endpoint(name: str) -> ModelEndpoint:
    with _REG_LOCK:
        if name not in _ENDPOINTS:
            raise MXNetError(f"unknown endpoint {name!r}; registered: "
                             f"{sorted(_ENDPOINTS)}")
        return _ENDPOINTS[name]


def list_endpoints():
    with _REG_LOCK:
        return sorted(_ENDPOINTS)


def unregister(name: str):
    with _REG_LOCK:
        _ENDPOINTS.pop(name, None)
