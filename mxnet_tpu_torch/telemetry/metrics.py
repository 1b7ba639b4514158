"""Thread-safe metrics registry: Counter / Gauge / Histogram with labels
(the port of ``mxnet_tpu/telemetry/metrics.py``; pure Python, a copy of the
reference's so the port imports nothing of it).

Design (the TensorFlow-Serving / Prometheus client model, PAPERS.md: fleet
counters are what make a fast kernel stack operable):

  - one process-wide ``MetricsRegistry`` (``telemetry.REGISTRY``); subsystems
    get-or-create metric *families* at import time and bump pre-bound label
    children on the hot path — no dict lookup, no string formatting, one
    short lock per bump (same sink discipline as profiler/monitor).
  - metric names are linted at registration (``^mxtpu_[a-z0-9_]+$``, unique
    per process) so a rename can never silently break a dashboard.
  - ``snapshot()`` renders the whole registry as one JSON-able dict;
    ``prometheus_text()`` renders the text exposition format
    (``# HELP``/``# TYPE`` + samples) scrapable by any Prometheus agent.

Histograms use fixed log-spaced buckets (powers of two in microseconds by
default: 1 us .. ~17.9 min over 30 bounds) so p50/p95/p99 are recoverable at
~constant relative error without retaining samples, and every histogram in
the process shares the same bucket layout — cross-metric ratios stay honest.
"""
from __future__ import annotations

import json
import re
import threading
import time
from bisect import bisect_left
from collections.abc import Mapping
from typing import Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "DEFAULT_BUCKETS", "METRIC_NAME_RE", "Baseline", "CountView",
           "prometheus_from_snapshot"]

# dashboards key on metric names: lint them at registration, not at scrape
METRIC_NAME_RE = re.compile(r"^mxtpu_[a-z0-9_]+$")

# fixed log-spaced duration buckets: 2^(k/2) microseconds (ratio ~1.41,
# quantile error <=~19%), 1 us .. ~25 min over 62 bounds
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    round(2.0 ** (k / 2.0), 3) for k in range(62))


def _quantile_from_buckets(bounds: Sequence[float], counts: Sequence[int],
                           n: int, p: float, max_seen: float) -> float:
    """Approximate p-quantile (p in [0,100]) as the geometric midpoint of the
    bucket holding the rank; the +Inf bucket reports the observed max."""
    if n == 0:
        return 0.0
    rank = max(1, int(round(p / 100.0 * n)))
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank:
            if i >= len(bounds):          # +Inf overflow bucket
                return max_seen
            hi = bounds[i]
            lo = bounds[i - 1] if i > 0 else hi / 2.0
            return (lo * hi) ** 0.5
    return max_seen


class _Child:
    """One labeled time series. Base for counter/gauge children."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value


class _CounterChild(_Child):
    def inc(self, n: float = 1.0):
        if n < 0:
            raise MXNetError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n


class _GaugeChild(_Child):
    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0):
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0):
        with self._lock:
            self._value -= n


class _HistogramChild:
    __slots__ = ("_lock", "bounds", "counts", "n", "total", "min", "max")

    def __init__(self, bounds: Tuple[float, ...]):
        self._lock = threading.Lock()
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # last = +Inf overflow
        self.n = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    def observe(self, v: float):
        v = float(v)
        idx = bisect_left(self.bounds, v)
        with self._lock:
            self.counts[idx] += 1
            self.n += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def percentile(self, p: float) -> float:
        with self._lock:
            return _quantile_from_buckets(self.bounds, self.counts, self.n,
                                          p, self.max)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            n, total = self.n, self.total
            counts = list(self.counts)
            mx = self.max
            mn = self.min if n else 0.0
        return {
            "count": n,
            "sum": total,
            "mean": (total / n) if n else 0.0,
            "min": mn,
            "max": mx,
            "p50": _quantile_from_buckets(self.bounds, counts, n, 50, mx),
            "p95": _quantile_from_buckets(self.bounds, counts, n, 95, mx),
            "p99": _quantile_from_buckets(self.bounds, counts, n, 99, mx),
        }


class _MetricFamily:
    """A named metric plus its labeled children. ``labels()`` interns the
    child so hot paths bind it once and never re-resolve."""

    kind = "untyped"
    _child_cls = _CounterChild

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._default = self._make_child()
            self._children[()] = self._default
        else:
            self._default = None

    def _make_child(self):
        return self._child_cls()

    def labels(self, *labelvalues, **labelkv):
        if labelkv:
            try:
                labelvalues = tuple(str(labelkv[k]) for k in self.labelnames)
            except KeyError as e:
                raise MXNetError(
                    f"{self.name}: missing label {e.args[0]!r} "
                    f"(expects {self.labelnames})") from None
        else:
            labelvalues = tuple(str(v) for v in labelvalues)
        if len(labelvalues) != len(self.labelnames):
            raise MXNetError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {labelvalues}")
        child = self._children.get(labelvalues)
        if child is None:
            with self._lock:
                child = self._children.setdefault(labelvalues,
                                                  self._make_child())
        return child

    def _series(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    # unlabeled convenience passthroughs -----------------------------------
    def _default_child(self):
        if self._default is None:
            raise MXNetError(f"{self.name} is labeled {self.labelnames}; "
                             "call .labels(...) first")
        return self._default


class Counter(_MetricFamily):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, n: float = 1.0):
        self._default_child().inc(n)

    @property
    def value(self):
        return self._default_child().value


class Gauge(_MetricFamily):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, v: float):
        self._default_child().set(v)

    def inc(self, n: float = 1.0):
        self._default_child().inc(n)

    def dec(self, n: float = 1.0):
        self._default_child().dec(n)

    @property
    def value(self):
        return self._default_child().value


class Histogram(_MetricFamily):
    kind = "histogram"

    def __init__(self, name, help, labelnames=(), buckets=None):
        self.buckets = tuple(float(b) for b in (buckets or DEFAULT_BUCKETS))
        if list(self.buckets) != sorted(self.buckets):
            raise MXNetError(f"{name}: histogram buckets must be ascending")
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float):
        self._default_child().observe(v)

    def percentile(self, p: float) -> float:
        return self._default_child().percentile(p)

    def summary(self):
        return self._default_child().summary()


class MetricsRegistry:
    """Process-wide metric registry. get-or-create semantics: re-registering
    the same (name, kind, labelnames) returns the existing family, so every
    module can declare its metrics idempotently at import time."""

    def __init__(self):
        self._metrics: Dict[str, _MetricFamily] = {}
        self._lock = threading.Lock()

    # -- registration -------------------------------------------------------
    def _register(self, cls, name, help, labelnames, **kw) -> _MetricFamily:
        if not METRIC_NAME_RE.match(name):
            raise MXNetError(
                f"metric name {name!r} fails the lint "
                f"{METRIC_NAME_RE.pattern!r}: all metrics are namespaced "
                "mxtpu_ and lowercase so dashboards never break on a rename")
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (existing.kind != cls.kind
                        or existing.labelnames != tuple(labelnames)):
                    raise MXNetError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.labelnames}; got "
                        f"{cls.kind}{tuple(labelnames)}")
                return existing
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    # -- introspection ------------------------------------------------------
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str) -> Optional[_MetricFamily]:
        with self._lock:
            return self._metrics.get(name)

    def lint_names(self) -> List[str]:
        """Return lint violations (empty = clean). Registration already
        enforces the pattern; this re-checks the live registry so CI can
        assert the invariant end-to-end."""
        bad = []
        for name in self.names():
            if not METRIC_NAME_RE.match(name):
                bad.append(f"{name}: fails {METRIC_NAME_RE.pattern}")
        return bad

    # -- export -------------------------------------------------------------
    def snapshot(self) -> Dict:
        """The whole registry as one JSON-able dict."""
        out = {"ts": time.time(), "metrics": {}}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            series = []
            for labelvalues, child in m._series():
                entry = {"labels": dict(zip(m.labelnames, labelvalues))}
                if m.kind == "histogram":
                    entry.update(child.summary())
                    with child._lock:
                        # raw per-bucket counts (last = +Inf overflow): a
                        # snapshot file round-trips to full Prometheus
                        # exposition (tools/metrics_dump.py --prom)
                        entry["bucket_counts"] = list(child.counts)
                else:
                    entry["value"] = child.value
                series.append(entry)
            fam = {
                "type": m.kind, "help": m.help,
                "label_names": list(m.labelnames), "series": series,
            }
            if m.kind == "histogram":
                fam["bucket_bounds"] = list(m.buckets)
            out["metrics"][m.name] = fam
        return out

    def snapshot_json(self, **dumps_kw) -> str:
        return json.dumps(self.snapshot(), **dumps_kw)

    def prometheus_text(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for labelvalues, child in m._series():
                base = dict(zip(m.labelnames, labelvalues))
                if m.kind == "histogram":
                    with child._lock:
                        counts = list(child.counts)
                        n, total = child.n, child.total
                    cum = 0
                    for bound, c in zip(child.bounds, counts):
                        cum += c
                        lines.append(_sample(f"{m.name}_bucket",
                                             {**base, "le": _fmt(bound)}, cum))
                    lines.append(_sample(f"{m.name}_bucket",
                                         {**base, "le": "+Inf"}, n))
                    lines.append(_sample(f"{m.name}_sum", base, total))
                    lines.append(_sample(f"{m.name}_count", base, n))
                else:
                    lines.append(_sample(m.name, base, child.value))
        return "\n".join(lines) + "\n"

    def _reset_for_tests(self):
        """Drop every registered metric (tests only: instrumented modules
        re-create their families lazily via get-or-create)."""
        with self._lock:
            self._metrics.clear()


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r"\""))


def _sample(name: str, labels: Dict[str, str], value) -> str:
    if labels:
        inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                         for k, v in labels.items())
        return f"{name}{{{inner}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


def _fmt_value(v) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def prometheus_from_snapshot(snap: Dict) -> str:
    """Render a :meth:`MetricsRegistry.snapshot` dict (e.g. read back from a
    dump file) as Prometheus text exposition — the offline face of
    :meth:`MetricsRegistry.prometheus_text`."""
    lines: List[str] = []
    for name, fam in sorted(snap.get("metrics", {}).items()):
        kind = fam.get("type", "untyped")
        if fam.get("help"):
            lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
        lines.append(f"# TYPE {name} {kind}")
        bounds = fam.get("bucket_bounds", [])
        for s in fam.get("series", []):
            base = dict(s.get("labels", {}))
            if kind == "histogram":
                counts = s.get("bucket_counts", [])
                cum = 0
                for bound, c in zip(bounds, counts):
                    cum += c
                    lines.append(_sample(f"{name}_bucket",
                                         {**base, "le": _fmt(bound)}, cum))
                lines.append(_sample(f"{name}_bucket",
                                     {**base, "le": "+Inf"}, s.get("count", 0)))
                lines.append(_sample(f"{name}_sum", base, s.get("sum", 0.0)))
                lines.append(_sample(f"{name}_count", base, s.get("count", 0)))
            else:
                lines.append(_sample(name, base, s.get("value", 0)))
    return "\n".join(lines) + "\n"


class Baseline:
    """One owner's view of family children: each child's value less its
    value when the view was made. The family keeps the one running count;
    an owner whose name a process may reuse (an endpoint built again under
    the same name, a second store) reads its own share through this."""

    __slots__ = ("_children", "_base", "_lock")

    def __init__(self, children: Optional[Dict[str, object]] = None):
        self._lock = threading.Lock()
        self._children: Dict[str, object] = {}
        self._base: Dict[str, float] = {}
        for k, c in (children or {}).items():
            self.add(k, c)

    def add(self, key: str, child):
        """Track ``child`` under ``key`` from its value now (a label value
        first seen later, such as a new shed reason); returns the child."""
        with self._lock:
            if key not in self._children:
                self._children[key] = child
                self._base[key] = child.value
            return self._children[key]

    def __getitem__(self, key: str) -> float:
        return self._children[key].value - self._base[key]

    def __contains__(self, key: str) -> bool:
        return key in self._children

    def as_dict(self, cast=int) -> Dict[str, float]:
        with self._lock:
            keys = list(self._children)
        return {k: cast(self[k]) for k in keys}


class CountView(Mapping):
    """A read-only mapping over counters: of a one-label family, label value
    -> its child's count (a label never bumped is absent); or of a dict of
    children or unlabeled families, key -> count. Module-level tables that
    subsystems exposed before the registry read through it."""

    def __init__(self, source):
        self._source = source

    def _children(self) -> Dict[str, object]:
        if isinstance(self._source, dict):
            return self._source
        fam = self._source
        with fam._lock:
            return {k[0]: c for k, c in fam._children.items()}

    def __getitem__(self, key) -> int:
        return int(self._children()[str(key)].value)

    def __iter__(self):
        return iter(list(self._children()))

    def __len__(self) -> int:
        return len(self._children())

    def __repr__(self):
        return repr(dict(self))


# the process-wide default registry
REGISTRY = MetricsRegistry()
