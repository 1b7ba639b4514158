"""mxnet_tpu_torch.telemetry — the part of ``mxnet_tpu.telemetry`` the
serving tier reads: the per-tenant SLO monitor (``slo.py``), whose burn
rates drive the brownout ladder and the autoscaler.

The reference's metrics registry, tracing, flight recorder, goodput and
debug server are not ported yet (ROADMAP Q1.12); until then the monitor's
counters and gauges are plain attributes of its objectives.
"""
from __future__ import annotations

from . import slo
from .slo import MONITOR, Objective, SLOMonitor

__all__ = ["slo", "MONITOR", "Objective", "SLOMonitor"]
