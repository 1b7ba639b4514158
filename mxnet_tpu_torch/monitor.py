"""Per-tensor statistics monitor of the port (the counterpart of
``mxnet_tpu/monitor.py``; MXNet's ``python/mxnet/monitor.py`` Monitor —
interval/stat_func/pattern/sort/monitor_all, install/tic/toc/toc_print).

A ``Monitor`` is a sink of ``(step, name, stat)`` samples kept per name.
Its sources push into it and never wait:

* bound executors: ``Executor.set_monitor_callback`` feeds each op's
  outputs as the DAG is walked (``<node>_output``, and ``<node>_input<i>``
  with ``monitor_all``);
* parameters and auxiliary states: read from each installed executor's
  ``arg_dict``/``aux_dict`` when a window closes.

A stat stays a small tensor on the array's device (one reduction queued on
its stream) until ``toc`` renders the window, which is where the host
first waits for the card.
"""
from __future__ import annotations

import logging
import re
from collections import OrderedDict

__all__ = ["Monitor"]


def _mean_abs(x):
    """Default statistic: mean absolute value, as an on-device scalar."""
    from . import ndarray as F
    return F.norm(x) / (x.size ** 0.5)


def _render(stat):
    """Format one captured stat (NDArray | list of NDArray) as the tab-joined
    string surface the reference's log readers expect."""
    from .ndarray.ndarray import NDArray
    vals = stat if isinstance(stat, (list, tuple)) else [stat]
    pieces = []
    for v in vals:
        if isinstance(v, NDArray):
            v = v.asscalar() if v.size == 1 else v.asnumpy()
        pieces.append(str(v))
    return "\t".join(pieces) + "\t"


class Monitor:
    """Watch outputs, weights and gradients of bound executors.

    ``interval`` — tic calls between open collection windows; ``stat_func`` —
    statistic per tensor (default mean absolute value); ``pattern`` — regex
    filter on tensor names; ``sort`` — render channels in name order;
    ``monitor_all`` — record op inputs too, not only outputs.
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 monitor_all=False):
        self.interval = interval
        self.stat_func = stat_func or _mean_abs
        self.sort = sort
        self.monitor_all = monitor_all
        self.re_prog = re.compile(pattern)
        self.step = 0
        self.activated = False       # window state; public for parity
        self._channels: "OrderedDict[str, list]" = OrderedDict()
        self._sources = []           # installed executors (param snapshots)

    # -- sink --------------------------------------------------------------
    def _capture(self, name, array):
        """Record one sample if the window is open and the name matches."""
        if not (self.activated and self.re_prog.match(name)):
            return
        from . import autograd
        with autograd.pause():       # stat reductions stay off the grad tape
            stat = self.stat_func(array)
        self._channels.setdefault(name, []).append((self.step, stat))

    # -- sources -----------------------------------------------------------
    def install(self, exe):
        """Attach a bound Executor as a sample source."""
        exe.set_monitor_callback(self._capture, self.monitor_all)
        self._sources.append(exe)

    def _snapshot_params(self):
        """Push one sample per matching argument/aux of every source."""
        for exe in self._sources:
            for mapping in (exe.arg_dict, exe.aux_dict):
                for name, arr in mapping.items():
                    self._capture(name, arr)

    # -- window control ----------------------------------------------------
    def tic(self):
        """Advance one step; open a collection window every `interval` steps."""
        if self.step % self.interval == 0:
            self._channels.clear()
            self.activated = True
        self.step += 1

    def toc(self):
        """Close the window and render it: list of (step, name, stat-string)."""
        if not self.activated:
            return []
        self._snapshot_params()
        self.activated = False
        names = sorted(self._channels) if self.sort else list(self._channels)
        rows = [(step, name, _render(stat))
                for name in names
                for step, stat in self._channels[name]]
        self._channels.clear()
        return rows

    def toc_print(self):
        """Close the window and log every rendered row."""
        for step, name, text in self.toc():
            logging.info("Batch: %7d %30s %s", step, name, text)
