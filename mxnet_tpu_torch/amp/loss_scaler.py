"""Dynamic loss scaling of the port (the counterpart of
``mxnet_tpu/amp/loss_scaler.py``): the same state machine, scale 2^16
halved on an overflow (never below 1) and doubled after ``scale_window``
good steps in a row.

The overflow check is one on-device finite flag over every gradient:
``launch_check_overflow`` computes the inf-norm of all of them with one
multi-tensor call (a NaN or an inf anywhere makes its norm non-finite) and
reduces them to one boolean on the device, without reading it;
``wait_and_update`` reads it, the one host synchronisation of the check.
``observe_finite_flag`` adopts a flag the caller computed itself: a
``resilience.NumericsGuard`` given ``loss_scaler=`` hands it the finite
flag its train step computes anyway, so no second reduction runs.
``state_dict``/``load_state_dict`` carry the scale and the good-step
counter, so a resumed run keeps its place in the scale window
(``resilience.CheckpointManager.save(step, loss_scaler=...)``).
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["LossScaler"]


def _leaves(params):
    """The gradient tensors of ``params`` (Parameters, NDArrays or
    tensors); a row-sparse gradient contributes its stored rows (its
    ``_data``)."""
    out = []
    for p in params:
        g = p.grad() if callable(getattr(p, "grad", None)) else p
        out.append(g._data if hasattr(g, "_data") else g)
    return out


def all_finite(tensors):
    """One on-device boolean: every element of every tensor is finite."""
    if not tensors:
        return None
    norms = torch._foreach_norm(list(tensors), float("inf"))
    return torch.isfinite(torch.stack([n.float() for n in norms])).all()


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0
        self._overflow = False
        self._pending = None       # the unread on-device finite flag

    def launch_check_overflow(self, params):
        """Start the finite check over every gradient of ``params``;
        returns the on-device flag without reading it."""
        self._pending = all_finite(_leaves(params))
        return self._pending

    def observe_finite_flag(self, flag):
        """Adopt an on-device finite flag computed elsewhere."""
        self._pending = flag

    def _resolve(self):
        if self._pending is not None:
            self._overflow = not bool(self._pending)   # the one read
            self._pending = None

    def wait_and_update(self):
        """Read the pending flag and update the scale; True when the step
        is to be skipped."""
        self._resolve()
        if self._overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
            self._overflow = False
            return True
        self._unskipped += 1
        if self._unskipped == self._scale_window:
            self.loss_scale *= self._scale_factor
            self._unskipped = 0
        return False

    def has_overflow(self, params):
        """Launch the check and read it at once."""
        self.launch_check_overflow(params)
        self._resolve()
        return self._overflow

    def state_dict(self):
        return {"kind": "LossScaler", "version": 1,
                "loss_scale": float(self.loss_scale),
                "scale_factor": float(self._scale_factor),
                "scale_window": int(self._scale_window),
                "unskipped": int(self._unskipped)}

    def load_state_dict(self, state):
        if state.get("kind") != "LossScaler":
            raise MXNetError(f"not a LossScaler state: {state.get('kind')!r}")
        self.loss_scale = float(state["loss_scale"])
        self._scale_factor = float(state["scale_factor"])
        self._scale_window = int(state["scale_window"])
        self._unskipped = int(state["unskipped"])
        self._overflow = False
        self._pending = None
