"""Dynamic loss scaling, all on the device (counterpart of
:mod:`apex_tpu.amp.scaler`).

Reference: ``apex/amp/scaler.py:33-217`` (the Python ``LossScaler``)
and ``csrc/update_scale_hysteresis.cu:5-47`` (the device-side scale
update of the capturable optimizers).  As in the JAX package, the whole
amp tail stays on the device: :class:`ScalerState` holds 0-d tensors
(an fp32 scale, an int32 growth tracker, an int32 hysteresis),
``unscale`` returns the fp32 grads and an ``all_finite`` vote, and
``update`` is the hysteresis logic written branch-free in
``torch.where``.  Nothing is read back to the host, so a train step with
the scaler in it is captured whole as a CUDA graph
(:mod:`apex_tpu_torch.graphs`).  ``state_dict`` and ``load_state_dict``
are the host-side checkpoint forms.
"""

from typing import NamedTuple

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops.multi_tensor import all_finite
from apex_tpu_torch.optimizers.tree import tree_map

__all__ = ["ScalerState", "DynamicLossScaler", "StaticLossScaler", "all_finite"]


class ScalerState(NamedTuple):
    loss_scale: torch.Tensor      # 0-d fp32
    growth_tracker: torch.Tensor  # 0-d int32: consecutive finite steps
    hysteresis: torch.Tensor      # 0-d int32: overflows still tolerated


def _state(scale, tracker, hysteresis, device) -> ScalerState:
    dev = resolve_device(device)
    return ScalerState(torch.tensor(float(scale), dtype=torch.float32, device=dev),
                       torch.tensor(int(tracker), dtype=torch.int32, device=dev),
                       torch.tensor(int(hysteresis), dtype=torch.int32, device=dev))


def _scale_loss(state, loss):
    return tree_map(lambda l: l * state.loss_scale.to(l.dtype), loss)


def _unscale(state, grads):
    inv = torch.div(torch.ones_like(state.loss_scale), state.loss_scale)
    out = tree_map(lambda g: g.to(torch.float32) * inv, grads)
    return out, all_finite(out)


class DynamicLossScaler:
    """Device-side dynamic loss scaler.

    Defaults as ``apex.amp.scaler.LossScaler`` (init 2**16, factor 2,
    window 2000; ``apex/amp/scaler.py:38-60``) with the hysteresis of
    ``update_scale_hysteresis.cu`` (hysteresis=1 is the Python scaler)."""

    def __init__(self, init_scale: float = 2.0 ** 16, growth_factor: float = 2.0,
                 backoff_factor: float = 0.5, growth_interval: int = 2000,
                 hysteresis: int = 1, min_scale: float = 1.0,
                 max_scale: float = 2.0 ** 24):
        self.init_scale = float(init_scale)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.init_hysteresis = int(hysteresis)
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)

    def init(self, device="cuda") -> ScalerState:
        return _state(self.init_scale, 0, self.init_hysteresis, device)

    def scale(self, state: ScalerState, loss):
        """The loss times the scale (before the gradient; apex handle.py:113)."""
        return _scale_loss(state, loss)

    def unscale(self, state: ScalerState, grads):
        """``(grads in fp32 times 1/scale, all_finite)``: the fp16 -> fp32
        unscale of ``LossScaler.unscale`` (apex/amp/scaler.py:94-119) with
        the inf/nan vote over its result."""
        return _unscale(state, grads)

    def update(self, state: ScalerState, all_finite_flag) -> ScalerState:
        """``update_scale_hysteresis.cu:5-47``, branch-free:

        if not finite: hysteresis -= 1; if hysteresis <= 0: scale =
        max(scale * backoff, min), hysteresis reset; tracker = 0.
        else: tracker += 1; if tracker == interval: scale = min(scale *
        growth, max), tracker = 0; hysteresis reset."""
        scale, tracker, hyst = state
        finite = torch.as_tensor(all_finite_flag, device=scale.device).to(torch.bool)
        # the overflow branch
        new_hyst = hyst - 1
        backoff = new_hyst <= 0
        scale_of = torch.where(backoff, torch.clamp(scale * self.backoff_factor,
                                                    min=self.min_scale), scale)
        hyst_of = torch.where(backoff, self.init_hysteresis, new_hyst)
        # the finite branch
        new_tracker = tracker + 1
        grow = new_tracker >= self.growth_interval
        scale_ok = torch.where(grow, torch.clamp(scale * self.growth_factor,
                                                 max=self.max_scale), scale)
        tracker_ok = torch.where(grow, 0, new_tracker)
        return ScalerState(
            loss_scale=torch.where(finite, scale_ok, scale_of),
            growth_tracker=torch.where(finite, tracker_ok, torch.zeros_like(tracker)),
            hysteresis=torch.where(finite, torch.full_like(hyst, self.init_hysteresis),
                                   hyst_of))

    def state_dict(self, state: ScalerState) -> dict:
        """Reference: apex/amp/frontend.py:365-376 (``amp.state_dict``)."""
        return {"loss_scale": float(state.loss_scale),
                "growth_tracker": int(state.growth_tracker),
                "hysteresis": int(state.hysteresis)}

    def load_state_dict(self, d, device="cuda") -> ScalerState:
        return _state(d["loss_scale"], d["growth_tracker"],
                      d.get("hysteresis", self.init_hysteresis), device)


class StaticLossScaler:
    """A constant loss scale (the ``loss_scale=<float>`` opt of apex's
    front end)."""

    def __init__(self, scale: float = 1.0):
        self._scale = float(scale)

    def init(self, device="cuda") -> ScalerState:
        return _state(self._scale, 0, 0, device)

    def scale(self, state, loss):
        return _scale_loss(state, loss)

    def unscale(self, state, grads):
        return _unscale(state, grads)

    def update(self, state, all_finite_flag):
        return state

    def state_dict(self, state):
        return {"loss_scale": float(state.loss_scale)}

    def load_state_dict(self, d, device="cuda"):
        return _state(d["loss_scale"], 0, 0, device)
