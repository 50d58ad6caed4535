"""The ``amp.initialize`` front end, functional (counterpart of
:mod:`apex_tpu.amp.frontend`).

Reference: ``apex/amp/frontend.py:197-404`` and ``apex/amp/handle.py:16``
(``scale_loss``).  The reference changes models and optimizers in place;
here, as in the JAX package, :func:`initialize` returns the cast params
and an immutable :class:`Amp`, and :func:`value_and_grad` wraps a loss
function so that one call gives ``(loss, grads, new_scaler_state,
grads_finite)`` with the scaling done (``torch.autograd.grad`` of the
scaled loss, then the unscale and the scaler update).
"""

from typing import Any, Callable, NamedTuple, Optional

import torch

from apex_tpu_torch.amp.policy import Policy, get_policy
from apex_tpu_torch.amp.scaler import DynamicLossScaler, StaticLossScaler, all_finite
from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["Amp", "initialize", "value_and_grad", "state_dict", "load_state_dict",
           "master_params"]


class Amp(NamedTuple):
    """A policy and its scaler; the scaler's state is the caller's."""

    policy: Policy
    scaler: Any  # DynamicLossScaler | StaticLossScaler | None

    def init_state(self, num_losses: int = 1, device="cuda"):
        """One scaler state, or a list of ``num_losses`` of them
        (``amp.initialize(num_losses=)``, frontend.py:197: one
        ``LossScaler`` a loss)."""
        if self.scaler is None:
            return None if num_losses == 1 else [None] * num_losses
        if num_losses == 1:
            return self.scaler.init(device)
        return [self.scaler.init(device) for _ in range(num_losses)]

    def scale_loss(self, scaler_state, loss):
        """``with amp.scale_loss(loss, opt)`` (handle.py:16), functional."""
        if self.scaler is None:
            return loss
        return self.scaler.scale(scaler_state, loss)

    def unscale_grads(self, scaler_state, grads):
        if self.scaler is None:
            g32 = tree_map(lambda g: g.to(torch.float32), grads)
            return g32, all_finite(g32)
        return self.scaler.unscale(scaler_state, grads)

    def update_scaler(self, scaler_state, grads_finite):
        if self.scaler is None:
            return scaler_state
        return self.scaler.update(scaler_state, grads_finite)

    def state_dict(self, scaler_state):
        """apex/amp/frontend.py:365-376: one ``loss_scalerN`` a loss."""
        if self.scaler is None:
            return {}
        if isinstance(scaler_state, list):
            return {f"loss_scaler{i}": self.scaler.state_dict(s)
                    for i, s in enumerate(scaler_state)}
        return {"loss_scaler0": self.scaler.state_dict(scaler_state)}

    def load_state_dict(self, d, device="cuda"):
        if self.scaler is None or not d:
            return None
        if len(d) > 1:
            return [self.scaler.load_state_dict(d[f"loss_scaler{i}"], device)
                    for i in range(len(d))]
        return self.scaler.load_state_dict(d["loss_scaler0"], device)


def initialize(params, opt_level: str = "O1", half_dtype=None, loss_scale=None,
               init_scale: float = 2.0 ** 16, growth_interval: int = 2000,
               hysteresis: int = 1):
    """``(cast params, Amp)`` for an opt level: ``amp.initialize(models,
    optimizers, opt_level=...)`` (apex/amp/frontend.py:197) with the
    param tree in place of models and optimizers."""
    policy = get_policy(opt_level, half_dtype=half_dtype, loss_scale=loss_scale)
    if policy.loss_scale == "dynamic":
        scaler = DynamicLossScaler(init_scale=init_scale, growth_interval=growth_interval,
                                   hysteresis=hysteresis)
    elif policy.loss_scale is None:
        scaler = None
    else:
        scaler = StaticLossScaler(float(policy.loss_scale))
    amp = Amp(policy=policy, scaler=scaler)
    global _last_amp
    _last_amp = amp
    return policy.cast_params(params), amp


#: the last Amp :func:`initialize` made, so that :func:`state_dict` and
#: :func:`load_state_dict` take the reference's call shape (its global
#: ``_amp_state``, apex/amp/frontend.py:365-404); the scaler state stays
#: the caller's
_last_amp: Optional[Amp] = None


def state_dict(scaler_state, destination=None):
    """The checkpointable amp state (reference frontend.py:365)."""
    if _last_amp is None:
        raise RuntimeError("amp.initialize() has not been called")
    d = _last_amp.state_dict(scaler_state)
    if destination is not None:
        destination.update(d)
        return destination
    return d


def load_state_dict(d, device="cuda"):
    """The scaler state of a :func:`state_dict` (frontend.py:377), to pass
    to the train step."""
    if _last_amp is None:
        raise RuntimeError("amp.initialize() has not been called")
    return _last_amp.load_state_dict(d, device)


def master_params(opt_state):
    """The fp32 master params of an optimizer state (reference
    apex/amp/_amp_state.py ``master_params(optimizer)``): the leaves of
    its ``master`` field, none without master weights."""
    master = getattr(opt_state, "master", None)
    if master is None:
        return
    yield from tree_leaves(master)


def value_and_grad(amp: Amp, loss_fn: Callable, **grad_kwargs):
    """Mixed-precision value and gradient of ``loss_fn(params, *args)``:
    the loss is scaled by the current scale before ``torch.autograd.grad``
    (with ``grad_kwargs``) and the grads come back unscaled in fp32, with
    the new scaler state and the finite vote::

        loss, grads, scaler_state, finite = amp_vg(params, scaler_state, batch)
        params, opt_state = opt.update(grads, opt_state, params, grads_finite=finite)

    The gradient is taken at ``params``' values through leaves that
    share their storage; ``params`` themselves are not changed."""

    def wrapped(params, scaler_state, *args, **kwargs):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            scaled_loss = amp.scale_loss(
                scaler_state, loss_fn(tree_unflatten(params, leaves), *args, **kwargs))
            grads = torch.autograd.grad(scaled_loss, leaves, **grad_kwargs)
        grads, finite = amp.unscale_grads(scaler_state, tree_unflatten(params, list(grads)))
        scaled_loss = scaled_loss.detach()
        if amp.scaler is None:
            return scaled_loss, grads, scaler_state, finite
        loss = scaled_loss / scaler_state.loss_scale.to(scaled_loss.dtype)
        return loss, grads, amp.update_scaler(scaler_state, finite), finite

    return wrapped
