"""FP16_Optimizer, a master-weight wrapper around an optimizer
(counterpart of :mod:`apex_tpu.fp16_utils.fp16_optimizer`).

Reference: ``apex/fp16_utils/fp16_optimizer.py:13``: fp32 master params,
the scaled loss, the grads unscaled into the master, an optional clip,
the wrapped optimizer's step on the master and the copy back to the
half params, all skipped on overflow.  Functional, as in the JAX
package: the state is ``(inner, scaler)`` and :meth:`step` is the whole
sequence, predicated on the device.
"""

from typing import Any, NamedTuple, Optional

import torch

from apex_tpu_torch.amp.scaler import DynamicLossScaler, StaticLossScaler
from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_
from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map


class FP16OptimizerState(NamedTuple):
    inner: Any
    scaler: Any


class FP16_Optimizer:
    def __init__(self, init_optimizer, static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False, dynamic_loss_args: Optional[dict] = None,
                 verbose: bool = False):
        self.optimizer = init_optimizer
        if dynamic_loss_scale:
            self.loss_scaler = DynamicLossScaler(**(dynamic_loss_args or {}))
        else:
            self.loss_scaler = StaticLossScaler(static_loss_scale)

    def init(self, params) -> FP16OptimizerState:
        """The inner optimizer's state with master weights, and the scaler's
        state, on the params' device."""
        self.optimizer.master_weights = True
        inner = self.optimizer.init(params)
        if inner.master is None:
            inner = inner._replace(master=tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params))
        device = tree_leaves(params)[0].device
        return FP16OptimizerState(inner=inner, scaler=self.loss_scaler.init(device))

    def scale_loss(self, state: FP16OptimizerState, loss):
        """In place of the reference's ``optimizer.backward(loss)``."""
        return self.loss_scaler.scale(state.scaler, loss)

    def step(self, grads, state: FP16OptimizerState, params,
             max_grad_norm: Optional[float] = None):
        """unscale -> (clip) -> the inner step on the master -> the model
        dtype, the whole commit predicated on the grads' finiteness.
        Returns ``(new params, new state, finite)``."""
        g32, finite = self.loss_scaler.unscale(state.scaler, grads)
        if max_grad_norm is not None:
            g32, _ = clip_grad_norm_(g32, max_grad_norm)
        new_params, new_inner = self.optimizer.update(g32, state.inner, params,
                                                      grads_finite=finite)
        new_scaler = self.loss_scaler.update(state.scaler, finite)
        return new_params, FP16OptimizerState(inner=new_inner, scaler=new_scaler), finite

    def state_dict(self, state: FP16OptimizerState):
        """The scaler's state dict and the inner state as CPU tensors
        (fp16_optimizer.py ``state_dict``)."""
        return {"loss_scaler": self.loss_scaler.state_dict(state.scaler),
                "inner": tree_map(lambda x: x.detach().cpu(), state.inner)}

    def load_state_dict(self, d, device="cuda") -> FP16OptimizerState:
        from apex_tpu_torch._device import resolve_device

        dev = resolve_device(device)
        return FP16OptimizerState(
            inner=tree_map(lambda x: torch.as_tensor(x).to(dev), d["inner"]),
            scaler=self.loss_scaler.load_state_dict(d["loss_scaler"], dev))
