"""Fused AdamW + stochastic weight averaging (counterpart of
:mod:`apex_tpu.contrib.openfold_triton.fused_adam_swa`; reference
``apex/contrib/openfold_triton/fused_adam_swa.py``: one kernel applying
the AdamW update and folding the result into an SWA copy, used in
OpenFold's training).

A step is the port's :class:`~apex_tpu_torch.optimizers.FusedAdam`
update (one ``mt_adam`` launch on the engine) and the SWA blend
``swa += w * (p - swa)`` over the updated params, whether the update
wrote them in place or returned new ones.  The SWA params are fp32
copies that never alias a param.  ``n_averaged`` counts only the steps
taken (``grads_finite`` true); the weight is ``1 / max(n, 1)`` (equal
average) or ``1 - swa_decay_rate``, and 0 on a skipped step, all
selected on the device: no host sync.
"""

from typing import Any, NamedTuple, Optional

import torch

from apex_tpu_torch.optimizers import base
from apex_tpu_torch.optimizers.fused_adam import AdamState, FusedAdam

__all__ = ["AdamSWAState", "FusedAdamSWA"]


class AdamSWAState(NamedTuple):
    adam: AdamState
    swa_params: Any
    n_averaged: torch.Tensor  # 0-d int32


class FusedAdamSWA(FusedAdam):
    """AdamW whose update also keeps an SWA average.
    ``swa_decay_rate``: the EMA coefficient; ``None`` = equal average."""

    #: the fused amp tail (``update_scaled``) would run the inherited Adam
    #: step without the SWA blend and count: use ``update``
    supports_update_scaled = False

    def __init__(self, *args, swa_decay_rate: Optional[float] = None, **kw):
        super().__init__(*args, **kw)
        self.swa_decay_rate = swa_decay_rate

    def init(self, params, bucketed: bool = False) -> AdamSWAState:
        adam = super().init(params, bucketed=bucketed)
        return AdamSWAState(
            adam=adam,
            swa_params=base.tree_map(lambda p: p.detach().to(torch.float32).clone(), params),
            n_averaged=torch.zeros((), dtype=torch.int32, device=adam.step.device))

    def update(self, grads, state: AdamSWAState, params, grads_finite=None, lr=None,
               inplace: bool = False, **kw):
        """One step; returns ``(new_params, new_state)``.  ``inplace``
        writes the params and the whole state (SWA copies and count
        too) over the given ones and returns them (the Adam state is
        written by ``FusedAdam``'s in-place update)."""
        new_params, adam_state = super().update(grads, state.adam, params,
                                                grads_finite=grads_finite, lr=lr,
                                                inplace=inplace, **kw)
        dev = state.n_averaged.device
        with torch.no_grad():
            took = (torch.ones((), dtype=torch.bool, device=dev) if grads_finite is None
                    else torch.as_tensor(grads_finite, device=dev).to(torch.bool))
            n = state.n_averaged + took.to(torch.int32)
            if self.swa_decay_rate is None:
                w = 1.0 / torch.clamp(n, min=1).to(torch.float32)  # equal average
            else:
                w = torch.full((), 1.0 - self.swa_decay_rate, dtype=torch.float32, device=dev)
            w = torch.where(took, w, 0.0)
            # swa + w * (p - swa), leaf by leaf, as multi-tensor ops
            s_leaves = base.tree_leaves(state.swa_params)
            diff = torch._foreach_sub([p.detach().to(torch.float32)
                                       for p in base.tree_leaves(new_params)], s_leaves)
            torch._foreach_mul_(diff, w)
            if inplace:
                torch._foreach_add_(s_leaves, diff)
                state.n_averaged.copy_(n)
                return new_params, state
            swa = base.tree_unflatten(state.swa_params, torch._foreach_add(s_leaves, diff))
        return new_params, AdamSWAState(adam=adam_state, swa_params=swa, n_averaged=n)
