"""The model-parallel grad scaler (counterpart of
:mod:`apex_tpu.transformer.amp.grad_scaler`).

Reference: ``apex/transformer/amp/grad_scaler.py:21-126``: a
``torch.cuda.amp.GradScaler`` whose only change is an all-reduce of
``found_inf`` over the model-parallel group in ``unscale_`` and
``update``, so that every rank agrees on skipping a step.  The JAX
package combines the vote over mesh axes; here the axes are
``torch.distributed`` process groups (or the ``AxisGroup`` handles of
:mod:`apex_tpu_torch.transformer.parallel_state`), combined by an
all-reduce MAX of the not-finite indicator.  The ZeRO optimizers agree
their vote over the data-parallel group through it.  With no groups (one
device) the vote is returned as it is; a one-rank axis of
``parallel_state`` (tp, pp here) has no group and adds no collective.
"""

from typing import Sequence

import torch

from apex_tpu_torch.amp.scaler import DynamicLossScaler, ScalerState

__all__ = ["GradScaler", "sync_found_inf"]


def sync_found_inf(grads_finite, groups: Sequence = ()):
    """Finite iff finite on every rank of every group in ``groups``
    (reference grad_scaler.py:49,102, a MAX all-reduce of found_inf); a
    0-d bool tensor.  With no groups, ``grads_finite`` unchanged."""
    if not groups:
        return grads_finite
    import torch.distributed as dist

    not_finite = 1.0 - torch.as_tensor(grads_finite).to(torch.float32).reshape(1)
    for group in groups:
        group = getattr(group, "group", group)  # an AxisGroup's ProcessGroup
        if group is None:
            continue
        dist.all_reduce(not_finite, op=dist.ReduceOp.MAX, group=group)
    return not_finite[0] == 0.0


class GradScaler(DynamicLossScaler):
    """A :class:`DynamicLossScaler` whose finite vote is agreed over the
    model-parallel process groups before the unscale's result is used."""

    def __init__(self, *args, model_parallel_groups: Sequence = (), **kw):
        super().__init__(*args, **kw)
        self.model_parallel_groups = tuple(model_parallel_groups)

    def unscale(self, state: ScalerState, grads):
        out, finite = super().unscale(state, grads)
        return out, sync_found_inf(finite, self.model_parallel_groups)
