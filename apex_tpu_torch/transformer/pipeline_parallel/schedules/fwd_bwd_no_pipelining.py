"""No-pipelining schedule: sequential microbatches with grad accumulation
(counterpart of
:mod:`apex_tpu.transformer.pipeline_parallel.schedules.fwd_bwd_no_pipelining`).

Reference: ``schedules/fwd_bwd_no_pipelining.py:23`` — run each
microbatch's forward and backward in turn, accumulating grads, each
microbatch's contribution divided by the number of microbatches
(common.py:305-309).  The path at pp = 1: the pipeline runtime
(:func:`~apex_tpu_torch.transformer.pipeline_parallel.schedules.
tick_schedule.pipelined_fwd_bwd`) over a one-rank group, so one loop
carries the microbatches at every pp.
"""

from typing import Callable

import torch

from apex_tpu_torch.transformer.parallel_state import PIPELINE_AXIS, AxisGroup

__all__ = ["forward_backward_no_pipelining"]


def forward_backward_no_pipelining(forward_step_func: Callable, batch, model=None, *,
                                   forward_only: bool = False, **kwargs):
    """``forward_step_func(params, microbatch) -> loss`` (a 0-d tensor).

    ``batch`` is a tree whose leaves lead with the microbatch index
    ``(M, ...)``; ``model`` is the param tree.  Returns
    ``(per-microbatch losses (M,), grads or None)``: the grads are the
    sum over microbatches of each one's gradient seeded with 1 / M,
    added in microbatch order into fp32 buffers, as the JAX package's
    scan adds them."""
    from apex_tpu_torch.transformer.pipeline_parallel.schedules.tick_schedule import (
        pipelined_fwd_bwd,
    )

    losses = []

    def post_fn(params, _, mb):
        loss = forward_step_func(params, mb)
        losses.append(loss.detach())
        return loss

    _, grads = pipelined_fwd_bwd(lambda params, mb: None, lambda chunk, x: None, post_fn,
                                 model, {}, batch, tensor_shape=(), dtype=torch.float32,
                                 axis_name=AxisGroup(PIPELINE_AXIS, None, 1, 0),
                                 forward_only=forward_only)
    return torch.stack(losses), None if forward_only else grads[0]
