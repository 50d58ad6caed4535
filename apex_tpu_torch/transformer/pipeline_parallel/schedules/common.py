"""Pipeline schedule building blocks (counterpart of
:mod:`apex_tpu.transformer.pipeline_parallel.schedules.common`).

Reference: ``apex/transformer/pipeline_parallel/schedules/common.py`` —
``build_model`` (:30), ``forward_step`` / ``backward_step`` (:253,
:325).  The JAX package's forward-only :func:`pipelined_apply` is a scan
of ticks with a ``ppermute`` ring; here each rank runs its stage on
every microbatch in turn, receiving from the previous stage and sending
to the next (:mod:`~apex_tpu_torch.transformer.pipeline_parallel.
p2p_communication`).  :func:`broadcast_from_last_stage` gives the last
stage's value to every stage, its backward the cotangent to the last
stage only.
"""

from typing import Callable

import torch

from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication as p2p

__all__ = ["pipelined_apply", "broadcast_from_last_stage", "build_model"]


def pipelined_apply(stage_fn, stage_params, mb_inputs, axis_name=None):
    """Run microbatched inputs through the P-stage pipeline, forward only.

    ``mb_inputs``: ``(M, ...)`` activations fed to stage 0;
    ``stage_fn(stage_params, x) -> y`` is this stage's chunk, with the
    same activation shape in and out.  Returns ``(M, ...)`` outputs, the
    pipeline's on the LAST stage and zeros elsewhere (combine with
    :func:`broadcast_from_last_stage`).  ``axis_name``: the pipeline's
    ``AxisGroup`` (default the registered one)."""
    group = p2p._group(axis_name)
    P, rank = group.size(), group.rank()
    out = torch.zeros_like(mb_inputs)
    shape, dtype, dev = tuple(mb_inputs.shape[1:]), mb_inputs.dtype, mb_inputs.device
    for m in range(mb_inputs.shape[0]):
        x = mb_inputs[m] if rank == 0 else p2p.recv_forward(shape, dtype, dev, group)
        y = stage_fn(stage_params, x)
        if rank < P - 1:
            p2p.send_forward(y, group)
        else:
            out[m] = y
    return out


class _FromLast(torch.autograd.Function):
    """The last stage's ``x`` on every stage of the group; the backward
    keeps the cotangent on the last stage and gives zeros elsewhere."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.last = group.rank() == group.size() - 1
        out = x.detach().clone().contiguous()
        if group.size() > 1:
            dist.broadcast(out, group.ranks[-1], group=group.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def broadcast_from_last_stage(x, axis_name=None):
    """The last stage's ``x`` on every stage (the pp analog of the
    reference's embedding-group broadcast, parallel_state.py:50-56); the
    backward routes the cotangent to the last stage only.  ``axis_name``:
    the pipeline's ``AxisGroup`` (default the registered one)."""
    group = p2p._group(axis_name)
    return _FromLast.apply(x, group)


def build_model(model_provider_func: Callable, wrap_with_ddp: bool = True,
                virtual_pipeline_model_parallel_size=None, **kwargs):
    """Reference: schedules/common.py:30, the model chunks of this rank:
    one, or ``virtual_pipeline_model_parallel_size`` for the interleaved
    schedule, each ``model_provider_func(**kwargs)`` (the provider reads
    the stage from ``parallel_state``).  The DDP wrap is the train step's
    grad sync here, so ``wrap_with_ddp`` changes nothing."""
    if virtual_pipeline_model_parallel_size is None:
        return [model_provider_func(**kwargs)]
    return [model_provider_func(**kwargs) for _ in range(virtual_pipeline_model_parallel_size)]
