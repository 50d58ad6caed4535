"""The pipelined schedule over the pipeline group, 1F1B (counterpart of
:mod:`apex_tpu.transformer.pipeline_parallel.schedules.fwd_bwd_pipelining_without_interleaving`).

Reference: ``schedules/fwd_bwd_pipelining_without_interleaving.py:241``
— warm-up (P - rank - 1 forwards), the 1F1B steady state, the
cool-down, with p2p send/recv at every boundary and grad accumulation
across microbatches.  The runtime is
:func:`~apex_tpu_torch.transformer.pipeline_parallel.schedules.
tick_schedule.pipelined_fwd_bwd` with one chunk.

Model contract, as the JAX package's (in place of torch's
``model.set_input_tensor``):

- ``pre_fn(shared_params, microbatch) -> activation`` (the embedding;
  stage 0)
- ``stage_fn(stage_params, activation) -> activation`` (this stage's
  layers)
- ``post_fn(shared_params, activation, microbatch) -> loss`` (the
  head; the last stage)

``shared_params`` are replicated over the pipeline and their grads are
summed over the whole group, as the JAX package psums them (:93-96).
"""

from typing import Callable

import torch

from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication as p2p
from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
    broadcast_from_last_stage,
    pipelined_apply,
)

__all__ = ["make_pipeline_loss_fn", "forward_backward_pipelining_without_interleaving",
           "sum_shared_grads"]


def sum_shared_grads(g_shared, axis_name=None):
    """The shared params' grads summed over the pipeline group (each stage
    holds its own contributions: the embedding on the first, the head on
    the last), in one all-reduce of their concatenation."""
    import torch.distributed as dist

    from apex_tpu_torch.optimizers.tree import tree_leaves, tree_unflatten

    group = p2p._group(axis_name)
    if group.size() == 1:
        return g_shared
    leaves = tree_leaves(g_shared)
    flat = torch.cat([g.reshape(-1) for g in leaves])
    dist.all_reduce(flat, group=group.group)
    out, at = [], 0
    for g in leaves:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return tree_unflatten(g_shared, out)


def make_pipeline_loss_fn(pre_fn: Callable, stage_fn: Callable, post_fn: Callable,
                          axis_name=None):
    """Compose pre / pipeline / post into ``loss_fn(shared, stages,
    microbatches)``, forward only: the mean over microbatches of
    ``post_fn``'s loss, on every stage.  ``microbatches``: a dict of
    tensors leading with (M, ...)."""

    def loss_fn(shared_params, stage_params, microbatches):
        from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map

        M = tree_leaves(microbatches)[0].shape[0]
        group = p2p._group(axis_name)
        first = group.rank() == 0
        mbs = [tree_map(lambda a: a[m], microbatches) for m in range(M)]
        if first:
            acts = torch.stack([pre_fn(shared_params, mb) for mb in mbs])
        else:
            x0 = pre_fn(shared_params, mbs[0])  # its shape and dtype
            acts = torch.zeros((M,) + tuple(x0.shape), dtype=x0.dtype, device=x0.device)
        outs = pipelined_apply(stage_fn, stage_params, acts, group)
        last = group.rank() == group.size() - 1
        loss = (torch.stack([post_fn(shared_params, outs[m], mbs[m]) for m in range(M)]).mean()
                if last else torch.zeros((), device=acts.device))
        return broadcast_from_last_stage(loss, group)

    return loss_fn


def forward_backward_pipelining_without_interleaving(
        pre_fn: Callable, stage_fn: Callable, post_fn: Callable, shared_params, stage_params,
        microbatches, *, tensor_shape, dtype, forward_only: bool = False, axis_name=None,
        schedule_log=None, stage_has_aux: bool = False):
    """Run the 1F1B schedule; returns ``(loss, (shared_grads,
    stage_grads))`` (or ``(loss, None)`` with ``forward_only``), the
    shared grads summed over the pipeline group.  ``tensor_shape`` and
    ``dtype``: a stage activation's.  ``stage_has_aux``: ``stage_fn``
    returns ``(y, aux)``, a scalar loss the schedule adds once per
    (stage, microbatch) unit (the MoE load-balancing channel,
    :func:`~apex_tpu_torch.transformer.pipeline_parallel.schedules.
    tick_schedule.pipelined_fwd_bwd`)."""
    from apex_tpu_torch.transformer.pipeline_parallel.schedules.tick_schedule import (
        pipelined_fwd_bwd,
    )

    loss, grads = pipelined_fwd_bwd(
        pre_fn, stage_fn, post_fn, shared_params, stage_params, microbatches,
        tensor_shape=tensor_shape, dtype=dtype, num_chunks=1, axis_name=axis_name,
        forward_only=forward_only, schedule_log=schedule_log,
        stage_has_aux=stage_has_aux)
    if forward_only:
        return loss, None
    g_shared, g_stage = grads
    return loss, (sum_shared_grads(g_shared, axis_name), g_stage)
