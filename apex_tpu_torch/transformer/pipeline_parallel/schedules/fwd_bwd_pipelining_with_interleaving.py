"""The interleaved (virtual-pipeline) schedule (counterpart of
:mod:`apex_tpu.transformer.pipeline_parallel.schedules.fwd_bwd_pipelining_with_interleaving`).

Reference: ``schedules/fwd_bwd_pipelining_with_interleaving.py:27`` —
each stage owns ``vpp`` non-contiguous layer chunks (stage s holds
chunks s, s + pp, s + 2·pp, ...) and walks microbatches over the chunks
in groups of pp, which shrinks the bubble from (P - 1) / M to
(P - 1) / (M·vpp).  The runtime is
:func:`~apex_tpu_torch.transformer.pipeline_parallel.schedules.
tick_schedule.pipelined_fwd_bwd` with ``num_chunks = vpp``: the ring's
wrap from the last stage to the first carries chunk v's output to chunk
v + 1.  The microbatches must be a multiple of pp, and the layers split
into pp x vpp chunks (:func:`apex_tpu_torch.models.gpt.params_to_vpp_layout`
orders them stage-major).
"""

from typing import Callable

from apex_tpu_torch.optimizers.tree import tree_leaves, tree_unflatten
from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication as p2p
from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import pipelined_apply
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_pipelining_without_interleaving import (  # noqa: E501
    sum_shared_grads,
)

__all__ = ["interleaved_pipelined_apply", "forward_backward_pipelining_with_interleaving"]


def interleaved_pipelined_apply(stage_fn, stage_params, mb_inputs, vpp: int, axis_name=None):
    """Run microbatches through ``vpp`` chunks x P stages, forward only:
    chunk after chunk, each through the whole pipeline, the last stage's
    outputs handed to the first for the next chunk.  ``stage_params``:
    this stage's layers ``(vpp·lpc, ...)``, chunk v at ``[v·lpc:(v+1)·lpc]``.
    Returns the outputs on the last stage, zeros elsewhere."""
    group = p2p._group(axis_name)
    P, rank = group.size(), group.rank()
    leaves = tree_leaves(stage_params)
    lpc = leaves[0].shape[0] // vpp
    outs = mb_inputs
    for v in range(vpp):
        chunk = tree_unflatten(stage_params, [t[v * lpc:(v + 1) * lpc] for t in leaves])
        outs = pipelined_apply(stage_fn, chunk, outs, group)
        if v < vpp - 1 and P > 1:
            # the last stage's results to the first, to feed the next chunk
            shape, dtype, dev = tuple(outs.shape), outs.dtype, outs.device
            if rank == P - 1:
                p2p.send_forward(outs, group)
            elif rank == 0:
                outs = p2p.recv_forward(shape, dtype, dev, group)
    return outs


def forward_backward_pipelining_with_interleaving(
        pre_fn: Callable, stage_fn: Callable, post_fn: Callable, shared_params, stage_params,
        microbatches, *, tensor_shape, dtype, virtual_pipeline_model_parallel_size: int = 2,
        forward_only: bool = False, axis_name=None, schedule_log=None,
        stage_has_aux: bool = False):
    """The interleaved analog of
    :func:`~apex_tpu_torch.transformer.pipeline_parallel.schedules.
    forward_backward_pipelining_without_interleaving`: the stage params
    hold ``vpp`` chunks stacked on the layer axis; ``stage_has_aux`` as
    there."""
    from apex_tpu_torch.transformer.pipeline_parallel.schedules.tick_schedule import (
        pipelined_fwd_bwd,
    )

    loss, grads = pipelined_fwd_bwd(
        pre_fn, stage_fn, post_fn, shared_params, stage_params, microbatches,
        tensor_shape=tensor_shape, dtype=dtype,
        num_chunks=virtual_pipeline_model_parallel_size, axis_name=axis_name,
        forward_only=forward_only, schedule_log=schedule_log,
        stage_has_aux=stage_has_aux)
    if forward_only:
        return loss, None
    g_shared, g_stage = grads
    return loss, (sum_shared_grads(g_shared, axis_name), g_stage)
