"""The encoder/decoder (T5) 1F1B schedule: two activation streams across
the pipeline's split rank (counterpart of
:mod:`apex_tpu.transformer.pipeline_parallel.schedules.tick_schedule_encdec`).

Reference: ``apex/transformer/pipeline_parallel/schedules/
fwd_bwd_pipelining_without_interleaving.py:50-84``
(``ModelType.encoder_and_decoder``: ranks before the split carry the
encoder stream; ranks at and after it carry the decoder stream and the
encoder's final output, forwarded stage to stage for cross-attention)
and ``schedules/common.py:85-100`` (the roles by
``pipeline_model_parallel_split_rank``).

The JAX package runs every stage in lockstep and picks each stage's
role with ``lax.cond``; here each rank runs its own role on the port's
per-rank 1F1B runtime (:mod:`.tick_schedule`: ``_Units`` and
``_one_f_one_b``) and talks to its neighbours with
:mod:`~apex_tpu_torch.transformer.pipeline_parallel.p2p_communication`:

- **One message a hop carries both streams**, ``cat([enc, dec])`` of
  shape ``(S_src + S_tgt, b, H)`` in the compute dtype: the JAX
  package's uniform pair as one tensor, so every exchange keeps
  ``p2p._communicate``'s one static shape and fixed post order.  Before
  the split the dec half rides as zeros; from the split on the enc half
  is the encoder's final output, passed through unchanged.
- **Roles.**  Rank 0 embeds the source (``pre_enc_fn``), ranks below the
  split run ``enc_stage_fn`` on the enc half, rank ``split`` embeds the
  target (``pre_dec_fn``; the dec half it receives is ignored), ranks
  from the split on run ``dec_stage_fn`` on the dec half with the enc
  half as the encoder's output, and the last rank runs ``post_fn`` on
  the dec half.  At pp 2 split 1 one rank embeds the target, runs the
  decoder and the loss head.
- **Backward.**  A unit's backward takes the cotangent of its whole
  message; its input's cotangent goes back as one message.  The
  encoder-output cotangent thus sums every decoder stage's
  cross-attention uses (each layer's ``lnm`` norm) on its way back to
  rank ``split - 1``; the last rank's seed is the loss's alone (its
  passthrough feeds nothing), so its enc half starts from zero, as the
  JAX package seeds it.  The target embedding runs inside rank
  ``split``'s unit, so its grads land in that unit's shared grads (the
  JAX package's ``_pre_d``), and the source embedding's in rank 0's.
  The shared grads are summed over the pipeline group by
  :func:`forward_backward_pipelining_encdec`.

There is no interleaved form (vpp > 1), as in the JAX package and the
reference, whose interleaved schedule takes ``encoder_or_decoder`` only.

Per-stage parameter layout: every stage holds an encoder and a decoder
chunk (:func:`pad_stage_layout_encdec`), zeros on the other side's
stages.  The zero chunks are never used: their grads come back zero, so
the optimizer keeps them at zero.
"""

from typing import Callable, Optional

import numpy as np
import torch

from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map, tree_unflatten
from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication as p2p
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_pipelining_without_interleaving import (  # noqa: E501
    sum_shared_grads,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.tick_schedule import (
    _one_f_one_b,
    _Units,
    _warm,
)

__all__ = ["pad_stage_layout_encdec", "unpad_stage_layout_encdec", "pipelined_fwd_bwd_encdec",
           "forward_backward_pipelining_encdec"]


def _place(a, rows: int, at: int):
    """``a`` (numpy or a tensor) written at row ``at`` of zeros with
    ``rows`` rows."""
    if isinstance(a, torch.Tensor):
        out = a.new_zeros((rows, *a.shape[1:]))
    else:
        out = np.zeros((rows, *a.shape[1:]), a.dtype)
    out[at:at + a.shape[0]] = a
    return out


def pad_stage_layout_encdec(enc_layers, dec_layers, pp: int, split: int):
    """Stack each side's layer tree into the per-stage layout.

    ``enc_layers`` leaves are ``(L_enc, ...)`` (numpy arrays or tensors);
    returns leaves of shape ``(pp·lpc_e, ...)`` with stages ``< split``
    holding the real chunks (lpc_e = L_enc // split) and later stages
    zeros, and the mirrored layout for ``dec_layers`` (real on stages
    ``>= split``, lpc_d = L_dec // (pp - split)).  Stage r's chunks are
    rows ``[r·lpc, (r+1)·lpc)``."""
    if not (0 < split < pp):
        raise ValueError(f"split must be in (0, {pp}); got {split}")

    def pad(tree, n_layers, first, count, lpc):
        if n_layers % count:
            raise ValueError(f"{n_layers} layers do not divide over {count} stages")
        return tree_map(lambda a: _place(a, pp * lpc, first * lpc), tree)

    L_e = tree_leaves(enc_layers)[0].shape[0]
    L_d = tree_leaves(dec_layers)[0].shape[0]
    lpc_e = L_e // split
    lpc_d = L_d // (pp - split)
    return (pad(enc_layers, L_e, 0, split, lpc_e),
            pad(dec_layers, L_d, split, pp - split, lpc_d))


def unpad_stage_layout_encdec(enc_padded, dec_padded, pp: int, split: int):
    """The inverse of :func:`pad_stage_layout_encdec` (checkpoints in the
    layout without a pipeline)."""

    def cut(tree, first, count):
        def one(a):
            lpc = a.shape[0] // pp
            return a[first * lpc:(first + count) * lpc]

        return tree_map(one, tree)

    return cut(enc_padded, 0, split), cut(dec_padded, split, pp - split)


def pipelined_fwd_bwd_encdec(pre_enc_fn: Callable, pre_dec_fn: Callable, enc_stage_fn: Callable,
                             dec_stage_fn: Callable, post_fn: Callable, shared_params,
                             enc_stage_params, dec_stage_params, microbatches, *, split: int,
                             tensor_shapes, dtype, axis_name=None,
                             schedule_log: Optional[list] = None):
    """1F1B forward and backward of an encoder/decoder model over this
    rank's stage of the pipeline group (module docstring).

    - ``pre_enc_fn(shared, mb) -> x_enc``: the source embedding, rank 0
    - ``pre_dec_fn(shared, mb) -> x_dec``: the target embedding, rank
      ``split`` (reference common.py:92: ``pre_process`` on rank 0 and
      rank split)
    - ``enc_stage_fn(enc_chunk, x_enc) -> y_enc``
    - ``dec_stage_fn(dec_chunk, x_dec, enc_out) -> y_dec``, ``enc_out``
      the encoder's final output (cross-attention's keys and values)
    - ``post_fn(shared, y_dec, mb) -> loss``: the last rank

    ``enc_stage_params`` / ``dec_stage_params`` are this rank's chunks in
    the :func:`pad_stage_layout_encdec` layout; ``microbatches`` a tree
    whose leaves lead with the microbatch index ``(M, ...)``;
    ``tensor_shapes`` the encoder and decoder streams' ``(S, b, H)`` and
    ``dtype`` theirs (the compute dtype); ``axis_name`` the pipeline's
    ``AxisGroup`` (by default the registered one); ``schedule_log`` as
    in :func:`~.tick_schedule.pipelined_fwd_bwd`.

    Returns ``(loss, (shared_grads, enc_stage_grads,
    dec_stage_grads))``: the loss on every rank of the group, the shared
    grads this rank's contributions (sum them over the group)."""
    group = p2p._group(axis_name)
    P, rank = group.size(), group.rank()
    if not (0 < split < P):
        raise ValueError(f"split must be in (0, {P}); got {split}")
    enc_shape, dec_shape = (tuple(s) for s in tensor_shapes)
    S_src = enc_shape[0]
    stages = {"enc": enc_stage_params, "dec": dec_stage_params}

    def pre_fn(shared, mb):
        xe = pre_enc_fn(shared, mb).to(dtype)
        return torch.cat([xe, xe.new_zeros(dec_shape)])

    def stage_fn(chunks, x, mb):
        xe, xd = x[:S_src], x[S_src:]
        if rank < split:
            # the dec half rides as zeros before the split
            return torch.cat([enc_stage_fn(chunks["enc"], xe).to(dtype), torch.zeros_like(xd)])
        if rank == split:
            xd = pre_dec_fn(shared_params, mb).to(dtype)
        return torch.cat([xe, dec_stage_fn(chunks["dec"], xd, xe).to(dtype)])

    def post(shared, y, mb):
        return post_fn(shared, y[S_src:], mb)

    u = _Units(pre_fn, stage_fn, post, shared_params, stages, microbatches, 1, P, rank, False,
               schedule_log, stage_takes_mb=True)
    device = u.loss_sum.device
    _warm(group, device)
    msg = (enc_shape[0] + dec_shape[0],) + enc_shape[1:]
    _one_f_one_b(u, (msg, dtype, device, group))
    loss = u.loss_sum
    import torch.distributed as dist

    dist.all_reduce(loss, group=group.group)
    g_stage = tree_unflatten(stages, u.g_stage)
    return loss, (tree_unflatten(shared_params, u.g_shared), g_stage["enc"], g_stage["dec"])


def forward_backward_pipelining_encdec(pre_enc_fn, pre_dec_fn, enc_stage_fn, dec_stage_fn,
                                       post_fn, shared_params, enc_stage_params,
                                       dec_stage_params, microbatches, *, split: int,
                                       tensor_shapes, dtype, axis_name=None,
                                       schedule_log: Optional[list] = None):
    """Run the encoder/decoder 1F1B schedule (:func:`pipelined_fwd_bwd_encdec`);
    returns ``(loss, (shared_grads, enc_stage_grads, dec_stage_grads))``
    with the shared grads summed over the pipeline group (the source
    embedding's on rank 0, the target embedding's on rank ``split``, the
    head's on the last rank: the reference's embedding-grad all-reduce
    between the first, split and last ranks,
    ``apex/transformer/parallel_state.py:316-340``)."""
    loss, (g_sh, g_enc, g_dec) = pipelined_fwd_bwd_encdec(
        pre_enc_fn, pre_dec_fn, enc_stage_fn, dec_stage_fn, post_fn, shared_params,
        enc_stage_params, dec_stage_params, microbatches, split=split,
        tensor_shapes=tensor_shapes, dtype=dtype, axis_name=axis_name,
        schedule_log=schedule_log)
    return loss, (sum_shared_grads(g_sh, axis_name), g_enc, g_dec)
