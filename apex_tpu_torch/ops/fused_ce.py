"""Fused LM-head + cross entropy: the per-token loss of the tied head
without the (S, B, V) logits.

Counterpart of :func:`apex_tpu.ops.fused_ce.fused_lm_head_ce`.  The
forward runs :func:`~apex_tpu_torch.ops.fused_ce_kernels.ce_fwd` on the
flattened (S*B, H) rows and returns ``loss = lse - tgt`` with ``lse = m
+ log(l)``; it saves x, embed, the kernels' targets and lse.  The
backward runs ``ce_dx`` then ``ce_dembed`` and casts dembed to embed's
dtype.  Without ``axis_name`` the targets are clamped into ``[0, V-1]``
first (``_local_targets`` in dense mode), so every single-device head
path gives an out-of-range id the same loss.

With ``axis_name`` (the tensor-parallel group, an ``AxisGroup``) the
embed is this rank's vocab shard ``(V / tp, H)`` and the targets are
global ids.  The three kernels run unchanged on the shard with the
targets made shard-local as the reference does (``_local_targets``:
``t - rank * V_local``, not clamped), so an id on another rank's rows
falls outside ``[0, V_local)`` and misses every tile: its ``tgt`` here
is 0.  The forward combines the ranks' statistics as the reference's
kernel path does (:217-221): ``m_g = max m`` over the group, ``l_g =
sum l * exp(m - m_g)``, ``lse = m_g + log(l_g)``, ``tgt = sum tgt``, in
two collectives (a MAX all-reduce, then one sum of ``l`` and ``tgt``
stacked).  The backward is shard-local with the global lse: dx is this
shard's partial, which the caller's copy-to-region backward sums, and
dembed is this shard's rows.  A global id outside ``[0, V)`` misses
every shard: its loss is ``lse``, with no target term, on this path and
the reference's (the reference's dense tp head gives ``lse - max``,
:mod:`~apex_tpu_torch.transformer.tensor_parallel.cross_entropy`).

``impl`` must be ``None``: the kernels (their plain versions for CPU
tensors) are the one implementation.  The JAX package's ``"on"``,
``"off"`` (its XLA chunked scan, the retry for when Mosaic rejects the
Pallas kernels) and ``"interpret"`` (the Pallas interpreter) have no
counterpart and raise.  The port has no twin of the JAX package's
fallback registry: a kernel that fails raises.
"""

import torch

from apex_tpu_torch.ops import fused_ce_kernels as K

__all__ = ["fused_lm_head_ce"]


def check_impl(impl):
    """Raise on an ``impl`` other than None: the port runs its kernels
    only, and never another implementation in their place."""
    if impl is not None:
        raise ValueError(
            f"fused_ce impl={impl!r}: the port has one implementation, the CUDA "
            f"kernels (their plain versions on CPU tensors); the JAX package's "
            f"'on', 'off' (XLA scan) and 'interpret' (Pallas interpreter) switches "
            f"have no counterpart; pass None")


def _local_targets(targets, partition, axis):
    """The kernels' int32 ids: clamped into ``[0, partition)`` without a
    group, shifted by this rank's first row with one (the reference's
    ``_local_targets``)."""
    if axis is None:
        return targets.clamp(0, partition - 1).to(torch.int32).contiguous()
    return (targets.long() - axis.rank() * partition).to(torch.int32).contiguous()


def _combine(m, l, tgt, axis):
    """``(lse, tgt)`` over the group from each rank's ``(m, l, tgt)``."""
    if axis is None:
        return m + torch.log(l), tgt
    import torch.distributed as dist

    from apex_tpu_torch.transformer.tensor_parallel.mappings import all_reduce_sum

    m_g = m.clone()
    if axis.size() > 1:
        dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=axis.group)
    l_g, tgt_g = all_reduce_sum(torch.stack([l * torch.exp(m - m_g), tgt]), axis).unbind(0)
    return m_g + torch.log(l_g), tgt_g


class _FusedLMHeadCE(torch.autograd.Function):
    """``apply(x (S, B, H), embed (V, H), targets (S, B), axis) -> loss
    (S, B) fp32``."""

    @staticmethod
    def forward(ctx, x, embed, targets, axis):
        S, B = targets.shape
        H, V = x.shape[-1], embed.shape[0]
        x2 = x.reshape(S * B, H).contiguous()
        e = embed.contiguous()
        t = _local_targets(targets.reshape(S * B), V, axis)
        m, l, tgt = K.ce_fwd(x2, e, t)
        lse, tgt = _combine(m, l, tgt, axis)
        ctx.save_for_backward(x2, e, t, lse)
        ctx.x_shape = x.shape
        return (lse - tgt).reshape(S, B)

    @staticmethod
    def backward(ctx, g):
        x2, e, t, lse = ctx.saved_tensors
        g2 = g.reshape(-1).float().contiguous()
        dx = K.ce_dx(x2, e, t, lse, g2)
        de = K.ce_dembed(x2, e, t, lse, g2)
        return dx.reshape(ctx.x_shape), de.to(e.dtype), None, None


def fused_lm_head_ce(x, embed, targets, chunk_size=128, axis_name=None, impl=None):
    """Per-token CE loss ``(S, B)`` of the tied LM head.

    ``x``: (S, B, H) post-final-LN activations; ``embed``: (V, H) tied
    embedding, or with ``axis_name`` (an ``AxisGroup``) this rank's
    (V / tp, H) vocab shard; ``targets``: (S, B) int ids (global ids with
    ``axis_name``; clamped into ``[0, V-1]`` without).  S must be
    divisible by ``chunk_size`` (``lm_head_loss`` takes the dense head
    otherwise)."""
    check_impl(impl)
    S = targets.shape[0]
    if S % chunk_size:
        raise ValueError(f"S={S} is not divisible by chunk_size={chunk_size}")
    if axis_name is not None:
        from apex_tpu_torch.transformer.tensor_parallel.mappings import tp_group

        axis_name = tp_group(axis_name)
    return _FusedLMHeadCE.apply(x, embed, torch.as_tensor(targets, device=x.device), axis_name)
