"""Fused LM-head + cross entropy: the per-token loss of the tied head
without the (S, B, V) logits.

Counterpart of :func:`apex_tpu.ops.fused_ce.fused_lm_head_ce` at
``axis_name=None``.  The forward runs :func:`~apex_tpu_torch.ops.
fused_ce_kernels.ce_fwd` on the flattened (S*B, H) rows and returns
``loss = lse - tgt`` with ``lse = m + log(l)``; it saves x, embed, the
clamped targets and lse.  The backward runs ``ce_dx`` then ``ce_dembed``
and casts dembed to embed's dtype.  Targets are clamped into ``[0,
V-1]`` first (``_local_targets`` in dense mode), so every head path
gives an out-of-range id the same loss.

``impl`` must be ``None``: the kernels (their plain versions for CPU
tensors) are the one implementation.  The JAX package's ``"on"``,
``"off"`` (its XLA chunked scan, the retry for when Mosaic rejects the
Pallas kernels) and ``"interpret"`` (the Pallas interpreter) have no
counterpart and raise, as does ``axis_name`` (the vocab-parallel
combine: tensor parallelism is not ported).  The port has no twin of the
JAX package's fallback registry: a kernel that fails raises.
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


class _FusedLMHeadCE(torch.autograd.Function):
    """``apply(x (S, B, H), embed (V, H), targets (S, B)) -> loss (S, B)
    fp32``."""

    @staticmethod
    def forward(ctx, x, embed, targets):
        S, B = targets.shape
        H, V = x.shape[-1], embed.shape[0]
        x2 = x.reshape(S * B, H).contiguous()
        e = embed.contiguous()
        t = targets.reshape(S * B).clamp(0, V - 1).to(torch.int32).contiguous()
        m, l, tgt = K.ce_fwd(x2, e, t)
        lse = m + torch.log(l)
        ctx.save_for_backward(x2, e, t, lse)
        ctx.x_shape = x.shape
        return (lse - tgt).reshape(S, B)

    @staticmethod
    def backward(ctx, g):
        x2, e, t, lse = ctx.saved_tensors
        g2 = g.reshape(-1).float().contiguous()
        dx = K.ce_dx(x2, e, t, lse, g2)
        de = K.ce_dembed(x2, e, t, lse, g2)
        return dx.reshape(ctx.x_shape), de.to(e.dtype), None


def fused_lm_head_ce(x, embed, targets, chunk_size=128, axis_name=None, impl=None):
    """Per-token CE loss ``(S, B)`` of the tied LM head.

    ``x``: (S, B, H) post-final-LN activations; ``embed``: (V, H) tied
    embedding; ``targets``: (S, B) int ids, clamped into ``[0, V-1]``.
    S must be divisible by ``chunk_size`` (``lm_head_loss`` takes the
    dense head otherwise)."""
    if axis_name is not None:
        raise NotImplementedError(
            "fused_lm_head_ce(axis_name=...): the vocab-parallel combine needs "
            "tensor parallelism, which is not ported yet")
    check_impl(impl)
    S = targets.shape[0]
    if S % chunk_size:
        raise ValueError(f"S={S} is not divisible by chunk_size={chunk_size}")
    return _FusedLMHeadCE.apply(x, embed, torch.as_tensor(targets, device=x.device))
