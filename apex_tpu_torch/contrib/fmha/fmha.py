"""FMHA: fused multi-head attention for padded (BERT-style) batches
(counterpart of :mod:`apex_tpu.contrib.fmha`; reference
``apex/contrib/fmha/fmha.py:33-60``, ``fmhalib``).

Both entry points run the flash kernels
(:func:`apex_tpu_torch.ops.attention.flash_attention` with ``kv_mask``):
the padded keys leave every row's softmax inside the kernel through its
per-key bias, and padded query rows are zeroed after it.  The
``qkv[:, :, i]`` slices are strided views; the kernel wrapper takes
contiguous copies of them in its ``(B*H, S, D)`` layout.

:func:`fmha_varlen` takes the reference's packed layout, unpacks it to
a dense ``(B, max_s)`` batch and repacks the output, with the JAX
package's gathers: indices past the packed tokens or past ``max_s`` are
clamped, as ``jnp.take(..., mode="clip")`` and JAX indexing clamp them
(a torch index would raise), so a sequence longer than ``max_s`` repeats
its last dense row, as there, and those repeated rows pass no gradient
back, as the transpose of JAX's gather (a scatter-add) drops them.  An empty sequence (two equal
``cu_seqlens``) owns no token and is skipped by the repack.
"""

from typing import Optional

import torch

from apex_tpu_torch.ops.attention import flash_attention

__all__ = ["fmha", "fmha_varlen"]


def fmha_varlen(qkv_packed, cu_seqlens, max_s: int, causal: bool = False,
                softmax_scale=None):
    """``qkv_packed`` (total_tokens, 3, H, D), every sequence
    concatenated; ``cu_seqlens`` (B + 1,) integer sequence starts;
    ``max_s`` the dense padding width.  Returns (total_tokens, H, D)."""
    dev = qkv_packed.device
    total = qkv_packed.shape[0]
    cu = cu_seqlens.to(device=dev, dtype=torch.long)
    seqlens = cu[1:] - cu[:-1]
    pos = torch.arange(max_s, device=dev)
    idx = cu[:-1, None] + pos[None, :]                     # (B, max_s)
    valid = pos[None, :] < seqlens[:, None]                # (B, max_s)
    # index_select, whose backward is an index-add (an advanced index's
    # backward sorts its indices first)
    dense = qkv_packed.index_select(0, idx.clamp(0, total - 1).reshape(-1))
    dense = dense.reshape(*idx.shape, *qkv_packed.shape[1:])
    dense = torch.where(valid[..., None, None, None], dense, 0.0)
    out_dense = fmha(dense, key_padding_mask=valid, causal=causal,
                     softmax_scale=softmax_scale)          # (B, max_s, H, D)

    # token t belongs to sequence b(t), at offset t - cu_seqlens[b]
    t = torch.arange(total, device=dev)
    b_of_t = (torch.searchsorted(cu, t, right=True) - 1).clamp(0, cu.shape[0] - 2)
    i_of_t = t - cu[b_of_t]
    rows = b_of_t * max_s + i_of_t.clamp(0, max_s - 1)
    out = out_dense.reshape(-1, *out_dense.shape[2:]).index_select(0, rows)
    # JAX's gather clamps the rows past max_s; its transpose, a scatter-add,
    # drops them: they carry no gradient
    return torch.where((i_of_t < max_s)[:, None, None], out, out.detach())


def fmha(qkv, key_padding_mask: Optional[torch.Tensor] = None, causal: bool = False,
         softmax_scale=None):
    """``qkv`` (B, S, 3, H, D) packed as in the reference; returns
    (B, S, H, D).  ``key_padding_mask``: (B, S) bool, True = valid
    token; padded keys are excluded from the softmax and padded query
    rows are zero."""
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, S, D)
    mask = None if key_padding_mask is None else key_padding_mask.to(torch.bool)
    out = flash_attention(q, k, v, causal=causal, softmax_scale=softmax_scale, kv_mask=mask)
    if mask is not None:
        out = out * mask[:, None, :, None].to(out.dtype)
    return out.transpose(1, 2)
