"""Flash (blockwise, online-softmax) attention.

Counterpart of :mod:`apex_tpu.ops.attention`, layout ``(batch, heads,
seq, head_dim)``.  :func:`flash_attention` always runs the flash
kernels' autograd Function
(:class:`apex_tpu_torch.ops.flash_attention.FlashAttention`): the CUDA
kernels for CUDA tensors, their plain versions for CPU tensors.  The
port has no ``impl`` choice.  A dense score bias (``attn_bias``) takes
the scan path instead, as in the JAX package, where a biased call never
reaches the Pallas kernel: :class:`ScanAttention`, the twin of its
``_flash`` ``custom_vjp``.

The plain versions are :func:`_attend_fwd_scan` and
:func:`flash_bwd_from_lse`, the JAX package's ``lax.scan`` numerics
specification written as a Python loop over key blocks: everything in
fp32, ``NEG_INF = -1e30`` for masked scores, probabilities re-masked
after the exp when causal or biased, ``l`` clamped at 1e-30, so a fully
masked row gives zeros and ``lse = m + log(l)``, never NaN.
"""

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def _block_sizes(sk, block_k):
    bk = min(block_k, sk)
    while sk % bk:
        bk -= 1
    return bk


def padding_bias(kv_mask):
    """(B, Sk) bool key-validity mask (True = valid) -> fp32 additive
    score bias (B, Sk): 0 for valid keys, NEG_INF for padded ones."""
    return torch.where(kv_mask, 0.0, NEG_INF).float()


def repeat_kv_heads(q, k, v):
    """Grouped-query attention on paths that want full-width kv: repeat
    each kv head across its q-head group (identity when the head counts
    match).  Autograd sums dk/dv over the group."""
    H, Hkv = q.shape[1], k.shape[1]
    if Hkv == H:
        return k, v
    if H % Hkv != 0:
        raise ValueError(f"q heads ({H}) not divisible by kv heads ({Hkv})")
    g = H // Hkv
    return k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)


def _bias4(kv_bias):
    """(B, Sk) key bias, or a 4D bias broadcastable to (B, H, Sq, Sk)."""
    return kv_bias[:, None, None, :] if kv_bias.dim() == 2 else kv_bias


def _masked_scores(qf, kblk, scale, bblk, causal, q_pos, k_pos):
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kblk) * scale
    if bblk is not None:
        s = s + bblk
    if causal:
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
    return s


def _attend_fwd_scan(q, k, v, scale, causal, q_offset, k_offset, block_k,
                     kv_bias=None):
    """Online-softmax forward.  q: (B,H,Sq,D), k/v: (B,H,Sk,D).
    ``kv_bias``: optional (B, Sk) fp32 additive key bias (padding masks)
    or a 4D one broadcastable to the scores.  Returns ``(out, lse)`` in
    fp32, lse (B,H,Sq) = log sum exp(s) per row."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    bk = _block_sizes(Sk, block_k)
    qf = q.float()
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    remask = causal or kv_bias is not None
    bias4 = None if kv_bias is None else _bias4(kv_bias.float())
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for j0 in range(0, Sk, bk):
        k_pos = k_offset + j0 + torch.arange(bk, device=q.device)
        bblk = None if bias4 is None else bias4[..., j0:j0 + bk]
        s = _masked_scores(qf, k[:, :, j0:j0 + bk].float(), scale, bblk, causal,
                           q_pos, k_pos)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if remask:
            p = torch.where(s > NEG_INF / 2, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p, v[:, :, j0:j0 + bk].float())
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return acc / l[..., None], m + torch.log(l)


def flash_bwd_from_lse(q, k, v, g, lse, delta, scale, causal, q_offset=0,
                       k_offset=0, block_k=256, kv_bias=None):
    """Blockwise flash backward from (lse, delta): dV = P^T dO;
    dS = P * (dO V^T - delta); dQ = dS K scale; dK = dS^T Q scale, with
    delta = rowsum(dO * O) over the full row.  Returns fp32
    ``(dq, dk, dv)``, and ``db`` (the bias's cotangent, dS summed over
    the dims the bias broadcast along) when ``kv_bias`` is given."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    bk = _block_sizes(Sk, block_k)
    qf, gf = q.float(), g.float()
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    remask = causal or kv_bias is not None
    bias4 = None if kv_bias is None else _bias4(kv_bias.float())
    if bias4 is not None:
        bias_reduce = tuple(i for i in range(3) if bias4.shape[i] == 1)
    dq = torch.zeros_like(qf)
    dks, dvs, dbs = [], [], []
    for j0 in range(0, Sk, bk):
        kblk, vblk = k[:, :, j0:j0 + bk].float(), v[:, :, j0:j0 + bk].float()
        k_pos = k_offset + j0 + torch.arange(bk, device=q.device)
        bblk = None if bias4 is None else bias4[..., j0:j0 + bk]
        s = _masked_scores(qf, kblk, scale, bblk, causal, q_pos, k_pos)
        p = torch.exp(s - lse[..., None])
        if remask:  # fully masked rows have lse == NEG_INF: exp(0) = 1
            p = torch.where(s > NEG_INF / 2, p, 0.0)
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, gf))
        dp = torch.einsum("bhqd,bhkd->bhqk", gf, vblk)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kblk) * scale
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale)
        if bias4 is not None:
            dbs.append(ds.sum(dim=bias_reduce, keepdim=True) if bias_reduce else ds)
    dk, dv = torch.cat(dks, dim=2), torch.cat(dvs, dim=2)
    if bias4 is None:
        return dq, dk, dv
    db = torch.cat(dbs, dim=-1)
    if kv_bias.dim() == 2:
        db = db[:, 0, 0, :]
    return dq, dk, dv, db


class ScanAttention(torch.autograd.Function):
    """The JAX package's ``_flash`` ``custom_vjp`` (apex_tpu/ops/
    attention.py:124-224): ``apply(q, k, v, bias, scale, causal,
    q_offset, k_offset, block_k) -> out`` in q's dtype, the forward
    :func:`_attend_fwd_scan` and the backward :func:`flash_bwd_from_lse`
    from the saved fp32 out and lse, ``delta = rowsum(g * out)``.
    ``bias`` (fp32, broadcastable to (B, H, Sq, Sk), or None) gets its
    cotangent, dS summed over the dims it broadcast along, in its dtype."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal, q_offset, k_offset, block_k):
        out, lse = _attend_fwd_scan(q, k, v, scale, causal, q_offset, k_offset, block_k,
                                    kv_bias=bias)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.config = (scale, causal, q_offset, k_offset, block_k)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        delta = torch.sum(g.float() * out, dim=-1)
        outs = flash_bwd_from_lse(q, k, v, g, lse, delta, *ctx.config, kv_bias=bias)
        dq, dk, dv = (d.to(t.dtype) for d, t in zip(outs[:3], (q, k, v)))
        db = None if bias is None else outs[3].to(bias.dtype)
        return dq, dk, dv, db, None, None, None, None, None


def _scan_attention(q, k, v, attn_bias, kv_mask, scale, causal, q_offset, k_offset,
                    block_k):
    """The JAX package's ``scan_impl``: kv heads repeated (autograd sums
    the group), the bias given leading dims up to 4 and taken in fp32,
    the padding bias of ``kv_mask`` added to it."""
    k, v = repeat_kv_heads(q, k, v)
    bias = None
    if attn_bias is not None:
        while attn_bias.dim() < 4:
            attn_bias = attn_bias[None]
        bias = attn_bias.float()
    if kv_mask is not None:
        pad = padding_bias(kv_mask)
        bias = pad if bias is None else bias + pad[:, None, None, :]
    return ScanAttention.apply(q, k, v, bias, scale, causal, q_offset, k_offset, block_k)


def flash_attention(q, k, v, causal: bool = True, softmax_scale: Optional[float] = None,
                    block_k: Optional[int] = None, q_offset: int = 0, k_offset: int = 0,
                    block_q: Optional[int] = None, kv_mask=None, attn_bias=None):
    """Memory-efficient attention, (B, H, S, D) layout, differentiable in
    q, k and v.

    ``q_offset``/``k_offset`` give the global positions of the local
    blocks (top-left aligned: row i sees keys j with q_offset + i >=
    k_offset + j).  ``kv_mask``: optional (B, Sk) bool key-validity mask,
    True = valid.  Grouped-query attention: k/v may carry fewer heads
    than q (H_kv divides H).  ``block_q``/``block_k`` are accepted for
    the JAX signature; the kernels' tile sizes are their own.

    ``attn_bias``: an additive score bias broadcastable as (B|1, H|1,
    Sq|1, Sk) (OpenFold's pair bias), differentiable.  As in the JAX
    package it runs on the scan path (:class:`ScanAttention`, key blocks
    of ``block_k``, 256 by default), never on the flash kernels, and a
    call without it never leaves them."""
    del block_q
    if attn_bias is not None:
        scale = softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(q.shape[-1])
        return _scan_attention(q, k, v, attn_bias, kv_mask, scale, causal, q_offset,
                               k_offset, block_k or 256)
    from apex_tpu_torch.ops.flash_attention import flash_attention_kernel

    return flash_attention_kernel(q, k, v, causal=causal, softmax_scale=softmax_scale,
                                  q_offset=q_offset, k_offset=k_offset, kv_mask=kv_mask)


def flash_attention_with_lse(q, k, v, causal=True, softmax_scale=None, block_k: int = 256,
                             q_offset=0, k_offset=0):
    """Forward returning fp32 ``(out, lse)`` for cross-device merging,
    through the scan specification as in the JAX package (no gradient
    of its own: ring attention differentiates through its own loop)."""
    scale = softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(q.shape[-1])
    return _attend_fwd_scan(q, k, v, scale, causal, q_offset, k_offset, block_k)


def mha_reference(q, k, v, causal=True, softmax_scale=None, kv_mask=None):
    """Naive O(S^2)-memory oracle for tests (GQA via head repeat).  Its
    causal mask is bottom-right aligned (``tril(k=Sk-Sq)``), so it
    agrees with :func:`flash_attention` only when Sq == Sk."""
    k, v = repeat_kv_heads(q, k, v)
    scale = softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        Sq, Sk = s.shape[-2], s.shape[-1]
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril(Sk - Sq)
        s = torch.where(mask, s, NEG_INF)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
