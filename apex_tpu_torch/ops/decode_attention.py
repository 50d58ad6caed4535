"""Paged single-query decode attention: the CUDA kernel and its plain
PyTorch version.

Counterpart of :mod:`apex_tpu.ops.decode_attention_pallas`.  One query
per sequence attends over that sequence's KV cache, which lives as
fixed-size pages in a preallocated pool
(:mod:`apex_tpu_torch.inference.kv_cache`).  The kernel is
``csrc/decode_attention.cu``: one block per (sequence, kv head) walks
the sequence's pages, reads each page's ids from the table itself
(clamped into the pool), and scores every query head of a GQA group
against one read of the page.

:func:`decode_attention_plain` is the numerics specification, as
``decode_attention_xla`` is in the JAX package: it gathers the pages,
scores in fp32 with ``/ sqrt(D)`` and a ``-10000`` fill, takes a full
fp32 softmax, casts the probabilities to v's dtype before the weighted
sum, and zeroes rows of length 0.

Only ``width == 1`` (one query per sequence) is ported; the
verify/chunk layout (``width > 1``) comes with speculative decoding.
"""

import math

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.transformer.functional.fused_softmax import MASK_FILL_VALUE

#: kernel launches by :func:`paged_decode_attention`
LAUNCHES = 0

_SMEM_LIMIT = 48 * 1024


def _check_width(width):
    if width != 1:
        raise NotImplementedError(
            f"decode attention with width={width} (the verify/chunk layout) "
            "is not ported yet; only width=1 is")


def decode_attention_plain(q, k_pool, v_pool, page_table, lengths, width=1):
    """Single-query attention over a paged KV cache, in plain PyTorch.

    ``q`` (B, H, D); ``k_pool``/``v_pool`` (num_pages, page_size, H_kv,
    D) one layer's pools; ``page_table`` (B, P) int page ids, clamped
    into the pool before the gather; ``lengths`` (B,) valid positions
    per sequence (0 = inactive: the output row is 0).  Returns (B, H,
    D) in ``v_pool``'s dtype."""
    _check_width(width)
    B, H, D = q.shape
    num_pages, page_size, h_kv, _ = k_pool.shape
    P = page_table.shape[1]
    group = H // h_kv
    pt = page_table.long().clamp(0, num_pages - 1)
    k = k_pool[pt].reshape(B, P * page_size, h_kv, D).transpose(1, 2)
    v = v_pool[pt].reshape(B, P * page_size, h_kv, D).transpose(1, 2)
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    scores = torch.einsum("bhd,bhtd->bht", q.float(), k.float()) / math.sqrt(D)
    t = torch.arange(P * page_size, device=q.device)
    lengths = lengths.to(q.device)
    valid = t[None, None, :] < lengths[:, None, None]
    scores = scores.masked_fill(~valid, MASK_FILL_VALUE)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bht,bhtd->bhd", probs.to(v.dtype), v)
    return torch.where(lengths[:, None, None] > 0, ctx, torch.zeros_like(ctx))


def _problem(q, k_pool, v_pool, page_table, lengths):
    """What the kernel cannot take about these arguments, or None (the
    message is built only on failure: this runs on every launch)."""
    if q.device.type != "cuda":
        return f"tensors on {q.device} are not supported"
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        return (f"q must be (B, H, D) and both pools (num_pages, page_size, H_kv, D), "
                f"got {tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    B, H, D = q.shape
    h_kv = k_pool.shape[2]
    if k_pool.shape[3] != D or H % h_kv:
        return f"pools {tuple(k_pool.shape)} do not fit q {tuple(q.shape)}"
    if page_table.dim() != 2 or page_table.shape[0] != B or lengths.shape != (B,):
        return "page_table must be (B, P) and lengths (B,)"
    if (q.dtype not in _build.DTYPE_CODES or k_pool.dtype not in _build.DTYPE_CODES
            or v_pool.dtype != k_pool.dtype):
        return "q and the pools must be float32 or bfloat16, the two pools of one dtype"
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        return "page_table and lengths must be int32"
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != q.device or not t.is_contiguous():
            return f"{name} must be contiguous and on {q.device}"
    return None


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths, width=1):
    """Shapes and semantics as :func:`decode_attention_plain`.  CPU
    tensors run the plain version; CUDA tensors launch the kernel:
    ``q`` float32/bfloat16, pools float32/bfloat16 of one dtype,
    ``page_table``/``lengths`` int32, all contiguous on one device."""
    _check_width(width)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_pool, v_pool, page_table, lengths)
    problem = _problem(q, k_pool, v_pool, page_table, lengths)
    if problem:
        raise ValueError(f"paged_decode_attention: {problem}")
    B, H, D = q.shape
    num_pages, page_size, h_kv, _ = k_pool.shape
    P = page_table.shape[1]
    out = torch.empty((B, H, D), dtype=v_pool.dtype, device=q.device)
    if B == 0:
        return out
    lib, stream = _build.prepare(q.device)
    smem = lib.apex_paged_decode_attention_smem(H // h_kv, D, page_size)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged_decode_attention: {smem} B of shared memory at "
                         f"group={H // h_kv}, D={D}, page_size={page_size} exceeds "
                         f"{_SMEM_LIMIT}")
    _build.check(lib.apex_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, H, h_kv, D, num_pages, page_size, P,
        math.sqrt(D), _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[k_pool.dtype],
        stream), "paged_decode_attention")
    global LAUNCHES
    LAUNCHES += 1
    return out
