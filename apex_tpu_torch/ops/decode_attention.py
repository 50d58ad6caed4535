"""Paged decode attention: the CUDA kernel and its plain PyTorch version.

Counterpart of :mod:`apex_tpu.ops.decode_attention_pallas`.  Query rows
attend over their sequence's KV cache, which lives as fixed-size pages
in a preallocated pool (:mod:`apex_tpu_torch.inference.kv_cache`).
With ``width == 1`` each sequence has one query row (plain decode);
with ``width == W > 1`` (speculative verification, a prefill chunk)
it has W consecutive ones, so ``q`` and ``lengths`` have ``B * W`` rows
while ``page_table`` keeps one row per sequence, and each query row is
masked at its own length.  The kernel is ``csrc/decode_attention.cu``:
one block per (sequence, kv head, tile of at most 64 query rows) walks
the sequence's positions in stages of 64, fixed in position whatever
the width, gathering each stage's k and v through the page table (ids
clamped into the pool) into shared memory by asynchronous copies while
the previous stage is scored.  Each 16 query rows get four warps, one
per 16-position slice of a stage, whose online softmaxes merge at the
end in slice order; bf16 scores and P.V run on the tensor cores, fp32
and mixed dtypes on CUDA cores.  :func:`launch_plan` states its launch
plan (rows per block, stage, shared memory), a pure function of the
shapes that the tests check without the card.  ``LAUNCHES`` counts
``width == 1`` launches and ``WIDE_LAUNCHES`` the others, so a run shows
which layout ran.

:func:`decode_attention_plain` is the numerics specification, as
``decode_attention_xla`` is in the JAX package: it gathers the pages,
scores in fp32 with ``/ sqrt(D)`` and a ``-10000`` fill, takes a full
fp32 softmax, casts the probabilities to v's dtype before the weighted
sum, and zeroes rows of length 0.
"""

import functools
import math
from typing import NamedTuple

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.transformer.functional.fused_softmax import MASK_FILL_VALUE

#: kernel launches by :func:`paged_decode_attention` at ``width == 1``
LAUNCHES = 0
#: kernel launches at ``width > 1`` (the verify/chunk layout)
WIDE_LAUNCHES = 0

#: positions of a shared-memory stage: stage s holds positions
#: [64 s, 64 s + 64) of its sequence at every width (csrc kStage)
STAGE_POSITIONS = 64
#: query rows of a warp (the mma tile's M) and of a block
WARP_ROWS = 16
MAX_BLOCK_ROWS = 64
#: shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT = 232448


class LaunchPlan(NamedTuple):
    rows_per_block: int   # query rows of a (sequence, kv head) block
    stage_positions: int  # positions a stage holds, fixed in position
    smem_bytes: int       # dynamic shared memory of one block


def _rup128(n):
    return (n + 127) // 128 * 128


@functools.lru_cache(maxsize=256)
def launch_plan(width, group, head_dim, q_bytes, kv_bytes):
    """The kernel's launch plan at these shapes (element sizes in
    bytes: 2 bf16, 4 fp32), as the C entry works it out from its
    ``Layout``: q tile, two stages of k and v, the FMA path's fp32 P
    (16 x 16 a warp, row stride 20), the rows' lengths, each region
    rounded to 128 bytes.  Stages depend on no argument: that, with each
    row's own dot products, keeps a row bitwise equal at every width.
    A statement of the plan that runs without the card, for the tests;
    ``chip_smoke.py`` holds it against ``apex_paged_decode_attention_plan``."""
    rows_per_block = min(width * group, MAX_BLOCK_ROWS)
    tile_rows = WARP_ROWS * -(-rows_per_block // WARP_ROWS)
    mma = q_bytes == 2 and kv_bytes == 2
    ldq = head_dim + (8 if mma else 4)
    ldk = head_dim + 16 // kv_bytes
    p_tile = 0 if mma else 4 * tile_rows * 20 * 4  # 4 slice warps a 16 rows
    smem = (_rup128(tile_rows * ldq * (2 if mma else 4))
            + 4 * _rup128(STAGE_POSITIONS * ldk * kv_bytes) + _rup128(p_tile)
            + _rup128(tile_rows * 4))
    return LaunchPlan(rows_per_block, STAGE_POSITIONS, smem)


def _check_rows(q_rows, table_rows, width):
    if width < 1 or table_rows * width != q_rows:
        raise ValueError(
            f"q rows ({q_rows}) must equal page-table rows ({table_rows}) x width "
            f"({width})")


def decode_attention_plain(q, k_pool, v_pool, page_table, lengths, width=1):
    """Paged attention over a KV cache, in plain PyTorch.

    ``q`` (B * width, H, D); ``k_pool``/``v_pool`` (num_pages, page_size,
    H_kv, D) one layer's pools; ``page_table`` (B, P) int page ids, one
    row per sequence, clamped into the pool before the gather;
    ``lengths`` (B * width,) valid positions per query row (0 = inactive:
    the output row is 0).  With ``width`` W > 1 the rows come in groups
    of W consecutive positions of one sequence.  Returns (B * width, H,
    D) in ``v_pool``'s dtype."""
    Bq, H, D = q.shape
    num_pages, page_size, h_kv, _ = k_pool.shape
    B, P = page_table.shape
    _check_rows(Bq, B, width)
    group = H // h_kv
    pt = page_table.long().clamp(0, num_pages - 1)
    k = k_pool[pt].reshape(B, P * page_size, h_kv, D).transpose(1, 2)
    v = v_pool[pt].reshape(B, P * page_size, h_kv, D).transpose(1, 2)
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    t = torch.arange(P * page_size, device=q.device)
    lengths = lengths.to(q.device)
    if width > 1:
        qf = q.float().reshape(B, width, H, D)
        scores = torch.einsum("bwhd,bhtd->bwht", qf, k.float()) / math.sqrt(D)
        lw = lengths.reshape(B, width)
        valid = t[None, None, None, :] < lw[:, :, None, None]
        scores = scores.masked_fill(~valid, MASK_FILL_VALUE)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bwht,bhtd->bwhd", probs.to(v.dtype), v)
        ctx = torch.where(lw[:, :, None, None] > 0, ctx, torch.zeros_like(ctx))
        return ctx.reshape(Bq, H, D)
    scores = torch.einsum("bhd,bhtd->bht", q.float(), k.float()) / math.sqrt(D)
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
    Bq, H, D = q.shape
    h_kv = k_pool.shape[2]
    if k_pool.shape[3] != D or H % h_kv:
        return f"pools {tuple(k_pool.shape)} do not fit q {tuple(q.shape)}"
    if D % 16 or not 16 <= D <= 128:
        return f"head dim must be a multiple of 16 up to 128, got {D}"
    if page_table.dim() != 2 or lengths.shape != (Bq,):
        return "page_table must be (B, P) and lengths (B * width,)"
    if (q.dtype not in _build.FP32_BF16 or k_pool.dtype not in _build.FP32_BF16
            or v_pool.dtype != k_pool.dtype):
        return "q and the pools must be float32 or bfloat16, the two pools of one dtype"
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        return "page_table and lengths must be int32"
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != q.device or not t.is_contiguous():
            return f"{name} must be contiguous and on {q.device}"
        if name in ("q", "k_pool", "v_pool") and t.data_ptr() % 16:
            return f"{name} must be 16-byte aligned (the kernel copies 16 bytes at a time)"
    return None


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths, width=1):
    """Shapes and semantics as :func:`decode_attention_plain`, both
    layouts.  CPU tensors run the plain version; CUDA tensors launch the
    kernel: ``q`` float32/bfloat16, pools float32/bfloat16 of one dtype,
    ``page_table``/``lengths`` int32, all contiguous on one device."""
    _check_rows(q.shape[0], page_table.shape[0], width)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_pool, v_pool, page_table, lengths, width)
    problem = _problem(q, k_pool, v_pool, page_table, lengths)
    if problem:
        raise ValueError(f"paged_decode_attention: {problem}")
    Bq, H, D = q.shape
    num_pages, page_size, h_kv, _ = k_pool.shape
    B, P = page_table.shape
    out = torch.empty((Bq, H, D), dtype=v_pool.dtype, device=q.device)
    if Bq == 0:
        return out
    lib, stream = _build.prepare(q.device)
    _build.check(lib.apex_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, width, H, h_kv, D, num_pages, page_size,
        P, math.sqrt(D), _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[k_pool.dtype],
        stream), "paged_decode_attention")
    global LAUNCHES, WIDE_LAUNCHES
    if width == 1:
        LAUNCHES += 1
    else:
        WIDE_LAUNCHES += 1
    return out
