"""Flash attention forward, dq and dk/dv: the CUDA kernels and their
plain PyTorch versions, and the autograd Function that joins them.

Counterpart of :mod:`apex_tpu.ops.flash_attention_pallas`, in its
flattened layout: q, out, do ``(B*H, Sq, D)``; k, v ``(B*H_kv, Sk, D)``
(grouped-query attention when ``kv_heads < heads``); lse and delta
``(B*H, Sq, 1)`` fp32; the per-key bias ``(B, 1, Sk)`` fp32.  The
kernels are ``csrc/flash_attention.cu`` (its header says what bounds
them and how they are laid out).

- :func:`flash_fwd` (``_fwd_kernel``) -> ``(out, lse)``;
- :func:`flash_dq` (``_dq_kernel``) -> ``dq``;
- :func:`flash_dkv` (``_dkv_kernel``) -> ``(dk, dv)``, summed over each
  kv head's q-head group.

:func:`bwd_launch_plan` states the bf16 dq and dkv kernels' tile
schedule (rows a block owns, the blocks' launch order, the tiles each
walks, shared memory), a pure function of the shapes that the CPU tests
check; ``chip_smoke.py`` holds its bytes against ``apex_flash_smem``.

Each launches its kernel for CUDA tensors and runs its plain version
(the ``_attend_fwd_scan`` / ``flash_bwd_from_lse`` specification of
:mod:`apex_tpu_torch.ops.attention`) for CPU tensors, and for nothing
else; ``FWD_LAUNCHES``, ``DQ_LAUNCHES`` and ``DKV_LAUNCHES`` count the
launches.  The plain versions are fp32 throughout; the bf16 kernels
round p and ds to bf16 before their dots, as the Pallas kernels do, so
they differ from the plain versions by that rounding.  float16 runs the
same mma kernels with fp16 operands (p and ds rounded to fp16).  The
reference has no fp16 Pallas kernel: at fp16 it runs the scan, the
plain versions here, so the fp16 kernels stand in for an XLA
composite.

The ring-chunk mode (``out_dtype=torch.float32`` with bfloat16 q, k and
v) is what ring attention asks of the kernels
(:mod:`apex_tpu_torch.transformer.context_parallel`), as
``flash_fwd_pallas(..., out_dtype=float32)`` and ``flash_bwd_pallas``
with an fp32 cotangent and ``out_dtype=float32`` are asked there:
:func:`flash_fwd` writes out in fp32 from the fp32 accumulator;
:func:`flash_dq` and :func:`flash_dkv` take the fp32 ``do`` beside the
bf16 q, k and v and write fp32 grads.  ``do`` is fp32 only in this mode:
every other dtype mismatch raises.  The kernels keep ``dp = do . v^T``
and ``dv += p^T . do`` at fp32 grade (each fp32 operand split into bf16
hi + lo, two or three products: the Pallas kernels widen v to fp32
instead) and round ds to bf16 for dq and dk as the Pallas kernels do.
``RING_FWD_LAUNCHES``, ``RING_DQ_LAUNCHES`` and ``RING_DKV_LAUNCHES``
count these launches apart from the dense path's.  The plain versions
are the same functions returning their fp32 results uncast.

:class:`FlashAttention` is the ``custom_vjp`` of ``_flash_pallas``: the
forward saves q, k, v, the bias, out and lse; the backward computes
``delta = rowsum(do * out)`` in fp32 with a torch op (XLA's job in the
JAX package) and runs dq then dk/dv.  The bias gets no gradient (a
padding mask is data).
"""

from typing import NamedTuple

import numpy as np
import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.attention import (
    _attend_fwd_scan, flash_bwd_from_lse, padding_bias, repeat_kv_heads,
)

#: kernel launches by :func:`flash_fwd`, :func:`flash_dq`, :func:`flash_dkv`
FWD_LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
#: launches in the ring-chunk mode (``out_dtype=torch.float32`` from bf16)
RING_FWD_LAUNCHES = 0
RING_DQ_LAUNCHES = 0
RING_DKV_LAUNCHES = 0

#: shared memory one block may use on the H100 (227 KB)
_SMEM_LIMIT = 232448

#: key-block size of the plain versions (the JAX scan path's default)
_PLAIN_BLOCK_K = 256

#: the bf16 backward kernels' tiles (csrc Dq, Dkv): rows a dq block owns
#: (q) and a dkv block owns (keys), and the rows of the tiles each walks
#: through its cp.async ring (keys for dq, q rows for dkv)
DQ_BLOCK_ROWS = 128
DKV_BLOCK_ROWS = 64
BWD_TILE = 64


class BwdLaunchPlan(NamedTuple):
    rows_per_block: int  # q rows (dq) or key rows (dkv) a block owns
    tile_rows: int       # rows of a walked tile: keys (dq), q rows (dkv)
    order: tuple         # the blocks (index of their rows) in launch order
    first: tuple         # by block index: the first tile it walks
    last: tuple          # by block index: the last (first - 1: none)
    smem_bytes: int      # dynamic shared memory of one block


def bwd_launch_plan(which, Sq, Sk, D, causal, q_offset=0, k_offset=0, ring=False):
    """The bf16 (and fp16) backward's schedule for one (batch, head) row,
    as the C kernels index it.  ``which`` 1: dq, a block of DQ_BLOCK_ROWS q rows
    walks the 64-key tiles up to the last key one of its rows (below
    Sq) sees; causal grids launch the last q blocks, the heaviest, first.
    ``which`` 2: dkv, a block of DKV_BLOCK_ROWS keys walks the 64-row q
    tiles from the first with a row that sees its first key (for each q
    head of its GQA group, the same tiles); its first blocks are the
    heaviest.  Shared memory: the owned tiles, two ring stages of two
    bf16 tiles (row stride D + 8) and, for dkv, two of lse and delta.
    ``ring`` (the ring-chunk mode) adds do's lo tile to dq's and, to
    dkv's, the fp32 do in each ring stage and one stage of its hi and lo
    tiles (which the bf16 do tiles' room holds)."""
    if which not in (1, 2):
        raise ValueError(f"which must be 1 (dq) or 2 (dkv), got {which}")
    N = BWD_TILE
    if which == 1:
        R = DQ_BLOCK_ROWS
        n_blocks = -(-Sq // R)
        first, last = [], []
        for qb in range(n_blocks):
            q0 = qb * R
            kend = Sk
            if causal:
                kend = min(Sk, max(0, q_offset + min(Sq, q0 + R) - k_offset))
            first.append(0)
            last.append(-(-kend // N) - 1)
        order = tuple(reversed(range(n_blocks))) if causal else tuple(range(n_blocks))
        smem = (2 * R + 4 * N + (R if ring else 0)) * (D + 8) * 2
    else:
        R = DKV_BLOCK_ROWS
        n_blocks = -(-Sk // R)
        first, last = [], []
        for kb in range(n_blocks):
            r = max(0, k_offset + kb * R - q_offset) if causal else 0
            first.append(r // N if r < Sq else -(-Sq // N))
            last.append(-(-Sq // N) - 1)
        order = tuple(range(n_blocks))
        smem = (2 * R + 4 * N) * (D + 8) * 2 + 4 * N * 4 + (2 * N * D * 4 if ring else 0)
    return BwdLaunchPlan(R, N, order, tuple(first), tuple(last), smem)


def _unflatten(q, k, v, kv_bias, heads, kv_heads):
    """The flattened tensors as the scan specification's (B, H, S, D)
    with kv heads repeated, and the (B, Sk) bias."""
    BH, Sq, D = q.shape
    B, Sk = BH // heads, k.shape[1]
    q4 = q.reshape(B, heads, Sq, D)
    k4, v4 = repeat_kv_heads(q4, k.reshape(B, kv_heads, Sk, D),
                             v.reshape(B, kv_heads, Sk, D))
    bias = None if kv_bias is None else kv_bias.reshape(B, Sk)
    return q4, k4, v4, bias


def flash_fwd_plain(q, k, v, scale, causal, q_offset=0, k_offset=0, kv_bias=None,
                    heads=1, kv_heads=None, out_dtype=None):
    """Plain version of :func:`flash_fwd`: ``_attend_fwd_scan`` in fp32,
    out cast to ``out_dtype`` (q's dtype by default; fp32, uncast, in the
    ring-chunk mode).  Returns ``(out (BH, Sq, D), lse (BH, Sq, 1))``."""
    kv_heads = kv_heads or heads
    q4, k4, v4, bias = _unflatten(q, k, v, kv_bias, heads, kv_heads)
    out, lse = _attend_fwd_scan(q4, k4, v4, scale, causal, q_offset, k_offset,
                                _PLAIN_BLOCK_K, kv_bias=bias)
    return (out.to(out_dtype or q.dtype).reshape(q.shape),
            lse.reshape(q.shape[0], q.shape[1], 1))


def _bwd_plain(q, k, v, do, lse, delta, scale, causal, q_offset, k_offset, kv_bias,
               heads, kv_heads):
    kv_heads = kv_heads or heads
    q4, k4, v4, bias = _unflatten(q, k, v, kv_bias, heads, kv_heads)
    B, H, Sq, D = q4.shape
    dq, dk, dv = flash_bwd_from_lse(
        q4, k4, v4, do.reshape(q4.shape), lse.reshape(B, H, Sq),
        delta.reshape(B, H, Sq), scale, causal, q_offset, k_offset, _PLAIN_BLOCK_K,
        kv_bias=bias)[:3]
    Sk, g = k.shape[1], heads // kv_heads
    dk = dk.reshape(B, kv_heads, g, Sk, D).sum(2)
    dv = dv.reshape(B, kv_heads, g, Sk, D).sum(2)
    return dq, dk, dv


def flash_dq_plain(q, k, v, do, lse, delta, scale, causal, q_offset=0, k_offset=0,
                   kv_bias=None, heads=1, kv_heads=None, out_dtype=None):
    """Plain version of :func:`flash_dq`: ``flash_bwd_from_lse``'s dq in
    fp32, cast to ``out_dtype`` (q's dtype by default)."""
    dq = _bwd_plain(q, k, v, do, lse, delta, scale, causal, q_offset, k_offset,
                    kv_bias, heads, kv_heads)[0]
    return dq.to(out_dtype or q.dtype).reshape(q.shape)


def flash_dkv_plain(q, k, v, do, lse, delta, scale, causal, q_offset=0, k_offset=0,
                    kv_bias=None, heads=1, kv_heads=None, out_dtype=None):
    """Plain version of :func:`flash_dkv`: ``flash_bwd_from_lse``'s dk
    and dv in fp32, summed over each GQA group, cast to ``out_dtype``
    (k's / v's dtype by default)."""
    _, dk, dv = _bwd_plain(q, k, v, do, lse, delta, scale, causal, q_offset, k_offset,
                           kv_bias, heads, kv_heads)
    return (dk.to(out_dtype or k.dtype).reshape(k.shape),
            dv.to(out_dtype or v.dtype).reshape(v.shape))


def ring_mode(q, out_dtype) -> bool:
    """Whether a call asks for the ring-chunk mode: fp32 outputs from
    lower-precision q, k and v (bfloat16 is the one the kernels take).
    Raises on an ``out_dtype`` that is neither q's dtype nor fp32."""
    if out_dtype is None or out_dtype == q.dtype:
        return False
    if out_dtype != torch.float32:
        raise ValueError(f"out_dtype must be q's dtype ({q.dtype}) or torch.float32, "
                         f"got {out_dtype}")
    return True


def dtype_problem(named, ring=False):
    """What the kernels cannot take about the dtypes of ``named`` (``(name,
    tensor)`` pairs, q first, then k, v and any of do, lse, delta), or
    None: one dtype of float32, bfloat16 or float16 for q, k, v and do;
    in the ring-chunk mode (``ring``) bfloat16 q, k and v beside an fp32
    do shaped as q, and no other mismatch."""
    q = named[0][1]
    if q.dtype not in _build.DTYPE_CODES:
        return f"dtype must be float32, bfloat16 or float16, got {q.dtype}"
    if ring and q.dtype != torch.bfloat16:
        return (f"the ring-chunk mode (fp32 outputs from narrower inputs) takes bfloat16 "
                f"q, k and v, got {q.dtype}")
    for name, t in named:
        if name == "do" and ring:
            if t.dtype != torch.float32 or t.shape != q.shape:
                return "do must be a float32 tensor shaped as q in the ring-chunk mode"
        elif name in ("q", "k", "v", "do") and t.dtype != q.dtype:
            return f"{name} has dtype {t.dtype}, q {q.dtype}: one dtype is required"
    return None


def _problem(q, k, v, kv_bias, heads, kv_heads, extra=(), ring=False):
    """What the kernels cannot take about these arguments, or None
    (``ring``: the ring-chunk mode, whose do is fp32)."""
    if q.device.type != "cuda":
        return f"tensors on {q.device} are not supported"
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        return (f"q must be (B*H, Sq, D) and k, v (B*H_kv, Sk, D), got "
                f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BH, Sq, D = q.shape
    if D % 16 or not 0 < D <= 128 or k.shape[2] != D:
        return f"head dim must be a multiple of 16 up to 128 and match, got {D}, {k.shape[2]}"
    if heads < 1 or kv_heads < 1 or BH % heads or heads % kv_heads:
        return f"heads={heads}, kv_heads={kv_heads} do not divide B*H={BH}"
    if k.shape[0] != BH // heads * kv_heads:
        return f"k has {k.shape[0]} rows, expected B*H_kv={BH // heads * kv_heads}"
    named = (("q", q), ("k", k), ("v", v)) + tuple(extra)
    problem = dtype_problem(named, ring)
    if problem:
        return problem
    for name, t in named:
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            return f"{name} must be contiguous, 16-byte aligned and on {q.device}"
        if name in ("lse", "delta") and (t.dtype != torch.float32
                                        or t.numel() != BH * Sq):
            return f"{name} must be float32 (B*H, Sq, 1)"
    if kv_bias is not None and (
            kv_bias.dtype != torch.float32 or kv_bias.device != q.device
            or not kv_bias.is_contiguous()
            or kv_bias.shape != (BH // heads, 1, k.shape[1])):
        return f"kv_bias must be a contiguous float32 (B, 1, Sk) tensor on {q.device}"
    return None


def _prepare(which, name, q, k, v, kv_bias, heads, kv_heads, extra=(), ring=False):
    problem = _problem(q, k, v, kv_bias, heads, kv_heads, extra, ring)
    if problem:
        raise ValueError(f"{name}: {problem}")
    lib, stream = _build.prepare(q.device)
    dtype = _build.DTYPE_CODES[q.dtype]
    smem = lib.apex_flash_smem(which, q.shape[2], dtype, int(ring))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: {smem} B of shared memory at D={q.shape[2]}, "
                         f"{q.dtype} exceeds {_SMEM_LIMIT}")
    bias_ptr = None if kv_bias is None else kv_bias.data_ptr()
    return lib, stream, dtype, bias_ptr


def flash_fwd(q, k, v, scale, causal, q_offset=0, k_offset=0, kv_bias=None, heads=1,
              kv_heads=None, out_dtype=None):
    """Flash attention forward on the flattened layout; returns ``(out
    (BH, Sq, D) in out_dtype (q's by default), lse (BH, Sq, 1) fp32)``.
    ``out_dtype=torch.float32`` with bf16 inputs is the ring-chunk mode."""
    kv_heads = kv_heads or heads
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal, q_offset, k_offset, kv_bias,
                               heads, kv_heads, out_dtype)
    ring = ring_mode(q, out_dtype)
    lib, stream, dtype, bias_ptr = _prepare(0, "flash_fwd", q, k, v, kv_bias, heads,
                                            kv_heads, ring=ring)
    BH, Sq, D = q.shape
    out = torch.empty(q.shape, dtype=torch.float32 if ring else q.dtype, device=q.device)
    lse = torch.empty((BH, Sq, 1), dtype=torch.float32, device=q.device)
    if BH == 0 or Sq == 0:
        return out, lse
    _build.check(lib.apex_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
        lse.data_ptr(), BH, Sq, k.shape[1], D, heads, kv_heads, float(scale),
        int(causal), int(q_offset), int(k_offset), dtype, int(ring), stream), "flash_fwd")
    global FWD_LAUNCHES, RING_FWD_LAUNCHES
    if ring:
        RING_FWD_LAUNCHES += 1
    else:
        FWD_LAUNCHES += 1
    return out, lse


def flash_dq(q, k, v, do, lse, delta, scale, causal, q_offset=0, k_offset=0,
             kv_bias=None, heads=1, kv_heads=None, out_dtype=None):
    """dq (BH, Sq, D) in out_dtype (q's by default) from the forward's
    lse and ``delta = rowsum(do * out)`` (BH, Sq, 1) fp32.  In the
    ring-chunk mode (``out_dtype=torch.float32``, bf16 q, k, v) ``do`` is
    fp32."""
    kv_heads = kv_heads or heads
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, scale, causal, q_offset,
                              k_offset, kv_bias, heads, kv_heads, out_dtype)
    ring = ring_mode(q, out_dtype)
    lib, stream, dtype, bias_ptr = _prepare(
        1, "flash_dq", q, k, v, kv_bias, heads, kv_heads,
        (("do", do), ("lse", lse), ("delta", delta)), ring)
    BH, Sq, D = q.shape
    dq = torch.empty(q.shape, dtype=torch.float32 if ring else q.dtype, device=q.device)
    if BH == 0 or Sq == 0:
        return dq
    _build.check(lib.apex_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), bias_ptr, dq.data_ptr(), BH, Sq, k.shape[1], D, heads,
        kv_heads, float(scale), int(causal), int(q_offset), int(k_offset), dtype,
        int(ring), stream), "flash_dq")
    global DQ_LAUNCHES, RING_DQ_LAUNCHES
    if ring:
        RING_DQ_LAUNCHES += 1
    else:
        DQ_LAUNCHES += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, scale, causal, q_offset=0, k_offset=0,
              kv_bias=None, heads=1, kv_heads=None, out_dtype=None):
    """(dk, dv), each (B*H_kv, Sk, D) in out_dtype (k's by default),
    summed over the q heads of each kv head's group.  In the ring-chunk
    mode (``out_dtype=torch.float32``, bf16 q, k, v) ``do`` is fp32."""
    kv_heads = kv_heads or heads
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, scale, causal, q_offset,
                               k_offset, kv_bias, heads, kv_heads, out_dtype)
    ring = ring_mode(q, out_dtype)
    lib, stream, dtype, bias_ptr = _prepare(
        2, "flash_dkv", q, k, v, kv_bias, heads, kv_heads,
        (("do", do), ("lse", lse), ("delta", delta)), ring)
    BH, Sq, D = q.shape
    odt = torch.float32 if ring else k.dtype
    dk = torch.empty(k.shape, dtype=odt, device=k.device)
    dv = torch.empty(v.shape, dtype=odt, device=v.device)
    if k.shape[0] == 0 or k.shape[1] == 0:
        return dk, dv
    if Sq == 0:
        return dk.zero_(), dv.zero_()
    _build.check(lib.apex_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), bias_ptr, dk.data_ptr(), dv.data_ptr(), k.shape[0], Sq,
        k.shape[1], D, heads, kv_heads, float(scale), int(causal), int(q_offset),
        int(k_offset), dtype, int(ring), stream), "flash_dkv")
    global DKV_LAUNCHES, RING_DKV_LAUNCHES
    if ring:
        RING_DKV_LAUNCHES += 1
    else:
        DKV_LAUNCHES += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """``_flash_pallas``'s ``custom_vjp`` on the flattened layout:
    ``apply(q, k, v, kv_bias, scale, causal, q_offset, k_offset, heads,
    kv_heads) -> out``."""

    @staticmethod
    def forward(ctx, q, k, v, kv_bias, scale, causal, q_offset, k_offset, heads,
                kv_heads):
        out, lse = flash_fwd(q, k, v, scale, causal, q_offset, k_offset, kv_bias,
                             heads, kv_heads)
        ctx.save_for_backward(q, k, v, kv_bias, out, lse)
        ctx.config = (scale, causal, q_offset, k_offset)
        ctx.heads = (heads, kv_heads)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_bias, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = (g.float() * out.float()).sum(dim=-1, keepdim=True)
        args = (q, k, v, g, lse, delta, *ctx.config)
        kw = dict(kv_bias=kv_bias, heads=ctx.heads[0], kv_heads=ctx.heads[1])
        dq = flash_dq(*args, **kw)
        dk, dv = flash_dkv(*args, **kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention_kernel(q, k, v, causal=True, softmax_scale=None, q_offset=0,
                           k_offset=0, kv_mask=None):
    """(B, H, S, D) flash attention through :class:`FlashAttention`
    (``flash_attention_pallas``).  k/v may carry fewer heads (GQA);
    ``kv_mask`` (B, Sk) bool, True = valid, becomes the kernels' key
    bias."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if H % Hkv != 0:
        raise ValueError(f"q heads ({H}) not divisible by kv heads ({Hkv})")
    scale = softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(D)
    bias = None if kv_mask is None else padding_bias(kv_mask)[:, None, :].contiguous()
    out = FlashAttention.apply(
        q.reshape(B * H, Sq, D).contiguous(), k.reshape(B * Hkv, Sk, D).contiguous(),
        v.reshape(B * Hkv, Sk, D).contiguous(), bias, float(scale), bool(causal),
        int(q_offset), int(k_offset), H, Hkv)
    return out.reshape(B, H, Sq, D)
