"""The fused LM-head cross entropy's three kernels and their plain
PyTorch versions.

Counterpart of :mod:`apex_tpu.ops.fused_ce_pallas` on flattened rows:
x ``(N, H)`` float32/bfloat16, embed ``(V, H)`` float32 (training keeps
it fp32) or bfloat16, t ``(N,)`` int32 target ids (the caller clamps
them), lse and g ``(N,)`` float32.  The kernels are ``csrc/fused_ce.cu``
(its header says what bounds them and how they are laid out).

- :func:`ce_fwd` (``_fwd_kernel``; one call launches the bf16 copies of
  fp32 operands, the vocab-split kernel and its combine, and counts
  once) -> ``(m, l, tgt)``, each (N,) fp32:
  the row max of the logits, the sum of ``exp(logit - m)``, the target
  logit (0 for an id outside ``[0, V)``), so ``lse = m + log(l)``;
- :func:`ce_dx` (``_dx_kernel``) -> dx (N, H) in x's dtype;
- :func:`ce_dembed` (``_dembed_kernel``) -> dembed (V, H) fp32;

the gradients of ``sum(g * (lse - tgt))``.  dx and dembed stream one
operand (the embed, x) past rows of the other held in a block; when it
is fp32 the wrapper allocates its bf16 copy as scratch, which the call
fills before the kernel runs (one call still counts one launch).
:func:`ce_bwd_plan` states their tile plan, a pure function of the
shapes that the CPU tests check; ``chip_smoke.py`` holds it against
``apex_ce_bwd_plan``, what the C side launches with.  The forward
streams bf16 operands too: :func:`ce_fwd_plan` states its tiles, vocab
splits and the one scratch buffer the wrapper allocates (the splits'
partials and the bf16 copies of fp32 x and embed), held against
``apex_ce_fwd_plan``.

The kernels' arithmetic is the Pallas kernels' default: x and embed rounded to bf16 before ``x .
e^T`` and d rounded to bf16 before ``d . e`` and ``d^T . x``, with fp32
accumulation, whatever x's dtype.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors, and for nothing else; ``FWD_LAUNCHES``,
``DX_LAUNCHES`` and ``DEMBED_LAUNCHES`` count the launches.  The plain
versions are the chunked scan specification (``_chunk_stats`` /
``_chunk_grads`` of :mod:`apex_tpu.ops.fused_ce`) over blocks of
``chunk_rows`` rows, with a ``dot_dtype``: ``torch.float32`` (the
default, what the CPU path runs: the JAX package's semantics there) or
``torch.bfloat16``, which rounds the dot inputs as the kernels do.
"""

from typing import NamedTuple

import torch

from apex_tpu_torch.ops import _build

#: kernel launches by :func:`ce_fwd`, :func:`ce_dx`, :func:`ce_dembed`
FWD_LAUNCHES = 0
DX_LAUNCHES = 0
DEMBED_LAUNCHES = 0

#: rows per block of the plain versions
PLAIN_CHUNK_ROWS = 1024

#: shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT = 232448

#: the forward's tiles (csrc FwdTiles): x rows and vocab rows of a block
#: tile, columns of H a ring stage, ring stages, warps down the rows and
#: across the vocab, blocks an SM
FWD_TILES = {"rows": 128, "cols": 256, "chunk": 64, "stages": 2, "warps_m": 2, "warps_n": 4,
             "blocks_per_sm": 1}

#: the SMs the forward's vocab splits aim to fill (an H100's 132)
SMS = 132

#: the backward's tiles (csrc BwdH768 for H <= 768, BwdH1024 above): own
#: rows a block, streamed rows a tile, K groups of the score product,
#: warps a block
BWD_TILES = {768: (64, 32, 4, 8), 1024: (32, 32, 6, 12)}


class CeFwdPlan(NamedTuple):
    rows: int           # x rows of a block tile
    vocab_rows: int     # vocab rows of a block tile (columns of s)
    chunk: int          # columns of H a ring stage holds
    stages: int         # chunks of the cp.async ring
    warps: int          # warps a block
    splits: int         # vocab splits (gridDim.y), merged by the combine
    smem_bytes: int     # dynamic shared memory of one block
    scratch_bytes: int  # the splits' partials, then the bf16 copies of fp32 x / embed


def _round256(n):
    return -(-n // 256) * 256


def fwd_smem_bytes(rows, cols, chunk, stages):
    """Shared memory of one forward block (``csrc`` ``fwd_smem``): the
    ring of x and embed chunks (bf16, row stride chunk + 8) and the rows'
    target ids."""
    return stages * (rows + cols) * (chunk + 8) * 2 + rows * 4


def ce_fwd_plan(N, H, V, x_dtype, e_dtype):
    """The forward's plan, as ``csrc/fused_ce.cu`` launches it: the block
    tile, ring and warps of ``FWD_TILES``, the vocab splits that bring
    the blocks to about ``SMS`` x blocks an SM (no split left empty),
    shared memory, and the scratch: the splits' partial (m, l, tgt), (3,
    S, N) fp32, then the bf16 copy of x when it is fp32 and of the embed
    when it is fp32, each from a 256-byte boundary."""
    f = FWD_TILES
    row_blocks = -(-N // f["rows"])
    nv = -(-V // f["cols"])
    S = SMS * f["blocks_per_sm"] // row_blocks if row_blocks else 1
    S = min(max(S, 1), nv)
    tps = -(-nv // S)
    S = -(-nv // tps)
    scratch = _round256(3 * S * N * 4)
    scratch += _round256(N * H * 2) if x_dtype == torch.float32 else 0
    scratch += _round256(V * H * 2) if e_dtype == torch.float32 else 0
    return CeFwdPlan(f["rows"], f["cols"], f["chunk"], f["stages"],
                     f["warps_m"] * f["warps_n"], S,
                     fwd_smem_bytes(f["rows"], f["cols"], f["chunk"], f["stages"]), scratch)


class CeBwdPlan(NamedTuple):
    own_rows: int       # rows of the held operand a block owns (x: dx, embed: dembed)
    stream_rows: int    # rows of the streamed operand a tile
    k_groups: int       # warp groups splitting the score product over H
    warps: int          # warps a block
    stages: int         # tiles of the cp.async ring
    smem_bytes: int     # dynamic shared memory of one block
    scratch_bytes: int  # the streamed operand's bf16 copy (0: it is bf16)


def ce_bwd_plan(which, N, H, V, x_dtype, e_dtype):
    """The bf16 backward's plan, as ``csrc/fused_ce.cu`` launches it:
    ``which`` 1 (dx: own x rows, streamed embed) or 2 (dembed: own embed
    rows, streamed x).  Shared memory: the own tile and two ring stages
    (bf16, row stride H + 8), d (bf16, row stride stream_rows + 8), the
    row data (lse, g, t of the own rows for dx, of two stages for
    dembed) and k_groups - 1 fp32 partials of s."""
    if which not in (1, 2):
        raise ValueError(f"which must be 1 (dx) or 2 (dembed), got {which}")
    rows, sr, kg, warps = BWD_TILES[768 if H <= 768 else 1024]
    streamed_dtype, streamed_rows = (e_dtype, V) if which == 1 else (x_dtype, N)
    scratch = streamed_rows * H * 2 if streamed_dtype == torch.float32 else 0
    return CeBwdPlan(rows, sr, kg, warps, 2, bwd_smem_bytes(which, H, rows, sr, kg), scratch)


def bwd_smem_bytes(which, H, rows, sr, kg):
    """Shared memory of one backward block (``csrc`` ``bwd_smem``)."""
    smem = ((rows + 2 * sr) * (H + 8) + rows * (sr + 8)) * 2
    return smem + 3 * (2 * sr if which == 2 else rows) * 4 + (kg - 1) * rows * sr * 4


def _dot_operand(a, dot_dtype):
    """``a`` rounded to ``dot_dtype`` and widened to fp32: the operand
    of an fp32-accumulating product with ``dot_dtype`` inputs."""
    return a.to(dot_dtype).float()


def _chunks(n, chunk_rows):
    return range(0, n, max(1, int(chunk_rows)))


def _onehot(t, V, dtype=torch.float32):
    """(rows, V) one-hot of ``t``; ids outside ``[0, V)`` hit nothing."""
    cols = torch.arange(V, device=t.device)
    return (cols[None, :] == t.long()[:, None]).to(dtype)


def ce_fwd_plain(x2, embed, t, dot_dtype=torch.float32, chunk_rows=PLAIN_CHUNK_ROWS):
    """Plain version of :func:`ce_fwd`: per block of rows, the fp32
    logits of the ``dot_dtype``-rounded operands, their max ``m``,
    ``l = sum(exp(logits - m))`` and the target logit."""
    e = _dot_operand(embed, dot_dtype)
    V = embed.shape[0]
    ms, ls, tgts = [], [], []
    for i in _chunks(x2.shape[0], chunk_rows):
        logits = _dot_operand(x2[i:i + chunk_rows], dot_dtype) @ e.T
        m = logits.max(dim=1).values
        ms.append(m)
        ls.append(torch.exp(logits - m[:, None]).sum(dim=1))
        tgts.append((logits * _onehot(t[i:i + chunk_rows], V)).sum(dim=1))
    if not ms:
        z = x2.new_zeros(0, dtype=torch.float32)
        return z, z.clone(), z.clone()
    return torch.cat(ms), torch.cat(ls), torch.cat(tgts)


def _d_chunk(x_c, e, t_c, lse_c, g_c, dot_dtype):
    """One block's ``d = (softmax - onehot) * g`` (rows, V) in fp32."""
    logits = _dot_operand(x_c, dot_dtype) @ e.T
    p = torch.exp(logits - lse_c[:, None])
    return (p - _onehot(t_c, e.shape[0])) * g_c[:, None]


def ce_dx_plain(x2, embed, t, lse, g, dot_dtype=torch.float32,
                chunk_rows=PLAIN_CHUNK_ROWS):
    """Plain version of :func:`ce_dx`: per block of rows, ``d . e`` with
    d and e rounded to ``dot_dtype``, fp32 accumulation, cast to x's
    dtype."""
    e = _dot_operand(embed, dot_dtype)
    out = [(_dot_operand(_d_chunk(x2[i:i + chunk_rows], e, t[i:i + chunk_rows],
                                  lse[i:i + chunk_rows], g[i:i + chunk_rows], dot_dtype),
                         dot_dtype) @ e).to(x2.dtype)
           for i in _chunks(x2.shape[0], chunk_rows)]
    return torch.cat(out) if out else torch.empty_like(x2)


def ce_dembed_plain(x2, embed, t, lse, g, dot_dtype=torch.float32,
                    chunk_rows=PLAIN_CHUNK_ROWS):
    """Plain version of :func:`ce_dembed`: the sum over blocks of rows,
    in order, of ``d^T . x`` with d and x rounded to ``dot_dtype``; fp32
    (V, H)."""
    e = _dot_operand(embed, dot_dtype)
    de = torch.zeros(embed.shape, dtype=torch.float32, device=embed.device)
    for i in _chunks(x2.shape[0], chunk_rows):
        x_c = x2[i:i + chunk_rows]
        d = _d_chunk(x_c, e, t[i:i + chunk_rows], lse[i:i + chunk_rows],
                     g[i:i + chunk_rows], dot_dtype)
        de += _dot_operand(d, dot_dtype).T @ _dot_operand(x_c, dot_dtype)
    return de


def _problem(x2, embed, t, rows=()):
    """What the kernels cannot take about these arguments, or None."""
    if x2.device.type != "cuda":
        return f"tensors on {x2.device} are not supported"
    if x2.dim() != 2 or embed.dim() != 2 or x2.shape[1] != embed.shape[1]:
        return f"x must be (N, H) and embed (V, H), got {tuple(x2.shape)}, {tuple(embed.shape)}"
    N, H = x2.shape
    if H % 16 or not 0 < H <= 1024:
        return f"H must be a multiple of 16 up to 1024 (tensor-core tiles), got {H}"
    if embed.shape[0] == 0:
        return "embed has no rows"
    if x2.dtype not in _build.FP32_BF16 or embed.dtype not in _build.FP32_BF16:
        return f"x and embed must be float32 or bfloat16, got {x2.dtype}, {embed.dtype}"
    for name, a in (("x", x2), ("embed", embed)):
        if a.device != x2.device or not a.is_contiguous() or a.data_ptr() % 16:
            return f"{name} must be contiguous, 16-byte aligned and on {x2.device}"
    if (t.device != x2.device or t.dtype != torch.int32 or t.shape != (N,)
            or not t.is_contiguous()):
        return f"t must be a contiguous int32 ({N},) tensor on {x2.device}"
    for name, a in rows:
        if (a.device != x2.device or a.dtype != torch.float32 or a.shape != (N,)
                or not a.is_contiguous()):
            return f"{name} must be a contiguous float32 ({N},) tensor on {x2.device}"
    return None


def _prepare(name, x2, embed, t, rows=()):
    problem = _problem(x2, embed, t, rows)
    if problem:
        raise ValueError(f"{name}: {problem}")
    lib, stream = _build.prepare(x2.device)
    return lib, stream, (_build.DTYPE_CODES[x2.dtype], _build.DTYPE_CODES[embed.dtype])


def _bf16_scratch(streamed):
    """A bf16 buffer the shape of the streamed operand, which the call
    fills with its copy, or None when the operand is bf16 already."""
    if streamed.dtype == torch.bfloat16:
        return None
    return torch.empty(streamed.shape, dtype=torch.bfloat16, device=streamed.device)


def _ptr(a):
    return None if a is None else a.data_ptr()


def ce_fwd(x2, embed, t):
    """``(m, l, tgt)``, each (N,) fp32, of the logits ``x2 . embed^T``."""
    if x2.device.type == "cpu":
        return ce_fwd_plain(x2, embed, t)
    lib, stream, codes = _prepare("ce_fwd", x2, embed, t)
    (N, H), V = x2.shape, embed.shape[0]
    m, l, tgt = (torch.empty(N, dtype=torch.float32, device=x2.device) for _ in range(3))
    if N == 0:
        return m, l, tgt
    # the vocab splits' partial (m, l, tgt), merged by the kernel's second
    # stage, and the bf16 copies of fp32 operands
    plan = ce_fwd_plan(N, H, V, x2.dtype, embed.dtype)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=x2.device)
    _build.check(lib.apex_ce_fwd(
        x2.data_ptr(), embed.data_ptr(), t.data_ptr(), scratch.data_ptr(), m.data_ptr(),
        l.data_ptr(), tgt.data_ptr(), N, H, V, *codes, stream), "ce_fwd")
    global FWD_LAUNCHES
    FWD_LAUNCHES += 1
    return m, l, tgt


def ce_dx(x2, embed, t, lse, g):
    """dx (N, H) in x's dtype of ``sum(g * (lse - tgt))``."""
    if x2.device.type == "cpu":
        return ce_dx_plain(x2, embed, t, lse, g)
    lib, stream, codes = _prepare("ce_dx", x2, embed, t, (("lse", lse), ("g", g)))
    N, H = x2.shape
    dx = torch.empty_like(x2)
    if N == 0:
        return dx
    scratch = _bf16_scratch(embed)
    _build.check(lib.apex_ce_dx(
        x2.data_ptr(), embed.data_ptr(), t.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dx.data_ptr(), _ptr(scratch), N, H, embed.shape[0], *codes, stream), "ce_dx")
    global DX_LAUNCHES
    DX_LAUNCHES += 1
    return dx


def ce_dembed(x2, embed, t, lse, g):
    """dembed (V, H) fp32 of ``sum(g * (lse - tgt))``."""
    if x2.device.type == "cpu":
        return ce_dembed_plain(x2, embed, t, lse, g)
    lib, stream, codes = _prepare("ce_dembed", x2, embed, t, (("lse", lse), ("g", g)))
    N, H = x2.shape
    if N == 0:
        return torch.zeros(embed.shape, dtype=torch.float32, device=x2.device)
    de = torch.empty(embed.shape, dtype=torch.float32, device=x2.device)
    scratch = _bf16_scratch(x2)
    _build.check(lib.apex_ce_dembed(
        x2.data_ptr(), embed.data_ptr(), t.data_ptr(), lse.data_ptr(), g.data_ptr(),
        de.data_ptr(), _ptr(scratch), N, H, embed.shape[0], *codes, stream), "ce_dembed")
    global DEMBED_LAUNCHES
    DEMBED_LAUNCHES += 1
    return de
