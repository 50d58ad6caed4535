"""The fused LM-head cross entropy's three kernels and their plain
PyTorch versions.

Counterpart of :mod:`apex_tpu.ops.fused_ce_pallas` on flattened rows:
x ``(N, H)`` float32/bfloat16, embed ``(V, H)`` float32 (training keeps
it fp32) or bfloat16, t ``(N,)`` int32 target ids (the caller clamps
them), lse and g ``(N,)`` float32.  The kernels are ``csrc/fused_ce.cu``
(its header says what bounds them and how they are laid out).

- :func:`ce_fwd` (``_fwd_kernel``; one call launches the vocab-split
  kernel and its combine, and counts once) -> ``(m, l, tgt)``, each (N,) fp32:
  the row max of the logits, the sum of ``exp(logit - m)``, the target
  logit (0 for an id outside ``[0, V)``), so ``lse = m + log(l)``;
- :func:`ce_dx` (``_dx_kernel``) -> dx (N, H) in x's dtype;
- :func:`ce_dembed` (``_dembed_kernel``) -> dembed (V, H) fp32;

the gradients of ``sum(g * (lse - tgt))``.  The kernels' arithmetic is
the Pallas kernels' default: x and embed rounded to bf16 before ``x .
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

import torch

from apex_tpu_torch.ops import _build

#: kernel launches by :func:`ce_fwd`, :func:`ce_dx`, :func:`ce_dembed`
FWD_LAUNCHES = 0
DX_LAUNCHES = 0
DEMBED_LAUNCHES = 0

#: rows per block of the plain versions
PLAIN_CHUNK_ROWS = 1024


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
    if x2.dtype not in _build.DTYPE_CODES or embed.dtype not in _build.DTYPE_CODES:
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


def ce_fwd(x2, embed, t):
    """``(m, l, tgt)``, each (N,) fp32, of the logits ``x2 . embed^T``."""
    if x2.device.type == "cpu":
        return ce_fwd_plain(x2, embed, t)
    lib, stream, codes = _prepare("ce_fwd", x2, embed, t)
    (N, H), V = x2.shape, embed.shape[0]
    m, l, tgt = (torch.empty(N, dtype=torch.float32, device=x2.device) for _ in range(3))
    if N == 0:
        return m, l, tgt
    # the vocab splits' partial (m, l, tgt), merged by the kernel's second stage
    part = torch.empty((3, lib.apex_ce_fwd_splits(N, H, V), N), dtype=torch.float32,
                       device=x2.device)
    _build.check(lib.apex_ce_fwd(
        x2.data_ptr(), embed.data_ptr(), t.data_ptr(), part.data_ptr(), m.data_ptr(),
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
    _build.check(lib.apex_ce_dx(
        x2.data_ptr(), embed.data_ptr(), t.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dx.data_ptr(), N, H, embed.shape[0], *codes, stream), "ce_dx")
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
    _build.check(lib.apex_ce_dembed(
        x2.data_ptr(), embed.data_ptr(), t.data_ptr(), lse.data_ptr(), g.data_ptr(),
        de.data_ptr(), N, H, embed.shape[0], *codes, stream), "ce_dembed")
    global DEMBED_LAUNCHES
    DEMBED_LAUNCHES += 1
    return de
