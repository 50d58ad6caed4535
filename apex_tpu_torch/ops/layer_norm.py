"""LayerNorm and RMSNorm forward and backward: the CUDA kernels and
their plain PyTorch versions.

Counterpart of :mod:`apex_tpu.ops.layer_norm_pallas`
(``layer_norm_fwd_pallas``, ``layer_norm_bwd_pallas``) with its flags:
``rms`` (mean 0, var = mean(x**2)), an optional fp32 weight (affine)
and an optional fp32 bias, on x in float32, bfloat16 or float16 (the
reference's Pallas kernels take the first two; at float16 it runs the
jnp path, which these kernels' float16 instantiation stands in for).
The kernels are in ``csrc/layer_norm.cu`` (its comments say what bounds
each and how it is laid out); the flags are parameters of the one
kernel pair.

Each call takes one of two paths, by shape alone: the fast path (a warp
or a few a row, the row in registers, 16-byte accesses) where H fits
its 16-byte vectors and every pointer is 16-byte aligned, the general
path (a block a row, scalar loads) for every other H up to
:data:`MAX_HIDDEN`.  :func:`ln_plan` states the launch plan, a pure
function of the shape that the CPU tests check; ``chip_smoke.py`` holds
it against ``apex_layer_norm_plan``, what the C side launches with.

:func:`layer_norm_fwd` and :func:`layer_norm_bwd` launch their kernels
for CUDA tensors and run :func:`layer_norm_fwd_plain` /
:func:`layer_norm_bwd_plain` for CPU tensors, and for nothing else.
``LAUNCHES`` and ``BWD_LAUNCHES`` count the kernels' launches.
"""

import ctypes
from typing import NamedTuple

import torch

from apex_tpu_torch.ops import _build

#: kernel launches by :func:`layer_norm_fwd` (a plain counter; set it
#: to 0 before a run to count that run's launches)
LAUNCHES = 0
#: launches by :func:`layer_norm_bwd` (one per call: its two stages)
BWD_LAUNCHES = 0

#: the general path's shared-memory row buffer holds H fp32 values in the
#: default 48 KB a block may use, less 1 KB for its static reduction buffer
MAX_HIDDEN = 47 * 1024 // 4

#: the fast path's tile plan (``csrc/layer_norm.cu`` ``LnFwdTiles``,
#: ``LnBwdTiles``): warps a forward block, warps a backward block, rows a
#: backward block walks for each of its warps; a lane holds at most
#: ``MAX_VECTORS`` 16-byte vectors and a row takes at most ``MAX_WARPS_ROW``
#: warps
FWD_WARPS = 8
BWD_WARPS = 4
BWD_ROWS_WARP = 8
MAX_VECTORS = 4
MAX_WARPS_ROW = 8
#: the general path: threads a block, rows a backward block
GENERAL_THREADS = 256
GENERAL_BWD_ROWS = 32
#: shared memory a block may use on the H100
SMEM_LIMIT = 232448


class LnPlan(NamedTuple):
    fast: int            # 1: the fast path, 0: the general path
    warps_row: int       # warps a row (general: the block's 8)
    vectors_lane: int    # 16-byte vectors a lane holds (general: 0)
    fwd_rows_block: int  # rows a forward block holds
    fwd_blocks: int      # forward grid
    bwd_rows_block: int  # rows a backward stage-1 block walks
    bwd_blocks: int      # G: stage-1 grid, rows of the dw/db partials
    fwd_smem: int        # shared bytes of a forward block
    bwd_smem: int        # shared bytes of a stage-1 block


def _row_groups(warps, wr):
    return warps // wr if warps > wr else 1


def ln_plan(R, H, dtype, aligned):
    """The launch plan of an (R, H) ``dtype`` (float32, bfloat16 or
    float16) norm, as ``csrc/layer_norm.cu`` ``ln_plan`` makes it;
    ``aligned``: x, dy, y, dx, w and b all start on 16 bytes.  The fast
    path takes H a multiple of a 16-byte vector's values (8 bf16 or
    fp16, 4 fp32) of at most ``32 * MAX_WARPS_ROW * MAX_VECTORS``
    vectors: a row gets the fewest
    warps (1, 2, 4, 8) that leave a lane at most ``MAX_VECTORS`` vectors.
    The grids are ceil(R / rows a block); a backward block walks
    ``BWD_WARPS * BWD_ROWS_WARP`` rows on the fast path, as many as on the
    general one, so G depends on R alone, never on the card."""
    if dtype not in _build.DTYPE_CODES or H <= 0 or R < 0:
        raise ValueError(f"ln_plan: no plan for R={R} H={H} {dtype}")
    e = 16 // dtype.itemsize
    nv, wr = H // e, 1
    while wr <= MAX_WARPS_ROW and nv > 32 * wr * MAX_VECTORS:
        wr *= 2
    if aligned and H % e == 0 and wr <= MAX_WARPS_ROW:
        ngf, ngb = _row_groups(FWD_WARPS, wr), _row_groups(BWD_WARPS, wr)
        fast, nvl, frb, brb = 1, -(-nv // (32 * wr)), ngf, BWD_WARPS * BWD_ROWS_WARP
        fsm = 2 * ngf * wr * 8 if wr > 1 else 0           # the group sums' float2 slots
        bsm = (2 * ngb * wr * 8 if wr > 1 else 0) + (2 * H * 4 if ngb > 1 else 0)
    else:
        fast, wr, nvl, frb, brb = 0, GENERAL_THREADS // 32, 0, 1, GENERAL_BWD_ROWS
        fsm = H * 4 + (GENERAL_THREADS // 32) * 4
        bsm = 4 * H * 4 + (2 * (GENERAL_THREADS // 32) + 2) * 4
    return LnPlan(fast, wr, nvl, frb, -(-R // frb), brb, -(-R // brb), fsm, bsm)


def _aligned(*tensors):
    """Whether every given tensor's data starts on 16 bytes."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def layer_norm_fwd_plain(x2, weight, bias, eps, rms=False):
    """The numerics specification (the jnp paths of
    ``apex_tpu.normalization.fused_layer_norm``, ``_ln_fwd_impl`` and
    ``_rms_fwd_jnp``): fp32 mean (0 for RMS), centred variance
    (``mean(x**2)`` for RMS), ``rsqrt(var + eps)``, then the weight and
    the bias where given, cast to x's dtype.  ``x2`` (R, H); returns
    ``(y, mean (R,), rstd (R,))``."""
    xf = x2.float()
    if rms:
        mean = torch.zeros_like(xf[:, :1])
        var = xf.square().mean(dim=1, keepdim=True)
    else:
        mean = xf.mean(dim=1, keepdim=True)
        var = (xf - mean).square().mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x2.dtype), mean[:, 0], rstd[:, 0]


def layer_norm_bwd_plain(x2, weight, dy2, mean, rstd, rms=False, with_bias=True):
    """The backward's numerics specification (``_ln_bwd_jnp`` /
    ``_rms_bwd_jnp`` of ``apex_tpu.normalization.fused_layer_norm``, as
    the Pallas ``_ln_bwd_kernel`` computes them): in fp32, ``xhat = (x -
    mean) * rstd`` (mean 0 for RMS), ``gw = dy * w`` (``dy`` without a
    weight), ``dx = (gw - mean(gw) - xhat * mean(gw * xhat)) * rstd``
    (RMS: without the ``mean(gw)`` term) cast to x's dtype; with a
    weight ``dw = sum_rows(dy * xhat)`` and, ``with_bias``, ``db =
    sum_rows(dy)`` in fp32.  ``x2``/``dy2`` (R, H), ``mean``/``rstd``
    (R,); returns ``(dx, dw (H,) or None, db (H,) or None)``."""
    xf, gf = x2.float(), dy2.float()
    rs = rstd[:, None]
    xhat = (xf if rms else xf - mean[:, None]) * rs
    gw = gf if weight is None else gf * weight.float()
    m2 = (gw * xhat).mean(dim=1, keepdim=True)
    if rms:
        dx = (gw - xhat * m2) * rs
    else:
        dx = (gw - gw.mean(dim=1, keepdim=True) - xhat * m2) * rs
    if weight is None:
        return dx.to(x2.dtype), None, None
    return dx.to(x2.dtype), (gf * xhat).sum(0), gf.sum(0) if with_bias else None


def _problem(x2, params):
    """What the kernel cannot take about these arguments, or None (the
    message is built only on failure: this runs on every launch)."""
    if x2.device.type != "cuda":
        return f"tensors on {x2.device} are not supported"
    if x2.dim() != 2 or x2.dtype not in _build.DTYPE_CODES or not x2.is_contiguous():
        return (f"x must be a contiguous float32/bfloat16/float16 (R, H) tensor, got "
                f"{x2.dtype} {tuple(x2.shape)}")
    H = x2.shape[1]
    if not 0 < H <= MAX_HIDDEN:
        return f"H={H} outside (0, {MAX_HIDDEN}]"
    for name, t in params:
        if t is not None and (t.device != x2.device or t.dtype != torch.float32 or t.dim() != 1
                              or t.shape[0] != H or not t.is_contiguous()):
            return f"{name} must be a contiguous float32 ({H},) tensor on {x2.device}"
    return None


def _ptr(t):
    return None if t is None else t.data_ptr()


def layer_norm_fwd(x2, weight, bias, eps, rms=False):
    """Row LayerNorm (RMSNorm with ``rms``) of ``x2`` (R, H)
    float32/bfloat16/float16, with fp32 ``weight``/``bias`` (H,) or None.
    Returns ``(y (R, H) x2.dtype, mean (R,) fp32, rstd (R,) fp32)``; the
    mean is 0 for RMS."""
    if x2.device.type == "cpu":
        return layer_norm_fwd_plain(x2, weight, bias, eps, rms)
    problem = _problem(x2, (("weight", weight), ("bias", bias)))
    if problem:
        raise ValueError(f"layer_norm_fwd: {problem}")
    R, H = x2.shape
    y = torch.empty_like(x2)
    mean = torch.empty(R, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(R, dtype=torch.float32, device=x2.device)
    if R == 0:
        return y, mean, rstd
    lib, stream = _build.prepare(x2.device)
    _build.check(lib.apex_layer_norm_fwd(
        x2.data_ptr(), _ptr(weight), _ptr(bias), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), R, H, float(eps), int(rms),
        _build.DTYPE_CODES[x2.dtype], stream), "layer_norm_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return y, mean, rstd


def layer_norm_bwd(x2, weight, dy2, mean, rstd, rms=False, with_bias=True):
    """Gradients of :func:`layer_norm_fwd`: ``x2``/``dy2`` (R, H) of one
    dtype (float32/bfloat16/float16), fp32 ``weight`` (H,) or None, and the
    forward's fp32 ``mean``/``rstd`` (R,).  Returns ``(dx (R, H)
    x2.dtype, dw (H,) fp32, db (H,) fp32)``: dw and db are None without
    a weight, db is None without ``with_bias``."""
    if x2.device.type == "cpu":
        return layer_norm_bwd_plain(x2, weight, dy2, mean, rstd, rms, with_bias)
    problem = _problem(x2, (("weight", weight),))
    if problem is None and (dy2.dtype != x2.dtype or dy2.shape != x2.shape
                            or not dy2.is_contiguous() or dy2.device != x2.device):
        problem = f"dy must be a contiguous {x2.dtype} {tuple(x2.shape)} tensor"
    if problem is None:
        for name, t in (("mean", mean), ("rstd", rstd)):
            if (t.device != x2.device or t.dtype != torch.float32
                    or t.shape != (x2.shape[0],) or not t.is_contiguous()):
                problem = f"{name} must be a contiguous float32 ({x2.shape[0]},) tensor"
    if problem:
        raise ValueError(f"layer_norm_bwd: {problem}")
    R, H = x2.shape
    affine = weight is not None
    dx = torch.empty_like(x2)
    # every column of dw and db is written by the kernels; with no rows
    # they are sums of nothing
    alloc = torch.zeros if R == 0 else torch.empty
    dw = alloc(H, dtype=torch.float32, device=x2.device) if affine else None
    db = alloc(H, dtype=torch.float32, device=x2.device) if affine and with_bias else None
    if R == 0:
        return dx, dw, db
    lib, stream = _build.prepare(x2.device)
    part_w = part_b = None
    if affine:
        # the C side's own plan, with the pointers its launch tests
        plan = (ctypes.c_int64 * len(LnPlan._fields))()
        _build.check(lib.apex_layer_norm_plan(
            R, H, _build.DTYPE_CODES[x2.dtype], int(_aligned(x2, dy2, dx, weight)),
            ctypes.addressof(plan)), "apex_layer_norm_plan")
        G = plan[LnPlan._fields.index("bwd_blocks")]
        part_w = torch.empty((G, H), dtype=torch.float32, device=x2.device)
        if with_bias:
            part_b = torch.empty((G, H), dtype=torch.float32, device=x2.device)
    _build.check(lib.apex_layer_norm_bwd(
        x2.data_ptr(), _ptr(weight), dy2.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), _ptr(part_w), _ptr(part_b), _ptr(dw), _ptr(db),
        R, H, int(rms), _build.DTYPE_CODES[x2.dtype], stream), "layer_norm_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dx, dw, db
