"""LayerNorm forward and backward: the CUDA kernels and their plain
PyTorch versions.

Counterpart of :mod:`apex_tpu.ops.layer_norm_pallas`
(``layer_norm_fwd_pallas``, ``layer_norm_bwd_pallas``), affine
LayerNorm.  The kernels are in ``csrc/layer_norm.cu`` (its comments say
what bounds each and how it is laid out).

:func:`layer_norm_fwd` and :func:`layer_norm_bwd` launch their kernels
for CUDA tensors and run :func:`layer_norm_fwd_plain` /
:func:`layer_norm_bwd_plain` for CPU tensors, and for nothing else.
``LAUNCHES`` and ``BWD_LAUNCHES`` count the kernels' launches.
"""

import torch

from apex_tpu_torch.ops import _build

#: kernel launches by :func:`layer_norm_fwd` (a plain counter; set it
#: to 0 before a run to count that run's launches)
LAUNCHES = 0
#: launches by :func:`layer_norm_bwd` (one per call: its two stages)
BWD_LAUNCHES = 0

#: the shared-memory row buffer holds H fp32 values in the default 48 KB
#: a block may use, less 1 KB for the kernel's static reduction buffer
MAX_HIDDEN = 47 * 1024 // 4


def layer_norm_fwd_plain(x2, weight, bias, eps):
    """The numerics specification (the jnp path of
    ``apex_tpu.normalization.fused_layer_norm._ln_fwd_impl``): fp32
    mean, centred variance, ``rsqrt(var + eps)``, affine, cast to x's
    dtype.  ``x2`` (R, H); returns ``(y, mean (R,), rstd (R,))``."""
    xf = x2.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = (xf - mean).square().mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd * weight.float() + bias.float()
    return y.to(x2.dtype), mean[:, 0], rstd[:, 0]


def layer_norm_bwd_plain(x2, weight, dy2, mean, rstd):
    """The backward's numerics specification (``_ln_bwd_jnp`` of
    ``apex_tpu.normalization.fused_layer_norm``, as the Pallas
    ``_ln_bwd_kernel`` computes it): in fp32, ``xhat = (x - mean) *
    rstd``, ``gw = dy * w``, ``dx = (gw - mean(gw) - xhat *
    mean(gw * xhat)) * rstd`` cast to x's dtype, ``dw = sum_rows(dy *
    xhat)``, ``db = sum_rows(dy)`` in fp32.  ``x2``/``dy2`` (R, H),
    ``mean``/``rstd`` (R,); returns ``(dx, dw (H,), db (H,))``."""
    xf, gf = x2.float(), dy2.float()
    rs = rstd[:, None]
    xhat = (xf - mean[:, None]) * rs
    gw = gf * weight.float()
    m1 = gw.mean(dim=1, keepdim=True)
    m2 = (gw * xhat).mean(dim=1, keepdim=True)
    dx = (gw - m1 - xhat * m2) * rs
    return dx.to(x2.dtype), (gf * xhat).sum(0), gf.sum(0)


def _problem(x2, weight, bias):
    """What the kernel cannot take about these arguments, or None (the
    message is built only on failure: this runs on every launch)."""
    if x2.device.type != "cuda":
        return f"tensors on {x2.device} are not supported"
    if x2.dim() != 2 or x2.dtype not in _build.DTYPE_CODES or not x2.is_contiguous():
        return f"x must be a contiguous float32/bfloat16 (R, H) tensor, got {x2.dtype} {tuple(x2.shape)}"
    H = x2.shape[1]
    if not 0 < H <= MAX_HIDDEN:
        return f"H={H} outside (0, {MAX_HIDDEN}]"
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.device != x2.device or t.dtype != torch.float32 or t.dim() != 1
                or t.shape[0] != H or not t.is_contiguous()):
            return f"{name} must be a contiguous float32 ({H},) tensor on {x2.device}"
    return None


def layer_norm_fwd(x2, weight, bias, eps):
    """Row LayerNorm of ``x2`` (R, H) float32/bfloat16 with fp32
    ``weight``/``bias`` (H,).  Returns ``(y (R, H) x2.dtype, mean (R,)
    fp32, rstd (R,) fp32)``."""
    if x2.device.type == "cpu":
        return layer_norm_fwd_plain(x2, weight, bias, eps)
    problem = _problem(x2, weight, bias)
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
        x2.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), R, H, float(eps),
        _build.DTYPE_CODES[x2.dtype], stream), "layer_norm_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return y, mean, rstd


def layer_norm_bwd(x2, weight, dy2, mean, rstd):
    """Gradients of :func:`layer_norm_fwd`: ``x2``/``dy2`` (R, H) of one
    dtype (float32/bfloat16), fp32 ``weight`` (H,) and the forward's
    fp32 ``mean``/``rstd`` (R,).  Returns ``(dx (R, H) x2.dtype, dw (H,)
    fp32, db (H,) fp32)``."""
    if x2.device.type == "cpu":
        return layer_norm_bwd_plain(x2, weight, dy2, mean, rstd)
    problem = _problem(x2, weight, weight)
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
    dx = torch.empty_like(x2)
    dw = torch.zeros(H, dtype=torch.float32, device=x2.device)
    db = torch.zeros(H, dtype=torch.float32, device=x2.device)
    if R == 0:
        return dx, dw, db
    lib, stream = _build.prepare(x2.device)
    parts = torch.empty((2, lib.apex_layer_norm_bwd_blocks(R), H), dtype=torch.float32,
                        device=x2.device)
    _build.check(lib.apex_layer_norm_bwd(
        x2.data_ptr(), weight.data_ptr(), dy2.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
        dw.data_ptr(), db.data_ptr(), R, H, _build.DTYPE_CODES[x2.dtype], stream),
        "layer_norm_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dx, dw, db
