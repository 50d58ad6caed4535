"""LayerNorm and RMSNorm forward and backward: the CUDA kernels and
their plain PyTorch versions.

Counterpart of :mod:`apex_tpu.ops.layer_norm_pallas`
(``layer_norm_fwd_pallas``, ``layer_norm_bwd_pallas``) with its flags:
``rms`` (mean 0, var = mean(x**2)), an optional fp32 weight (affine)
and an optional fp32 bias.  The kernels are in ``csrc/layer_norm.cu``
(its comments say what bounds each and how it is laid out); the flags
are parameters of the one kernel pair.

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
        return f"x must be a contiguous float32/bfloat16 (R, H) tensor, got {x2.dtype} {tuple(x2.shape)}"
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
    float32/bfloat16, with fp32 ``weight``/``bias`` (H,) or None.
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
    dtype (float32/bfloat16), fp32 ``weight`` (H,) or None, and the
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
    dw = torch.zeros(H, dtype=torch.float32, device=x2.device) if affine else None
    db = torch.zeros(H, dtype=torch.float32, device=x2.device) if affine and with_bias else None
    if R == 0:
        return dx, dw, db
    lib, stream = _build.prepare(x2.device)
    part_w = part_b = None
    if affine:
        G = lib.apex_layer_norm_bwd_blocks(R)
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
