"""Fused LayerNorm and RMSNorm: the functions and modules of
``apex.normalization``.

Counterpart of :mod:`apex_tpu.normalization.fused_layer_norm`
(``fused_layer_norm_affine``, ``fused_layer_norm``,
``fused_rms_norm_affine``, ``fused_rms_norm``, ``manual_rms_norm``, the
``mixed_dtype_*`` aliases and the ``FusedLayerNorm``/``FusedRMSNorm``
modules).  The rows of the input (everything but the trailing
``normalized_shape``) go through
:func:`apex_tpu_torch.ops.layer_norm.layer_norm_fwd` and, for a
gradient, :func:`~apex_tpu_torch.ops.layer_norm.layer_norm_bwd`: the
CUDA kernels for CUDA tensors, the plain PyTorch versions for CPU
tensors, in the kernels' LN or RMS mode, with or without weight and
bias.  The numerics are the jnp specification there: fp32 statistics
(the centred variance for LN, ``mean(x**2)`` for RMS), ``rstd =
rsqrt(var + eps)``, affine in fp32, the output cast to the input's
dtype; the backward's dx in the input's dtype and dw/db in fp32 (cast
to the params' dtype by autograd).

When a gradient is needed the forward saves x, mean and rstd, and the
backward is one call of ``layer_norm_bwd``.  With ``memory_efficient``
it saves the output instead of x and recovers ``xhat`` from it (``(y -
b) / w``, or ``y / w`` for RMS), as ``_ln_bwd_jnp``/``_rms_bwd_jnp`` do:
that backward is plain PyTorch on either device, as the JAX package
runs it in jnp and never in its Pallas kernel.
"""

import numbers

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd


def _canon_shape(normalized_shape):
    if isinstance(normalized_shape, numbers.Integral):
        return (int(normalized_shape),)
    return tuple(int(s) for s in normalized_shape)


def manual_rms_norm(x, normalized_shape, weight, eps):
    """Pure reference (``manual_rms_norm`` of the JAX package): the fp32
    mean of squares, ``x * rsqrt(var + eps)`` in x's dtype, times the
    weight."""
    dims = tuple(range(-len(_canon_shape(normalized_shape)), 0))
    var = x.float().square().mean(dim=dims, keepdim=True)
    out = x * torch.rsqrt(var + eps).to(x.dtype)
    return out if weight is None else out * weight


def _memory_efficient_bwd(y2, weight, bias, rstd, g2, rms):
    """``_ln_bwd_jnp`` / ``_rms_bwd_jnp`` with ``memory_efficient``: xhat
    from the saved output, then the kernel's formulas, in fp32 torch
    ops.  Returns ``(dx, dw, db)``, None where there is no param."""
    gf, yf = g2.float(), y2.float()
    inv = rstd[:, None]
    if bias is not None:
        yf = yf - bias.float()
    xhat = yf / weight.float() if weight is not None else yf
    gw = gf * weight.float() if weight is not None else gf
    m2 = (gw * xhat).mean(dim=1, keepdim=True)
    if rms:
        dx = (gw - xhat * m2) * inv
    else:
        dx = (gw - gw.mean(dim=1, keepdim=True) - xhat * m2) * inv
    dw = (gf * xhat).sum(0) if weight is not None else None
    db = gf.sum(0) if bias is not None else None
    return dx.to(g2.dtype), dw, db


class _LayerNormCUDA(torch.autograd.Function):
    """LayerNorm (RMSNorm with ``rms``) of (R, H) rows, weight and bias
    optional, whose backward is ``layer_norm_bwd`` (the kernel on CUDA
    tensors, its plain version on CPU tensors) or, with
    ``memory_efficient``, :func:`_memory_efficient_bwd`."""

    @staticmethod
    def forward(ctx, x2, weight, bias, eps, rms, memory_efficient):
        y, mean, rstd = layer_norm_fwd(x2, weight, bias, eps, rms)
        if memory_efficient:
            ctx.save_for_backward(y, weight, bias, rstd)
        else:
            ctx.save_for_backward(x2, weight, bias, rstd, mean)
        ctx.flags = (rms, memory_efficient)
        return y

    @staticmethod
    def backward(ctx, grad):
        rms, memory_efficient = ctx.flags
        grad = grad.contiguous()
        if memory_efficient:
            y, weight, bias, rstd = ctx.saved_tensors
            dx, dw, db = _memory_efficient_bwd(y, weight, bias, rstd, grad, rms)
        else:
            x2, weight, bias, rstd, mean = ctx.saved_tensors
            dx, dw, db = layer_norm_bwd(x2, weight, grad, mean, rstd, rms,
                                        with_bias=bias is not None)
        return dx, dw, db, None, None, None


def _norm(input, weight, bias, normalized_shape, eps, memory_efficient, rms):
    shape = _canon_shape(normalized_shape)
    n = int(np.prod(shape))
    x2 = input.reshape(-1, n).contiguous()
    w = None if weight is None else weight.reshape(n).float().contiguous()
    b = None if bias is None else bias.reshape(n).float().contiguous()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x2, w, b)):
        y = _LayerNormCUDA.apply(x2, w, b, eps, rms, memory_efficient)
    else:
        y = layer_norm_fwd(x2, w, b, eps, rms)[0]
    return y.reshape(input.shape)


def fused_layer_norm_affine(input, weight, bias, normalized_shape, eps=1e-6,
                            memory_efficient=False):
    """Affine LayerNorm over the trailing ``normalized_shape`` of
    ``input`` (``FusedLayerNormAffineFunction``), differentiable in
    input, weight and bias."""
    return _norm(input, weight, bias, normalized_shape, eps, memory_efficient, False)


def fused_layer_norm(input, normalized_shape, eps=1e-6, memory_efficient=False):
    """LayerNorm without weight and bias (``FusedLayerNormFunction``)."""
    return _norm(input, None, None, normalized_shape, eps, memory_efficient, False)


def fused_rms_norm_affine(input, weight, normalized_shape, eps=1e-6,
                          memory_efficient=False):
    """RMSNorm with a weight (``FusedRMSNormAffineFunction``)."""
    return _norm(input, weight, None, normalized_shape, eps, memory_efficient, True)


def fused_rms_norm(input, normalized_shape, eps=1e-6, memory_efficient=False):
    """RMSNorm without a weight (``FusedRMSNormFunction``)."""
    return _norm(input, None, None, normalized_shape, eps, memory_efficient, True)


def mixed_dtype_fused_layer_norm_affine(input, weight, bias, normalized_shape, eps=1e-6,
                                        memory_efficient=False):
    """Mixed input/param dtype variant: fp32 params, a half input, the
    output in the input's dtype (the params are fp32 here anyway)."""
    return fused_layer_norm_affine(input, weight, bias, normalized_shape, eps,
                                   memory_efficient)


def mixed_dtype_fused_rms_norm_affine(input, weight, normalized_shape, eps=1e-6,
                                      memory_efficient=False):
    """Mixed dtype RMSNorm."""
    return fused_rms_norm_affine(input, weight, normalized_shape, eps, memory_efficient)


class _FusedNorm(torch.nn.Module):
    """The modules' shared body: fp32 ``weight`` (ones) and, for
    LayerNorm, ``bias`` (zeros) as parameters on ``device`` (default
    ``"cuda"``, which raises without a GPU)."""

    _rms = False

    def __init__(self, normalized_shape, eps=1e-5, elementwise_affine=True,
                 memory_efficient=False, device="cuda"):
        super().__init__()
        self.normalized_shape = _canon_shape(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        self.memory_efficient = memory_efficient
        dev = resolve_device(device)
        self.weight = self.bias = None
        if elementwise_affine:
            self.weight = torch.nn.Parameter(
                torch.ones(self.normalized_shape, dtype=torch.float32, device=dev))
            if not self._rms:
                self.bias = torch.nn.Parameter(
                    torch.zeros(self.normalized_shape, dtype=torch.float32, device=dev))

    def load_flax_params(self, params):
        """Copy the JAX module's params (``{"weight", "bias"}`` as numpy
        arrays, optionally under a ``"params"`` key) into this module."""
        params = params.get("params", params)
        names = [n for n, p in (("weight", self.weight), ("bias", self.bias))
                 if p is not None]
        if sorted(params) != sorted(names):
            raise ValueError(f"expected params {names}, got {sorted(params)}")
        with torch.no_grad():
            for name in names:
                p = getattr(self, name)
                src = torch.as_tensor(np.asarray(params[name], np.float32))
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(p.shape)}")
                p.copy_(src)
        return self

    def forward(self, x):
        return _norm(x, self.weight, self.bias, self.normalized_shape, self.eps,
                     self.memory_efficient, self._rms)

    def extra_repr(self):
        return (f"{self.normalized_shape}, eps={self.eps}, "
                f"elementwise_affine={self.elementwise_affine}, "
                f"memory_efficient={self.memory_efficient}")


class FusedLayerNorm(_FusedNorm):
    """``apex.normalization.FusedLayerNorm``: fp32 params, any input
    dtype (the "mixed" behaviour is the default)."""


class FusedRMSNorm(_FusedNorm):
    """``apex.normalization.FusedRMSNorm``: an fp32 weight, no bias."""

    _rms = True


# The mixed variants are the same computation (the params are fp32).
MixedFusedLayerNorm = FusedLayerNorm
MixedFusedRMSNorm = FusedRMSNorm
