"""Fused LayerNorm, forward and backward.

Counterpart of ``fused_layer_norm_affine`` in
:mod:`apex_tpu.normalization.fused_layer_norm` (``_ln_fwd``,
``_ln_bwd``, ``_ln_bwd_jnp``).  The rows of the input (everything but
the trailing ``normalized_shape``) go through
:func:`apex_tpu_torch.ops.layer_norm.layer_norm_fwd` and, for a
gradient, :func:`~apex_tpu_torch.ops.layer_norm.layer_norm_bwd`: the
CUDA kernels for CUDA tensors, the plain PyTorch versions for CPU
tensors.  The numerics are the jnp specification there: fp32 mean, then
``var = mean((x - mean)**2)``, ``rstd = rsqrt(var + eps)``, affine in
fp32, the output cast to the input's dtype; the backward's dx in the
input's dtype and dw/db in fp32 (cast to the params' dtype by autograd).

When a gradient is needed, the forward saves x, mean and rstd, on either
device, and the backward is one call of ``layer_norm_bwd``.  The
``memory_efficient`` backward (saving the output instead of x) is not
ported: asking for it with a gradient raises.
"""

import numbers

import torch

from apex_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd


def _canon_shape(normalized_shape):
    if isinstance(normalized_shape, numbers.Integral):
        return (int(normalized_shape),)
    return tuple(int(s) for s in normalized_shape)


class _LayerNormCUDA(torch.autograd.Function):
    """LayerNorm of (R, H) rows whose backward is ``layer_norm_bwd``:
    the kernel on CUDA tensors, its plain version on CPU tensors."""

    @staticmethod
    def forward(ctx, x2, weight, bias, eps):
        y, mean, rstd = layer_norm_fwd(x2, weight, bias, eps)
        ctx.save_for_backward(x2, weight, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, grad):
        x2, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x2, weight, grad.contiguous(), mean, rstd)
        return dx, dw, db, None


def fused_layer_norm_affine(input, weight, bias, normalized_shape, eps=1e-6,
                            memory_efficient=False):
    """Affine LayerNorm over the trailing ``normalized_shape`` of
    ``input``, differentiable in input, weight and bias."""
    shape = _canon_shape(normalized_shape)
    n = 1
    for s in shape:
        n *= s
    x2 = input.reshape(-1, n).contiguous()
    w = weight.reshape(n).float().contiguous()
    b = bias.reshape(n).float().contiguous()
    if torch.is_grad_enabled() and (
            x2.requires_grad or w.requires_grad or b.requires_grad):
        if memory_efficient:
            raise NotImplementedError(
                "the memory_efficient LayerNorm backward (saving the output "
                "instead of the input) is not ported yet")
        y = _LayerNormCUDA.apply(x2, w, b, eps)
    else:
        y = layer_norm_fwd(x2, w, b, eps)[0]
    return y.reshape(input.shape)
