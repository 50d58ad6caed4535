"""Fused LayerNorm, forward.

Counterpart of ``fused_layer_norm_affine`` in
:mod:`apex_tpu.normalization.fused_layer_norm`.  The rows of the input
(everything but the trailing ``normalized_shape``) go through
:func:`apex_tpu_torch.ops.layer_norm.layer_norm_fwd`: the CUDA kernel
for CUDA tensors, the plain PyTorch version for CPU tensors.  The
numerics are the jnp specification there: fp32 mean, then
``var = mean((x - mean)**2)``, ``rstd = rsqrt(var + eps)``, affine in
fp32, and the output cast to the input's dtype.

Only the forward is ported.  On the CPU the plain version is ordinary
PyTorch and differentiates as such; through the CUDA kernel a backward
raises ``NotImplementedError`` until the training slice brings the
backward kernel.
"""

import numbers

import torch

from apex_tpu_torch.ops.layer_norm import layer_norm_fwd


def _canon_shape(normalized_shape):
    if isinstance(normalized_shape, numbers.Integral):
        return (int(normalized_shape),)
    return tuple(int(s) for s in normalized_shape)


class _LayerNormCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, weight, bias, eps):
        return layer_norm_fwd(x2, weight, bias, eps)[0]

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the LayerNorm backward kernel is not ported yet (it comes "
            "with the training slice)")


def fused_layer_norm_affine(input, weight, bias, normalized_shape, eps=1e-6,
                            memory_efficient=False):
    """Affine LayerNorm over the trailing ``normalized_shape`` of
    ``input``.  ``memory_efficient`` only changes what a backward
    saves, and no backward is ported: it is accepted and ignored."""
    del memory_efficient
    shape = _canon_shape(normalized_shape)
    n = 1
    for s in shape:
        n *= s
    x2 = input.reshape(-1, n).contiguous()
    w = weight.reshape(n).float().contiguous()
    b = bias.reshape(n).float().contiguous()
    if x2.device.type == "cuda" and torch.is_grad_enabled() and (
            x2.requires_grad or w.requires_grad or b.requires_grad):
        y = _LayerNormCUDA.apply(x2, w, b, eps)  # its backward raises
    else:
        y = layer_norm_fwd(x2, w, b, eps)[0]
    return y.reshape(input.shape)
