"""Softmax cross entropy with label smoothing on logits (counterpart of
:mod:`apex_tpu.contrib.xentropy.softmax_xentropy`; reference
``apex/contrib/xentropy/softmax_xentropy.py:6``,
``SoftmaxCrossEntropyLoss`` over ``apex/contrib/csrc/xentropy``).

An autograd Function of PyTorch ops, as it is an XLA composite (a
``custom_vjp``) in the JAX package: the forward saves the fp32
log-softmax, and the backward is one ``softmax - (1 - s) * onehot - s / C``
pass times the loss's cotangent, cast to the logits' dtype.  The fused
CE kernels (:mod:`apex_tpu_torch.ops.fused_ce`) compute ``x . embed^T``
and never take logits, so they do not serve here.
"""

import torch

__all__ = ["softmax_xentropy", "SoftmaxCrossEntropyLoss"]


def _fwd_math(logits, labels, smoothing):
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    if smoothing > 0:
        smooth_loss = -torch.mean(logp, dim=-1)
        return (1.0 - smoothing) * nll + smoothing * smooth_loss, logp
    return nll, logp


class _SoftmaxXentropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, smoothing):
        loss, logp = _fwd_math(logits, labels, smoothing)
        ctx.save_for_backward(logp, labels)
        ctx.smoothing, ctx.dtype = smoothing, logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        logp, labels = ctx.saved_tensors
        s = ctx.smoothing
        c = logp.shape[1]
        onehot = (labels.long()[:, None] == torch.arange(c, device=logp.device)).to(torch.float32)
        grad = torch.exp(logp) - (1.0 - s) * onehot - s / c
        return (grad * g[:, None]).to(ctx.dtype), None, None


def softmax_xentropy(logits, labels, smoothing: float = 0.0, half_to_float: bool = False):
    """Per-sample loss (fp32); logits (N, C), labels (N,).  With
    smoothing s: ``(1 - s) * nll(target) + s * mean_c(nll(c))``.
    ``half_to_float`` is accepted for the reference's signature (the
    loss is fp32 either way)."""
    del half_to_float
    return _SoftmaxXentropy.apply(logits, labels, float(smoothing))


class SoftmaxCrossEntropyLoss:
    """The reference's autograd-Function class form: ``apply(logits,
    labels, smoothing, padding_idx, half_to_float)``.  ``padding_idx`` is
    accepted and ignored, as in the JAX package."""

    @staticmethod
    def apply(logits, labels, smoothing=0.0, padding_idx=0, half_to_float=False):
        return softmax_xentropy(logits, labels, smoothing, half_to_float)
