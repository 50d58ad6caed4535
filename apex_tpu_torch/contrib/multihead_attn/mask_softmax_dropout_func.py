"""The fused mask + softmax + dropout of the attention core (counterpart
of :mod:`apex_tpu.contrib.multihead_attn.mask_softmax_dropout_func`;
reference ``apex/contrib/multihead_attn/mask_softmax_dropout_func.py``,
``MaskSoftmaxDropout.apply`` over the ``fast_multihead_attn``
extension).

A composite of PyTorch ops, as it is an XLA composite in the JAX
package: the mask added in fp32, the row softmax in fp32 cast back to
the input's dtype, then dropout; autograd gives the backward.  The
reference's positional signature ``(is_training, heads, inputs,
pad_mask, mask_additive, dropout_prob)`` is kept, ``inputs`` shaped
``(B*heads, Sq, Sk)`` and ``pad_mask`` either a byte mask ``(B, Sk)``
(nonzero = PAD) or an additive float mask broadcastable to the scores.
Dropout draws from an explicit ``generator=`` (a ``torch.Generator`` on
the inputs' device), the twin of the JAX function's ``key=``: training
with dropout raises without one.
"""

from typing import Optional

import torch

from apex_tpu_torch.ops.attention import padding_bias

__all__ = ["fast_mask_softmax_dropout_func", "dropout"]


def dropout(x, rate: float, generator: Optional[torch.Generator]):
    """``x`` with each element kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``, else 0 (flax's ``Dropout`` and
    ``jax.random.bernoulli`` form), the keep mask drawn from
    ``generator``."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x / keep, 0.0)


def fast_mask_softmax_dropout_func(
    is_training: bool,
    heads: int,
    inputs: torch.Tensor,
    pad_mask: Optional[torch.Tensor],
    mask_additive: bool,
    dropout_prob: float,
    *,
    generator: Optional[torch.Generator] = None,
):
    """Softmax over the last axis with an optional padding mask, then
    dropout.  ``inputs``: (B*heads, Sq, Sk) scores.  ``pad_mask``: (B,
    Sk) with nonzero = PAD when ``mask_additive`` is False, else an
    additive float mask broadcastable to the scores."""
    scores = inputs
    if pad_mask is not None:
        if mask_additive:
            add = pad_mask.to(torch.float32)
        else:
            add = padding_bias(~pad_mask.to(torch.bool))  # True = PAD -> NEG_INF
        if add.dim() == 2:  # (B, Sk): broadcast over heads and Sq
            bh, sq, sk = scores.shape
            scores = (scores.to(torch.float32).reshape(-1, heads, sq, sk)
                      + add[:, None, None, :]).reshape(bh, sq, sk)
        else:
            scores = scores.to(torch.float32) + add
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(inputs.dtype)
    if is_training and dropout_prob > 0.0:
        if generator is None:
            raise ValueError("fast_mask_softmax_dropout_func: training dropout needs "
                             "generator=")
        probs = dropout(probs, dropout_prob, generator).to(inputs.dtype)
    return probs
