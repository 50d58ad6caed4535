"""Scaled causal masked softmax.

Counterpart of :mod:`apex_tpu.transformer.functional.fused_softmax`
(``MASK_FILL_VALUE``, ``scaled_upper_triang_masked_softmax``).  Plain
PyTorch: the JAX package has no Pallas kernel here either (scale, mask
and softmax are one XLA fusion there).
"""

import torch

MASK_FILL_VALUE = -10000.0


def scaled_upper_triang_masked_softmax(x, scale: float = 1.0):
    """Causal softmax over the last axis of ``(..., sq, sk)`` scores:
    entries with j > i are filled with ``MASK_FILL_VALUE`` after the
    scale, the softmax runs in fp32, and the result has x's dtype."""
    sq, sk = x.shape[-2], x.shape[-1]
    causal = torch.ones((sq, sk), dtype=torch.bool, device=x.device).tril()
    scores = (x * scale).masked_fill(~causal, MASK_FILL_VALUE)
    return torch.softmax(scores.float(), dim=-1).to(x.dtype)
