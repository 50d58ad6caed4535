"""Sigmoid focal loss for detection (counterpart of
:mod:`apex_tpu.contrib.focal_loss.focal_loss`; reference
``apex/contrib/focal_loss/focal_loss.py:6``, the ``focal_loss_cuda``
extension): ``FL(p_t) = -alpha_t (1 - p_t)^gamma log(p_t)`` over anchor
logits with one-hot targets, normalized by ``num_positives_sum``; PyTorch
ops, as it is an XLA composite in the JAX package.

Targets are class ids with -1 = ignore and 0 = background: the one-hot
of ``id - 1`` over the real classes, whose rows are zero for ids -1 and
0 (``jax.nn.one_hot``'s result for out-of-range ids; ``F.one_hot``
raises on negatives, so the one-hot is built by comparison with
``arange(C)``).
"""

import torch

__all__ = ["focal_loss"]


def focal_loss(cls_output, cls_targets_at_level, num_positives_sum, num_real_classes: int,
               alpha: float = 0.25, gamma: float = 2.0, label_smoothing: float = 0.0):
    """``cls_output`` (..., C) raw logits; ``cls_targets_at_level``
    (...) integer ids; returns the 0-d fp32 loss sum over
    ``max(num_positives_sum, 1)``."""
    t = cls_targets_at_level
    C = num_real_classes
    onehot = ((t.long() - 1)[..., None] == torch.arange(C, device=t.device)).to(torch.float32)
    valid = (t >= 0).to(torch.float32)[..., None]
    if label_smoothing > 0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / C
    x = cls_output.to(torch.float32)
    p = torch.sigmoid(x)
    ce = torch.logaddexp(torch.zeros((), dtype=torch.float32, device=x.device), x) - x * onehot
    p_t = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    loss = alpha_t * torch.pow(1 - p_t, gamma) * ce * valid
    nps = torch.as_tensor(num_positives_sum, dtype=torch.float32, device=x.device)
    return torch.sum(loss) / torch.clamp(nps, min=1.0)
