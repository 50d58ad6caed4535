"""Fused gradient clipping (counterpart of
:mod:`apex_tpu.contrib.clip_grad.clip_grad`, after apex's
``contrib/clip_grad/clip_grad.py``).

Functional: ``clip_grad_norm_(grads, max_norm, norm_type)`` returns
``(clipped_grads, total_norm)`` and mutates nothing.  The L2 norm runs
on the ``mt_l2norm`` kernel (:func:`~apex_tpu_torch.ops.multi_tensor.multi_tensor_l2norm`);
norm types inf and p are plain tensor ops, as in the JAX package.
"""

import math

import torch

from apex_tpu_torch.ops.multi_tensor import multi_tensor_l2norm
from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map


def clip_grad_norm_(grads, max_norm: float, norm_type: float = 2.0,
                    error_if_nonfinite: bool = False):
    """torch ``clip_grad_norm_`` semantics: ``clip_coef = max_norm /
    (total_norm + 1e-6)``, applied when below 1; each grad is multiplied
    in fp32 and cast back to its dtype.  ``error_if_nonfinite`` is
    accepted for the signature and, as in the JAX package, not acted on
    (acting on it would read the norm on the host)."""
    leaves = tree_leaves(grads)
    if not leaves:
        return grads, torch.zeros((), dtype=torch.float32)
    if norm_type == 2.0:
        total_norm = multi_tensor_l2norm(grads)
    elif norm_type == math.inf:
        total_norm = torch.max(torch.stack(
            [torch.max(torch.abs(g.to(torch.float32))) for g in leaves]))
    else:
        total_norm = torch.pow(torch.stack(
            [torch.sum(torch.pow(torch.abs(g.to(torch.float32)), norm_type))
             for g in leaves]).sum(), 1.0 / norm_type)
    max_t = torch.full((), float(max_norm), dtype=torch.float32, device=total_norm.device)
    clip_coef = torch.clamp(torch.div(max_t, total_norm + 1e-6), max=1.0)
    clipped = tree_map(lambda g: (g.to(torch.float32) * clip_coef).to(g.dtype), grads)
    return clipped, total_norm
