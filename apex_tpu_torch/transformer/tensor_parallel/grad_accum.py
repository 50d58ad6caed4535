"""Gradient accumulation into one fp32 buffer a parameter: the
``main_grad`` contract (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel.grad_accum`).

Reference: ``fused_weight_gradient_mlp_cuda.wgrad_gemm_accum_fp32`` with
``LinearWithGradAccumulationAndAsyncCommunication``
(``apex/transformer/tensor_parallel/layers.py:415-427``): over
micro-batches, each backward's weight gradient adds into one persistent
fp32 ``main_grad``, fp32 even when the model computes in half precision.
The JAX package scans the micro-batches with the buffer as the carry;
here a loop adds each micro-batch's gradients into the fp32 buffers.
"""

from typing import Callable

import torch

__all__ = ["accumulate_gradients", "make_grad_accumulator"]


def accumulate_gradients(loss_fn: Callable, params, microbatches, *args,
                         accum_dtype=torch.float32, mean_loss: bool = True):
    """Run ``loss_fn(params, microbatch, *args)`` over the leading axis of
    ``microbatches`` (a tensor or a tree of them), adding each
    micro-batch's gradients into one ``accum_dtype`` buffer a parameter.
    Returns ``(loss, grads)``: with ``mean_loss`` both averaged over the
    micro-batches (what one large-batch backward of a mean loss gives),
    else summed.  Collectives inside ``loss_fn`` (the tp mappings) run a
    micro-batch at a time, as the reference's backward does."""
    from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map, tree_unflatten

    leaves = tree_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    M = tree_leaves(microbatches)[0].shape[0]
    acc = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for p in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for m in range(M):
        loss = loss_fn(params, tree_map(lambda t: t[m], microbatches), *args)
        grads = torch.autograd.grad(loss, leaves)
        for a, g in zip(acc, grads):
            a.add_(g.to(accum_dtype))
        loss_sum = loss_sum + loss.detach().float()
    if mean_loss:
        inv = 1.0 / M
        return loss_sum * inv, tree_unflatten(params, [a * inv for a in acc])
    return loss_sum, tree_unflatten(params, acc)


def make_grad_accumulator(loss_fn: Callable, **kw):
    """``accum = make_grad_accumulator(loss_fn); loss, g = accum(params,
    microbatches)``."""

    def accum(params, microbatches, *args):
        return accumulate_gradients(loss_fn, params, microbatches, *args, **kw)

    return accum
