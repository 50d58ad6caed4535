"""LayerNorms that mark their params as sequence-parallel (counterpart of
:mod:`apex_tpu.transformer.layers.layer_norm`).

Reference: ``apex/transformer/layers/layer_norm.py:26-99``: subclasses
of the fused norms whose one job is ``param.sequence_parallel_enabled =
True``, so that the trainer sums these params' grads over the
tensor-parallel group when sequence parallelism is on (each rank saw
only its own tokens).  Here the modules set that attribute on their
params and run the port's :mod:`~apex_tpu_torch.normalization` (the
LayerNorm kernels); :func:`sequence_parallel_param_mask` finds such
leaves in a param tree by name, as the JAX package does, and
:func:`allreduce_sequence_parallel_grads` sums them over the group.
"""

from typing import Sequence

import apex_tpu_torch.normalization as _norm
from apex_tpu_torch.transformer.tensor_parallel.mappings import tp_group

__all__ = ["FusedLayerNorm", "FastLayerNorm", "sequence_parallel_param_mask",
           "allreduce_sequence_parallel_grads"]


class FusedLayerNorm(_norm.FusedLayerNorm):
    """A LayerNorm whose params are replicated over tp; with
    ``sequence_parallel_enabled`` their grads must be summed over the
    tensor-parallel group (reference layer_norm.py:26)."""

    def __init__(self, normalized_shape, eps=1e-5, elementwise_affine=True,
                 memory_efficient=False, sequence_parallel_enabled: bool = False,
                 device="cuda"):
        super().__init__(normalized_shape, eps, elementwise_affine, memory_efficient, device)
        self.sequence_parallel_enabled = sequence_parallel_enabled
        for p in (self.weight, self.bias):
            if p is not None:
                p.sequence_parallel_enabled = sequence_parallel_enabled


class FastLayerNorm(FusedLayerNorm):
    """Reference layer_norm.py:73, the kernels tuned for some widths; the
    port's LayerNorm kernels take every width, so it is the same module."""


def sequence_parallel_param_mask(params, norm_keywords: Sequence[str] = ("ln", "norm",
                                                                         "layernorm")):
    """A tree of bools shaped like ``params`` (nested dicts): True for
    the leaves whose path names a norm, the grads that need the
    sequence-parallel sum."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}['{k}']") for k, v in node.items()}
        p = path.lower()
        return any(k in p for k in norm_keywords)

    return walk(params, "")


def allreduce_sequence_parallel_grads(grads, mask, axis_name=None):
    """``grads`` with the leaves ``mask`` marks summed over ``axis_name``
    (default the tensor-parallel group), all in one all-reduce of their
    concatenation, in fp32 (Megatron's
    ``allreduce_sequence_parallel_gradients``)."""
    import torch

    from apex_tpu_torch.optimizers.tree import tree_leaves, tree_unflatten
    from apex_tpu_torch.transformer.tensor_parallel.mappings import all_reduce_sum

    axis = tp_group(axis_name)
    leaves, marks = tree_leaves(grads), tree_leaves(mask)
    picked = [i for i, m in enumerate(marks) if m]
    if axis.size() == 1 or not picked:
        return grads
    flat = torch.cat([leaves[i].reshape(-1).float() for i in picked])
    flat = all_reduce_sum(flat, axis)
    out = list(leaves)
    off = 0
    for i in picked:
        n = leaves[i].numel()
        out[i] = flat[off:off + n].view(leaves[i].shape).to(leaves[i].dtype)
        off += n
    return tree_unflatten(grads, out)
