"""Tensor-parallel parameter attributes (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel.attributes`).

Reference: ``apex/transformer/tensor_parallel/layers.py:70-107`` stamps
``tensor_model_parallel``, ``partition_dim`` and ``partition_stride``
onto each ``torch.nn.Parameter`` so that the grad norm and checkpoints
can tell sharded parameters from replicated duplicates.  The JAX package
keeps them as a spec tree beside the params; so does the port, with the
same functions over :class:`TensorParallelAttributes` and dict trees
(:func:`attributes_tree`).  :func:`apply_attributes` stamps a spec onto a
tensor as the reference does, for code that reads
``param.tensor_model_parallel``.
"""

import dataclasses
from typing import Any, Optional

__all__ = ["TensorParallelAttributes", "set_tensor_model_parallel_attributes",
           "set_defaults_if_not_set_tensor_model_parallel_attributes",
           "copy_tensor_model_parallel_attributes", "param_is_not_tensor_parallel_duplicate",
           "attributes_tree", "apply_attributes"]


@dataclasses.dataclass
class TensorParallelAttributes:
    """The reference's three attributes (layers.py:70-74)."""

    tensor_model_parallel: bool = False
    partition_dim: int = -1
    partition_stride: int = 1


def set_tensor_model_parallel_attributes(is_parallel: bool, dim: int,
                                         stride: int) -> TensorParallelAttributes:
    """The spec of a sharded param (layers.py:82-89)."""
    return TensorParallelAttributes(tensor_model_parallel=is_parallel, partition_dim=dim,
                                    partition_stride=stride)


def set_defaults_if_not_set_tensor_model_parallel_attributes(
        attrs: Optional[TensorParallelAttributes]) -> TensorParallelAttributes:
    """None -> the replicated defaults (layers.py:92-98)."""
    return TensorParallelAttributes() if attrs is None else attrs


def copy_tensor_model_parallel_attributes(
        source: TensorParallelAttributes) -> TensorParallelAttributes:
    """A fresh copy of a spec (layers.py:101-107)."""
    return dataclasses.replace(source)


def param_is_not_tensor_parallel_duplicate(attrs: Optional[TensorParallelAttributes],
                                           tp_rank: int) -> bool:
    """True when the param counts on this tp rank: it is sharded (every
    rank holds a distinct slice) or this is tp rank 0 (a replicated param
    counted once).  ``attrs`` is a spec, None, or a tensor stamped by
    :func:`apply_attributes` (unstamped: replicated).  Reference
    layers.py:76-79."""
    return bool(getattr(attrs, "tensor_model_parallel", False)) or tp_rank == 0


def attributes_tree(params: Any, is_parallel_fn) -> Any:
    """A spec tree shaped like ``params`` (nested dicts of tensors):
    ``is_parallel_fn(path, leaf)`` gives None (replicated) or ``(dim,
    stride)`` for a sharded leaf; ``path`` is the tuple of keys."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        r = is_parallel_fn(path, node)
        if r is None:
            return TensorParallelAttributes()
        dim, stride = r
        return set_tensor_model_parallel_attributes(True, dim, stride)

    return walk(params, ())


def apply_attributes(tensor, attrs: TensorParallelAttributes):
    """Stamp the reference's three attributes onto ``tensor`` (a
    Parameter or a tensor) and return it."""
    for f in dataclasses.fields(TensorParallelAttributes):
        setattr(tensor, f.name, getattr(attrs, f.name))
    return tensor
