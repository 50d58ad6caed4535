"""Tensor-parallel layers: the column- and row-parallel linears and the
vocab-parallel embedding (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel.layers`).

Reference: ``apex/transformer/tensor_parallel/layers.py``:
``VocabParallelEmbedding`` (:174), ``ColumnParallelLinear`` (:460),
``RowParallelLinear`` (:645).  The weight layout is the reference's: a
column linear holds ``(out / tp, in)``, a row linear ``(out, in / tp)``,
and ``y = x W^T + b`` with the weight and bias cast to x's dtype at use,
as the JAX package spells it.  The products stay ``torch.matmul``
(cuBLAS), as the JAX package's stay ``jnp.matmul``.

Sequence parallelism keeps the reference's dataflow: activations enter
a column linear split over the sequence (dim 0) and are all-gathered
(reduce-scattered in the backward); a row linear's output is
reduce-scattered (all-gathered in the backward).  The reference's
asynchronous grad all-reduce and fused wgrad accumulation are
scheduling of its eager backward; a captured step holds the same
collectives in one CUDA graph.

The functional forms take the local shards; the modules own them, with
the reference's three attributes stamped on each parameter.
"""

import math
from typing import Optional

import torch

from apex_tpu_torch.transformer.tensor_parallel.attributes import (
    TensorParallelAttributes, apply_attributes, set_tensor_model_parallel_attributes)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
    tp_group,
)
from apex_tpu_torch.transformer.utils import divide

__all__ = ["column_parallel_linear", "row_parallel_linear", "vocab_parallel_embedding",
           "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding"]


def column_parallel_linear(x, weight, bias: Optional[torch.Tensor] = None, *,
                           gather_output: bool = True,
                           sequence_parallel_enabled: bool = False, axis_name=None):
    """``Y = X A^T + b`` with A split over its rows (the output features);
    ``weight`` is the local ``(out / tp, in)`` shard."""
    if sequence_parallel_enabled:
        x = gather_from_sequence_parallel_region(x, axis_name)
    else:
        x = copy_to_tensor_model_parallel_region(x, axis_name)
    y = torch.matmul(x, weight.T.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    if gather_output:
        if sequence_parallel_enabled:
            raise ValueError("gather_output is incompatible with sequence parallelism")
        y = gather_from_tensor_model_parallel_region(y, axis_name)
    return y


def row_parallel_linear(x, weight, bias: Optional[torch.Tensor] = None, *,
                        input_is_parallel: bool = True,
                        sequence_parallel_enabled: bool = False, axis_name=None):
    """``Y = X A^T + b`` with A split over its columns (the input
    features); ``weight`` is the local ``(out, in / tp)`` shard.  The bias
    is added once, after the reduction."""
    if not input_is_parallel:
        if sequence_parallel_enabled:
            raise ValueError("sequence parallelism requires input_is_parallel")
        x = scatter_to_tensor_model_parallel_region(x, axis_name)
    y = torch.matmul(x, weight.T.to(x.dtype))
    if sequence_parallel_enabled:
        y = reduce_scatter_to_sequence_parallel_region(y, axis_name)
    else:
        y = reduce_from_tensor_model_parallel_region(y, axis_name)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def vocab_parallel_embedding(ids, weight, *, axis_name=None):
    """Embedding with the vocab split over the group (reference
    layers.py:174-277): ids outside this rank's rows look up some row and
    are zeroed, then the ranks' rows are summed.  ``weight`` is the local
    ``(vocab / tp, hidden)`` shard.  The reference looks such ids up at
    row 0; here at ``id mod (vocab / tp)``, the same zeros, but spread
    over the rows: the lookup's backward adds each id's zero gradient
    into its row, and (tp - 1) / tp of the ids on one row serialize that
    backward (4.3 ms a step at GPT-345M, tp 4, on an H100)."""
    axis = tp_group(axis_name)
    per_partition = weight.shape[0]
    local = ids.long() - axis.rank() * per_partition
    mask = (local < 0) | (local >= per_partition)
    out = weight[local.remainder(per_partition)]
    out = out.masked_fill(mask[..., None], 0.0)
    # all-reduce forward, identity backward: a bare all-reduce's backward
    # would count the embedding gradient tp times (layers.py:270)
    return reduce_from_tensor_model_parallel_region(out, axis)


def _normal(shape, std, device, dtype, generator):
    return torch.randn(shape, generator=generator, device=device, dtype=dtype) * std


def _param(t, attrs: TensorParallelAttributes):
    return apply_attributes(torch.nn.Parameter(t), attrs)


class ColumnParallelLinear(torch.nn.Module):
    """The module form; holds the local ``(output_size / tp, input_size)``
    shard (``output_size`` is the global width, as in layers.py:460).
    Weights are ``normal(0, 1 / sqrt(input_size))`` from ``generator``."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 gather_output: bool = True, sequence_parallel_enabled: bool = False,
                 axis_name=None, device="cuda", params_dtype=torch.float32, generator=None):
        super().__init__()
        from apex_tpu_torch._device import resolve_device

        dev = resolve_device(device)
        self.axis_name = tp_group(axis_name)
        self.input_size, self.output_size = input_size, output_size
        self.gather_output = gather_output
        self.sequence_parallel_enabled = sequence_parallel_enabled
        out_local = divide(output_size, self.axis_name.size())
        col = set_tensor_model_parallel_attributes(True, 0, 1)
        self.weight = _param(_normal((out_local, input_size), 1.0 / math.sqrt(input_size),
                                     dev, params_dtype, generator), col)
        self.bias = (_param(torch.zeros(out_local, device=dev, dtype=params_dtype), col)
                     if bias else None)

    def forward(self, x):
        return column_parallel_linear(
            x, self.weight, self.bias, gather_output=self.gather_output,
            sequence_parallel_enabled=self.sequence_parallel_enabled, axis_name=self.axis_name)


class RowParallelLinear(torch.nn.Module):
    """The module form; holds the local ``(output_size, input_size / tp)``
    shard and the whole bias (layers.py:645)."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 input_is_parallel: bool = True, sequence_parallel_enabled: bool = False,
                 axis_name=None, device="cuda", params_dtype=torch.float32, generator=None):
        super().__init__()
        from apex_tpu_torch._device import resolve_device

        dev = resolve_device(device)
        self.axis_name = tp_group(axis_name)
        self.input_size, self.output_size = input_size, output_size
        self.input_is_parallel = input_is_parallel
        self.sequence_parallel_enabled = sequence_parallel_enabled
        in_local = divide(input_size, self.axis_name.size())
        self.weight = _param(_normal((output_size, in_local), 1.0 / math.sqrt(input_size),
                                     dev, params_dtype, generator),
                             set_tensor_model_parallel_attributes(True, 1, 1))
        self.bias = (_param(torch.zeros(output_size, device=dev, dtype=params_dtype),
                            TensorParallelAttributes()) if bias else None)

    def forward(self, x):
        return row_parallel_linear(
            x, self.weight, self.bias, input_is_parallel=self.input_is_parallel,
            sequence_parallel_enabled=self.sequence_parallel_enabled, axis_name=self.axis_name)


class VocabParallelEmbedding(torch.nn.Module):
    """The module form; holds the local ``(num_embeddings / tp,
    embedding_dim)`` rows, ``normal(0, 0.02)`` from ``generator``."""

    def __init__(self, num_embeddings: int, embedding_dim: int, axis_name=None, device="cuda",
                 params_dtype=torch.float32, generator=None):
        super().__init__()
        from apex_tpu_torch._device import resolve_device

        dev = resolve_device(device)
        self.axis_name = tp_group(axis_name)
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        rows = divide(num_embeddings, self.axis_name.size())
        self.weight = _param(_normal((rows, embedding_dim), 0.02, dev, params_dtype, generator),
                             set_tensor_model_parallel_attributes(True, 0, 1))

    def forward(self, ids):
        return vocab_parallel_embedding(ids, self.weight, axis_name=self.axis_name)
