"""Megatron-style tensor parallelism over a ``torch.distributed`` group
(counterpart of :mod:`apex_tpu.transformer.tensor_parallel`, with its
names; reference ``apex/transformer/tensor_parallel``)."""

from apex_tpu_torch.transformer.tensor_parallel.attributes import (
    TensorParallelAttributes,
    apply_attributes,
    attributes_tree,
    copy_tensor_model_parallel_attributes,
    param_is_not_tensor_parallel_duplicate,
    set_defaults_if_not_set_tensor_model_parallel_attributes,
    set_tensor_model_parallel_attributes,
)
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.data import broadcast_data, broadcast_from_rank0
from apex_tpu_torch.transformer.tensor_parallel.grad_accum import (
    accumulate_gradients,
    make_grad_accumulator,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    column_parallel_linear,
    row_parallel_linear,
    vocab_parallel_embedding,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.memory import (
    MemoryBuffer,
    RingMemBuffer,
    allocate_mem_buff,
    get_mem_buffs,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    RNGStatesTracker,
    checkpoint,
    get_cuda_rng_tracker,
    get_rng_state_tracker,
    init_checkpointed_activations_memory_buffer,
    model_parallel_cuda_manual_seed,
    model_parallel_seed,
    reset_checkpointed_activations_memory_buffer,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility,
    split_tensor_along_last_dim,
)

__all__ = [
    "TensorParallelAttributes",
    "apply_attributes",
    "attributes_tree",
    "copy_tensor_model_parallel_attributes",
    "param_is_not_tensor_parallel_duplicate",
    "set_defaults_if_not_set_tensor_model_parallel_attributes",
    "set_tensor_model_parallel_attributes",
    "init_checkpointed_activations_memory_buffer",
    "reset_checkpointed_activations_memory_buffer",
    "vocab_parallel_cross_entropy",
    "broadcast_data",
    "broadcast_from_rank0",
    "accumulate_gradients",
    "make_grad_accumulator",
    "ColumnParallelLinear",
    "RowParallelLinear",
    "VocabParallelEmbedding",
    "column_parallel_linear",
    "row_parallel_linear",
    "vocab_parallel_embedding",
    "copy_to_tensor_model_parallel_region",
    "gather_from_sequence_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "scatter_to_sequence_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "MemoryBuffer",
    "RingMemBuffer",
    "allocate_mem_buff",
    "get_mem_buffs",
    "RNGStatesTracker",
    "checkpoint",
    "get_cuda_rng_tracker",
    "get_rng_state_tracker",
    "model_parallel_cuda_manual_seed",
    "model_parallel_seed",
    "VocabUtility",
    "split_tensor_along_last_dim",
]
