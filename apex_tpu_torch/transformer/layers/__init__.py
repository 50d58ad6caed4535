from apex_tpu_torch.transformer.layers.layer_norm import (
    FastLayerNorm,
    FusedLayerNorm,
    allreduce_sequence_parallel_grads,
    sequence_parallel_param_mask,
)

__all__ = ["FusedLayerNorm", "FastLayerNorm", "sequence_parallel_param_mask",
           "allreduce_sequence_parallel_grads"]
