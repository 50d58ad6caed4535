"""Transformer building blocks of the port (counterpart of
:mod:`apex_tpu.transformer`): the causal softmax of the attention's
einsum path, the model-parallel ``GradScaler``
(:mod:`~apex_tpu_torch.transformer.amp`), the process groups
(:mod:`~apex_tpu_torch.transformer.parallel_state`), tensor and sequence
parallelism (:mod:`~apex_tpu_torch.transformer.tensor_parallel`,
:mod:`~apex_tpu_torch.transformer.layers`), the mixture-of-experts FFN
(:mod:`~apex_tpu_torch.transformer.expert_parallel`), the utilities and
enums, and the Megatron batch samplers (``_data``)."""
