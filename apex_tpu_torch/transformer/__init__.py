"""Transformer building blocks of the port (counterpart of
:mod:`apex_tpu.transformer`); so far the causal softmax of the
attention's einsum path and the model-parallel ``GradScaler``
(:mod:`~apex_tpu_torch.transformer.amp`)."""
