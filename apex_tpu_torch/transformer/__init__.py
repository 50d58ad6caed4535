"""Transformer building blocks of the port (counterpart of
:mod:`apex_tpu.transformer`); so far only the causal softmax of the
attention's einsum path."""
