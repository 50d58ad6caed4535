"""Contrib modules of the port (counterpart of :mod:`apex_tpu.contrib`):
:mod:`~apex_tpu_torch.contrib.clip_grad`, the ZeRO optimizers
(:mod:`~apex_tpu_torch.contrib.optimizers`) and the fast LayerNorm
names (:mod:`~apex_tpu_torch.contrib.layer_norm`)."""
