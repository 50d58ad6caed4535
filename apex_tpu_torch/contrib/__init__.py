"""Contrib modules of the port (counterpart of :mod:`apex_tpu.contrib`):
:mod:`~apex_tpu_torch.contrib.clip_grad` and the ZeRO optimizers
(:mod:`~apex_tpu_torch.contrib.optimizers`)."""
