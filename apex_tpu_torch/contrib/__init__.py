"""Contrib modules of the port (counterpart of :mod:`apex_tpu.contrib`):
so far :mod:`~apex_tpu_torch.contrib.clip_grad`."""
