"""Optimizers of the port (counterpart of :mod:`apex_tpu.optimizers`):
so far :class:`FusedAdam`, on its per-leaf path."""

from apex_tpu_torch.optimizers.fused_adam import AdamState, FusedAdam

__all__ = ["AdamState", "FusedAdam"]
