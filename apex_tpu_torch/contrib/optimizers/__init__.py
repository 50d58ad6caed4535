"""ZeRO distributed optimizers (counterpart of
:mod:`apex_tpu.contrib.optimizers`): :class:`DistributedFusedAdam` and
:class:`DistributedFusedLAMB` over the data-parallel process group, and
:func:`zero_state_from_numpy`, which carries a JAX ``DistributedFusedAdam``
/ ``DistributedFusedLAMB`` state over at any world size.  The reference's
deprecated ``FusedAdam`` / ``FusedLAMB`` / ``FP16_Optimizer`` aliases
are not carried over: import them from their maintained modules."""

from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
    DistributedFusedAdam,
    DistributedFusedAdamState,
)
from apex_tpu_torch.contrib.optimizers.distributed_fused_lamb import (
    DistributedFusedLAMB,
    DistributedFusedLAMBState,
)

__all__ = [
    "DistributedFusedAdam",
    "DistributedFusedAdamState",
    "DistributedFusedLAMB",
    "DistributedFusedLAMBState",
    "zero_state_from_numpy",
]


def zero_state_from_numpy(optimizer, shards, device=None):
    """This rank's state of ``optimizer`` (already ``init``-ed at the live
    world) from the sharded state dicts of a ZeRO state saved by either
    package at any world: a list of every saved rank's
    ``sharded_state_dict`` (numpy arrays from the JAX package, or CPU
    tensors), e.g. the ``"opt"`` entries of an elastic checkpoint's shard
    files.  The state is resharded for the optimizer's world
    (``load_sharded_state_dicts``; with model-parallel params this rank's
    model segment), checked against its master precision and wire, and
    put on ``device`` (the optimizer's by default).  The
    ZeRO twin of ``models.gpt.params_from_numpy`` and
    ``train_state_from_numpy``."""
    if optimizer.world_size is None:
        raise ValueError("init() the optimizer at the live world first: the resharded "
                         "state must match its bucket plan")
    return type(optimizer).load_sharded_state_dicts(
        shards, world_size=optimizer.world_size, rank=optimizer.rank,
        store_param_remainders=optimizer.store_param_remainders,
        grad_sync_dtype=optimizer.grad_sync_dtype,
        device=optimizer._device if device is None else device,
        model_index=optimizer.model_index)
