"""Host-side I/O runtime of the port (counterpart of
:mod:`apex_tpu.io`): the native flatten/unflatten/gather_rows host
library, single-file and sharded checkpoints in the JAX package's byte
layout, the async checkpointer and input prefetch."""

from apex_tpu_torch.io import native
from apex_tpu_torch.io.async_checkpoint import AsyncCheckpointer
from apex_tpu_torch.io.checkpoint import (
    AllCheckpointsTornError,
    CorruptCheckpoint,
    LocalShard,
    checkpoint_step,
    latest_checkpoint,
    latest_distributed_step,
    load_checkpoint,
    load_distributed_checkpoint,
    load_sharded_checkpoint,
    open_checkpoint_lazy,
    probe_checkpoint,
    probe_checkpoint_dir,
    quarantine_checkpoint,
    read_index,
    save_checkpoint,
    save_distributed_checkpoint,
    save_sharded_checkpoint,
    validate_checkpoint,
    written_by_jax,
)
from apex_tpu_torch.io.prefetch import PrefetchIterator

__all__ = [
    "AllCheckpointsTornError", "AsyncCheckpointer", "CorruptCheckpoint", "LocalShard",
    "PrefetchIterator", "checkpoint_step", "latest_checkpoint", "latest_distributed_step",
    "load_checkpoint", "load_distributed_checkpoint", "load_sharded_checkpoint", "native",
    "open_checkpoint_lazy", "probe_checkpoint", "probe_checkpoint_dir",
    "quarantine_checkpoint", "read_index", "save_checkpoint", "save_distributed_checkpoint",
    "save_sharded_checkpoint", "validate_checkpoint", "written_by_jax",
]
