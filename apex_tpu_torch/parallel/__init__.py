"""Data parallelism (counterpart of :mod:`apex_tpu.parallel`; reference
``apex/parallel``): the replicated-state grad sync over a
``torch.distributed`` process group (:mod:`.distributed`) and the
process-group start (:mod:`.multiproc`).  ``SyncBatchNorm`` and
``LARC`` are not ported yet (ROADMAP.md queue 1 item 10)."""

from apex_tpu_torch.parallel.distributed import (
    DistributedDataParallel,
    Reducer,
    allreduce_gradients,
)
from apex_tpu_torch.parallel.multiproc import destroy_distributed, initialize_distributed

__all__ = [
    "DistributedDataParallel",
    "Reducer",
    "allreduce_gradients",
    "destroy_distributed",
    "initialize_distributed",
]
