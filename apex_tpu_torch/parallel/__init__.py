"""Data parallelism (counterpart of :mod:`apex_tpu.parallel`; reference
``apex/parallel``): the replicated-state grad sync over a
``torch.distributed`` process group (:mod:`.distributed`), the
process-group start (:mod:`.multiproc`), batch norm with statistics
over a group (:mod:`.sync_batchnorm`) and layer-wise adaptive rate
control around an optimizer (:mod:`.LARC`)."""

from apex_tpu_torch.parallel.distributed import (
    DistributedDataParallel,
    Reducer,
    allreduce_gradients,
)
from apex_tpu_torch.parallel.LARC import LARC
from apex_tpu_torch.parallel.multiproc import destroy_distributed, initialize_distributed
from apex_tpu_torch.parallel.sync_batchnorm import (
    SYNCBN_AXIS,
    SyncBatchNorm,
    convert_syncbn_model,
    create_syncbn_process_group,
    sync_batch_norm_stats,
)

__all__ = [
    "DistributedDataParallel",
    "LARC",
    "Reducer",
    "SYNCBN_AXIS",
    "SyncBatchNorm",
    "allreduce_gradients",
    "convert_syncbn_model",
    "create_syncbn_process_group",
    "destroy_distributed",
    "initialize_distributed",
    "sync_batch_norm_stats",
]
