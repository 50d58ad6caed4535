"""Shared utilities of the port (counterpart of :mod:`apex_tpu.utils`):
the rank-aware logging and its structured records, the math helpers and
the profiling ranges."""

from apex_tpu_torch.utils.logging import (
    RankInfoFormatter,
    get_logger,
    log_structured,
    set_logging_level,
)
from apex_tpu_torch.utils.misc import divide, ensure_divisibility
from apex_tpu_torch.utils.profiler import (
    nvtx_range,
    nvtx_range_pop,
    nvtx_range_push,
    profile,
    start_profile,
    stop_profile,
)

__all__ = ["RankInfoFormatter", "get_logger", "log_structured", "set_logging_level", "divide",
           "ensure_divisibility", "nvtx_range", "nvtx_range_push", "nvtx_range_pop",
           "profile", "start_profile", "stop_profile"]
