"""Shared utilities of the port (counterpart of :mod:`apex_tpu.utils`);
so far the rank-aware logging and its structured records."""

from apex_tpu_torch.utils.logging import (
    RankInfoFormatter,
    get_logger,
    log_structured,
    set_logging_level,
)

__all__ = ["RankInfoFormatter", "get_logger", "log_structured", "set_logging_level"]
