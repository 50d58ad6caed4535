"""Rank-aware logging (counterpart of :mod:`apex_tpu.utils.logging`).

Reference: ``apex/__init__.py:32-43`` (``RankInfoFormatter``) and
``apex/transformer/log_util.py``.  The rank is ``torch.distributed``'s
when a process group is initialized, read lazily so logging works
before ``init_process_group``.
"""

import json
import logging
import sys


def _rank_info() -> str:
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return f"[p{dist.get_rank()}/{dist.get_world_size()}]"
        return "[p0/1]"
    except Exception:  # noqa: BLE001 — rank is best-effort decoration
        return "[p?/?]"


class RankInfoFormatter(logging.Formatter):
    """Prepends the process rank to every record."""

    def format(self, record):
        record.rank_info = _rank_info()
        return super().format(record)


_FORMAT = "%(asctime)s %(rank_info)s %(name)s %(levelname)s: %(message)s"


def get_logger(name: str = "apex_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(RankInfoFormatter(_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
    return logger


def set_logging_level(level) -> None:
    """Reference: apex/transformer/log_util.py (set_logging_level)."""
    get_logger().setLevel(level)


def log_structured(logger: logging.Logger, level: int, event: str,
                   **fields) -> None:
    """One-line machine-parseable log record: ``EVENT {json fields}``.

    The resilience runtime (step guard, preemption, the watchdog) and
    the checkpoint I/O report through this, so a postmortem can grep one
    event name and get every occurrence with its context as JSON.  The
    step-correlation context
    (:func:`apex_tpu_torch.observability.set_step_context`) is merged
    into every record, and an installed flight recorder
    (:func:`apex_tpu_torch.observability.flightrec.install`) gets every
    record in its event ring."""
    from apex_tpu_torch.observability.correlation import step_context
    from apex_tpu_torch.observability.flightrec import observe_event

    fields = {**step_context(), **fields}
    observe_event(event, fields)  # no-op without an installed recorder
    try:
        payload = json.dumps(fields, sort_keys=True, default=str)
    except (TypeError, ValueError):
        payload = json.dumps({k: repr(v) for k, v in fields.items()},
                             sort_keys=True)
    logger.log(level, "%s %s", event, payload)
