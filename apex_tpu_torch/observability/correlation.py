"""Step-correlation context: join logs, metrics, and trace spans
(counterpart of :mod:`apex_tpu.observability.correlation`).

One tiny process-global ``(run_id, step)`` pair, set by the training /
serving loop at its own cadence.  Three consumers read it:

- :func:`apex_tpu_torch.utils.logging.log_structured` merges it into every
  structured event's JSON payload,
- :meth:`apex_tpu_torch.observability.metrics.MetricsRegistry.snapshot_jsonl`
  stamps it onto every metrics point,
- :mod:`~apex_tpu_torch.observability.tracing` stamps it on every span,

so a wedged-run postmortem can join a log line, a metrics sample, and
a trace span on exactly ``(run_id, step)``.

Deliberately stdlib-only and import-cycle-free: this module imports
nothing from the package.
"""

import re
from typing import Optional

__all__ = ["clear_step_context", "set_step_context", "span_suffix",
           "step_context"]

_RUN_ID: Optional[str] = None
_STEP: Optional[int] = None

#: keep ids to characters every consumer (file names, trace viewers,
#: profiler range names) accepts
_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def set_step_context(run_id: Optional[str] = None,
                     step: Optional[int] = None) -> None:
    """Record the loop's current ``(run_id, step)``.  ``run_id=None``
    keeps the previously set id (the loop usually sets it once and then
    only advances ``step``)."""
    global _RUN_ID, _STEP
    if run_id is not None:
        _RUN_ID = _SAFE.sub("_", str(run_id))
    if step is not None:
        _STEP = int(step)


def clear_step_context() -> None:
    global _RUN_ID, _STEP
    _RUN_ID, _STEP = None, None


def step_context() -> dict:
    """The current correlation fields (empty dict when unset) — callers
    merge this into their own payloads."""
    out = {}
    if _RUN_ID is not None:
        out["run_id"] = _RUN_ID
    if _STEP is not None:
        out["step"] = _STEP
    return out


def span_suffix() -> str:
    """Trace-span spelling of the context (``""`` when unset):
    ``.run_<id>.s<step>`` appended to a range name."""
    parts = []
    if _RUN_ID is not None:
        parts.append(f"run_{_RUN_ID}")
    if _STEP is not None:
        parts.append(f"s{_STEP}")
    return ("." + ".".join(parts)) if parts else ""
