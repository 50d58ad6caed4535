"""Crash-forensics flight recorder: the last N things the process did
(counterpart of :mod:`apex_tpu.observability.flightrec`).

A wedged collective, a bad-step budget abort, a preemption, a hard
kill — by the time the postmortem starts, the process is gone and the
logs only hold what someone thought to print.  The flight recorder is
the black box: a fixed-size ring of the most recent

- **trace spans** (fed live from the :mod:`~apex_tpu_torch.observability
  .tracing` tracer via a listener — including the still-OPEN span of a
  wedged dispatch),
- **structured events** (fed from ``utils.logging.log_structured``
  whenever a recorder is installed),
- **StepStats windows** (the trainer records each harvested summary),

dumped ATOMICALLY (``io.native.atomic_output`` — a crash mid-dump can
never publish a torn file) when something dies:

| trigger | who calls it |
|---|---|
| watchdog wedge | the driver's ``on_wedge`` hook → :meth:`FlightRecorder.dump` (``"wedge"``) |
| StepGuard budget abort | ``StepGuard.check`` → :func:`dump_active` (``"step_guard_abort"``) |
| preemption notice | ``PreemptionHandler`` → :func:`dump_active` (``"preemption"``) |
| hard kill (137) | nothing runs — the periodically republished :meth:`checkpoint` file IS the dump |

Reading side: :func:`load_dump` validates the schema and fails loudly
on torn bytes; :func:`latest_dump` scans a directory newest-first and
SKIPS torn/partial files with a structured
``flightrec.torn_dump_skipped`` warning — a half-written dump from the
crash being investigated must not crash the investigation.

Every record carries the correlation ``(run_id, step)``
(:mod:`~apex_tpu_torch.observability.correlation`), so a dump's last span, a
metrics point, and a log line all join on the wedged step.
"""

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from apex_tpu_torch.observability.correlation import step_context

__all__ = [
    "FlightRecorder", "active", "default_dir", "dump_active", "install",
    "latest_dump", "latest_dump_path", "load_dump", "observe_event",
    "uninstall",
]


def default_dir(metrics_dir=None, trace_dir=None) -> Optional[str]:
    """The ONE dir convention writers (drivers) and readers (the
    supervisor's attach-to-restart-record) share: the trace dir when
    tracing is on, else ``<metrics_dir>/flightrec``, else None (memory-
    only recording)."""
    if trace_dir:
        return str(trace_dir)
    if metrics_dir:
        return os.path.join(str(metrics_dir), "flightrec")
    return None

SCHEMA = "apex_tpu_flightrec_v1"

_ACTIVE: Optional["FlightRecorder"] = None


class FlightRecorder:
    """Bounded ring of recent spans/events/stats + atomic dump.

    ``dir_path`` (optional) enables file output: :meth:`checkpoint`
    atomically republishes ``flightrec_<pid>.json`` (call it at the
    telemetry cadence — a hard-killed process leaves its last
    checkpoint as the de-facto dump), and :meth:`dump` writes a final
    reason-stamped ``flightrec_dump_<ms>_<pid>.json``.  Thread-safe:
    the tracer listener and ``log_structured`` feed from any thread.
    """

    def __init__(self, dir_path=None, capacity: int = 512,
                 events_capacity: int = 512, stats_capacity: int = 64,
                 run_id: Optional[str] = None, time_fn=time.time):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.dir = str(dir_path) if dir_path is not None else None
        if self.dir is not None:
            os.makedirs(self.dir, exist_ok=True)
        self.run_id = run_id
        self._time = time_fn
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=int(capacity))
        self._events: deque = deque(maxlen=int(events_capacity))
        self._stats: deque = deque(maxlen=int(stats_capacity))
        self._tracer = None
        self.dumped: List[str] = []
        self.path = (os.path.join(self.dir,
                                  f"flightrec_{os.getpid()}.json")
                     if self.dir is not None else None)

    # ----------------------------------------------------------- feeds
    def attach(self, tracer) -> "FlightRecorder":
        """Subscribe to a :class:`~apex_tpu_torch.observability.tracing
        .Tracer`: every finished span lands in the ring, and dumps
        include the tracer's OPEN spans (the wedged dispatch)."""
        self._tracer = tracer
        tracer.add_listener(self.record_span)
        return self

    def record_span(self, span: Dict[str, Any]) -> None:
        with self._lock:
            self._spans.append(dict(span))

    def record_event(self, event: str, fields: Dict[str, Any]) -> None:
        """One structured event (``log_structured`` feeds this for
        every record while a recorder is installed).  Must never log
        itself — that would recurse through the feed."""
        with self._lock:
            self._events.append({
                "ts": round(float(self._time()), 6), "event": str(event),
                **{k: v for k, v in fields.items()},
            })

    def record_stats(self, step: int, summary: Dict[str, Any]) -> None:
        """One harvested StepStats window summary."""
        with self._lock:
            self._stats.append({
                "ts": round(float(self._time()), 6), "step": int(step),
                **{k: v for k, v in summary.items()},
            })

    # ------------------------------------------------------------ dump
    def snapshot(self, reason: Optional[str] = None, **extra
                 ) -> Dict[str, Any]:
        """The dump payload: rings + the tracer's open spans +
        correlation, JSON-serializable."""
        with self._lock:
            spans = [dict(s) for s in self._spans]
            events = [dict(e) for e in self._events]
            stats = [dict(s) for s in self._stats]
        open_spans: List[dict] = []
        if self._tracer is not None:
            try:
                open_spans = self._tracer.open_spans()
            except Exception:  # noqa: BLE001 — a broken tracer must not
                pass           # rob the dump of the rings it DOES hold
        rec: Dict[str, Any] = {
            "schema": SCHEMA, "pid": os.getpid(),
            "ts": round(float(self._time()), 6),
            "reason": reason, **step_context(),
            "spans": spans, "open_spans": open_spans,
            "events": events, "stats_windows": stats,
        }
        if self.run_id is not None:
            rec["run_id"] = str(self.run_id)
        rec.update(extra)
        return rec

    def _write(self, path: str, rec: Dict[str, Any]) -> None:
        from apex_tpu_torch.io.native import atomic_output

        with atomic_output(path) as f:
            f.write(json.dumps(rec, sort_keys=True, default=str).encode())

    def checkpoint(self) -> Optional[str]:
        """Atomically republish the rolling recording (no reason
        stamp).  Call at the telemetry cadence: a hard kill (exit 137
        runs no handlers) then still leaves the last checkpoint as the
        forensics artifact."""
        if self.path is None:
            return None
        self._write(self.path, self.snapshot(reason=None))
        return self.path

    def dump(self, reason: str, dir_path=None, **extra) -> Optional[str]:
        """Write the final reason-stamped dump
        (``flightrec_dump_<ms>_<pid>.json``) and log its path.  Returns
        the path (None without a directory).  Never raises — the dump
        rides exit paths (watchdog ``on_wedge``, budget abort) whose
        one job is to exit."""
        d = str(dir_path) if dir_path is not None else self.dir
        if d is None:
            return None
        path = os.path.join(
            d, f"flightrec_dump_{int(self._time() * 1000)}"
               f"_{os.getpid()}.json")
        try:
            self._write(path, self.snapshot(reason=reason, **extra))
        except Exception as e:  # noqa: BLE001 — report, never block exit
            _log_warning("flightrec.dump_failed", reason=reason,
                         error=f"{type(e).__name__}: {e}")
            return None
        self.dumped.append(path)
        _log_warning("flightrec.dumped", reason=reason, path=path)
        return path


# ------------------------------------------------------- global recorder
def install(rec: FlightRecorder) -> FlightRecorder:
    """Make ``rec`` the process recorder: ``log_structured`` events and
    the library dump triggers (:func:`dump_active`) route to it."""
    global _ACTIVE
    _ACTIVE = rec
    return rec


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FlightRecorder]:
    return _ACTIVE


def observe_event(event: str, fields: Dict[str, Any]) -> None:
    """``log_structured``'s feed seam: record into the installed
    recorder, swallow everything — a telemetry failure must never
    change a logging call's control flow."""
    rec = _ACTIVE
    if rec is None:
        return
    try:
        rec.record_event(event, fields)
    except Exception:  # noqa: BLE001 — observers never participate
        pass


def dump_active(reason: str, **extra) -> Optional[str]:
    """Dump the installed recorder (no-op without one) — the library
    trigger seam (``StepGuard.check`` before its budget raise,
    ``PreemptionHandler`` on the notice).  Best-effort by design."""
    rec = _ACTIVE
    if rec is None:
        return None
    try:
        return rec.dump(reason, **extra)
    except Exception:  # noqa: BLE001 — a broken recorder must not turn
        return None    # an orderly abort into a telemetry crash


# ------------------------------------------------------------ read side
def load_dump(path) -> Dict[str, Any]:
    """Parse + validate one dump file; raises ``ValueError`` on torn
    bytes or a wrong schema (callers that scan directories use
    :func:`latest_dump`, which skips torn files loudly)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        rec = json.loads(data)
    except ValueError as e:
        raise ValueError(
            f"{path} is not a valid flight-recorder dump (torn/partial "
            f"JSON: {e})") from e
    if not isinstance(rec, dict) or rec.get("schema") != SCHEMA:
        raise ValueError(
            f"{path} is not a flight-recorder dump (schema "
            f"{rec.get('schema') if isinstance(rec, dict) else None!r}, "
            f"want {SCHEMA!r})")
    return rec


def latest_dump(dir_path) -> Optional[Tuple[str, Dict[str, Any]]]:
    """Newest readable dump in ``dir_path`` as ``(path, record)``;
    None when the dir holds none.  Reason-stamped ``flightrec_dump_*``
    files outrank the rolling ``flightrec_<pid>.json`` checkpoints of
    the same vintage only by recency — newest mtime wins across both.
    Torn/partial files are SKIPPED with a loud structured warning,
    never raised: the half-written dump belongs to the crash being
    investigated."""
    import glob

    candidates = glob.glob(os.path.join(str(dir_path), "flightrec_*.json"))
    candidates.sort(key=lambda p: (_mtime(p), p), reverse=True)
    for p in candidates:
        try:
            return p, load_dump(p)
        except (OSError, ValueError) as e:
            _log_warning("flightrec.torn_dump_skipped", path=p,
                         error=f"{type(e).__name__}: {e}")
    return None


def latest_dump_path(dir_path) -> Optional[str]:
    """Just the newest readable dump's path (the supervisor's
    attach-to-restart-record call)."""
    if dir_path is None:
        return None
    try:
        hit = latest_dump(dir_path)
    except OSError:
        return None
    return hit[0] if hit is not None else None


def _mtime(p: str) -> float:
    try:
        return os.path.getmtime(p)
    except OSError:
        return 0.0


def _log_warning(event: str, **fields) -> None:
    from apex_tpu_torch.utils.logging import get_logger, log_structured

    log_structured(get_logger("apex_tpu_torch.observability"), logging.WARNING,
                   event, **fields)
