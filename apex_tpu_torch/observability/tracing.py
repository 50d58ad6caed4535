"""Host-side tracing: where did a step's wall time go?  (Counterpart of
:mod:`apex_tpu.observability.tracing`.)

The metrics layer answers *how much*; this module answers *where*: a
near-zero-overhead span API over the host-side phases of a run (data
wait, step dispatch, telemetry harvest, checkpoint save/restore),
correlated with logs and metrics through the one ``(run_id, step)``
join key (:mod:`~apex_tpu_torch.observability.correlation`), and
exported two ways:

- **JSONL** (:meth:`Tracer.export_jsonl`): one line per span, the same
  fields every other sidecar carries (``ts``/``rank``/``run_id``/``step``).
- **Chrome trace-event / Perfetto JSON**
  (:meth:`Tracer.export_chrome`): load the file straight into
  https://ui.perfetto.dev (or ``chrome://tracing``) — spans render per
  thread with their attributes as args.

Design constraints, each load-bearing:

- **Spans wrap DISPATCH, never run inside a captured step.**  A traced
  step is the same CUDA graph as an untraced one, so loss and params
  are bitwise equal with tracing on or off.  Because a replay is
  asynchronous, a dispatch span measures *host* time — queueing a
  step, not running it.  That is exactly what the span name says
  (``train.step.dispatch``); it is not a device step time.  Real step
  wall time shows up as the steady-state dispatch cadence once the
  device queue throttles the host.
- **Near-zero overhead when off.**  :func:`span` with no tracer
  configured returns a no-op singleton — one module-global read, no
  allocation, no lock.
- **Bounded memory.**  The span buffer is a ring (``capacity`` spans,
  oldest dropped, drop count kept).
- **Thread-aware.**  Spans record their thread id and name — the
  watchdog, preemption, and async-checkpoint threads show up as their
  own Perfetto tracks.
- **Crash-forensics ready.**  OPEN spans (started, never finished —
  the wedged dispatch) are tracked and included in exports and in
  :mod:`~apex_tpu_torch.observability.flightrec` dumps, flagged
  ``open=True`` with their elapsed time: the last open span of a
  wedged process names the step that wedged.

Span naming schema: ``<subsystem>.<phase>`` — ``train.step.dispatch``,
``train.data_wait``, ``train.telemetry_fetch``, ``train.checkpoint_save``,
``train.checkpoint_restore``.
"""

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from apex_tpu_torch.observability.correlation import step_context

__all__ = [
    "TracedStep", "Tracer", "TracingScope", "configure", "disable",
    "emit_sync_plan", "enabled", "export_run", "get_tracer", "instant",
    "new_trace_id", "overlap_fraction", "span",
]

SCHEMA = "apex_tpu_trace_v1"

_TRACER: Optional["Tracer"] = None

_TRACE_IDS = itertools.count()


def new_trace_id() -> str:
    """A process-unique request/trace id (``<pid-hex>-<n-hex>``) —
    what the serving scheduler stamps on every request so a p99
    histogram outlier joins back to its spans.  Monotonic per process:
    two requests can never share one."""
    return f"{os.getpid():x}-{next(_TRACE_IDS):x}"


# --------------------------------------------------------------- span core
class _Span:
    """One in-flight span; records itself into the tracer on exit.
    Also usable as a context manager (the common spelling)."""

    __slots__ = ("_tracer", "name", "attrs", "ts", "_t0", "tid",
                 "thread", "_done")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        # correlation captured at START: the step the span belongs to
        # is the step the loop had set when the phase began
        self.attrs = {**step_context(), **attrs}
        self.ts = time.time()
        self._t0 = time.perf_counter()
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.thread = t.name
        self._done = False
        tracer._opened(self)

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def set(self, **attrs) -> "_Span":
        """Attach attributes mid-span (spec accept counts, result
        sizes)."""
        self.attrs.update(attrs)
        return self

    def end(self, **attrs) -> None:
        if self._done:
            return
        self._done = True
        if attrs:
            self.attrs.update(attrs)
        self._tracer._finished(self, self.elapsed())

    # ------------------------------------------------- context manager
    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self.end()
        return False


class _NoopSpan:
    """The disabled-tracing singleton: every operation is a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def end(self, **attrs):
        pass

    def elapsed(self) -> float:
        return 0.0


_NOOP = _NoopSpan()


class Tracer:
    """Bounded in-memory span buffer + exporters.

    Thread-safe: spans may start/finish on any thread (the watchdog
    fires from its own).  ``capacity`` bounds FINISHED spans (ring —
    oldest dropped, counted in ``dropped``); open spans are tracked in
    a side table so a crash dump can name what never finished."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self.capacity)
        self._open: Dict[int, _Span] = {}
        self._listeners: List[Callable[[dict], None]] = []
        self.started = 0
        self.finished = 0
        self.dropped = 0

    # ----------------------------------------------------------- record
    def span(self, name: str, **attrs) -> _Span:
        """Start a span; ``with tracer.span("x"):`` or keep the handle
        and call ``.end()``."""
        return _Span(self, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        """A zero-duration marker event (Chrome ``i`` phase)."""
        t = threading.current_thread()
        self._record({
            "name": name, "ph": "i", "ts": time.time(), "dur_us": 0,
            "tid": t.ident or 0, "thread": t.name,
            "attrs": {**step_context(), **attrs},
        })

    def emit(self, name: str, start_ts: float, dur_s: float,
             **attrs) -> None:
        """Retro-record a COMPLETED span from its measured endpoints
        (the serving scheduler's admission wait: both timestamps are
        known only at admit time)."""
        t = threading.current_thread()
        self._record({
            "name": name, "ph": "X", "ts": float(start_ts),
            "dur_us": max(int(dur_s * 1e6), 0),
            "tid": t.ident or 0, "thread": t.name,
            "attrs": {**step_context(), **attrs},
        })

    def add_listener(self, fn: Callable[[dict], None]) -> None:
        """Call ``fn(span_dict)`` on every finished span — the flight
        recorder's feed.  Listener errors are swallowed (observers
        never participate)."""
        self._listeners.append(fn)

    # ------------------------------------------------------- internals
    def _opened(self, s: _Span) -> None:
        with self._lock:
            self.started += 1
            self._open[id(s)] = s

    def _finished(self, s: _Span, dur_s: float) -> None:
        with self._lock:
            self._open.pop(id(s), None)
        self._record({
            "name": s.name, "ph": "X", "ts": s.ts,
            "dur_us": max(int(dur_s * 1e6), 0),
            "tid": s.tid, "thread": s.thread, "attrs": dict(s.attrs),
        })

    def _record(self, rec: dict) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(rec)
            self.finished += 1
            listeners = tuple(self._listeners)
        for fn in listeners:
            try:
                fn(rec)
            except Exception:  # noqa: BLE001 — observers never participate
                pass

    # ---------------------------------------------------------- export
    def spans(self) -> List[dict]:
        """Finished spans, oldest first (a snapshot copy)."""
        with self._lock:
            return [dict(s) for s in self._spans]

    def open_spans(self) -> List[dict]:
        """Started-but-unfinished spans with their elapsed time so far
        — the wedged dispatch shows up HERE, flagged ``open``."""
        with self._lock:
            live = list(self._open.values())
        return [{
            "name": s.name, "ph": "X", "ts": s.ts,
            "dur_us": max(int(s.elapsed() * 1e6), 0),
            "tid": s.tid, "thread": s.thread,
            "attrs": dict(s.attrs), "open": True,
        } for s in live]

    def export_jsonl(self, path) -> int:
        """One JSON line per span (finished then open), the sidecar
        contract fields (``ts``/``rank``; ``run_id``/``step`` ride the
        span attrs).  One open/flush/fsync for the whole file append.
        Returns lines written."""
        rank = _rank()
        lines = []
        for rec in self.spans() + self.open_spans():
            lines.append(json.dumps({
                "span": rec["name"], "ph": rec["ph"],
                "ts": round(rec["ts"], 6), "dur_us": rec["dur_us"],
                "tid": rec["tid"], "thread": rec["thread"],
                "rank": rank, "open": rec.get("open", False),
                **rec.get("attrs", {}),
            }, sort_keys=True, default=str))
        if lines:
            with open(path, "a") as f:
                f.write("\n".join(lines) + "\n")
                f.flush()
                os.fsync(f.fileno())
        return len(lines)

    def export_chrome(self, path) -> int:
        """Chrome trace-event JSON (Perfetto-loadable), written
        ATOMICALLY (tmp+fsync+rename — a wedge dump must never publish
        a torn trace).  Timestamps are epoch microseconds; each thread
        gets a ``thread_name`` metadata event so watchdog/checkpoint
        threads render as named tracks.  Returns the event count."""
        from apex_tpu_torch.io.native import atomic_output

        pid = os.getpid()
        events = []
        threads = {}
        for rec in self.spans() + self.open_spans():
            threads.setdefault(rec["tid"], rec["thread"])
            args = dict(rec.get("attrs", {}))
            if rec.get("open"):
                args["open"] = True
            events.append({
                "name": rec["name"], "ph": rec["ph"],
                "ts": int(rec["ts"] * 1e6), "dur": rec["dur_us"],
                "pid": pid, "tid": rec["tid"], "args": args,
            })
        for tid, tname in sorted(threads.items()):
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": tid, "args": {"name": tname},
            })
        doc = {"schema": SCHEMA, "displayTimeUnit": "ms",
               "traceEvents": events,
               "otherData": {"rank": _rank(), "dropped": self.dropped}}
        with atomic_output(path) as f:
            f.write(json.dumps(doc).encode())
        return len(events)


def _rank() -> int:
    # the ONE rank resolution (metrics JSONL and span exports join on
    # the rank field — they must never disagree)
    from apex_tpu_torch.observability.metrics import _rank as metrics_rank

    return metrics_rank()


# ------------------------------------------------------- global configure
def configure(capacity: int = 4096,
              tracer: Optional[Tracer] = None) -> Tracer:
    """Install (and return) the process tracer; until this is called
    every :func:`span`/:func:`instant` is a no-op."""
    global _TRACER
    _TRACER = tracer if tracer is not None else Tracer(capacity=capacity)
    return _TRACER


def disable() -> None:
    global _TRACER
    _TRACER = None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


class TracingScope:
    """``with TracingScope() as tracer:`` — scope a tracer for tests /
    embedded engines (restores the previous one on exit, exactly the
    :class:`~apex_tpu_torch.observability.metrics.MetricsScope` pattern)."""

    def __init__(self, tracer: Optional[Tracer] = None,
                 capacity: int = 4096):
        self.tracer = tracer if tracer is not None \
            else Tracer(capacity=capacity)
        self._prev: Optional[Tracer] = None

    def __enter__(self) -> Tracer:
        global _TRACER
        self._prev = _TRACER
        _TRACER = self.tracer
        return self.tracer

    def __exit__(self, *exc):
        global _TRACER
        _TRACER = self._prev
        return False


def span(name: str, **attrs):
    """Module-level span against the current tracer — THE instrumented
    spelling (``with span("train.data_wait"): ...``).  One global read
    and a no-op singleton when tracing is off."""
    t = _TRACER
    return t.span(name, **attrs) if t is not None else _NOOP


def instant(name: str, **attrs) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, **attrs)


def export_run(dir_path, run_id, tracer: Optional["Tracer"] = None
               ) -> Optional[Dict[str, Any]]:
    """Export the current trace under ``dir_path`` with THE repo-wide
    artifact convention — ``trace_<run_id>_<pid>.json`` (Perfetto/
    Chrome) plus ``spans_<run_id>_<pid>.jsonl`` (sidecar contract) —
    the one spelling the trainer and its wedge hook share, and the
    names the JAX package's drivers write.  Creates ``dir_path`` if missing; returns
    ``{"chrome", "jsonl", "events", "dropped"}``, or None when no
    tracer is installed."""
    t = tracer if tracer is not None else _TRACER
    if t is None:
        return None
    os.makedirs(str(dir_path), exist_ok=True)
    pid = os.getpid()
    chrome = os.path.join(str(dir_path), f"trace_{run_id}_{pid}.json")
    jsonl = os.path.join(str(dir_path), f"spans_{run_id}_{pid}.jsonl")
    n = t.export_chrome(chrome)
    t.export_jsonl(jsonl)
    return {"chrome": chrome, "jsonl": jsonl, "events": n,
            "dropped": t.dropped}


# ----------------------------------------------------- dispatch wrapping
class TracedStep:
    """Wrap a compiled step callable (a
    :class:`~apex_tpu_torch.graphs.CapturedStep`) in a DISPATCH span.

    The wrapper lives entirely outside the captured graph: every
    attribute delegates to the wrapped callable, so the graph is the
    same with tracing on or off and loss/params stay bitwise.  The span
    measures HOST dispatch time (a replay returns before the device
    runs); in steady state the device queue throttles dispatch, so the
    span cadence tracks real step time — but a single span is not a
    step-time measurement."""

    def __init__(self, fn, name: str = "step.dispatch",
                 attrs: Optional[Dict[str, Any]] = None):
        self._fn = fn
        self._name = str(name)
        self._attrs = dict(attrs or {})

    def __call__(self, *args, **kw):
        t = _TRACER
        if t is None:
            return self._fn(*args, **kw)
        with t.span(self._name, dispatch=True, **self._attrs):
            return self._fn(*args, **kw)

    def __getattr__(self, name):
        return getattr(self._fn, name)


def overlap_fraction(tracer: Optional[Tracer] = None,
                     prefix: str = "zero_sync.bucket") -> float:
    """Span-concurrency of the wire plan against dispatch: the
    fraction of ``prefix``-named instant markers in the tracer's
    buffer whose timestamp falls INSIDE some ``*step.dispatch`` span's
    ``[ts, ts + dur]`` interval.  A marker emitted while a dispatch is
    in flight is a sync whose host-side bookkeeping overlapped the
    step — the host-observable proxy for the compiled step's
    compute/communication overlap.  ``prefix`` defaults to the ZeRO
    wire plan's ``zero_sync.bucket`` markers (:func:`emit_sync_plan`).
    0.0 with no tracer, no markers, or no dispatch spans."""
    tracer = tracer if tracer is not None else _TRACER
    if tracer is None:
        return 0.0
    spans = tracer.spans() + tracer.open_spans()
    windows = [(s["ts"], s["ts"] + s["dur_us"] / 1e6) for s in spans
               if s["name"].endswith("step.dispatch")]
    marks = [s["ts"] for s in spans
             if s["ph"] == "i" and s["name"].startswith(prefix)]
    if not marks or not windows:
        return 0.0
    inside = sum(1 for ts in marks
                 if any(lo <= ts <= hi for lo, hi in windows))
    return inside / len(marks)


def emit_sync_plan(optimizer, tracer: Optional[Tracer] = None) -> dict:
    """Emit one ``zero_sync.bucket<k>.hop_<axis>`` marker per (bucket,
    hop) of a ZeRO optimizer's sync plan, attributes carrying the
    per-hop payload/scale bytes (the optimizer's ``sync_plan_hops()``:
    the ZeRO optimizers of :mod:`apex_tpu_torch.contrib.optimizers`).
    A no-op for the replicated optimizers, as in the JAX package.

    Returns ``{"markers": n, "overlap_fraction": f}``: markers emitted
    this call (0 when tracing is off or the optimizer has no plan) and
    :func:`overlap_fraction` over the tracer's whole buffer."""
    tracer = tracer if tracer is not None else _TRACER
    hops_fn = getattr(optimizer, "sync_plan_hops", None)
    if tracer is None or hops_fn is None:
        return {"markers": 0, "overlap_fraction": 0.0}
    n = 0
    for rec in hops_fn():
        tracer.instant(
            f"zero_sync.bucket{rec['bucket']}.hop_{rec['hop']}", **rec)
        n += 1
    return {"markers": n, "overlap_fraction": overlap_fraction(tracer)}
