"""Goodput and MFU accounting across the run lifecycle (counterpart of
:mod:`apex_tpu.observability.goodput`).

The resilience runtime makes runs *survive* restarts, wedges, and
preemptions; this module makes the cost of surviving **measurable** as
a wall-time breakdown:

- Each process records one *session* file under the metrics dir
  (``goodput_*.json``, atomically republished at every heartbeat so a
  hard kill still leaves the last known progress): start/end, the
  attributed segments (``checkpoint``, ``restore``, ``reshard``, …),
  step/token counters, and an exit cause.
- :func:`goodput_report` folds every session into one breakdown whose
  fractions **sum to exactly 1** over the run's wall clock
  (first session start → last session end): ``productive`` is the
  remainder after the attributed buckets, inter-session gaps are
  ``restart``, and a session that died wedged contributes its
  last-progress→death tail to ``wedge`` — so an injected wedged
  collective shows up as a measurable goodput loss, not a log line.

MFU helpers centralize the model-FLOPs formula of the JAX package's
bench.py (6N + 12·L·S·H per trained token, no recompute credit; 2N per
decoded token) so the trainer and the report agree on it.
"""

import contextlib
import glob
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = [
    "GoodputAccountant", "decode_flops_per_token", "goodput_report",
    "model_flops_per_step", "model_flops_per_token", "param_count",
    "session_progress",
]

SCHEMA = "apex_tpu_goodput_v1"


# ------------------------------------------------------------- MFU helpers
def param_count(params) -> int:
    """Elements over the leaves of a tree of tensors (or arrays)."""
    from apex_tpu_torch.optimizers.tree import tree_leaves

    return sum(int(np.prod(p.shape)) for p in tree_leaves(params))


def model_flops_per_token(n_params: int, num_layers: int, seq: int,
                          hidden: int) -> float:
    """Train-step model FLOPs per token: ``6N`` (fwd+bwd matmuls) plus
    the attention term ``12·L·S·H`` — the usual MFU convention (no
    recompute credit), and exactly bench.py's historical formula."""
    return 6.0 * n_params + 12.0 * num_layers * seq * hidden


def model_flops_per_step(n_params: int, num_layers: int, seq: int,
                         hidden: int, batch: int) -> float:
    return model_flops_per_token(n_params, num_layers, seq, hidden) \
        * batch * seq


def decode_flops_per_token(n_params: int) -> float:
    """Serving decode FLOPs per generated token: the forward matmuls
    (``2N``); attention-over-cache is cache-length-dependent and small
    against the matmuls at the page sizes served here."""
    return 2.0 * n_params


# --------------------------------------------------------------- accountant
class GoodputAccountant:
    """One training process's slice of the goodput record.

    Usage (``python -m apex_tpu_torch.pretrain_gpt --metrics-dir``)::

        acct = GoodputAccountant(metrics_dir, run_id="gpt")
        with acct.attribute("restore"):
            ...restore checkpoint...
        for step in ...:
            ...train...
            acct.step_done(tokens=batch*seq)
            with acct.attribute("checkpoint"): ...save...
            acct.heartbeat()          # at the telemetry fetch cadence
        acct.finalize("clean")        # or "preempted"; the watchdog's
                                      # on_wedge hook calls finalize("wedge")

    The session file is republished atomically (tmp+rename) at every
    heartbeat/segment/finalize, so a chaos hard-kill (exit 137 — no
    cleanup runs) still leaves the last heartbeat's end time and the
    report attributes the lost tail to ``restart``."""

    def __init__(self, dir_path, run_id: str = "run",
                 time_fn=time.time):
        import threading

        self.dir = str(dir_path)
        os.makedirs(self.dir, exist_ok=True)
        self.run_id = str(run_id)
        self._time = time_fn
        # finalize("wedge") arrives from the WATCHDOG thread while the
        # main thread may be mid-heartbeat — an unserialized concurrent
        # json.dump into the same .tmp would publish torn bytes (or the
        # dump would race a first-time segment-key insert) and the
        # report would silently drop the wedged session.  RLock: the
        # mutators hold it across mutation + _persist
        self._lock = threading.RLock()
        start = float(time_fn())
        self._rec: Dict[str, Any] = {
            "schema": SCHEMA, "run_id": self.run_id,
            "pid": os.getpid(),
            "start": start, "end": start,
            # last_activity: the last moment the session demonstrably
            # did SOMETHING (a step finished, an attributed segment
            # ended) — the wedge tail is end - last_activity
            "last_activity": start,
            "segments": {}, "steps": 0, "tokens": 0,
            "exit_cause": None,
        }
        # "goodput_session_" prefix, NOT bare "goodput_": the aggregate
        # goodput_report.json the example writes into the same dir must
        # never match the session glob (it carries the same schema tag
        # and no "start" — found by the third-resume crash)
        self.path = os.path.join(
            self.dir,
            f"goodput_session_{int(start * 1000)}_{os.getpid()}.json")
        self._persist()

    # ------------------------------------------------------------ recording
    def _persist(self) -> None:
        with self._lock:
            self._rec["end"] = float(self._time())
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._rec, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)

    @contextlib.contextmanager
    def attribute(self, cause: str):
        """Attribute the body's wall time to ``cause`` (``checkpoint``,
        ``restore``, ``reshard``, ``drain`` …); everything never
        attributed is productive."""
        t0 = self._time()
        try:
            yield
        finally:
            self.add_segment(cause, float(self._time() - t0))

    def add_segment(self, cause: str, seconds: float) -> None:
        """Attribute an already-measured duration (the non-contextmanager
        spelling of :meth:`attribute`, for code paths that time
        themselves)."""
        if seconds > 0:
            with self._lock:
                seg = self._rec["segments"]
                seg[cause] = seg.get(cause, 0.0) + float(seconds)
                self._rec["last_activity"] = float(self._time())
                self._persist()

    def step_done(self, steps: int = 1, tokens: int = 0) -> None:
        """Record step/token progress (host counters only — no
        persistence; ride :meth:`heartbeat` for that)."""
        with self._lock:
            self._rec["steps"] += int(steps)
            self._rec["tokens"] += int(tokens)
            self._rec["last_activity"] = float(self._time())

    def heartbeat(self) -> None:
        self._persist()

    def finalize(self, exit_cause: str = "clean") -> None:
        """Stamp the exit cause and republish — the watchdog's
        ``on_wedge`` hook calls ``finalize("wedge")`` before
        ``os._exit``, which is what lets the report attribute the
        wedged tail per cause."""
        with self._lock:
            self._rec["exit_cause"] = str(exit_cause)
            self._persist()

    def report(self, **kw) -> Dict[str, Any]:
        """The aggregate report over every session in this dir
        (including this live one, already persisted)."""
        self._persist()
        return goodput_report(self.dir, **kw)


# ------------------------------------------------------------------ report
def _load_sessions(dir_path) -> List[Dict[str, Any]]:
    out = []
    pattern = os.path.join(str(dir_path), "goodput_session_*.json")
    for p in sorted(glob.glob(pattern)):
        try:
            with open(p) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue  # torn session file: skip, never crash the report
        if rec.get("schema") == SCHEMA and "start" in rec \
                and "end" in rec:
            out.append(rec)
    out.sort(key=lambda r: r["start"])
    return out


def session_progress(dir_path) -> int:
    """Total steps recorded across every session file in ``dir_path``
    (0 when the dir is missing/empty) — monotone over a run's life, so
    the supervisor's crash-loop breaker can compare it across restarts:
    a relaunch that adds no steps before dying made NO progress, and K
    of those in a row is a crash loop, not a recoverable fault."""
    return sum(int(r.get("steps", 0)) for r in _load_sessions(dir_path))


def goodput_report(dir_path, flops_per_token: Optional[float] = None,
                   roofline_tflops: Optional[float] = None
                   ) -> Dict[str, Any]:
    """Fold every session record into one goodput breakdown.

    Buckets over ``wall = last session end - first session start``:

    - every explicitly attributed segment cause (``checkpoint``,
      ``restore``, ``reshard``, ``drain``, …), summed across sessions;
    - ``wedge``: for sessions whose ``exit_cause`` is ``"wedge"``, the
      tail from their last recorded progress to their end (the steps
      the wedged collective ate);
    - ``restart``: the gaps between one session's end and the next's
      start (supervisor backoff + process relaunch + CUDA init; a
      hard-killed session's unpersisted tail lands here too — its
      recorded end IS its last heartbeat);
    - ``productive``: the remainder — so the fractions sum to exactly
      1 by construction.

    With ``flops_per_token`` (see :func:`model_flops_per_token`) the
    report adds achieved model TFLOP/s over *productive* time, and with
    ``roofline_tflops`` the MFU against a measured roofline."""
    sessions = _load_sessions(dir_path)
    if not sessions:
        return {"schema": SCHEMA, "sessions": 0, "wall_secs": 0.0,
                "fractions": {}, "seconds": {}}
    wall = max(r["end"] for r in sessions) - sessions[0]["start"]
    wall = max(wall, 1e-9)
    seconds: Dict[str, float] = {}

    def add(cause, secs):
        if secs > 0:
            seconds[cause] = seconds.get(cause, 0.0) + float(secs)

    for i, rec in enumerate(sessions):
        for cause, secs in rec.get("segments", {}).items():
            add(cause, secs)
        if rec.get("exit_cause") == "wedge":
            add("wedge", rec["end"] - rec.get("last_activity", rec["end"]))
        if i + 1 < len(sessions):
            add("restart", sessions[i + 1]["start"] - rec["end"])
    attributed = sum(seconds.values())
    seconds["productive"] = max(wall - attributed, 0.0)
    fractions = {k: v / wall for k, v in seconds.items()}
    steps = sum(r.get("steps", 0) for r in sessions)
    tokens = sum(r.get("tokens", 0) for r in sessions)
    out: Dict[str, Any] = {
        "schema": SCHEMA,
        "run_id": sessions[-1].get("run_id"),
        "sessions": len(sessions),
        "wall_secs": round(wall, 3),
        "seconds": {k: round(v, 3) for k, v in sorted(seconds.items())},
        # fractions stay full-precision: the productive bucket is the
        # remainder, so they sum to 1 exactly — rounding would break
        # the closure the acceptance contract pins
        "fractions": dict(sorted(fractions.items())),
        "steps": steps,
        "tokens": tokens,
        "exit_causes": [r.get("exit_cause") for r in sessions],
        "wedge_events": sum(1 for r in sessions
                            if r.get("exit_cause") == "wedge"),
    }
    productive = seconds["productive"]
    if tokens and productive > 0:
        out["tokens_per_sec_productive"] = round(tokens / productive, 2)
        out["tokens_per_sec_wall"] = round(tokens / wall, 2)
        if flops_per_token:
            tflops = flops_per_token * tokens / productive / 1e12
            out["model_tflops_productive"] = round(tflops, 3)
            if roofline_tflops:
                out["mfu_vs_measured_roofline"] = round(
                    tflops / roofline_tflops, 4)
    return out
