"""Anomaly & straggler detection: notice degradation before a human does
(counterpart of :mod:`apex_tpu.observability.anomaly`).

The metrics layer records *what happened*; this module decides *whether
that was normal*.  Rolling median/MAD detectors (robust to the heavy
right tail every latency series has — a mean/stddev detector is blown
by the first outlier it exists to catch) watch the series the rest of
the observability stack already produces:

- **step time** (the trainer loop's iteration cadence — the wedge's
  slow-motion precursor),
- **per-hop sync time** (span durations off the tracer: a slow
  cross-slice hop is a network problem, a slow inner hop a chip),
- **goodput / window throughput** (direction ``low``: a regression is
  a DROP),
- **per-lane TTFT and inter-token latency** (the serving SLO burn,
  split by lane so the best-effort tail can't hide an interactive
  regression),
- **dp-rank stragglers** (cross-sectional: one rank's per-step value
  against the same step's other ranks).

Every detection increments an ``apex_anomaly_<kind>_total`` counter
(labels preserved — the serving counters split by lane) and emits one
structured ``anomaly.detected`` record carrying the value, the rolling
median/MAD, and the robust z-score — which also lands in the flight
recorder's event ring whenever one is installed, so a postmortem dump
SHOWS the degradation ramp that preceded the death.

The detector is deliberately boring: a bounded ``window`` of recent
values, median/MAD over it, alarm when the robust z-score
``|v - median| / (1.4826 * MAD)`` exceeds ``threshold`` in the watched
direction.  A relative floor on the scale (``min_rel_spread``) keeps a
near-constant series (CPU-test step times agree to microseconds) from
alarming on noise, and ``min_points`` keeps the cold start quiet.

Consumption: the supervisor's goodput-adaptive backoff reads the
summary files :meth:`AnomalyMonitor.persist` leaves under the metrics
dir (:func:`recent_alert_count`) — a child that was ramping into
step-time regressions before it died earns a LONGER cool-down than a
clean crash, the same logic as the wedge-repeat lengthening.
"""

import glob
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from apex_tpu_torch.observability import metrics as _metrics
from apex_tpu_torch.observability.correlation import step_context

__all__ = [
    "AnomalyMonitor", "RollingMadDetector", "recent_alert_count",
    "robust_zscore",
]

#: scale factor that makes the MAD a consistent estimator of the
#: standard deviation under normality
MAD_TO_SIGMA = 1.4826


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def robust_zscore(value: float, values: List[float],
                  min_rel_spread: float = 0.05,
                  min_abs_spread: float = 1e-12
                  ) -> Tuple[float, float, float]:
    """``(z, median, mad)`` of ``value`` against ``values`` — the one
    median/MAD expression every detector here uses.  The scale is
    floored at ``min_rel_spread * |median|`` (and an absolute epsilon)
    so a series that agrees to the last microsecond cannot alarm on
    measurement noise."""
    med = _median(values)
    mad = _median([abs(v - med) for v in values])
    scale = max(MAD_TO_SIGMA * mad, min_rel_spread * abs(med),
                min_abs_spread)
    return (value - med) / scale, med, mad


class RollingMadDetector:
    """One series' rolling median/MAD detector.

    ``direction``: ``"high"`` alarms on spikes (latency, step time),
    ``"low"`` on drops (goodput, throughput), ``"both"`` on either.
    The candidate value is scored against the window EXCLUDING itself
    (an outlier must not mask itself), then appended — so a genuine
    level shift alarms for ~window/2 updates and then becomes the new
    normal, which is the wanted behavior for a *detector* (the alert
    count records that the shift happened)."""

    def __init__(self, window: int = 64, threshold: float = 4.0,
                 min_points: int = 16, direction: str = "high",
                 min_rel_spread: float = 0.05):
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        if direction not in ("high", "low", "both"):
            raise ValueError(
                f"direction must be high/low/both, got {direction!r}")
        if min_points < 2:
            raise ValueError(f"min_points must be >= 2, got {min_points}")
        self.window = int(window)
        self.threshold = float(threshold)
        self.min_points = int(min_points)
        self.direction = direction
        self.min_rel_spread = float(min_rel_spread)
        self._values: deque = deque(maxlen=self.window)
        self.alerts = 0

    def update(self, value: float) -> Optional[Dict[str, float]]:
        """Score ``value``; returns the alert record (``value`` /
        ``median`` / ``mad`` / ``zscore``) when anomalous, else None.
        The value joins the window either way."""
        value = float(value)
        out = None
        if len(self._values) >= self.min_points:
            z, med, mad = robust_zscore(value, list(self._values),
                                        self.min_rel_spread)
            hit = ((self.direction in ("high", "both") and z > self.threshold)
                   or (self.direction in ("low", "both")
                       and -z > self.threshold))
            if hit:
                self.alerts += 1
                out = {"value": value, "median": med, "mad": mad,
                       "zscore": round(z, 3)}
        self._values.append(value)
        return out


#: detector kinds with their watched direction (anything else defaults
#: to "high" — latency-like)
_DIRECTIONS = {
    "step_time": "high",
    "hop_sync_time": "high",
    "ttft": "high",
    "inter_token": "high",
    "goodput": "low",
    "tokens_per_sec": "low",
}


class AnomalyMonitor:
    """Named rolling detectors + the counter/log/flight-recorder fanout.

    One monitor per process (the drivers build one when observability
    is on); series are keyed ``(kind, sorted labels)`` so per-lane and
    per-hop streams are scored independently.  Thread-safe: the serving
    scheduler observes from the serve loop while the watchdog thread
    may force a wedge alert."""

    def __init__(self, threshold: float = 4.0, window: int = 64,
                 min_points: int = 16, max_alerts_kept: int = 256):
        self.threshold = float(threshold)
        self.window = int(window)
        self.min_points = int(min_points)
        self._lock = threading.Lock()
        self._detectors: Dict[Tuple, RollingMadDetector] = {}
        self.alerts: deque = deque(maxlen=int(max_alerts_kept))
        #: TRUE alert totals (the deque above keeps only the most
        #: recent records — counts must not saturate at its length)
        self._counts: Dict[str, int] = {}
        self._label_counts: Dict[Tuple[str, str, str], int] = {}
        #: first-seen label-name tuple per kind — the registry pins a
        #: counter's labelnames at first use, so a later alert with a
        #: different label shape must be conformed or its increment is
        #: silently swallowed by the best-effort module helper
        self._label_schema: Dict[str, Tuple[str, ...]] = {}
        self._schema_warned: set = set()

    # ------------------------------------------------------------ core
    def _detector(self, kind: str, key: Tuple) -> RollingMadDetector:
        with self._lock:
            det = self._detectors.get(key)
            if det is None:
                det = RollingMadDetector(
                    window=self.window, threshold=self.threshold,
                    min_points=self.min_points,
                    direction=_DIRECTIONS.get(kind, "high"))
                self._detectors[key] = det
            return det

    def observe(self, kind: str, value: float,
                **labels) -> Optional[Dict[str, Any]]:
        """Score one sample of series ``(kind, labels)``; on detection
        increment ``apex_anomaly_<kind>_total{labels}``, log one
        structured ``anomaly.detected`` (which feeds any installed
        flight recorder), and return the alert record."""
        key = (kind, tuple(sorted(labels.items())))
        hit = self._detector(kind, key).update(value)
        if hit is None:
            return None
        return self._alert(kind, dict(labels), hit)

    def wedge(self, elapsed_s: float, step=None) -> Dict[str, Any]:
        """A watchdog-adjudicated wedge IS a step-time anomaly — no
        window vote needed (the wedged dispatch never returns, so the
        ordinary ``observe`` would never see it).  Rides the watchdog's
        pre-exit hook; the counter increment and the structured alert
        are what the postmortem greps for."""
        return self._alert("step_time", {}, {
            "value": float(elapsed_s), "median": None, "mad": None,
            "zscore": None, "wedge": True, "step": step,
        })

    def check_stragglers(self, per_rank: Dict[Any, float],
                         kind: str = "rank_step_time",
                         threshold: Optional[float] = None
                         ) -> List[Dict[str, Any]]:
        """Cross-sectional straggler vote: each rank's value against the
        SAME step's other ranks (per-rank StepStats windows, per-rank
        wall times).  Needs >= 3 ranks (with 2 there is no majority to
        deviate from).  Returns the alert records, one per straggler."""
        if len(per_rank) < 3:
            return []
        thr = self.threshold if threshold is None else float(threshold)
        out = []
        for rank, v in sorted(per_rank.items()):
            others = [float(x) for r, x in per_rank.items() if r != rank]
            z, med, mad = robust_zscore(float(v), others)
            if z > thr:
                out.append(self._alert(
                    "straggler", {"rank": str(rank), "series": kind},
                    {"value": float(v), "median": med, "mad": mad,
                     "zscore": round(z, 3)}))
        return out

    # ------------------------------------------------------------ fanout
    def _alert(self, kind: str, labels: Dict[str, Any],
               hit: Dict[str, Any]) -> Dict[str, Any]:
        rec = {"ts": round(time.time(), 3), "kind": kind,
               **step_context(), **labels, **hit}
        with self._lock:
            self.alerts.append(rec)
            self._counts[kind] = self._counts.get(kind, 0) + 1
            for k, v in labels.items():
                key = (kind, k, str(v))
                self._label_counts[key] = self._label_counts.get(key, 0) + 1
            schema = self._label_schema.setdefault(
                kind, tuple(sorted(labels)))
            conform = tuple(sorted(labels)) != schema
            warn_schema = conform and kind not in self._schema_warned
            if warn_schema:
                self._schema_warned.add(kind)
        out_labels = {k: str(v) for k, v in labels.items()}
        if conform:
            # conform to the kind's first-seen shape so the increment
            # COUNTS (missing names filled empty, unknown dropped)
            # instead of being swallowed as a labelnames clash
            out_labels = {k: str(labels.get(k, "")) for k in schema}
            if warn_schema:
                _log(logging.WARNING, "anomaly.label_schema_conformed",
                     kind=kind, expected=list(schema),
                     got=sorted(labels))
        # best-effort by design (the module helpers never raise): a
        # registry clash must not rob the loop of its alert record
        _metrics.inc(f"apex_anomaly_{kind}_total",
                     help=f"anomaly detections on the {kind} series",
                     **out_labels)
        _log(logging.WARNING, "anomaly.detected", **{
            k: v for k, v in rec.items() if k != "ts"})
        return rec

    # ------------------------------------------------------- tracer feed
    def span_listener(self, name_to_kind: Dict[str, str]):
        """A :meth:`~apex_tpu_torch.observability.tracing.Tracer.add_listener`
        hook routing finished-span durations into detectors: exact
        names map directly; a mapping key ending in ``*`` prefix-matches
        (``zero_sync.*`` -> ``hop_sync_time``, labeled by span name)."""
        prefixes = [(k[:-1], v) for k, v in name_to_kind.items()
                    if k.endswith("*")]
        exact = {k: v for k, v in name_to_kind.items()
                 if not k.endswith("*")}

        def feed(span: Dict[str, Any]) -> None:
            name = span.get("name", "")
            kind = exact.get(name)
            if kind is None:
                for pfx, k in prefixes:
                    if name.startswith(pfx):
                        kind = k
                        break
            if kind is None or span.get("ph") != "X":
                return
            # one STABLE label shape per feed (span always, lane empty
            # when the span carries none): optional labels would flip
            # the counter's labelnames between alerts and the registry
            # would swallow every increment after the first shape
            labels = {"span": name,
                      "lane": span.get("attrs", {}).get("lane") or ""}
            self.observe(kind, span.get("dur_us", 0) / 1e6, **labels)

        return feed

    # ------------------------------------------------------ introspection
    def counts(self) -> Dict[str, int]:
        """TRUE alert counts per kind (the bench/driver report column;
        the ``alerts`` deque holds only the most recent records, so
        counts come from dedicated counters that never saturate)."""
        with self._lock:
            return dict(self._counts)

    def counts_by(self, label: str) -> Dict[str, Dict[str, int]]:
        """kind -> {label value -> alerts} (the per-lane serve column;
        true totals, same as :meth:`counts`)."""
        out: Dict[str, Dict[str, int]] = {}
        with self._lock:
            items = list(self._label_counts.items())
        for (kind, name, value), n in items:
            if name == label:
                out.setdefault(kind, {})[value] = n
        return out

    # ------------------------------------------------------- persistence
    def persist(self, dir_path) -> Optional[str]:
        """Atomically publish ``anomaly_<pid>.json`` (counts + recent
        alerts) under ``dir_path`` — what the supervisor's backoff reads
        after a child death (:func:`recent_alert_count`).  Best-effort:
        rides exit paths."""
        if dir_path is None:
            return None
        try:
            from apex_tpu_torch.io.native import atomic_output

            os.makedirs(str(dir_path), exist_ok=True)
            path = os.path.join(str(dir_path), f"anomaly_{os.getpid()}.json")
            with self._lock:
                alerts = list(self.alerts)
            doc = {"schema": "apex_tpu_anomaly_v1",
                   "ts": round(time.time(), 3), "pid": os.getpid(),
                   **step_context(),
                   "counts": self.counts(), "alerts": alerts}
            with atomic_output(path) as f:
                f.write(json.dumps(doc, sort_keys=True,
                                   default=str).encode())
            return path
        except Exception as e:  # noqa: BLE001 — report, never block exit
            _log(logging.WARNING, "anomaly.persist_failed",
                 error=f"{type(e).__name__}: {e}")
            return None


def recent_alert_count(dir_path, max_age_sec: Optional[float] = None,
                       now: Optional[float] = None) -> int:
    """Total alerts across the ``anomaly_*.json`` summaries under
    ``dir_path`` (0 for a missing dir; torn files skipped — they belong
    to the crash being investigated).  ``max_age_sec`` keeps the
    supervisor's backoff from re-lengthening on a week-old record."""
    if dir_path is None:
        return 0
    total = 0
    now = time.time() if now is None else now
    for p in glob.glob(os.path.join(str(dir_path), "anomaly_*.json")):
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(doc, dict) \
                or doc.get("schema") != "apex_tpu_anomaly_v1":
            continue
        if max_age_sec is not None \
                and now - float(doc.get("ts", 0)) > max_age_sec:
            continue
        total += sum(int(v) for v in (doc.get("counts") or {}).values())
    return total


def _log(level: int, event: str, **fields) -> None:
    from apex_tpu_torch.utils.logging import get_logger, log_structured

    log_structured(get_logger("apex_tpu_torch.observability"), level, event,
                   **fields)
