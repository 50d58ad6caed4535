"""Process-local, rank-aware metrics registry (counterpart of
:mod:`apex_tpu.observability.metrics`).

- **Counters / gauges / histograms with labels**: plain host-side
  Python objects (a dict update under a lock — safe to call from the
  watchdog/preemption threads), never device work.  Library code
  records through the module helpers (:func:`inc`, :func:`set_gauge`,
  :func:`observe`), which resolve the *current* registry so tests and
  embedded servers can scope their own.
- **JSONL time-series sidecar** (:meth:`MetricsRegistry.snapshot_jsonl`):
  one line per sample per snapshot, append+flush+fsync.  Every line
  carries ``ts``, the process ``rank``, and the
  :mod:`~apex_tpu_torch.observability.correlation` ``(run_id, step)`` so
  it joins against logs and trace spans.
- **Prometheus text exporter** (:meth:`MetricsRegistry.prometheus_text`):
  the 0.0.4 exposition format (``# HELP``/``# TYPE`` + samples;
  histograms expand to cumulative ``_bucket``/``_sum``/``_count``) for
  scrape-style collection.

Naming schema: ``apex_<subsystem>_<what>`` with Prometheus unit
conventions (``_total`` counters, ``_seconds`` histograms) — e.g.
``apex_checkpoint_io_retries_total``, ``apex_train_loss``.
"""

import json
import math
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from apex_tpu_torch.observability.correlation import step_context

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricsScope",
    "append_jsonl", "get_metrics", "inc", "observe", "set_gauge",
]

#: default latency buckets (seconds): sub-ms decode tokens through
#: multi-minute restarts
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0)


def _rank() -> int:
    """The ``torch.distributed`` rank when a process group is
    initialized, else 0 (read lazily: metrics work before
    ``init_process_group`` and in single-process runs)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 — rank is best-effort decoration
        pass
    return 0


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]) -> Tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match the metric's declared "
            f"label names {sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.RLock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._children: Dict[Tuple, object] = {}

    def _child(self, labels: Dict[str, str]):
        key = _label_key(self.labelnames, labels)
        with self._lock:
            if key not in self._children:
                self._children[key] = self._new_child()
            return key

    def _read(self, labels: Dict[str, str]) -> float:
        """Non-inserting read: an absent series reads 0.0 WITHOUT
        minting it — a value() probe with a typo'd label must not
        pollute every later export with a permanent zero sample."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            return 0.0 if child is None else child[0]

    # ------------------------------------------------------------ export
    def samples(self) -> Iterator[Tuple[str, Dict[str, str], float]]:
        """``(sample_name, labels, value)`` triples (histograms expand
        to the cumulative bucket/sum/count series).

        The expansion MATERIALIZES under the lock: ``_expand`` reads
        mutable child state (a histogram's ``counts``/``sum``/
        ``count``), and yielding lazily would interleave those reads
        with a watchdog-thread ``observe`` — a torn scrape where
        ``_bucket`` rows disagree with ``_count``."""
        with self._lock:
            out: List[Tuple[str, Dict[str, str], float]] = []
            for key, child in self._children.items():
                labels = dict(zip(self.labelnames, key))
                out.extend(self._expand(labels, child))
        return iter(out)


class Counter(_Metric):
    """Monotonic cumulative count (``_total`` naming convention)."""

    kind = "counter"

    def _new_child(self):
        return [0.0]

    def labels(self, **labels) -> "_BoundCounter":
        return _BoundCounter(self, self._child(labels))

    def inc(self, n: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(n)

    def value(self, **labels) -> float:
        return self._read(labels)

    def _expand(self, labels, child):
        yield (self.name, labels, child[0])


class _BoundCounter:
    def __init__(self, metric: Counter, key: Tuple):
        self._m, self._key = metric, key

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self._m.name} cannot decrease")
        with self._m._lock:
            self._m._children[self._key][0] += float(n)


class Gauge(_Metric):
    """Point-in-time value (set wins; no rate semantics)."""

    kind = "gauge"

    def _new_child(self):
        return [0.0]

    def labels(self, **labels) -> "_BoundGauge":
        return _BoundGauge(self, self._child(labels))

    def set(self, v: float, **labels) -> None:
        self.labels(**labels).set(v)

    def value(self, **labels) -> float:
        return self._read(labels)

    def _expand(self, labels, child):
        yield (self.name, labels, child[0])


class _BoundGauge:
    def __init__(self, metric: Gauge, key: Tuple):
        self._m, self._key = metric, key

    def set(self, v: float) -> None:
        with self._m._lock:
            self._m._children[self._key][0] = float(v)


class _HistState:
    __slots__ = ("counts", "sum", "count", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +inf bucket
        self.sum = 0.0
        self.count = 0
        #: recent exemplar records ({"value", "ts", **ids}), bounded —
        #: drained by snapshot_jsonl so each appears in ONE snapshot
        self.exemplars: List[dict] = []


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        super().__init__(name, help, labelnames, lock)

    def _new_child(self):
        return _HistState(len(self.buckets))

    #: exemplars kept per histogram child between snapshots
    MAX_EXEMPLARS = 16

    def labels(self, **labels) -> "_BoundHistogram":
        return _BoundHistogram(self, self._child(labels))

    def observe(self, v: float, exemplar: Optional[dict] = None,
                **labels) -> None:
        """Record ``v``; ``exemplar`` (e.g. ``{"trace_id": ..., "rid":
        ...}``) attaches join-key identity to this OTHERWISE-ANONYMOUS
        sample — a p99 outlier in the exported series becomes joinable
        to its request's trace spans.  Exemplars ride the JSONL export
        (``<name>_exemplar`` lines, drained per snapshot); the
        Prometheus 0.0.4 text format has no exemplar syntax, so the
        .prom export carries only the histogram itself."""
        self.labels(**labels).observe(v, exemplar=exemplar)

    def drain_exemplars(self) -> List[Tuple[dict, dict]]:
        """``(labels, exemplar)`` pairs recorded since the last drain
        (the JSONL snapshot's feed); clears the rings."""
        with self._lock:
            items = list(self._children.items())
            out = []
            for key, child in items:
                if child.exemplars:
                    labels = dict(zip(self.labelnames, key))
                    out.extend((labels, ex) for ex in child.exemplars)
                    child.exemplars = []
        return out

    def _expand(self, labels, child: _HistState):
        cum = 0
        for le, c in zip(self.buckets, child.counts):
            cum += c
            yield (f"{self.name}_bucket", {**labels, "le": _fmt(le)}, cum)
        yield (f"{self.name}_bucket", {**labels, "le": "+Inf"}, child.count)
        yield (f"{self.name}_sum", labels, child.sum)
        yield (f"{self.name}_count", labels, child.count)


class _BoundHistogram:
    def __init__(self, metric: Histogram, key: Tuple):
        self._m, self._key = metric, key

    def observe(self, v: float, exemplar: Optional[dict] = None) -> None:
        v = float(v)
        m = self._m
        with m._lock:
            st: _HistState = m._children[self._key]
            st.sum += v
            st.count += 1
            if exemplar is not None:
                # recency ring, but the window MAX survives eviction:
                # the p99 outlier is the sample worth joining, and a
                # single end-of-run drain (serve_gpt.py) must still
                # hold it after hundreds of ordinary samples
                exs = st.exemplars
                if len(exs) >= Histogram.MAX_EXEMPLARS:
                    mx = max(range(len(exs)),
                             key=lambda i: exs[i]["value"])
                    del exs[1 if mx == 0 else 0]
                exs.append(
                    {"value": v, "ts": round(time.time(), 3), **exemplar})
            for i, le in enumerate(m.buckets):
                if v <= le:
                    st.counts[i] += 1
                    return
            st.counts[-1] += 1


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    s = repr(float(v))
    return s[:-2] if s.endswith(".0") else s


class MetricsRegistry:
    """One process-local family of named metrics.

    ``counter``/``gauge``/``histogram`` are get-or-create: repeated
    registration with the same kind returns the existing metric (so
    library call sites need no init ceremony), a kind or label clash on
    an existing name fails loudly."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) \
                        or tuple(labelnames) != m.labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.labelnames}")
                want_buckets = kw.get("buckets")
                # DEFAULT_BUCKETS (by identity) means the caller did not
                # choose bounds — get-or-create, don't compare; explicit
                # differing bounds would silently misfile observations
                if want_buckets is not None \
                        and want_buckets is not DEFAULT_BUCKETS \
                        and tuple(sorted(
                            float(b) for b in want_buckets)) != m.buckets:
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {m.buckets}; re-registering with "
                        f"different bounds would silently misfile "
                        f"observations")
                return m
            m = cls(name, help, labelnames, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    # ------------------------------------------------------------ export
    def metrics(self) -> List[_Metric]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def prometheus_text(self) -> str:
        """Prometheus text exposition (0.0.4): HELP/TYPE headers plus
        every sample, ``rank`` label added to each.  Label values and
        HELP text are escaped per the spec — one un-escaped quote in an
        error-derived label would invalidate the WHOLE scrape.

        The whole exposition is assembled under the registry lock (one
        re-entrant lock shared by every metric), so the scrape is a
        CONSISTENT point-in-time snapshot: a watchdog-thread ``inc``
        or a registry insert mid-scrape waits, instead of mutating the
        dicts this iterates or tearing a histogram mid-expansion."""
        rank = str(_rank())
        out: List[str] = []
        with self._lock:
            for m in self.metrics():
                if m.help:
                    out.append(f"# HELP {m.name} {_esc_help(m.help)}")
                out.append(f"# TYPE {m.name} {m.kind}")
                for name, labels, value in m.samples():
                    lbl = ",".join(
                        f'{k}="{_esc_label(v)}"' for k, v in
                        sorted({**labels, "rank": rank}.items()))
                    out.append(f"{name}{{{lbl}}} {_fmt_val(value)}")
        return "\n".join(out) + "\n"

    def snapshot_jsonl(self, path, **extra) -> int:
        """Append the current value of every sample as one JSONL line
        each — the time-series sidecar.  Lines carry ``ts``, ``rank``,
        the correlation ``(run_id, step)``, and any ``extra`` fields;
        returns the number of lines written.  ONE open/flush/fsync per
        snapshot (not per line): a serving registry's histograms emit
        dozens of lines, and the fetch cadence this rides exists to
        keep host work cheap."""
        ctx = step_context()
        ts = round(time.time(), 3)
        rank = _rank()
        lines = []
        # assemble under the registry lock for a consistent snapshot
        # (concurrent inserts/incs wait); the file write + fsync below
        # happens OUTSIDE it — disk I/O under a lock the watchdog and
        # preemption threads also take could deadlock their drain
        with self._lock:
            for m in self.metrics():
                for name, labels, value in m.samples():
                    lines.append(json.dumps({
                        "ts": ts, "rank": rank, **ctx,
                        "metric": name, "type": m.kind,
                        "labels": labels, "value": value, **extra,
                    }, sort_keys=True, default=str))
                if isinstance(m, Histogram):
                    # exemplars: the identity (trace id, request id) of
                    # individual samples — one line each, drained so a
                    # sample's identity rides exactly one snapshot.
                    # This is what makes a p99 outlier in the series
                    # JOINABLE to its request's trace spans.
                    for labels, ex in m.drain_exemplars():
                        lines.append(json.dumps({
                            "ts": ts, "rank": rank, **ctx,
                            "metric": f"{m.name}_exemplar",
                            "type": "exemplar",
                            "labels": labels, **ex, **extra,
                        }, sort_keys=True, default=str))
        if lines:
            with open(path, "a") as f:
                f.write("\n".join(lines) + "\n")
                f.flush()
                os.fsync(f.fileno())
        return len(lines)


def _fmt_val(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _esc_label(v) -> str:
    """Prometheus 0.0.4 label-value escaping: backslash, quote, LF."""
    return str(v).replace("\\", r"\\").replace('"', r"\"") \
        .replace("\n", r"\n")


def _esc_help(v: str) -> str:
    """HELP-text escaping: backslash and LF."""
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


def append_jsonl(path, obj: dict) -> None:
    """THE append-one-JSON-line writer (append + flush + fsync), so a
    process killed mid-run keeps every line that was written."""
    line = json.dumps(obj, sort_keys=True, default=str)
    with open(path, "a") as f:
        f.write(line + "\n")
        f.flush()
        os.fsync(f.fileno())


# ------------------------------------------------------- current registry
_DEFAULT = MetricsRegistry()
_SCOPES: List[MetricsRegistry] = []


def get_metrics() -> MetricsRegistry:
    """The registry library call sites record into: the innermost
    :class:`MetricsScope`'s, else the process default."""
    return _SCOPES[-1] if _SCOPES else _DEFAULT


class MetricsScope:
    """``with MetricsScope(reg):`` — route every module-helper record
    (the resilience/IO/serving retrofits) into ``reg`` for the scope's
    duration.  This is how tests isolate counters and how an embedded
    server owns its own registry without threading one through every
    library signature."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()

    def __enter__(self) -> MetricsRegistry:
        _SCOPES.append(self.registry)
        return self.registry

    def __exit__(self, *exc):
        _SCOPES.pop()
        return False


# ---------------------------------------------------------- module helpers
#
# The helpers are BEST-EFFORT by design: they are the retrofit seam the
# resilience paths record through (fallback trip, watchdog fire,
# preemption drain, step-guard abort, io retry), and a telemetry
# failure — a registry clash from a caller-owned scope, a torn install
# — must never change THEIR control flow (a metrics error swallowing a
# BadStepBudgetExceeded, or crashing the degrade-once fallback before
# it runs, is strictly worse than a lost sample).  Failures warn once
# per metric name; registry methods used directly stay strict.
_WARNED: set = set()


def _best_effort(fn, name: str) -> None:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — observers never participate
        if name not in _WARNED:
            _WARNED.add(name)
            import logging

            from apex_tpu_torch.utils.logging import get_logger, log_structured

            log_structured(get_logger("apex_tpu_torch.observability"),
                           logging.WARNING, "metrics.record_failed",
                           metric=name,
                           error=f"{type(e).__name__}: {e}")


def inc(name: str, value: float = 1.0, help: str = "", **labels) -> None:
    """Increment counter ``name`` in the current registry (labels
    create the series on first use).  Best-effort — see above."""
    _best_effort(
        lambda: get_metrics().counter(
            name, help, tuple(sorted(labels))).inc(value, **labels),
        name)


def set_gauge(name: str, value: float, help: str = "", **labels) -> None:
    _best_effort(
        lambda: get_metrics().gauge(
            name, help, tuple(sorted(labels))).set(value, **labels),
        name)


def observe(name: str, value: float, help: str = "",
            buckets: Sequence[float] = DEFAULT_BUCKETS,
            exemplar: Optional[dict] = None, **labels) -> None:
    _best_effort(
        lambda: get_metrics().histogram(
            name, help, tuple(sorted(labels)),
            buckets=buckets).observe(value, exemplar=exemplar, **labels),
        name)
