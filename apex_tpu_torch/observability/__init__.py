"""Metrics, step telemetry, goodput, tracing and crash forensics for the
port's trainer (counterpart of :mod:`apex_tpu.observability`):

- :mod:`~apex_tpu_torch.observability.metrics`: process-local,
  rank-aware counters/gauges/histograms with labels, a JSONL time-series
  sidecar and a Prometheus text exporter;
- :mod:`~apex_tpu_torch.observability.stepstats`: the
  :class:`StepStats` window riding the train step
  (``train_gpt.make_train_step(telemetry=...)``) in fixed device
  buffers, fetched asynchronously (:class:`AsyncFetcher`);
- :mod:`~apex_tpu_torch.observability.goodput`: per-session wall-time
  attribution whose fractions sum to 1, and the model-FLOPs formulas;
- :mod:`~apex_tpu_torch.observability.tracing`: host-side spans over the
  loop's phases, exported as JSONL and Perfetto JSON;
- :mod:`~apex_tpu_torch.observability.flightrec`: the flight recorder,
  dumped on watchdog wedge, StepGuard abort and preemption;
- :mod:`~apex_tpu_torch.observability.anomaly`: rolling median/MAD
  detectors over step time and throughput;
- :mod:`~apex_tpu_torch.observability.correlation`: the ``(run_id,
  step)`` join key all of them stamp.
"""

from apex_tpu_torch.observability.anomaly import AnomalyMonitor, RollingMadDetector
from apex_tpu_torch.observability.correlation import (
    clear_step_context,
    set_step_context,
    span_suffix,
    step_context,
)
from apex_tpu_torch.observability.flightrec import FlightRecorder
from apex_tpu_torch.observability.goodput import (
    GoodputAccountant,
    decode_flops_per_token,
    goodput_report,
    model_flops_per_step,
    model_flops_per_token,
    param_count,
    session_progress,
)
from apex_tpu_torch.observability.metrics import (
    MetricsRegistry,
    MetricsScope,
    append_jsonl,
    get_metrics,
)
from apex_tpu_torch.observability.stepstats import AsyncFetcher, StepStats, StepTelemetry
from apex_tpu_torch.observability.tracing import (
    TracedStep,
    Tracer,
    TracingScope,
    new_trace_id,
    span,
)

__all__ = [
    "AnomalyMonitor", "AsyncFetcher", "FlightRecorder",
    "GoodputAccountant", "MetricsRegistry", "MetricsScope",
    "RollingMadDetector", "StepStats", "StepTelemetry", "TracedStep",
    "Tracer", "TracingScope", "append_jsonl", "clear_step_context",
    "decode_flops_per_token", "get_metrics", "goodput_report",
    "model_flops_per_step", "model_flops_per_token", "new_trace_id",
    "param_count", "session_progress", "set_step_context", "span",
    "span_suffix", "step_context",
]
