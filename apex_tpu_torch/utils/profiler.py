"""Profiling ranges and trace capture (counterpart of
:mod:`apex_tpu.utils.profiler`).

Reference: the NVTX ranges gated by the ``prof`` flag in apex DDP
(``apex/parallel/distributed.py:363-364,406-407,520-521``).  The JAX
package turns a range into ``jax.named_scope`` plus a host
``TraceAnnotation``, and capture into ``jax.profiler.start_trace``; the
port is back on the reference's own tools:

- :func:`nvtx_range` is a ``torch.profiler.record_function`` (the range
  on the profiler's host timeline, around the kernels it launches) and,
  once CUDA is initialized, a ``torch.cuda.nvtx`` range (what Nsight
  shows).  An annotation computes nothing, so it adds no device work
  and is legal inside a CUDA graph capture.
- :func:`start_profile` / :func:`stop_profile` / :func:`profile` run a
  ``torch.profiler.profile`` over the CPU and, when there is one, the
  CUDA device, and write its chrome trace (Perfetto and
  ``chrome://tracing`` load it) into ``logdir``.

With a step context set (:func:`apex_tpu_torch.observability
.set_step_context`) a range's name carries the ``.run_<id>.s<step>``
suffix, so a range joins a structured log line and a metrics point on
``(run_id, step)``.
"""

import contextlib
import os
from pathlib import Path
from typing import List, Optional

import torch

__all__ = ["nvtx_range", "nvtx_range_push", "nvtx_range_pop", "start_profile",
           "stop_profile", "profile"]

_range_stack: List[object] = []


@contextlib.contextmanager
def nvtx_range(name: str):
    """A named range on the profiler's timeline and, with CUDA up, in
    NVTX."""
    from apex_tpu_torch.observability.correlation import span_suffix

    tagged = name + span_suffix()
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(tagged):
        if nvtx:
            torch.cuda.nvtx.range_push(tagged)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def nvtx_range_push(name: str) -> None:
    """``torch.cuda.nvtx.range_push`` parity (the stack form)."""
    cm = nvtx_range(name)
    cm.__enter__()
    _range_stack.append(cm)


def nvtx_range_pop() -> None:
    """``torch.cuda.nvtx.range_pop`` parity."""
    if not _range_stack:
        raise RuntimeError("nvtx_range_pop without a matching push")
    _range_stack.pop().__exit__(None, None, None)


_running: Optional[tuple] = None  # (profiler, logdir)


def start_profile(logdir: str) -> None:
    """Begin a host (and device, when CUDA is available) trace."""
    global _running
    if _running is not None:
        raise RuntimeError(f"profile already running (logdir={_running[1]})")
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _running = (prof, str(logdir))


def stop_profile() -> Optional[str]:
    """End the trace and write it as ``<logdir>/trace_<pid>.json``;
    returns the logdir."""
    global _running
    if _running is None:
        raise RuntimeError("no profile running")
    (prof, logdir), _running = _running, None
    prof.stop()
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / f"trace_{os.getpid()}.json"))
    return logdir


@contextlib.contextmanager
def profile(logdir: str):
    """``with profile('/tmp/trace'):`` — capture a trace of the body."""
    start_profile(logdir)
    try:
        yield
    finally:
        stop_profile()
