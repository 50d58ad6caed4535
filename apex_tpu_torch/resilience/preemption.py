"""Preemption-safe shutdown and resume (counterpart of
:mod:`apex_tpu.resilience.preemption`).

A scheduler (a spot reclaim, a maintenance event, a batch system's
wall clock) sends SIGTERM with a short grace window.  Surviving it is
three small pieces:

- :class:`PreemptionHandler` — converts SIGTERM (or an approaching
  wall-clock deadline, or a simulated preemption) into a flag the
  training loop polls once per step (a Python bool read — no device
  work; the signal handler only marks the flag, so a signal landing
  while a CUDA graph replays changes nothing in flight).  On the way
  out the loop saves after the step it is in and calls :meth:`drain`
  to flush the ``AsyncCheckpointer`` queue, so every save already
  accepted is durable before the process exits.
- :func:`apex_tpu_torch.io.latest_checkpoint` — restart-side discovery
  that validates checkpoint headers and sizes and *skips torn files*.
- :func:`rng_tracker_state_dict` / :func:`load_rng_tracker_state_dict`
  — the named RNG streams of
  :mod:`apex_tpu_torch.transformer.tensor_parallel.random` as plain
  checkpointable data (each generator's state bytes and the fork
  counts), so that a resumed run draws what the uninterrupted one would.
"""

import logging
import signal
import threading
import time
from typing import Optional

from apex_tpu_torch.observability import flightrec as _flightrec
from apex_tpu_torch.observability import metrics as _metrics
from apex_tpu_torch.utils.logging import get_logger, log_structured

__all__ = ["PreemptionHandler", "rng_tracker_state_dict", "load_rng_tracker_state_dict"]

_logger = get_logger("apex_tpu_torch.resilience")


class PreemptionHandler:
    """SIGTERM/deadline hook for graceful training-loop shutdown.

    Usage::

        with PreemptionHandler(deadline_sec=None) as pre:
            for step in range(...):
                ...train, save...
                if pre.preempted:
                    pre.drain(ckpt)   # flush queued saves to disk
                    break

    ``signals``: which signals mean "preempted" (default SIGTERM — the
    scheduler's preemption notice).  The previous handler is
    chained, not clobbered, and restored on exit.  ``deadline_sec``:
    treat the approach of a wall-clock budget (job schedulers, bench
    watchdogs) as a preemption ``grace_sec`` before it lands.
    """

    def __init__(self, signals=(signal.SIGTERM,),
                 deadline_sec: Optional[float] = None,
                 grace_sec: float = 30.0):
        self._event = threading.Event()
        self._signals = tuple(signals)
        self._prev = {}
        self._installed = False
        self._drain_lock = threading.Lock()
        self._draining = False
        self._drain_done = threading.Event()
        self._deadline = (
            time.monotonic() + float(deadline_sec)
            if deadline_sec is not None else None)
        self._grace = float(grace_sec)
        self.reason: Optional[str] = None

    # ----------------------------------------------------- installation
    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        try:
            for sig in self._signals:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            self._installed = True
        except ValueError:
            # not the main thread (pytest-xdist workers, bg threads):
            # signal delivery is impossible there anyway — deadline and
            # simulate() still work, so degrade instead of failing
            log_structured(_logger, logging.WARNING, "preemption.install_degraded",
                           why="not on main thread; signal hooks skipped")
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # ------------------------------------------------------------ state
    def _on_signal(self, signum, frame):
        self._mark(f"signal {signal.Signals(signum).name}")
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def _mark(self, reason: str) -> None:
        if not self._event.is_set():
            self.reason = reason
            log_structured(_logger, logging.WARNING, "preemption.received",
                           reason=reason)
            _metrics.inc("apex_preemptions_total",
                         help="preemption notices received")
            # forensics at the NOTICE (not the exit): the grace window
            # may close before an orderly dump path ever runs (no-op
            # without an installed recorder)
            _flightrec.dump_active("preemption", preempt_reason=reason)
        self._event.set()

    def simulate(self, reason: str = "simulated (chaos)") -> None:
        """Flip the flag as a real signal would (tests, fault drills)."""
        self._mark(reason)

    @property
    def preempted(self) -> bool:
        if self._event.is_set():
            return True
        if self._deadline is not None \
                and time.monotonic() >= self._deadline - self._grace:
            self._mark("deadline approaching")
            return True
        return False

    # ------------------------------------------------------------ drain
    def drain(self, checkpointer) -> None:
        """Flush every queued async save to disk (and surface write
        errors) — the step that turns "a save was accepted" into "the
        bytes are durable" before the grace window closes.

        NOT re-entrant by design, and guarded against it: a second
        SIGTERM landing mid-drain (schedulers often resend), or the
        step watchdog firing from its own thread while the loop is
        already draining, must not re-enter ``wait_until_finished`` —
        worst case two callers race ``close()``-adjacent state.  A
        re-entrant call logs ``preemption.drain_reentered`` and then
        WAITS for the in-flight drain to finish (never flushing twice):
        returning early instead would let the watchdog report
        "drained" and ``os._exit`` while the first flush is still
        writing, losing the final accepted save.  Callers that need a
        bound on that wait wrap drain in their own timeout (the
        watchdog's ``_drain_bounded`` helper thread)."""
        with self._drain_lock:
            if self._draining:
                log_structured(_logger, logging.WARNING,
                               "preemption.drain_reentered",
                               reason=self.reason)
                done = self._drain_done
            else:
                self._draining = True
                done = None
        if done is not None:
            done.wait()  # the in-flight drain's completion IS this one's
            err = getattr(done, "error", None)
            if err is not None:
                # the flush this caller piggybacked on FAILED: returning
                # normally would let a watchdog report "drained" and
                # exit over an unflushed save — surface it here too
                raise RuntimeError(
                    f"in-flight drain failed: {type(err).__name__}: {err}"
                ) from err
            return
        try:
            t0 = time.monotonic()
            checkpointer.wait_until_finished()
            flush_s = time.monotonic() - t0
            log_structured(_logger, logging.WARNING, "preemption.drained",
                           reason=self.reason,
                           flush_seconds=round(flush_s, 3))
            _metrics.inc("apex_preemption_drains_total",
                         help="async-checkpoint queue drains")
            _metrics.observe("apex_preemption_drain_seconds", flush_s,
                             help="drain flush latency")
        except BaseException as e:
            self._drain_done.error = e  # visible to piggybacked waiters
            raise
        finally:
            with self._drain_lock:
                self._draining = False
                self._drain_done.set()
                self._drain_done = threading.Event()  # re-arm


# ----------------------------------------------------- RNG tracker I/O
def _tracker(tracker):
    if tracker is None:
        from apex_tpu_torch.transformer.tensor_parallel.random import get_rng_state_tracker

        tracker = get_rng_state_tracker()
    return tracker


def rng_tracker_state_dict(tracker=None) -> dict:
    """The named RNG streams (each generator's state as uint8 numpy, and
    the fork counts) as plain checkpointable data; by default the global
    tracker's."""
    tracker = _tracker(tracker)
    return {"states": {k: v.numpy() for k, v in tracker.get_states().items()},
            "counts": dict(tracker.counts_)}


def load_rng_tracker_state_dict(d: dict, tracker=None):
    """Restore a :func:`rng_tracker_state_dict` snapshot into ``tracker``
    (its streams added already), so that the next draw continues each
    stream where the save left it."""
    tracker = _tracker(tracker)
    tracker.set_states(d["states"])
    tracker.counts_ = {k: int(v) for k, v in d["counts"].items()}
    return tracker
