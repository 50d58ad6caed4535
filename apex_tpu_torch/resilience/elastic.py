"""The step watchdog (counterpart of :class:`apex_tpu.resilience.elastic
.StepWatchdog`): a step exceeding its deadline (a wedged kernel, a hung
build, a dead filesystem) is declared dead — one structured
``watchdog.step_wedged`` record, the ``on_wedge`` hook, a flight
recorder dump, a bounded drain of the async checkpointer (every
ACCEPTED save durable; the wedged step itself is lost by definition),
then ``os._exit(EXIT_WEDGED)`` so a supervisor restarts with backoff.

Exit-code contract (what a supervisor keys restart policy on)::

    0            clean finish, or preemption save+drain (resume freely)
    EXIT_WEDGED  (75, EX_TEMPFAIL) the watchdog killed a wedged step —
                 restart with backoff; the run resumes from its newest
                 valid checkpoint
    anything else: a real crash; do not blindly restart

The JAX module's elastic checkpoints, reshard and run controller come
with ZeRO.
"""

import logging
import os
import threading
import time
from typing import Optional

from apex_tpu_torch.observability import flightrec as _flightrec
from apex_tpu_torch.observability import metrics as _metrics
from apex_tpu_torch.utils.logging import get_logger, log_structured

__all__ = ["EXIT_WEDGED", "StepWatchdog"]

_logger = get_logger("apex_tpu_torch.resilience")

#: sysexits EX_TEMPFAIL: "temporary failure, retry later" — the
#: watchdog's exit code.  Distinct from 0 (clean/preempted) and from
#: Python's generic 1 so a supervisor can apply restart-with-backoff to
#: exactly the wedged-step case.
EXIT_WEDGED = 75


# ---------------------------------------------------------- step watchdog
class StepWatchdog:
    """Heartbeat-deadline watchdog for the training loop.

    The loop calls :meth:`beat` once per step (host-side, a couple of
    float stores).  A background thread checks the time since the last
    beat; past ``deadline_sec`` the step is declared WEDGED: one
    structured ``watchdog.step_wedged`` record, a bounded drain of the
    async checkpointer (``drain_timeout_sec`` — the wedged thing may BE
    the filesystem), then ``os._exit(exit_code)`` so the supervisor
    restarts with backoff.  ``os._exit`` (not ``sys.exit``): the main
    thread may be blocked inside a C call (a synchronize on a wedged
    kernel); only a hard exit reliably escapes it.

    ``first_deadline_sec`` covers the first interval (the kernels' build
    and the graph capture make step 0 legitimately slow); defaults to
    ``deadline_sec``.
    ``on_fire`` replaces the exit for tests: called with the fire-info
    dict instead of terminating.  ``on_wedge`` is a best-effort
    pre-exit hook called with the fire-info dict BEFORE the drain (the
    goodput accountant's ``finalize("wedge")`` rides it, so the wedged
    tail is attributable after the ``os._exit``); its failures are
    swallowed — the watchdog must still exit.  ``preemption`` (a
    :class:`~apex_tpu.resilience.preemption.PreemptionHandler`) routes
    the drain through its re-entrancy guard so a watchdog firing while
    the loop already drains cannot double-enter the flush.
    """

    def __init__(self, deadline_sec: float, checkpointer=None,
                 exit_code: int = EXIT_WEDGED, poll_sec: Optional[float] = None,
                 first_deadline_sec: Optional[float] = None,
                 drain_timeout_sec: float = 60.0, on_fire=None,
                 preemption=None, on_wedge=None):
        if deadline_sec <= 0:
            raise ValueError(f"deadline_sec must be > 0, got {deadline_sec}")
        self.deadline_sec = float(deadline_sec)
        self.first_deadline_sec = float(
            first_deadline_sec if first_deadline_sec is not None
            else deadline_sec)
        self.exit_code = int(exit_code)
        self._checkpointer = checkpointer
        self._preemption = preemption
        self._drain_timeout = float(drain_timeout_sec)
        self._on_fire = on_fire
        self.on_wedge = on_wedge
        self._poll = float(poll_sec) if poll_sec is not None else min(
            1.0, self.deadline_sec / 4.0)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_beat: Optional[float] = None
        self._armed_at: Optional[float] = None
        self._step: Optional[int] = None
        self._interval_deadline = self.deadline_sec
        self.fired = False
        self.fire_info: Optional[dict] = None

    # ------------------------------------------------------- lifecycle
    def start(self) -> "StepWatchdog":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._armed_at = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="apex_tpu_torch-step-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(2.0, 4 * self._poll))
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------- heartbeat
    def beat(self, step: Optional[int] = None,
             deadline: Optional[float] = None) -> None:
        """Record progress: the loop reached (the top of) ``step``.
        ``deadline`` overrides the allowance for THIS interval only —
        the loop grants the first step its build-and-capture grace
        (``watchdog.beat(0, deadline=compile_grace)``) without
        loosening the steady-state deadline."""
        with self._lock:
            self._last_beat = time.monotonic()
            self._interval_deadline = (float(deadline) if deadline is not None
                                       else self.deadline_sec)
            if step is not None:
                self._step = int(step)

    # --------------------------------------------------------- monitor
    def _expired(self, now: float):
        with self._lock:
            last, step = self._last_beat, self._step
            interval = self._interval_deadline
        if last is None:
            # never beaten: the first interval covers startup + compile
            start = self._armed_at if self._armed_at is not None else now
            elapsed, deadline = now - start, self.first_deadline_sec
        else:
            elapsed, deadline = now - last, interval
        return (elapsed, deadline, step) if elapsed >= deadline else None

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            hit = self._expired(time.monotonic())
            if hit is None:
                continue
            elapsed, deadline, step = hit
            self._fire(elapsed, deadline, step)
            return

    def _drain_bounded(self) -> str:
        """Drain the async checkpointer from a helper thread with a
        timeout: the wedge may be the filesystem itself, and a watchdog
        that hangs in its own cleanup protects nothing."""
        if self._checkpointer is None:
            return "no_checkpointer"
        done = threading.Event()
        outcome = {"state": "drain_timeout"}

        def flush():
            try:
                if self._preemption is not None:
                    self._preemption.drain(self._checkpointer)
                else:
                    self._checkpointer.wait_until_finished()
                outcome["state"] = "drained"
            except BaseException as e:  # noqa: BLE001 — report, then exit anyway
                outcome["state"] = f"drain_error:{type(e).__name__}"
            finally:
                done.set()

        threading.Thread(target=flush, daemon=True,
                         name="apex_tpu_torch-watchdog-drain").start()
        done.wait(self._drain_timeout)
        return outcome["state"]

    def _fire(self, elapsed: float, deadline: float,
              step: Optional[int]) -> None:
        info = {"step": step, "elapsed_s": round(elapsed, 3),
                "deadline_s": deadline, "exit_code": self.exit_code}
        log_structured(_logger, logging.ERROR, "watchdog.step_wedged",
                       **info)
        # two SEPARATE best-effort blocks: a metrics registration clash
        # must not also rob the goodput accountant of its wedge stamp
        # (the attribution the report exists to make)
        _metrics.inc("apex_watchdog_wedges_total",
                     help="steps the watchdog declared wedged")
        try:
            if self.on_wedge is not None:
                self.on_wedge(info)
        except Exception as e:  # noqa: BLE001 — the hook is best-effort;
            # the watchdog's one job is to exit, so a broken accountant
            # must never wedge the wedge handler
            log_structured(_logger, logging.WARNING,
                           "watchdog.on_wedge_failed",
                           error=f"{type(e).__name__}: {e}")
        # flight-recorder dump AFTER the on_wedge hook (so the hook's
        # own records — the goodput wedge stamp, the forced anomaly
        # alert — are IN the dump) and BEFORE the drain (the wedged
        # thing may be the filesystem the drain is about to wait on).
        # dump_active is best-effort and a no-op without a recorder.
        info["flight_dump"] = _flightrec.dump_active(
            "wedge", wedged_step=step,
            elapsed_s=info["elapsed_s"], deadline_s=deadline)
        info["drain"] = self._drain_bounded()
        log_structured(_logger, logging.ERROR, "watchdog.exiting",
                       **info)
        self.fired = True
        self.fire_info = info
        if self._on_fire is not None:
            self._on_fire(info)
            return
        os._exit(self.exit_code)
