"""The self-healing supervisor (counterpart of
:mod:`apex_tpu.resilience.supervisor`): the process that runs the
restart contract the rest of the package documents.  It launches the
trainer (``python -m apex_tpu_torch.pretrain_gpt``) or the serving
engine (``python -m apex_tpu_torch.serve_gpt``) as a child and runs the
restart state machine, the JAX module's, decision for decision::

    SPAWN -> WAIT -> rc == 0 ----------------------------> DONE (exit 0)
              |       rc != 0 and SIGTERM was forwarded --> DONE (exit rc)
              |       rc != 0:
              |         progress advanced?  -> streak = 0
              |         no progress         -> streak += 1
              |         corrupt newest ckpt -> QUARANTINE it
              |         streak >= K         -> BREAKER (exit 76)
              |         restarts exhausted  -> GIVE UP (exit rc)
              +------ BACKOFF (full jitter; wedge repeats lengthen it)
                        -> SPAWN (attempt += 1)

- **Exit codes** (:mod:`apex_tpu_torch.resilience.elastic`): 0 is done;
  75 (wedged) and 137 (killed) are the recoverable codes, and any other
  nonzero code is restarted too, bounded by the breaker.
- **Progress feeds the breaker**: ``progress_fn`` reads the goodput
  session files and the newest complete checkpoint step; a child that
  banked new steps, or ran ``min_healthy_runtime_sec``, resets the
  streak.  K failures with no progress exit :data:`EXIT_CRASH_LOOP`.
- **Quarantine**: after a no-progress failure the newest restore
  candidate is probed (``io.checkpoint.probe_checkpoint_dir``); a
  corrupt one moves to ``quarantine/`` so the next start resumes from
  the step before.
- **Backoff**: ``restart_backoff(streak - 1)`` through an injectable
  ``rng``; a wedge (exit 75) again at the same progress multiplies the
  delay by its repeats, and fresh anomaly alerts double it.
- **SIGTERM** is forwarded once, then a grace window, then SIGKILL; a
  child asked to stop is never restarted.
- Events log through ``log_structured`` with ``(run_id, attempt)``;
  ``apex_supervisor_restarts_total{exit_code}`` and
  ``apex_supervisor_backoff_seconds`` land on the metrics registry; the
  job's goodput report prints from here.

Every effect runs through a seam (``spawn_fn``, ``sleep_fn``,
``time_fn``, ``rng``, ``progress_fn``, ``probe_fn``, ``anomaly_fn``), so
the tests drive the whole machine with fake children and a pinned clock.
Host code only: the children own the card.
"""

import logging
import signal
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

from apex_tpu_torch.observability import anomaly as _anomaly
from apex_tpu_torch.observability import flightrec as _flightrec
from apex_tpu_torch.observability import metrics as _metrics
from apex_tpu_torch.resilience.elastic import EXIT_WEDGED, restart_backoff
from apex_tpu_torch.utils.logging import get_logger, log_structured

__all__ = [
    "EXIT_CRASH_LOOP", "SUPERVISOR_FLAGS", "Supervisor",
    "add_supervisor_args", "run_supervised_cli", "strip_supervisor_argv",
]

_logger = get_logger("apex_tpu_torch.resilience")

#: sysexits EX_PROTOCOL repurposed for the restart protocol itself
#: failing: K consecutive relaunches made no step progress, so
#: restarting again would burn the machine, not heal the job.  Distinct
#: from 0 (done), 75 (wedged — restartable), 137 (killed —
#: restartable), and the child's own crash codes, so a fleet scheduler
#: can page a human on exactly this one.
EXIT_CRASH_LOOP = 76

#: supervisor-owned CLI flags (flag -> value-arg count) — what
#: :func:`strip_supervisor_argv` removes so the child never sees (and
#: never recursively re-enters) supervision.
SUPERVISOR_FLAGS = {
    "--supervise": 0,
    "--max-restarts": 1,
    "--crash-loop-threshold": 1,
    "--backoff-base": 1,
    "--backoff-cap": 1,
    "--backoff-seed": 1,
    "--supervise-grace": 1,
    "--fault-script": 1,
}


def strip_supervisor_argv(argv: Sequence[str],
                          flags=None) -> List[str]:
    """Drop the supervisor-owned flags (and their values) from an
    argv, handling both ``--flag value`` and ``--flag=value``
    spellings — the child relaunch command is the operator's own
    command line minus the supervision layer."""
    flags = SUPERVISOR_FLAGS if flags is None else flags
    out: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        name = a.split("=", 1)[0]
        if name in flags:
            i += 1 + (0 if "=" in a else flags[name])
            continue
        out.append(a)
        i += 1
    return out


class Supervisor:
    """Crash-loop-aware restart orchestration for one child command.

    Usage (what ``pretrain_gpt --supervise`` and ``serve_gpt
    --supervise`` wire)::

        sup = Supervisor(cmd, checkpoint_dir=ck, metrics_dir=md,
                         run_id=args.run_id)
        sys.exit(sup.run())

    Parameters:

    ``cmd``: the child argv (already stripped of supervisor flags).
    ``checkpoint_dir``: enables the post-failure corruption probe +
    quarantine; ``metrics_dir``: enables goodput-based progress reading
    and the final report print.  ``max_restarts`` bounds total
    relaunches; ``crash_loop_threshold`` (K) is the no-progress streak
    that trips the breaker.  ``backoff_base``/``backoff_cap``/``seed``
    parameterize :func:`restart_backoff`; ``rng`` (anything with
    ``uniform``) overrides the seed derivation so tests pin delays.
    ``grace_sec`` bounds the SIGTERM->SIGKILL drain.
    ``min_healthy_runtime_sec``: a child that RAN at least this long
    before failing counts as progress even when no step counter moved —
    the signal a stateless child (the serving engine, which banks no
    checkpoints) still has; without it the breaker would degenerate to
    "K failures ever" and put down a server that served for days
    between transient wedges.
    ``fault_script`` (:class:`~apex_tpu_torch.resilience.chaos
    .SupervisorFaultScript`) arms per-attempt chaos: extra child args
    and/or a pre-spawn corrupt-newest-checkpoint.
    ``install_signals=True`` (the CLI path) forwards a received
    SIGTERM to the child exactly once.
    """

    def __init__(self, cmd: Sequence[str], *, checkpoint_dir=None,
                 metrics_dir=None, run_id: str = "run",
                 max_restarts: int = 16, crash_loop_threshold: int = 3,
                 backoff_base: float = 2.0, backoff_cap: float = 300.0,
                 seed: int = 0, rng=None, grace_sec: float = 30.0,
                 min_healthy_runtime_sec: float = 300.0,
                 fault_script=None, install_signals: bool = False,
                 flight_dir=None,
                 spawn_fn: Optional[Callable] = None,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 time_fn: Callable[[], float] = time.monotonic,
                 progress_fn: Optional[Callable[[], int]] = None,
                 probe_fn: Optional[Callable] = None,
                 anomaly_fn: Optional[Callable[[], int]] = None):
        if crash_loop_threshold < 1:
            raise ValueError(
                f"crash_loop_threshold must be >= 1, got "
                f"{crash_loop_threshold}")
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        self.cmd = [str(c) for c in cmd]
        self.checkpoint_dir = checkpoint_dir
        self.metrics_dir = metrics_dir
        self.run_id = str(run_id)
        self.max_restarts = int(max_restarts)
        self.crash_loop_threshold = int(crash_loop_threshold)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.seed = int(seed)
        self.rng = rng
        self.grace_sec = float(grace_sec)
        self.min_healthy_runtime_sec = float(min_healthy_runtime_sec)
        self.fault_script = fault_script
        self._spawn = spawn_fn if spawn_fn is not None else self._spawn_child
        self._sleep = sleep_fn
        self._time = time_fn
        self._progress_fn = progress_fn if progress_fn is not None \
            else self._default_progress
        self._probe = probe_fn if probe_fn is not None \
            else self._default_probe
        self._install_signals = bool(install_signals)
        #: where the children's flight-recorder dumps land (the trace
        #: dir when the drivers trace, else <metrics_dir>/flightrec) —
        #: the newest readable dump is attached to every restart and
        #: quarantine record, so each exit-75/137 points at its own
        #: forensics artifact
        self.flight_dir = (str(flight_dir) if flight_dir is not None
                           else _flightrec.default_dir(
                               metrics_dir=metrics_dir))
        self._anomaly_fn = anomaly_fn if anomaly_fn is not None \
            else self._default_anomaly
        self._anomaly_seen = 0
        # ---- run state (introspectable by tests / postmortems)
        self.attempt = 0            # child launches so far
        self.restarts = 0           # relaunches after a failure
        self.quarantined: List[str] = []
        self.flight_dumps: List[Optional[str]] = []
        self.backoffs: List[float] = []
        self._streak = 0            # consecutive no-progress failures
        self._last_progress = 0
        self._wedge_repeats = 0
        self._wedge_progress: Optional[int] = None
        self._child = None
        self._stop_requested = False
        self._term_forwarded = False
        self._kill_deadline: Optional[float] = None

    # -------------------------------------------------------- seams
    @staticmethod
    def _spawn_child(argv):
        # stdout/stderr inherited: the child's loss lines and
        # structured events ARE the job's output; the supervisor only
        # adds its own events around them
        return subprocess.Popen(argv)

    def _default_progress(self) -> int:
        """Best available monotone progress signal: goodput session
        steps (the authoritative record) plus the newest COMPLETE
        checkpoint step (covers runs launched without --metrics-dir).
        Completeness matters: a hard kill can leave an incomplete
        newest ``step_*`` dir that no restore can use — counting it as
        progress would mask exactly the no-progress failure the
        quarantine probe and the breaker exist to catch."""
        from pathlib import Path

        from apex_tpu_torch.io import checkpoint as ckpt

        best = 0
        if self.metrics_dir is not None:
            from apex_tpu_torch.observability.goodput import session_progress

            best = max(best, session_progress(self.metrics_dir))
        d = Path(self.checkpoint_dir) if self.checkpoint_dir is not None \
            else None
        if d is None or not d.is_dir():
            return best
        if any(p.is_dir() for p in d.glob("step_*")):
            try:
                step = ckpt.latest_distributed_step(d)
            except ckpt.AllCheckpointsTornError:
                step = -1  # dirs exist, none complete: nothing banked
            return max(best, step)
        try:
            newest = ckpt.latest_checkpoint(d)
        except FileNotFoundError:  # incl. the all-torn subclass
            newest = None          # no restorable file: nothing banked
        if newest is not None:
            best = max(best, ckpt.checkpoint_step(newest))
        return best

    def _default_probe(self):
        if self.checkpoint_dir is None:
            return None
        from apex_tpu_torch.io.checkpoint import probe_checkpoint_dir

        return probe_checkpoint_dir(self.checkpoint_dir)

    def _default_anomaly(self) -> int:
        """Total alerts the children's anomaly monitors persisted under
        the metrics dir — falling back to the flight/trace dir, where
        the drivers persist when only ``--trace-dir`` is set — recent
        only (a week-old regression record must not keep lengthening
        today's backoff)."""
        d = self.metrics_dir if self.metrics_dir is not None \
            else self.flight_dir
        if d is None:
            return 0
        return _anomaly.recent_alert_count(d, max_age_sec=3600.0)

    def _latest_flight_dump(self) -> Optional[str]:
        if self.flight_dir is None:
            return None
        return _flightrec.latest_dump_path(self.flight_dir)

    # ------------------------------------------------------ signals
    def _on_sigterm(self, signum, frame):  # pragma: no cover - signal path
        self.request_stop()

    def request_stop(self) -> None:
        """Stop the job: forward SIGTERM to the live child EXACTLY
        once, arm the grace-then-SIGKILL deadline, and never spawn
        again.  Idempotent — schedulers resend the reclaim notice."""
        self._stop_requested = True
        child = self._child
        if child is not None and not self._term_forwarded:
            self._term_forwarded = True
            self._kill_deadline = self._time() + self.grace_sec
            log_structured(_logger, logging.WARNING,
                           "supervisor.forwarding_sigterm",
                           run_id=self.run_id, attempt=self.attempt,
                           grace_sec=self.grace_sec)
            try:
                child.terminate()
            except OSError:
                # already-reaped child: wait() below returns immediately
                log_structured(_logger, logging.WARNING,
                               "supervisor.forward_failed",
                               run_id=self.run_id, attempt=self.attempt)

    def _wait(self, child) -> int:
        """Reap the child, honoring the grace-then-SIGKILL drain when a
        stop was requested (the poll loop is what lets a signal landing
        mid-wait arm the deadline and still bound the drain)."""
        killed = False
        while True:
            try:
                rc = child.wait(timeout=0.2)
            except subprocess.TimeoutExpired:
                rc = None  # still running: fall through to the deadline
            if rc is not None:
                rc = int(rc)
                # Popen reports a signal death as -SIGNUM; the process
                # table (and this supervisor's own exit) speaks
                # 128+SIGNUM — returning the raw negative would garble
                # the final exit status (SystemExit(-9) exits 247, not
                # 137) and EXIT_KILLED would never match a REAL SIGKILL
                return 128 - rc if rc < 0 else rc
            if (self._kill_deadline is not None and not killed
                    and self._time() >= self._kill_deadline):
                killed = True
                log_structured(_logger, logging.ERROR,
                               "supervisor.grace_expired_sigkill",
                               run_id=self.run_id, attempt=self.attempt,
                               grace_sec=self.grace_sec)
                try:
                    child.kill()
                except OSError as e:
                    # it died on its own in the window — wait() below
                    # reaps it; still worth a line in the postmortem
                    log_structured(_logger, logging.WARNING,
                                   "supervisor.kill_failed",
                                   run_id=self.run_id,
                                   attempt=self.attempt,
                                   error=f"{type(e).__name__}: {e}")

    # --------------------------------------------------------- faults
    def _apply_fault(self, argv: List[str]) -> List[str]:
        if self.fault_script is None:
            return argv
        fault = self.fault_script.fault_for(self.attempt)
        if fault is None:
            return argv
        if fault.corrupt_newest_checkpoint:
            if self.checkpoint_dir is None:
                raise ValueError(
                    "fault script asks to corrupt the newest checkpoint "
                    "but the supervisor has no checkpoint_dir")
            from apex_tpu_torch.resilience.chaos import corrupt_newest_checkpoint

            corrupt_newest_checkpoint(self.checkpoint_dir)
        return argv + list(fault.extra_args)

    # ------------------------------------------------------ quarantine
    def _probe_and_quarantine(self) -> None:
        """Post-failure: deep-probe the checkpoint the NEXT restore
        would load; quarantine it when corrupt.  Probe errors are
        logged, never fatal — a broken probe must not stop the restart
        machine whose whole job is to keep the run alive."""
        try:
            bad = self._probe()
        except Exception as e:  # noqa: BLE001 — report, keep supervising
            log_structured(_logger, logging.WARNING,
                           "supervisor.probe_failed", run_id=self.run_id,
                           attempt=self.attempt,
                           error=f"{type(e).__name__}: {e}")
            return
        if bad is None:
            return
        from apex_tpu_torch.io.checkpoint import quarantine_checkpoint

        dest = quarantine_checkpoint(self.checkpoint_dir, bad.path,
                                     bad.reason)
        self.quarantined.append(dest)
        _metrics.inc("apex_supervisor_quarantines_total",
                     help="corrupt newest checkpoints quarantined")
        log_structured(_logger, logging.ERROR, "supervisor.quarantined",
                       run_id=self.run_id, attempt=self.attempt,
                       path=bad.path, quarantined_to=dest,
                       reason=bad.reason,
                       flight_dump=self._latest_flight_dump())

    # -------------------------------------------------------- backoff
    def _backoff_delay(self, exit_code: int, progress: int) -> float:
        delay = restart_backoff(max(self._streak - 1, 0),
                                base=self.backoff_base,
                                cap=self.backoff_cap, seed=self.seed,
                                rng=self.rng)
        alerts = self._safe_anomaly()
        if alerts > self._anomaly_seen:
            # the dead child's anomaly monitor recorded NEW regressions
            # (step-time ramp, SLO burn) before it died: the fault was
            # building, not transient — double the cool-down once per
            # batch of fresh alerts (the goodput-adaptive leg of the
            # backoff, same logic as the wedge-repeat lengthening)
            delay *= 2.0
            log_structured(_logger, logging.WARNING,
                           "supervisor.backoff_lengthened",
                           run_id=self.run_id, attempt=self.attempt,
                           reason="anomaly_alerts",
                           new_alerts=alerts - self._anomaly_seen,
                           delay_s=round(delay, 3))
        # track DOWN as well as up: summaries age out of the recent-
        # alert window, and a stale high watermark would silently eat
        # the next batch of fresh alerts (healthy-for-an-hour server,
        # then a real ramp)
        self._anomaly_seen = alerts
        if exit_code == EXIT_WEDGED:
            if self._wedge_progress == progress:
                # the SAME point in the run wedged again: the goodput
                # record says the short cool-down did not help —
                # lengthen it instead of hammering the fault
                self._wedge_repeats += 1
                delay *= (1 + self._wedge_repeats)
                log_structured(_logger, logging.WARNING,
                               "supervisor.backoff_lengthened",
                               run_id=self.run_id, attempt=self.attempt,
                               progress=progress,
                               wedge_repeats=self._wedge_repeats,
                               delay_s=round(delay, 3))
            else:
                self._wedge_progress = progress
                self._wedge_repeats = 0
        return delay

    # ------------------------------------------------------------ run
    def run(self) -> int:
        """Drive the restart state machine to a final exit code (also
        what the process should exit with)."""
        from apex_tpu_torch.observability import set_step_context

        set_step_context(run_id=self.run_id)
        prev_handler = None
        if self._install_signals:
            prev_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
        try:
            return self._run()
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def _run(self) -> int:
        self._last_progress = self._safe_progress()
        # baseline, not zero: anomaly summaries a PREVIOUS run left in
        # the same metrics dir must not double THIS run's first backoff
        self._anomaly_seen = self._safe_anomaly()
        while True:
            if self._stop_requested:
                # SIGTERM landed before this (first or next) spawn —
                # e.g. during the initial progress read: launching a
                # child the scheduler already wants dead would end in
                # an undrained cgroup SIGKILL
                log_structured(_logger, logging.WARNING,
                               "supervisor.stopped_before_spawn",
                               run_id=self.run_id, attempt=self.attempt)
                return self._finish(0, "stopped by SIGTERM before spawn")
            argv = self._apply_fault(list(self.cmd))
            log_structured(_logger, logging.INFO, "supervisor.spawning",
                           run_id=self.run_id, attempt=self.attempt,
                           cmd=" ".join(argv))
            spawned_at = self._time()
            self._child = self._spawn(argv)
            if self._stop_requested and not self._term_forwarded:
                # the signal raced the spawn itself: the handler saw
                # _child=None and could not forward — do it now, so the
                # fresh child still gets the TERM + grace contract
                self.request_stop()
            rc = self._wait(self._child)
            self._child = None
            runtime = self._time() - spawned_at
            log_structured(_logger, logging.INFO, "supervisor.child_exit",
                           run_id=self.run_id, attempt=self.attempt,
                           exit_code=rc, runtime_s=round(runtime, 3))
            if rc == 0:
                return self._finish(0, "clean child exit")
            if self._stop_requested:
                # the child was ASKED to die: its code is the truth,
                # restarting would fight the scheduler
                return self._finish(rc, "stopped by SIGTERM")
            progress = self._safe_progress()
            # a long-healthy runtime IS progress: a stateless child
            # (the serving engine) banks no step counters, and a
            # trainer's sessions may be unreadable — "ran fine for
            # minutes before this fault" must not accumulate toward
            # the breaker across days of otherwise-healthy serving
            if progress > self._last_progress \
                    or runtime >= self.min_healthy_runtime_sec:
                self._streak = 0
            else:
                self._streak += 1
            self._last_progress = progress
            if self._streak >= 1:
                # quarantine probe only on a NO-PROGRESS failure: a
                # corrupt-newest restore crash is one by construction,
                # while probing after every progress-making wedge would
                # re-read multi-GB of healthy shards per restart (the
                # child's own load-time crc re-verifies them anyway)
                self._probe_and_quarantine()
            if self._streak >= self.crash_loop_threshold:
                log_structured(
                    _logger, logging.ERROR,
                    "supervisor.circuit_breaker_tripped",
                    run_id=self.run_id, attempt=self.attempt,
                    exit_code=rc, no_progress_failures=self._streak,
                    threshold=self.crash_loop_threshold,
                    breaker_exit_code=EXIT_CRASH_LOOP)
                return self._finish(
                    EXIT_CRASH_LOOP,
                    f"{self._streak} consecutive no-progress failures")
            if self.restarts >= self.max_restarts:
                log_structured(_logger, logging.ERROR,
                               "supervisor.restarts_exhausted",
                               run_id=self.run_id, attempt=self.attempt,
                               max_restarts=self.max_restarts,
                               exit_code=rc)
                return self._finish(rc, "restart budget exhausted")
            delay = self._backoff_delay(rc, progress)
            self.backoffs.append(delay)
            # the child's own flight recorder dumped on its way out
            # (watchdog wedge, budget abort) or left its periodically
            # republished checkpoint (hard kill): the restart record
            # carries the path, so every exit-75/137 names its own
            # forensics artifact
            flight = self._latest_flight_dump()
            self.flight_dumps.append(flight)
            _metrics.observe("apex_supervisor_backoff_seconds", delay,
                             help="pre-restart backoff delays")
            log_structured(_logger, logging.WARNING,
                           "supervisor.restarting", run_id=self.run_id,
                           attempt=self.attempt, exit_code=rc,
                           delay_s=round(delay, 3), progress=progress,
                           no_progress_failures=self._streak,
                           flight_dump=flight)
            self._sleep(delay)
            if self._stop_requested:
                # SIGTERM landed during the backoff sleep: no child to
                # forward to, nothing new to lose — report the last rc
                # (counted as ZERO relaunches: none happened)
                return self._finish(rc, "stopped by SIGTERM in backoff")
            # counted HERE, after every return that skips the respawn:
            # the metric means relaunches that actually happen, and
            # must agree with self.restarts at every exit
            _metrics.inc("apex_supervisor_restarts_total",
                         help="child relaunches by exit code",
                         exit_code=str(rc))
            self.restarts += 1
            self.attempt += 1

    def _safe_anomaly(self) -> int:
        try:
            return int(self._anomaly_fn())
        except Exception as e:  # noqa: BLE001 — a broken alert probe
            # must degrade to "nothing new", not kill the machine
            log_structured(_logger, logging.WARNING,
                           "supervisor.anomaly_read_failed",
                           run_id=self.run_id, attempt=self.attempt,
                           error=f"{type(e).__name__}: {e}")
            return self._anomaly_seen

    def _safe_progress(self) -> int:
        try:
            return int(self._progress_fn())
        except Exception as e:  # noqa: BLE001 — a broken progress probe
            # must degrade to "no progress seen", not kill the machine
            log_structured(_logger, logging.WARNING,
                           "supervisor.progress_read_failed",
                           run_id=self.run_id, attempt=self.attempt,
                           error=f"{type(e).__name__}: {e}")
            return self._last_progress

    def _finish(self, code: int, why: str) -> int:
        report = None
        if self.metrics_dir is not None:
            try:
                from apex_tpu_torch.observability.goodput import goodput_report

                report = goodput_report(self.metrics_dir)
            except Exception as e:  # noqa: BLE001 — the summary is
                # best-effort; the exit code is the contract
                log_structured(_logger, logging.WARNING,
                               "supervisor.report_failed",
                               run_id=self.run_id,
                               error=f"{type(e).__name__}: {e}")
        log_structured(_logger, logging.INFO, "supervisor.done",
                       run_id=self.run_id, attempt=self.attempt,
                       exit_code=code, why=why, restarts=self.restarts,
                       quarantined=self.quarantined,
                       sessions=(report or {}).get("sessions"))
        if report and report.get("fractions"):
            # ONE process owns the job summary: the per-session lines
            # the children printed cover their own lifetimes; this is
            # the whole job, restarts and backoff included
            print("supervisor goodput: " + " ".join(
                f"{k}={v:.1%}"
                for k, v in sorted(report["fractions"].items())),
                flush=True)
        return int(code)


def run_supervised_cli(args, argv=None, *, module: str, **overrides) -> int:
    """The drivers' ``--supervise`` entry: rebuild the child command
    from this process's own argv minus the supervisor flags, as
    ``python -m <module>`` (the port's drivers are modules),
    wire the fault script, and run.  ``args`` is the parsed namespace
    (needs ``checkpoint``/``metrics_dir``/``run_id`` plus the
    supervisor flags); ``overrides`` pass straight to
    :class:`Supervisor` (the serving driver has no checkpoint dir)."""
    argv = list(sys.argv if argv is None else argv)
    cmd = [sys.executable, "-m", module, *strip_supervisor_argv(argv[1:])]
    fault_script = None
    if getattr(args, "fault_script", None):
        from apex_tpu_torch.resilience.chaos import SupervisorFaultScript

        fault_script = SupervisorFaultScript.from_file(args.fault_script)
    kw = dict(
        checkpoint_dir=getattr(args, "checkpoint", None),
        metrics_dir=getattr(args, "metrics_dir", None),
        flight_dir=_flightrec.default_dir(
            metrics_dir=getattr(args, "metrics_dir", None),
            trace_dir=getattr(args, "trace_dir", None)),
        run_id=getattr(args, "run_id", "run"),
        max_restarts=args.max_restarts,
        crash_loop_threshold=args.crash_loop_threshold,
        backoff_base=args.backoff_base, backoff_cap=args.backoff_cap,
        seed=args.backoff_seed, grace_sec=args.supervise_grace,
        fault_script=fault_script, install_signals=True,
    )
    kw.update(overrides)
    return Supervisor(cmd, **kw).run()


def add_supervisor_args(parser) -> None:
    """The shared ``--supervise`` flag family both drivers expose (one
    definition, so the flags and :data:`SUPERVISOR_FLAGS` cannot drift
    per driver)."""
    parser.add_argument(
        "--supervise", action="store_true",
        help="run under the self-healing supervisor: this process "
             "relaunches the SAME command (minus the supervisor flags) "
             "as a child, restarts it with full-jitter backoff on the "
             "documented exit codes (75 wedged, 137 killed, any other "
             "nonzero crash), quarantines a corrupt newest checkpoint "
             "so a bad save costs one save interval instead of a crash "
             "loop, trips a circuit breaker (exit 76) after "
             "--crash-loop-threshold consecutive no-progress failures, "
             "and prints the whole job's goodput report at final exit")
    parser.add_argument("--max-restarts", type=int, default=16,
                        help="total relaunch budget under --supervise")
    parser.add_argument("--crash-loop-threshold", type=int, default=3,
                        help="consecutive no-progress failures that trip "
                             "the circuit breaker (exit 76)")
    parser.add_argument("--backoff-base", type=float, default=2.0,
                        help="restart_backoff base (attempt k waits "
                             "uniform(0, min(cap, base*2^k)) seconds)")
    parser.add_argument("--backoff-cap", type=float, default=300.0)
    parser.add_argument("--backoff-seed", type=int, default=0,
                        help="jitter seed (real pods seed per host so "
                             "restarts don't land in lockstep)")
    parser.add_argument("--supervise-grace", type=float, default=30.0,
                        help="SIGTERM-forward grace before SIGKILL")
    parser.add_argument("--fault-script", default=None,
                        help="chaos: JSON mapping attempt index -> "
                             "{args: [...], corrupt_newest_checkpoint: "
                             "bool} (resilience.chaos."
                             "SupervisorFaultScript) — the one-command "
                             "fault gauntlet")
