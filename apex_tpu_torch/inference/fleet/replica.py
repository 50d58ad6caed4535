"""One serving replica: a scheduler behind a health state machine
(counterpart of :mod:`apex_tpu.inference.fleet.replica`).

State machine (``REPLICA_STATES``, in lifecycle order)::

    starting -> warm -> serving -> draining -> dead -> (restart) -> warm

- **starting**: the build function is running (pools allocated, steps
  built).  Not routable.
- **warm**: built, no step taken yet — the first step pays the graph
  captures (on the card).  Not routable: admitting traffic here would
  eat that wait inside a caller's TTFT.
- **serving**: at least one step completed; the router admits.
- **draining**: planned restart — :meth:`LocalReplica.begin_drain`
  stops admission (the scheduler refuses ``submit``), hands back the
  queued requests for re-routing, and residents finish through the
  ordinary step/evict path; :meth:`LocalReplica.drained` flags when
  the process can be recycled with nothing dropped.
- **dead**: killed (exit-137 shape), wedged (exit-75 shape), or
  drained-and-retired.  :meth:`LocalReplica.restart` rebuilds — the
  supervised-child analogue — and the step counter does NOT reset, so
  a chaos plan keyed on replica steps fires once, not once per life.

:class:`LocalReplica` is the in-process incarnation (one scheduler per
replica object, same process) that the fleet tests and chip_smoke.py drive
— the same frontend logic applies unchanged when each replica is a
supervised ``serve_gpt --replica-id`` child, because every
interaction goes through the scheduler's public seams (``submit`` /
``step`` / ``drain_manifest`` / ``completed``) plus the two fault
signals a process boundary also delivers (died-hard, wedged-with-
manifest).  Chaos faults are checked at the top of :meth:`step`, where
a real kill/wedge would land (mid-step-dispatch), and are re-raised as
:class:`ReplicaKilled` / :class:`ReplicaWedged` for the frontend —
which plays the supervisor here, the one place deliberately allowed to
absorb a replica's ``SystemExit``.
"""

import dataclasses
import logging
import time
from typing import Callable, List, Optional

from apex_tpu_torch.inference.scheduler import (
    ContinuousBatchingScheduler, ManifestEntry, Request,
)
from apex_tpu_torch.observability import metrics as _metrics
from apex_tpu_torch.resilience.chaos import ChaosReplicaKilled, active_monkey
from apex_tpu_torch.resilience.elastic import EXIT_KILLED, EXIT_WEDGED
from apex_tpu_torch.resilience.uniformity import uniform_digest
from apex_tpu_torch.utils.logging import get_logger, log_structured

__all__ = ["LocalReplica", "REPLICA_STATES", "ReplicaKilled",
           "ReplicaWedged"]

_logger = get_logger("apex_tpu_torch.inference")

#: lifecycle order; the gauge ``apex_fleet_replica_state{replica=}``
#: reports the index into this tuple
REPLICA_STATES = ("starting", "warm", "serving", "draining", "dead")


class ReplicaKilled(RuntimeError):
    """A replica died HARD mid-step (SIGKILL shape, exit 137): no
    drain, no manifest — the frontend's journal is the only replay
    source."""

    def __init__(self, replica_id: str, step: int):
        self.replica_id = str(replica_id)
        self.step = int(step)
        self.exit_code = EXIT_KILLED
        super().__init__(
            f"replica {replica_id!r} killed at replica step {step} "
            f"(exit {EXIT_KILLED})")


class ReplicaWedged(RuntimeError):
    """A replica's decode step wedged (watchdog shape, exit 75): the
    ``serve.step_wedged`` record fired and ``manifest`` carries the
    scheduler's structured requeue manifest — the richer replay source
    (it includes tokens the frontend never got to poll)."""

    def __init__(self, replica_id: str, step: int,
                 manifest: List[ManifestEntry]):
        self.replica_id = str(replica_id)
        self.step = int(step)
        self.manifest = list(manifest)
        self.exit_code = EXIT_WEDGED
        super().__init__(
            f"replica {replica_id!r} wedged at replica step {step} "
            f"(exit {EXIT_WEDGED}; manifest carries "
            f"{len(manifest)} unfinished request(s))")


class LocalReplica:
    """One in-process serving replica: ``build_fn()`` constructs its
    scheduler (so each replica owns its pools/allocator/trie), the
    state machine above gates routability, and every step beats
    ``last_beat`` — the heartbeat a health check reads."""

    def __init__(self, replica_id: str,
                 build_fn: Callable[[], ContinuousBatchingScheduler],
                 *, time_fn=time.monotonic):
        self.replica_id = str(replica_id)
        self._build = build_fn
        self._time = time_fn
        self.sched: Optional[ContinuousBatchingScheduler] = None
        self.state = "dead"            # not started yet
        self.config_digest: Optional[str] = None
        self.last_beat: Optional[float] = None
        self.restarts = 0
        #: monotonic across restarts (supervisor-attempt semantics) —
        #: a chaos plan keyed on replica steps cannot re-fire after
        #: the restart it caused
        self.steps_total = 0

    # ------------------------------------------------------- lifecycle
    def _set_state(self, state: str) -> None:
        assert state in REPLICA_STATES
        self.state = state
        _metrics.set_gauge(
            "apex_fleet_replica_state",
            float(REPLICA_STATES.index(state)),
            help="replica lifecycle state (index into "
                 "starting/warm/serving/draining/dead)",
            replica=self.replica_id)
        log_structured(_logger, logging.INFO, "fleet.replica_state",
                       replica=self.replica_id, state=state,
                       step=self.steps_total)

    def start(self) -> "LocalReplica":
        """Build the scheduler: ``starting`` while the build runs,
        ``warm`` after — the first :meth:`step` promotes to
        ``serving``."""
        self._set_state("starting")
        self.sched = self._build()
        self.config_digest = uniform_digest({
            "decode": dataclasses.asdict(self.sched.dcfg),
            "model": dataclasses.asdict(self.sched.config),
        })
        self._set_state("warm")
        return self

    def restart(self) -> "LocalReplica":
        """Rebuild after a death — the supervised-relaunch analogue.
        ``steps_total`` carries over (see the class docstring)."""
        if self.state != "dead":
            raise RuntimeError(
                f"replica {self.replica_id!r} is {self.state}, not dead")
        self.restarts += 1
        _metrics.inc("apex_fleet_replica_restarts_total",
                     help="replica rebuilds after a death",
                     replica=self.replica_id)
        return self.start()

    def mark_dead(self, cause: str) -> None:
        """Record the death and DISCARD the scheduler — a killed
        process keeps no state, and keeping the object would tempt the
        frontend into reading a corpse instead of its journal."""
        self.sched = None
        _metrics.inc("apex_fleet_replica_deaths_total",
                     help="replica deaths, by cause",
                     replica=self.replica_id, cause=cause)
        log_structured(_logger, logging.WARNING, "fleet.replica_dead",
                       replica=self.replica_id, cause=cause,
                       step=self.steps_total)
        self._set_state("dead")

    # --------------------------------------------------------- serving
    def submit(self, request: Request) -> None:
        if self.state not in ("serving", "warm"):
            raise RuntimeError(
                f"replica {self.replica_id!r} is {self.state} — the "
                f"router must not admit here")
        self.sched.submit(request)

    def step(self) -> bool:
        """One scheduler step, with the chaos fault checks at the top
        — where a real SIGKILL or a wedged kernel would land, i.e. before
        any of this step's work becomes visible."""
        if self.state in ("dead", "starting") or self.sched is None:
            return False
        step = self.steps_total
        monkey = active_monkey()
        if monkey is not None:
            if monkey.maybe_wedge_replica(self.replica_id, step):
                # the exit-75 path: the watchdog hook fires the
                # serve.step_wedged record (manifest included), then
                # the process dies — modeled by discarding the
                # scheduler after capturing its manifest
                manifest = self.sched.drain_manifest()
                self.sched._on_wedge({"elapsed_s": None})
                self.steps_total += 1
                self.mark_dead("wedge")
                raise ReplicaWedged(self.replica_id, step, manifest)
            try:
                monkey.maybe_kill_replica(self.replica_id, step)
            except ChaosReplicaKilled as exc:
                # deliberate SystemExit absorption: this layer IS the
                # supervisor for in-process replicas (the documented
                # chaos-consumer role) — exit-137 means no manifest
                self.steps_total += 1
                self.mark_dead("kill")
                raise ReplicaKilled(self.replica_id, step) from exc
        worked = self.sched.step()
        self.steps_total += 1
        self.last_beat = self._time()
        if self.state == "warm":
            # first completed step: the captures are paid — open
            # for traffic
            self._set_state("serving")
        return worked

    def kill(self) -> None:
        """Direct in-process SIGKILL analogue (tests, drivers): die hard
        right now, no manifest."""
        self.mark_dead("kill")

    # -------------------------------------------------------- draining
    def begin_drain(self) -> List[ManifestEntry]:
        """Planned restart: stop admitting, return the queued requests
        (as a manifest, for the frontend to re-route), let residents
        finish.  The replica keeps stepping while ``draining``."""
        if self.state != "serving":
            raise RuntimeError(
                f"replica {self.replica_id!r} is {self.state}; only a "
                f"serving replica drains")
        manifest = self.sched.begin_drain()
        self._set_state("draining")
        return manifest

    def drained(self) -> bool:
        return (self.state == "draining" and self.sched is not None
                and self.sched.drained())

    def retire(self) -> None:
        """Complete a drain: the residents are gone, recycle the
        process (``dead``, restartable) with nothing dropped."""
        if not self.drained():
            raise RuntimeError(
                f"replica {self.replica_id!r} still holds residents "
                f"(or is not draining) — poll drained() first")
        self.mark_dead("drain")

    # ------------------------------------------------- router inputs
    def queue_depth(self, lane: Optional[str] = None) -> int:
        if self.sched is None:
            return 0
        if lane == "interactive":
            return len(self.sched.queue)
        if lane == "best_effort":
            return len(self.sched.be_queue)
        return len(self.sched.queue) + len(self.sched.be_queue)

    def load(self) -> dict:
        """The router's ranking inputs, one snapshot."""
        s = self.sched
        return {
            "active": 0 if s is None else s.num_active,
            "queued_interactive": 0 if s is None else len(s.queue),
            "queued_best_effort": 0 if s is None else len(s.be_queue),
            "alerts": 0 if s is None or s._anomaly is None
            else sum(s._anomaly.counts().values()),
        }

    def prefix_affinity(self, prompt: List[int]) -> int:
        """Tokens of ``prompt`` this replica's prefix trie already
        holds — the router's affinity signal.  ``match`` is read-only
        (no refcounts taken), so probing N replicas is free."""
        if self.sched is None or self.sched.prefix is None:
            return 0
        return self.sched.prefix.match(list(prompt)).shared_len
