"""The fleet frontend: replica failure and overload, made invisible
(counterpart of :mod:`apex_tpu.inference.fleet.frontend`).

One :class:`FleetFrontend` owns N replicas (:mod:`.replica`), a router
(:mod:`.router`), and a request journal (:mod:`.journal`).  Callers
``submit`` requests and read ``completed``; everything between — which
replica serves, a replica dying mid-stream, a straggler getting
hedged, a planned drain — is this module's problem:

- **submit** routes through the health gate + brownout ladder, assigns
  the trace id (ONE id for the request's whole life, every leg on
  every replica stamps it), journals, and hands the request to the
  chosen replica.
- **step** advances every live replica and, per replica: polls its
  ``drain_manifest()`` to splice newly-generated tokens into the
  journal (the caller-visible stream), drains its ``completed`` list,
  and converts its death into replays.  A wedge
  (:class:`~.replica.ReplicaWedged`, exit-75 shape) replays from the
  ``serve.step_wedged`` MANIFEST — richer than the journal, it carries
  tokens the frontend never got to poll; a kill
  (:class:`~.replica.ReplicaKilled`, exit-137 shape) replays from the
  JOURNAL — the manifest died with the process.  Either way the
  continuation request is ``prompt + emitted`` with the remaining
  budget, routed to a healthy replica with admission bypassed, and the
  journal's splice invariant guarantees the caller's stream is gapless
  and duplicate-free — with greedy decoding, bitwise the unkilled
  stream.
- **hedging**: an interactive request with NO token past
  ``hedge_after_s`` gets its ONE hedged copy on another serving
  replica; the first leg to produce a token wins, the loser is
  cancelled if still queued or its output suppressed if resident
  (greedy decode makes either copy's tokens identical, so the race is
  benign by construction).
- **uniformity**: the fleet decision surface (router config, replica
  roster, per-replica scheduler-config digests) registers under
  ``serve.fleet_config`` (:mod:`apex_tpu_torch.resilience.uniformity`) —
  ``check_uniform()``
  catches a fleet whose processes disagree about the fleet.
"""

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from apex_tpu_torch.inference.fleet.journal import (
    FleetCompletion, JournalEntry, RequestJournal,
)
from apex_tpu_torch.inference.fleet.replica import (
    LocalReplica, ReplicaKilled, ReplicaWedged,
)
from apex_tpu_torch.inference.fleet.router import Overloaded, Router, RouterConfig
from apex_tpu_torch.inference.scheduler import ManifestEntry, Request
from apex_tpu_torch.observability import metrics as _metrics
from apex_tpu_torch.observability import tracing as _tracing
from apex_tpu_torch.resilience.uniformity import register_uniform
from apex_tpu_torch.utils.logging import get_logger, log_structured

__all__ = ["FleetFrontend"]

_logger = get_logger("apex_tpu_torch.inference")


class FleetFrontend:
    """Multi-replica serving frontend (see the module docstring).

    ``auto_restart`` (default True) relaunches dead replicas and
    retires-then-relaunches drained ones inside :meth:`step` — the
    in-process supervisor role; pass False to drive restarts by hand
    (the drain-then-restart test does)."""

    def __init__(self, replicas: Sequence[LocalReplica], *,
                 router: Optional[Router] = None,
                 config: Optional[RouterConfig] = None,
                 time_fn=time.monotonic, auto_restart: bool = True):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self.replicas: Dict[str, LocalReplica] = {
            r.replica_id: r for r in replicas}
        self.router = router or Router(config)
        self.journal = RequestJournal()
        self.completed: List[FleetCompletion] = []
        self._time = time_fn
        self.auto_restart = bool(auto_restart)
        #: (replica_id, rid) legs whose output must be dropped — the
        #: resident hedge losers a scheduler cannot cancel mid-flight
        self._suppressed: Set[Tuple[str, int]] = set()
        self.stats: Dict[str, int] = {
            "accepted": 0, "rejected": 0, "replays": 0, "hedges": 0,
            "restarts": 0, "replica_deaths": 0,
        }
        register_uniform("serve.fleet_config", self._uniform_view)

    def _uniform_view(self) -> dict:
        """The fleet decision surface for ``check_uniform``: in a
        multi-process fleet every frontend must agree on the roster,
        the routing knobs, and each replica's scheduler config — a
        divergent replica serves from a DIFFERENT captured program and
        replay-splicing onto it breaks the bitwise contract."""
        return {
            "router": dataclasses.asdict(self.router.config),
            "replicas": sorted(self.replicas),
            "config_digests": {
                rid: r.config_digest
                for rid, r in sorted(self.replicas.items())},
        }

    # ---------------------------------------------------------- launch
    def start(self) -> "FleetFrontend":
        """Start every replica and take each one's first (empty) step
        so the fleet opens at ``serving`` — without this, the first
        caller would be rejected by the health gate for no reason a
        caller can act on."""
        for r in self.replicas.values():
            if r.state == "dead" and r.sched is None and r.restarts == 0:
                r.start()
            r.step()
        return self

    # ---------------------------------------------------------- submit
    def submit(self, request: Request, *,
               replica_id: Optional[str] = None) -> str:
        """Accept (journal + place) one request; returns the chosen
        replica id.  Raises :class:`~.router.Overloaded` when the
        brownout ladder rejects — typed backpressure the caller can
        honor.  ``replica_id`` pins placement (tests, affinity
        experiments) past the router but not past the journal."""
        if replica_id is not None:
            target = self.replicas[replica_id]
        else:
            try:
                target = self.router.pick(
                    request, list(self.replicas.values()))
            except Overloaded as exc:
                self.stats["rejected"] += 1
                _metrics.inc("apex_fleet_rejections_total",
                             help="admissions rejected, by brownout "
                                  "reason and lane",
                             reason=exc.reason, lane=exc.lane)
                log_structured(_logger, logging.WARNING,
                               "fleet.rejected", rid=request.rid,
                               lane=request.lane, reason=exc.reason,
                               retry_after_s=exc.retry_after_s)
                raise
        if request.trace_id is None:
            # assigned HERE, not in the scheduler: the id must span
            # every leg on every replica
            request.trace_id = _tracing.new_trace_id()
        entry = self.journal.add(request, target.replica_id,
                                 self._time())
        self.stats["accepted"] += 1
        _metrics.inc("apex_fleet_accepted_total",
                     help="requests accepted into the fleet",
                     lane=request.lane)
        target.submit(dataclasses.replace(
            request, prompt=list(request.prompt)))
        return entry.owner

    # ------------------------------------------------------------ step
    def step(self) -> bool:
        """Advance the fleet by one scheduler step per live replica,
        absorbing deaths into replays (see the module docstring).
        Returns True when any replica did work."""
        worked = False
        for r in list(self.replicas.values()):
            if r.state == "dead":
                if self.auto_restart:
                    self._restart(r)
                continue
            try:
                worked = r.step() or worked
            except ReplicaWedged as exc:
                self._on_replica_dead(r, exc.manifest, "wedge")
                continue
            except ReplicaKilled:
                self._on_replica_dead(r, None, "kill")
                continue
            self._poll(r)
            self._drain_completions(r)
            if r.drained():
                r.retire()
                if self.auto_restart:
                    self._restart(r)
        self._maybe_hedge()
        return worked

    def _restart(self, r: LocalReplica) -> None:
        r.restart()
        r.step()  # pay the warm->serving promotion step
        self.stats["restarts"] += 1

    def run_until_drained(self, max_steps: int = 10_000
                          ) -> List[FleetCompletion]:
        """Drive :meth:`step` until every journaled request finished
        (the test and driver convenience loop)."""
        for _ in range(max_steps):
            if not self.journal.unfinished():
                return self.completed
            self.step()
        pending = [e.request.rid for e in self.journal.unfinished()]
        raise RuntimeError(
            f"fleet not drained after {max_steps} steps "
            f"(pending rids: {pending})")

    # ------------------------------------------------------- progress
    def _leg_of(self, r: LocalReplica,
                entry: JournalEntry) -> bool:
        """Does ``r`` currently run a leg of ``entry``?"""
        return entry.owner == r.replica_id \
            or entry.hedge_owner == r.replica_id

    def _poll(self, r: LocalReplica) -> None:
        """Splice the replica's in-progress tokens into the journal —
        the 'tokens emitted so far' the replay contract needs,
        refreshed every step so a kill loses at most one step's worth
        (regenerated bitwise by the continuation leg)."""
        now = self._time()
        for m in r.sched.drain_manifest():
            entry = self.journal.get(m.rid)
            if entry is None or entry.done \
                    or (r.replica_id, m.rid) in self._suppressed \
                    or not self._leg_of(r, entry):
                continue
            new = entry.splice(m.emitted, now=now)
            if new:
                self._leg_won(entry, r.replica_id)
                if entry.finished():
                    self._finalize(entry)

    def _drain_completions(self, r: LocalReplica) -> None:
        comps, r.sched.completed = r.sched.completed, []
        for c in comps:
            if (r.replica_id, c.rid) in self._suppressed:
                self._suppressed.discard((r.replica_id, c.rid))
                continue
            entry = self.journal.get(c.rid)
            if entry is None or entry.done or not self._leg_of(r, entry):
                continue
            entry.splice(c.tokens, leg_times=c.token_times)
            self._leg_won(entry, r.replica_id)
            self._finalize(entry)

    def _leg_won(self, entry: JournalEntry, replica_id: str) -> None:
        """First token decides a pending hedge race: ``replica_id``
        becomes the owner, the loser's copy is cancelled if still
        queued or suppressed if resident."""
        if entry.hedge_owner is None:
            return
        loser_id = (entry.hedge_owner if replica_id == entry.owner
                    else entry.owner)
        entry.owner = replica_id
        entry.hedge_owner = None
        loser = self.replicas.get(loser_id)
        if loser is not None and loser.sched is not None:
            if loser.sched.cancel(entry.request.rid) is None:
                self._suppressed.add((loser_id, entry.request.rid))
        log_structured(_logger, logging.INFO, "fleet.hedge_resolved",
                       rid=entry.request.rid, winner=replica_id,
                       loser=loser_id)

    def _finalize(self, entry: JournalEntry) -> None:
        entry.done = True
        finish = (entry.token_times[-1] if entry.token_times
                  else self._time())
        self.completed.append(FleetCompletion(
            rid=entry.request.rid, prompt=list(entry.request.prompt),
            tokens=list(entry.emitted),
            submit_time=entry.submit_time, finish_time=finish,
            token_times=list(entry.token_times),
            lane=entry.request.lane, replica_id=entry.owner,
            replays=entry.replays, hedged=entry.hedged,
            trace_id=entry.request.trace_id))
        _metrics.inc("apex_fleet_completions_total",
                     help="requests completed by the fleet",
                     lane=entry.request.lane)

    # --------------------------------------------------------- failure
    def _on_replica_dead(self, r: LocalReplica,
                         manifest: Optional[List[ManifestEntry]],
                         cause: str) -> None:
        """Turn a replica death into replays: splice what the manifest
        preserved (wedge) or what the journal last polled (kill), then
        resubmit every unfinished tail to a healthy replica."""
        self.stats["replica_deaths"] += 1
        self._suppressed = {(rep, rid) for rep, rid in self._suppressed
                            if rep != r.replica_id}
        by_rid = {m.rid: m for m in (manifest or [])}
        for entry in self.journal.owned_by(r.replica_id):
            if entry.hedge_owner == r.replica_id:
                # the hedge copy died with the replica; the primary
                # leg is untouched — just re-arm nothing (one hedge
                # per request is the bound)
                entry.hedge_owner = None
                continue
            m = by_rid.get(entry.request.rid)
            if m is not None:
                entry.splice(m.emitted, now=self._time())
            if entry.finished():
                # died in the same step the stream completed — the
                # journal/manifest already holds every owed token
                self._finalize(entry)
                continue
            hedge = self.replicas.get(entry.hedge_owner or "")
            if hedge is not None and hedge.state != "dead":
                # a live hedge leg IS the replay — promote it
                entry.owner, entry.hedge_owner = entry.hedge_owner, None
                continue
            entry.hedge_owner = None
            self._replay(entry, from_replica=r.replica_id, cause=cause)
        if self.auto_restart:
            self._restart(r)

    def _replay(self, entry: JournalEntry, *, from_replica: str,
                cause: str) -> None:
        """Resubmit the unfinished tail: continuation prompt is
        ``original prompt + emitted`` (prefix sharing makes the
        re-prefill cheap on a replica that served the twin), budget is
        what remains, trace id is THE SAME — the spans join."""
        req = entry.request
        t0 = self._time()
        cont = Request(
            rid=req.rid, prompt=list(req.prompt) + list(entry.emitted),
            max_new_tokens=entry.remaining(), eos_id=req.eos_id,
            lane=req.lane, trace_id=req.trace_id)
        target = self.router.pick(cont, list(self.replicas.values()),
                                  bypass_admission=True,
                                  exclude=frozenset({from_replica}))
        entry.owner = target.replica_id
        entry.leg_prefix = list(entry.emitted)
        entry.replays += 1
        self.stats["replays"] += 1
        target.submit(cont)
        # detection -> resubmission gap, measured from the last token
        # the caller saw (the stream's visible stall)
        stalled_since = (entry.token_times[-1] if entry.token_times
                         else entry.submit_time)
        _metrics.inc("apex_fleet_replays_total",
                     help="unfinished requests resubmitted after a "
                          "replica death, by cause", cause=cause)
        _metrics.observe("apex_fleet_replay_latency_seconds",
                         self._time() - stalled_since,
                         help="last streamed token -> continuation "
                              "resubmitted",
                         exemplar={"trace_id": req.trace_id,
                                   "rid": req.rid})
        tracer = _tracing.get_tracer()
        if tracer is not None:
            tracer.emit("fleet.replay", time.time(),
                        self._time() - t0, rid=req.rid,
                        trace_id=req.trace_id, cause=cause,
                        from_replica=from_replica,
                        to_replica=target.replica_id,
                        spliced_tokens=len(entry.emitted),
                        remaining=entry.remaining())
        log_structured(_logger, logging.WARNING, "fleet.replayed",
                       rid=req.rid, cause=cause,
                       from_replica=from_replica,
                       to_replica=target.replica_id,
                       spliced_tokens=len(entry.emitted),
                       remaining=entry.remaining())

    # --------------------------------------------------------- hedging
    def _maybe_hedge(self) -> None:
        """One bounded hedged retry for interactive stragglers: a
        request with NO token ``hedge_after_s`` past submit gets a
        copy on another serving replica.  Never more than one hedge
        per request (``hedged`` latches), never for requests already
        streaming (splicing two divergent mid-streams is not a thing
        the journal should ever have to referee — pre-first-token the
        copies are interchangeable)."""
        cfg = self.router.config
        if cfg.hedge_after_s <= 0:
            return
        now = self._time()
        for entry in self.journal.unfinished():
            if (entry.hedged or entry.emitted
                    or entry.request.lane != "interactive"
                    or now - entry.submit_time < cfg.hedge_after_s):
                continue
            req = entry.request
            copy = Request(rid=req.rid, prompt=list(req.prompt),
                           max_new_tokens=req.max_new_tokens,
                           eos_id=req.eos_id, lane=req.lane,
                           trace_id=req.trace_id)
            try:
                target = self.router.pick(
                    copy, list(self.replicas.values()),
                    bypass_admission=True,
                    exclude=frozenset({entry.owner}))
            except Overloaded:
                continue  # nowhere to hedge — keep waiting
            entry.hedged = True
            entry.hedge_owner = target.replica_id
            self.stats["hedges"] += 1
            target.submit(copy)
            _metrics.inc("apex_fleet_hedges_total",
                         help="interactive stragglers hedged to a "
                              "second replica")
            log_structured(_logger, logging.INFO, "fleet.hedged",
                           rid=req.rid, primary=entry.owner,
                           hedge=target.replica_id,
                           waited_s=round(now - entry.submit_time, 6))

    # -------------------------------------------------------- draining
    def drain_replica(self, replica_id: str) -> int:
        """Planned restart, zero drops: stop the replica admitting,
        re-route its QUEUED requests (admission bypassed — they were
        already accepted), and leave residents finishing in place.
        Returns the number of requests re-routed."""
        r = self.replicas[replica_id]
        manifest = r.begin_drain()
        moved = 0
        for m in manifest:
            entry = self.journal.get(m.rid)
            if entry is None or entry.done:
                continue
            if entry.hedge_owner == replica_id:
                entry.hedge_owner = None  # drop the queued hedge copy
                continue
            entry.splice(m.emitted, now=self._time())
            if entry.finished():
                self._finalize(entry)
                continue
            self._replay(entry, from_replica=replica_id, cause="drain")
            moved += 1
        log_structured(_logger, logging.INFO, "fleet.drain_started",
                       replica=replica_id, rerouted=moved,
                       residents=0 if r.sched is None
                       else r.sched.num_active)
        return moved
