"""Health-gated routing with prefix affinity and graceful brownout
(counterpart of :mod:`apex_tpu.inference.fleet.router`).

Placement, in decision order:

1. **Health gate** — only ``serving`` replicas are candidates (warm
   replicas are still paying captures, draining ones refuse submits,
   dead ones are corpses).  No candidate at all is an
   :class:`Overloaded` with ``reason="no_serving_replica"``.
2. **Brownout ladder** — overload degrades EXPLICITLY instead of
   letting queues collapse into an SLO breach for everyone:
   fleet-wide queued depth ``>= reject_queue_depth`` rejects every
   admission (``reason="overloaded"``); depth
   ``>= be_shed_queue_depth`` sheds only best-effort admissions
   (``reason="brownout_shed"``) so the interactive lane keeps its
   TTFT.  Both carry ``retry_after_s`` — a typed backpressure signal,
   not a timeout.  Replays and hedges bypass the ladder
   (``bypass_admission=True``): the fleet already owes those tokens.
3. **Prefix affinity** — the prompt is matched against each
   candidate's prefix trie (read-only); if the best match reaches
   ``affinity_min_tokens``, the best-matching replicas are preferred
   (shared pages turn the re-prefill into a near-no-op — this is also
   what makes replay-after-death cheap on a replica that served the
   original prompt's twin).
4. **Lane-aware least-loaded** — among the remaining candidates, pick
   the lowest ``(own-lane queue depth, total queue depth, residents,
   anomaly alerts, replica id)``; the id tail makes ties
   deterministic.
"""

import dataclasses
from typing import FrozenSet, List, Optional, Sequence

from apex_tpu_torch.inference.fleet.replica import LocalReplica
from apex_tpu_torch.inference.scheduler import Request

__all__ = ["Overloaded", "Router", "RouterConfig"]


class Overloaded(RuntimeError):
    """Typed admission rejection: the caller should retry after
    ``retry_after_s`` (or downgrade its ask).  ``reason`` is one of
    ``brownout_shed`` (best-effort shed while interactive still
    admits), ``overloaded`` (every lane rejected), or
    ``no_serving_replica`` (the fleet has no healthy capacity)."""

    def __init__(self, reason: str, lane: str, retry_after_s: float):
        self.reason = str(reason)
        self.lane = str(lane)
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"admission rejected ({reason}, lane={lane}): retry after "
            f"{retry_after_s:g}s")


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """The routing and brownout knobs (the JAX package's defaults).  ``hedge_after_s`` is the interactive-lane straggler
    deadline: a request with NO token past it gets its one hedged
    retry on another replica."""

    affinity_min_tokens: int = 16
    be_shed_queue_depth: int = 8
    reject_queue_depth: int = 16
    retry_after_s: float = 0.5
    hedge_after_s: float = 5.0


class Router:
    """Stateless placement over a replica list — all state it reads
    lives in the replicas (queues, tries, anomaly counts), so the
    frontend can call it per admission without bookkeeping."""

    def __init__(self, config: Optional[RouterConfig] = None):
        self.config = config or RouterConfig()

    @staticmethod
    def _serving(replicas: Sequence[LocalReplica],
                 exclude: FrozenSet[str]) -> List[LocalReplica]:
        return [r for r in replicas
                if r.state == "serving" and r.replica_id not in exclude]

    @staticmethod
    def fleet_queue_depth(replicas: Sequence[LocalReplica]) -> int:
        """Total queued (not yet admitted) requests across the live
        fleet — the brownout ladder's pressure signal."""
        return sum(r.queue_depth() for r in replicas
                   if r.state in ("serving", "warm", "draining"))

    def pick(self, request: Request,
             replicas: Sequence[LocalReplica], *,
             bypass_admission: bool = False,
             exclude: FrozenSet[str] = frozenset()) -> LocalReplica:
        """Choose the replica for ``request`` (raises
        :class:`Overloaded`; never returns a non-serving replica).
        ``bypass_admission`` skips the brownout ladder — replays and
        hedges are already-accepted work.  ``exclude`` bars replicas
        (a hedge must not land on the straggling primary)."""
        cfg = self.config
        serving = self._serving(replicas, exclude)
        if not serving:
            raise Overloaded("no_serving_replica", request.lane,
                             cfg.retry_after_s)
        if not bypass_admission:
            depth = self.fleet_queue_depth(replicas)
            if depth >= cfg.reject_queue_depth:
                raise Overloaded("overloaded", request.lane,
                                 cfg.retry_after_s)
            if depth >= cfg.be_shed_queue_depth \
                    and request.lane == "best_effort":
                raise Overloaded("brownout_shed", request.lane,
                                 cfg.retry_after_s)
        affinities = {r.replica_id: r.prefix_affinity(request.prompt)
                      for r in serving}
        best = max(affinities.values())
        cands = (serving if best < cfg.affinity_min_tokens
                 else [r for r in serving
                       if affinities[r.replica_id] == best])
        return min(cands, key=lambda r: self._load_key(r, request.lane))

    @staticmethod
    def _load_key(r: LocalReplica, lane: str):
        load = r.load()
        return (r.queue_depth(lane), r.queue_depth(), load["active"],
                load["alerts"], r.replica_id)
