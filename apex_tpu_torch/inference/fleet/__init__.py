"""Fault-tolerant multi-replica serving (counterpart of
:mod:`apex_tpu.inference.fleet`): the layer that consumes the replicas'
failure signals — the watchdog's ``serve.step_wedged`` manifest, a hard
kill — so a replica's death is absorbed instead of dropping its streams.

- :mod:`~apex_tpu_torch.inference.fleet.replica` — the replica
  lifecycle (starting → warm → serving → draining → dead) with
  heartbeats and a state gauge; :class:`LocalReplica` is the in-process
  replica (replicas in one process share its card).
- :mod:`~apex_tpu_torch.inference.fleet.journal` — the request journal
  and the splice invariant that keeps multi-leg streams gapless and
  free of duplicates (at T = 0, bitwise the unkilled stream).
- :mod:`~apex_tpu_torch.inference.fleet.router` — health-gated
  placement: prefix affinity first, lane-aware least-loaded after, and
  the brownout ladder (shed best-effort, then typed :class:`Overloaded`
  rejections with a retry-after).
- :mod:`~apex_tpu_torch.inference.fleet.frontend` — the
  :class:`FleetFrontend`: replay on failure (a wedge from its manifest,
  a kill from the journal), one bounded hedged retry for interactive
  stragglers, drain then restart with nothing dropped, and the
  ``serve.fleet_config`` uniformity registration.

Host code only, over the scheduler's public seams; every replica's
steps are its scheduler's captured steps.
"""

from apex_tpu_torch.inference.fleet.frontend import FleetFrontend
from apex_tpu_torch.inference.fleet.journal import (
    FleetCompletion, JournalEntry, RequestJournal,
)
from apex_tpu_torch.inference.fleet.replica import (
    LocalReplica, REPLICA_STATES, ReplicaKilled, ReplicaWedged,
)
from apex_tpu_torch.inference.fleet.router import Overloaded, Router, RouterConfig

__all__ = [
    "FleetCompletion", "FleetFrontend", "JournalEntry", "LocalReplica",
    "Overloaded", "REPLICA_STATES", "ReplicaKilled", "ReplicaWedged",
    "RequestJournal", "Router", "RouterConfig",
]
