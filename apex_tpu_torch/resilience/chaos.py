"""Deterministic fault injection for the resilience runtime (counterpart
of :mod:`apex_tpu.resilience.chaos`).

Each fault is injected from a static plan (no RNG, no clocks), at the
seam where the real fault would surface, so the tests can assert exact
recovery: skip this step, resume at exactly step k.

- **NaN grads** — :meth:`ChaosMonkey.grad_fault` gives a 0-d fp32 tensor,
  NaN on the planned steps and 1.0 otherwise.  The planned set is a
  static device tensor compared with the guard state's device step
  counter, so it runs inside a captured step with no host read; the
  train step multiplies it into the loss before the backward and the
  NaN reaches every gradient.
- **Preemption** — :meth:`ChaosMonkey.maybe_preempt` flips a
  :class:`~apex_tpu_torch.resilience.preemption.PreemptionHandler` as a
  real SIGTERM would.
- **Wedges** — :meth:`ChaosMonkey.maybe_wedge` sleeps at a named site;
  :meth:`ChaosMonkey.maybe_wedge_step` sleeps before a step's dispatch
  (:class:`~apex_tpu_torch.resilience.elastic.ElasticRunController`,
  the serving scheduler's step), which the step watchdog must catch.
- **Hard kills** — :meth:`ChaosMonkey.maybe_kill` (a host of N) and
  :meth:`ChaosMonkey.maybe_kill_replica` (a serving replica) raise
  ``SystemExit`` subclasses carrying exit 137.
- **Checkpoint I/O** — :func:`check_io`, inside ``io.checkpoint``'s
  retry loop, stalls or raises :class:`ChaosIOError`.
- **Supervisor faults** — :class:`SupervisorFaultScript` arms a restart
  attempt with extra child flags or a corrupted newest checkpoint.

Not ported: the kernel-launch failures, which the JAX package injects
for its fallback registry.  The port has no fallback (a kernel that
fails raises), so a plan that arms ``kernel_failures`` raises
:class:`ValueError` at construction.  Nor the wedge of one rank inside
the step before its collective (``wedge_collective_*``): the JAX step
runs a host callback there, and a captured CUDA graph runs none, so
such a plan raises too.

Activate with ``with monkey.active(): ...``: module-global, so the seams
deep inside the runtime see it without a handle through every layer.
"""

import contextlib
import dataclasses
import threading
import time
from typing import Dict, FrozenSet, Iterable, Mapping, Optional

import logging

from apex_tpu_torch.utils.logging import get_logger, log_structured

__all__ = [
    "ChaosHostKilled", "ChaosIOError", "ChaosKernelFailure", "ChaosPlan",
    "ChaosMonkey", "ChaosReplicaKilled", "SupervisorFault",
    "SupervisorFaultScript", "active_monkey", "check_io", "corrupt_newest_checkpoint",
]

_logger = get_logger("apex_tpu_torch.resilience")


#: why a plan cannot arm kernel-launch failures here
KERNEL_FAILURE_REASON = ("the port has no kernel fallback (resilience/fallback.py is never "
                         "ported): a kernel that fails to build or launch raises, so there "
                         "is no recovery path for an injected failure to exercise")
#: why a plan cannot wedge one rank inside the step
COLLECTIVE_WEDGE_REASON = ("the JAX step stalls one rank with a host callback before its "
                           "collective; a captured CUDA graph runs no host callback")


class ChaosKernelFailure(RuntimeError):
    """The JAX package's injected kernel-launch error.  Kept for its
    name: no plan of the port arms it (:data:`KERNEL_FAILURE_REASON`)."""


class ChaosHostKilled(SystemExit):
    """Injected stand-in for one host of N dying hard (spot reclaim
    past the grace window, kernel panic): no save, no drain, no exit
    handler — the pod-scale fault the elastic controller must resume
    from at a SMALLER world.  A ``SystemExit`` subclass so an unwitting
    ``except Exception`` recovery path cannot swallow the death; the
    carried code is :data:`~apex_tpu_torch.resilience.elastic.EXIT_KILLED`."""

    def __init__(self, rank: int, step: int, code: int):
        super().__init__(code)
        self.rank = int(rank)
        self.step = int(step)

    def __str__(self):
        return (f"injected hard kill of host rank {self.rank} at step "
                f"{self.step} (exit {self.code})")


class ChaosReplicaKilled(SystemExit):
    """Injected stand-in for one serving replica of N dying hard
    (SIGKILL, OOM, host loss): no drain, no manifest, no exit handler —
    the fleet fault the frontend's request journal exists to replay
    from.  A ``SystemExit`` subclass for the same reason as
    :class:`ChaosHostKilled`; the carried code is
    :data:`~apex_tpu_torch.resilience.elastic.EXIT_KILLED` (137)."""

    def __init__(self, replica_id: str, step: int, code: int):
        super().__init__(code)
        self.replica_id = str(replica_id)
        self.step = int(step)

    def __str__(self):
        return (f"injected hard kill of serving replica "
                f"{self.replica_id!r} at replica step {self.step} "
                f"(exit {self.code})")


class ChaosIOError(OSError):
    """Injected transient filesystem error on a checkpoint I/O site —
    an ``OSError`` subclass so it takes exactly the retry-with-backoff
    path real NFS/GCS hiccups take (``io.checkpoint._with_io_retries``)."""


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """Static description of the faults to inject.

    ``nan_grad_steps``: step indices whose gradients are poisoned.
    ``kernel_failures``: must stay empty (raises: no fallback to
    exercise, :data:`KERNEL_FAILURE_REASON`).
    ``preempt_at_step``: loop step at which a simulated SIGTERM lands.
    ``wedge_seconds``: site name -> seconds to sleep when reached.

    Pod-scale faults (all deterministic, all CPU-testable):

    ``kill_at``: host rank -> loop step at which that host dies HARD
    (:meth:`ChaosMonkey.maybe_kill` raises :class:`ChaosHostKilled` —
    no save, no drain; the elastic-resume scenario "preempt one host
    of N").  Per-rank, so a matrix test can kill host 2 of 4 and
    resume the survivors at world 3.
    ``wedge_step_at``: loop step whose dispatch wedges for
    ``wedge_step_seconds`` (a hung whole step: a wedged kernel, a hung
    build) — the step-watchdog fault.
    ``wedge_collective_rank``/``wedge_collective_at_step``/
    ``wedge_collective_seconds``: must stay unset (raises,
    :data:`COLLECTIVE_WEDGE_REASON`).
    ``io_failures``: I/O site name (``"ckpt.write"``/``"ckpt.read"``)
    -> how many operations raise :class:`ChaosIOError` before the
    "filesystem" recovers; ``io_delay_seconds``: site -> seconds each
    operation stalls first (slow disk).  Both ride
    :func:`check_io` inside ``io.checkpoint``'s retry loop.

    Serving-fleet faults (``inference.fleet`` — per-replica, keyed on
    the replica's OWN step count so a 2-replica plan kills exactly one
    mid-stream):

    ``kill_replica_at``: replica id -> replica step at which that
    replica dies HARD (:meth:`ChaosMonkey.maybe_kill_replica` raises
    :class:`ChaosReplicaKilled` — no drain, no manifest; the frontend
    must replay from its own journal, exit-137 shape).
    ``wedge_replica_at``: replica id -> replica step at which that
    replica's decode step wedges (:meth:`ChaosMonkey
    .maybe_wedge_replica` returns True once) — the exit-75 shape: the
    watchdog path emits the ``serve.step_wedged`` manifest and the
    frontend replays THAT.
    """

    nan_grad_steps: FrozenSet[int] = frozenset()
    kernel_failures: Mapping[str, int] = dataclasses.field(
        default_factory=dict)
    preempt_at_step: Optional[int] = None
    wedge_seconds: Mapping[str, float] = dataclasses.field(
        default_factory=dict)
    kill_at: Mapping[int, int] = dataclasses.field(default_factory=dict)
    wedge_step_at: Optional[int] = None
    wedge_step_seconds: float = 0.0
    wedge_collective_rank: Optional[int] = None
    wedge_collective_at_step: Optional[int] = None
    wedge_collective_seconds: float = 0.0
    io_failures: Mapping[str, int] = dataclasses.field(default_factory=dict)
    io_delay_seconds: Mapping[str, float] = dataclasses.field(
        default_factory=dict)
    kill_replica_at: Mapping[str, int] = dataclasses.field(
        default_factory=dict)
    wedge_replica_at: Mapping[str, int] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        if self.kernel_failures:
            raise ValueError(f"ChaosPlan(kernel_failures={dict(self.kernel_failures)!r}) "
                             f"is refused: {KERNEL_FAILURE_REASON}")
        if (self.wedge_collective_rank is not None
                or self.wedge_collective_at_step is not None
                or self.wedge_collective_seconds):
            raise ValueError(f"ChaosPlan(wedge_collective_*) is refused: "
                             f"{COLLECTIVE_WEDGE_REASON}")

    @staticmethod
    def make(nan_grad_steps: Iterable[int] = (),
             kernel_failures: Optional[Mapping[str, int]] = None,
             preempt_at_step: Optional[int] = None,
             wedge_seconds: Optional[Mapping[str, float]] = None,
             kill_at: Optional[Mapping[int, int]] = None,
             wedge_step_at: Optional[int] = None,
             wedge_step_seconds: float = 0.0,
             wedge_collective_rank: Optional[int] = None,
             wedge_collective_at_step: Optional[int] = None,
             wedge_collective_seconds: float = 0.0,
             io_failures: Optional[Mapping[str, int]] = None,
             io_delay_seconds: Optional[Mapping[str, float]] = None,
             kill_replica_at: Optional[Mapping[str, int]] = None,
             wedge_replica_at: Optional[Mapping[str, int]] = None
             ) -> "ChaosPlan":
        return ChaosPlan(
            nan_grad_steps=frozenset(int(s) for s in nan_grad_steps),
            kernel_failures=dict(kernel_failures or {}),
            preempt_at_step=preempt_at_step,
            wedge_seconds=dict(wedge_seconds or {}),
            kill_at={int(r): int(s) for r, s in (kill_at or {}).items()},
            wedge_step_at=wedge_step_at,
            wedge_step_seconds=float(wedge_step_seconds),
            wedge_collective_rank=wedge_collective_rank,
            wedge_collective_at_step=wedge_collective_at_step,
            wedge_collective_seconds=float(wedge_collective_seconds),
            io_failures=dict(io_failures or {}),
            io_delay_seconds=dict(io_delay_seconds or {}),
            kill_replica_at={str(r): int(s)
                             for r, s in (kill_replica_at or {}).items()},
            wedge_replica_at={str(r): int(s)
                              for r, s in (wedge_replica_at or {}).items()},
        )


class ChaosMonkey:
    """One armed fault plan plus the mutable counters it burns down."""

    def __init__(self, plan: ChaosPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._steps: Dict[str, object] = {}  # device -> the planned steps
        self._io_budget: Dict[str, int] = dict(plan.io_failures)
        self.injected: Dict[str, int] = {}  # fault kind -> times fired

    def _count(self, kind: str) -> None:
        with self._lock:
            self.injected[kind] = self.injected.get(kind, 0) + 1

    # ------------------------------------------------------- NaN grads
    def grad_fault(self, step):
        """0-d fp32 tensor on ``step``'s device: NaN on planned steps,
        1.0 otherwise.

        ``step`` is the guard state's 0-d int32 step counter.  The
        planned set is a device tensor made once a device (on the first
        call, the step's eager warm-up) and compared there, so a
        captured step replays it with no host read."""
        import torch

        step = torch.as_tensor(step)
        one = torch.ones((), dtype=torch.float32, device=step.device)
        if not self.plan.nan_grad_steps:
            return one
        key = str(step.device)
        steps = self._steps.get(key)
        if steps is None:
            steps = self._steps[key] = torch.tensor(
                sorted(self.plan.nan_grad_steps), dtype=torch.int32, device=step.device)
        hit = (steps == step.to(torch.int32)).any()
        return torch.where(hit, torch.full_like(one, float("nan")), one)

    # ----------------------------------------------------- preemption
    def maybe_preempt(self, step: int, handler) -> bool:
        """Deliver the planned preemption to ``handler`` at ``step``."""
        if self.plan.preempt_at_step is None \
                or int(step) != int(self.plan.preempt_at_step):
            return False
        with self._lock:
            self.injected["preemption"] = \
                self.injected.get("preemption", 0) + 1
        log_structured(_logger, logging.INFO, "chaos.preemption", step=int(step))
        handler.simulate()
        return True

    # -------------------------------------------------------- wedges
    def maybe_wedge(self, site: str) -> float:
        """Sleep the planned seconds at ``site`` (0.0 when unarmed)."""
        secs = float(self.plan.wedge_seconds.get(site, 0.0))
        if secs > 0.0:
            with self._lock:
                self.injected[f"wedge:{site}"] = \
                    self.injected.get(f"wedge:{site}", 0) + 1
            log_structured(_logger, logging.INFO, "chaos.wedge",
                           site=site, seconds=secs)
            time.sleep(secs)
        return secs

    # ------------------------------------------------ pod-scale faults
    def maybe_kill(self, step, rank: int = 0) -> None:
        """Deliver the planned HARD death of host ``rank`` at ``step``:
        raises :class:`ChaosHostKilled` (a ``SystemExit``) with the
        elastic runtime's documented kill exit code — no save, no
        drain, mirroring a spot VM vanishing past its grace window.
        The elastic matrix tests catch it to play the supervisor; the
        example lets it exit the process."""
        planned = self.plan.kill_at.get(int(rank))
        if planned is None or int(step) != int(planned):
            return
        self._count(f"kill:{int(rank)}")
        from apex_tpu_torch.resilience.elastic import EXIT_KILLED

        log_structured(_logger, logging.WARNING, "chaos.host_killed",
                       rank=int(rank), step=int(step))
        raise ChaosHostKilled(int(rank), int(step), EXIT_KILLED)

    def maybe_wedge_step(self, step) -> float:
        """Host-side whole-step wedge: sleep the planned seconds before
        dispatching ``step`` (a wedged kernel or a hung build presents as
        the dispatch never returning).  Returns the seconds slept —
        the step watchdog should fire mid-sleep."""
        if self.plan.wedge_step_at is None \
                or int(step) != int(self.plan.wedge_step_at):
            return 0.0
        secs = float(self.plan.wedge_step_seconds)
        if secs > 0.0:
            self._count("wedge_step")
            log_structured(_logger, logging.INFO, "chaos.wedge_step",
                           step=int(step), seconds=secs)
            time.sleep(secs)
        return secs

    # ---------------------------------------------- serving-fleet faults
    def maybe_kill_replica(self, replica_id: str, step: int) -> None:
        """Deliver the planned HARD death of serving replica
        ``replica_id`` at ITS step ``step``: raises
        :class:`ChaosReplicaKilled` (a ``SystemExit``, exit 137) — no
        drain, no wedge manifest, so the only replay source is the
        frontend's own request journal."""
        planned = self.plan.kill_replica_at.get(str(replica_id))
        if planned is None or int(step) != int(planned):
            return
        self._count(f"kill_replica:{replica_id}")
        from apex_tpu_torch.resilience.elastic import EXIT_KILLED

        log_structured(_logger, logging.WARNING, "chaos.replica_killed",
                       replica=str(replica_id), step=int(step))
        raise ChaosReplicaKilled(str(replica_id), int(step), EXIT_KILLED)

    def maybe_wedge_replica(self, replica_id: str, step: int) -> bool:
        """True exactly once, at the planned (replica, step): the
        replica's decode dispatch has wedged — the
        caller runs the watchdog path (``serve.step_wedged`` manifest,
        exit 75) instead of sleeping a real watchdog out."""
        planned = self.plan.wedge_replica_at.get(str(replica_id))
        if planned is None or int(step) != int(planned):
            return False
        self._count(f"wedge_replica:{replica_id}")
        log_structured(_logger, logging.WARNING, "chaos.replica_wedged",
                       replica=str(replica_id), step=int(step))
        return True

    # ------------------------------------------------------ I/O faults
    def io_fault(self, site: str) -> None:
        """Checkpoint-I/O seam: stall the planned delay, then raise
        :class:`ChaosIOError` while the site's failure budget lasts —
        each retry of ``io.checkpoint._with_io_retries`` burns one
        budget unit, so a budget smaller than the retry cap means "the
        filesystem recovers mid-retry" and larger means "stays down"."""
        delay = float(self.plan.io_delay_seconds.get(site, 0.0))
        if delay > 0.0:
            self._count(f"io_delay:{site}")
            time.sleep(delay)
        with self._lock:
            left = self._io_budget.get(site, 0)
            if left <= 0:
                return
            self._io_budget[site] = left - 1
        self._count(f"io_fail:{site}")
        log_structured(_logger, logging.INFO, "chaos.io_failure",
                       site=site, remaining=left - 1)
        raise ChaosIOError(f"injected transient I/O failure at {site!r} "
                           f"({left - 1} more planned)")

    # ---------------------------------------------------- activation
    @contextlib.contextmanager
    def active(self):
        """Install this monkey as the process-wide active one."""
        global _ACTIVE
        prev = _ACTIVE
        _ACTIVE = self
        try:
            yield self
        finally:
            _ACTIVE = prev


# ------------------------------------------------- supervisor-level faults
def corrupt_newest_checkpoint(dir_path, flip_bytes: int = 64) -> str:
    """Deterministic stand-in for silent storage corruption: XOR the
    LAST ``flip_bytes`` of the newest restore candidate (a complete
    ``step_*`` dir's rank-0 shard, or the newest single-file
    checkpoint) with 0xFF — **size-preserving**, so the index
    completeness check and the torn-size validation both still pass and
    only the blob-crc corruption probe (``io.probe_checkpoint``) or the
    load-time crc verify can see it.  The tail of the file is blob
    bytes by the format's layout (header first), so the flip never
    fabricates a different-but-parseable header.  Returns the corrupted
    file's path; raises ``FileNotFoundError`` when the dir holds no
    complete checkpoint to corrupt."""
    import os
    from pathlib import Path

    from apex_tpu_torch.io.checkpoint import (
        _shard_name, checkpoint_step, latest_distributed_step, read_index,
    )

    d = Path(dir_path)
    target = None
    if any(d.glob("step_*/index.json")):
        step = latest_distributed_step(d)
        if step >= 0:
            sd = d / f"step_{step:08d}"
            world = int(read_index(sd)["world_size"])
            target = sd / _shard_name(0, world)
    else:
        cands = sorted(
            (p for p in d.iterdir()
             if p.is_file() and p.suffix in (".ckpt", ".apex")),
            key=checkpoint_step, reverse=True) if d.is_dir() else []
        target = cands[0] if cands else None
    if target is None or not target.exists():
        raise FileNotFoundError(
            f"no complete checkpoint under {dir_path} to corrupt")
    size = target.stat().st_size
    n = min(int(flip_bytes), size)
    # r+b (no truncate, no append): the size must not change — that is
    # the whole point of this fault class
    with open(target, "r+b") as f:
        f.seek(size - n)
        tail = f.read(n)
        f.seek(size - n)
        f.write(bytes(b ^ 0xFF for b in tail))
        f.flush()
        os.fsync(f.fileno())
    log_structured(_logger, logging.WARNING, "chaos.checkpoint_corrupted",
                   path=str(target), flipped_bytes=n)
    return str(target)


@dataclasses.dataclass(frozen=True)
class SupervisorFault:
    """One restart attempt's planned fault, applied by the
    :class:`~apex_tpu_torch.resilience.supervisor.Supervisor` around a spawn:
    ``extra_args`` append to the child argv (arming the child-side
    chaos flags — kill at step N, wedge a step — for THIS attempt
    only, so the fault does not recur on every relaunch), and
    ``corrupt_newest_checkpoint`` flips bytes in the newest restore
    candidate before the child launches."""

    extra_args: tuple = ()
    corrupt_newest_checkpoint: bool = False


class SupervisorFaultScript:
    """attempt index -> :class:`SupervisorFault`: the deterministic
    script that turns the whole fault gauntlet (kill, wedge storm,
    corrupt checkpoint, recover) into ONE supervised invocation.

    JSON shape (``from_file`` / ``pretrain_gpt.py --fault-script``)::

        {"0": {"args": ["--chaos-kill-at-step", "3"]},
         "1": {"args": ["--watchdog-secs", "3",
                         "--chaos-wedge-step", "4",
                         "--chaos-wedge-secs", "300"]},
         "2": {"corrupt_newest_checkpoint": true}}

    Unlisted attempts run clean."""

    def __init__(self, faults: Mapping[int, SupervisorFault]):
        self.faults = {int(k): v for k, v in dict(faults).items()}

    @classmethod
    def from_dict(cls, spec: Mapping) -> "SupervisorFaultScript":
        faults = {}
        for k, v in dict(spec).items():
            unknown = set(v) - {"args", "corrupt_newest_checkpoint"}
            if unknown:
                raise ValueError(
                    f"fault script attempt {k!r}: unknown key(s) "
                    f"{sorted(unknown)} (valid: args, "
                    "corrupt_newest_checkpoint)")
            faults[int(k)] = SupervisorFault(
                extra_args=tuple(str(a) for a in v.get("args", ())),
                corrupt_newest_checkpoint=bool(
                    v.get("corrupt_newest_checkpoint", False)))
        return cls(faults)

    @classmethod
    def from_file(cls, path) -> "SupervisorFaultScript":
        import json

        with open(path) as f:
            return cls.from_dict(json.load(f))

    def fault_for(self, attempt: int) -> Optional[SupervisorFault]:
        return self.faults.get(int(attempt))


_ACTIVE: Optional[ChaosMonkey] = None


def active_monkey() -> Optional[ChaosMonkey]:
    return _ACTIVE


def check_io(site: str) -> None:
    """Checkpoint-I/O hook (``io.checkpoint._with_io_retries`` calls it
    in each attempt): stall or raise the injected fault when armed."""
    m = _ACTIVE
    if m is not None:
        m.io_fault(site)
