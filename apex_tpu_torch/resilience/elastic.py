"""The step watchdog (counterpart of :class:`apex_tpu.resilience.elastic
.StepWatchdog`): a step exceeding its deadline (a wedged kernel, a hung
build, a dead filesystem) is declared dead — one structured
``watchdog.step_wedged`` record, the ``on_wedge`` hook, a flight
recorder dump, a bounded drain of the async checkpointer (every
ACCEPTED save durable; the wedged step itself is lost by definition),
then ``os._exit(EXIT_WEDGED)`` so a supervisor restarts with backoff.

Exit-code contract (what :class:`~apex_tpu_torch.resilience.supervisor
.Supervisor` keys its restart policy on)::

    0            clean finish, or preemption save+drain (resume freely)
    EXIT_WEDGED  (75, EX_TEMPFAIL) the watchdog killed a wedged step —
                 restart with backoff (:func:`restart_backoff`); the run
                 resumes from its newest valid checkpoint
    EXIT_KILLED  (137, 128+SIGKILL) a hard kill, or the chaos harness's
                 stand-in for one — restart
    anything else: a real crash; do not blindly restart

Elastic checkpoints (:func:`save_elastic_checkpoint` /
:func:`restore_elastic_checkpoint`, the JAX module's :289-463): one
``step_<N>/`` directory a save, one shard file a data-parallel rank
plus an ``index.json`` recording the saved world layout, in the JAX
package's file layout and tree.  Each rank writes its own shard (the
process holds only its own); rank 0's also carries the replicated
pieces (params, the step, the loss-scaler / StepGuard / RNG state
dicts).  A ZeRO state saved at one world restores at another through
``load_sharded_state_dicts``, residuals included; a JAX-saved directory
restores here and the reverse.  :class:`ElasticRunController` is the
loop's side of it (restore-or-fresh, the heartbeat and the chaos
faults planned for a step, saves with bounded disk).
"""

import logging
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np

from apex_tpu_torch.observability import flightrec as _flightrec
from apex_tpu_torch.observability import metrics as _metrics
from apex_tpu_torch.utils.logging import get_logger, log_structured

__all__ = ["EXIT_KILLED", "EXIT_WEDGED", "ElasticRestore", "ElasticRunController",
           "StepWatchdog", "restart_backoff", "restore_elastic_checkpoint",
           "save_elastic_checkpoint"]

_logger = get_logger("apex_tpu_torch.resilience")

#: sysexits EX_TEMPFAIL: "temporary failure, retry later" — the
#: watchdog's exit code.  Distinct from 0 (clean/preempted) and from
#: Python's generic 1 so a supervisor can apply restart-with-backoff to
#: exactly the wedged-step case.
EXIT_WEDGED = 75

#: 128+SIGKILL — what a hard-killed process reports; the chaos harness's
#: :class:`~apex_tpu_torch.resilience.chaos.ChaosHostKilled` carries it,
#: so a supervisor cannot tell the simulated death from a real one.
EXIT_KILLED = 137


def restart_backoff(attempt: int, base: float = 2.0, cap: float = 300.0,
                    seed: int = 0, rng=None) -> float:
    """The supervisor's backoff (the JAX module's, to the bit): full
    jitter, attempt ``k`` sleeps ``uniform(0, min(cap, base·2^k))``
    seconds, deterministic per ``(seed, attempt)``; a host seeds by its
    rank so a pod's restarts do not land in lockstep.  ``rng`` (anything
    with ``uniform(a, b)``) overrides the per-(seed, attempt) stream."""
    import random

    if attempt < 0:
        raise ValueError(f"attempt must be >= 0, got {attempt}")
    hi = min(float(cap), float(base) * (2.0 ** int(attempt)))
    if rng is None:
        rng = random.Random(int(seed) * 1000003 + int(attempt))
    return rng.uniform(0.0, hi)


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


# ------------------------------------------------------ elastic checkpoints
#: index.json metadata kinds: which restore path owns the state
ELASTIC_KIND_ZERO = "zero2"
ELASTIC_KIND_REPLICATED = "replicated"


class ElasticRestore(NamedTuple):
    """What :func:`restore_elastic_checkpoint` hands the loop: host
    trees (CPU tensors), the optimizer state already on the optimizer's
    device and resharded for the live world."""

    step: int
    params: Any
    opt_state: Any
    scaler: Optional[dict]
    guard: Optional[dict]
    rng: Optional[dict]
    saved_world: int
    resharded: bool


def _is_zero(optimizer) -> bool:
    return hasattr(optimizer, "sharded_state_dict")


def _step_dir(dir_path, step: int) -> Path:
    return Path(dir_path) / f"step_{int(step):08d}"


def _live_rank(optimizer) -> int:
    if _is_zero(optimizer):
        return int(optimizer.rank)
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def save_elastic_checkpoint(dir_path, step: int, *, params, opt_state, optimizer,
                            world_size: int, mesh_axes: Optional[Mapping[str, int]] = None,
                            scaler_state: Optional[dict] = None,
                            guard_state: Optional[dict] = None,
                            rng_state: Optional[dict] = None, checkpointer=None) -> str:
    """Publish this rank's part of the train state as an elastic
    ``step_<N>/`` directory.  A ZeRO optimizer's rank writes its
    :meth:`sharded_state_dict`; a replicated one's rank 0 writes its
    state as a world-1 shard (the state is the same on every rank).
    Rank 0 writes the index first, then its shard with the replicated
    pieces.  ``scaler_state`` / ``guard_state`` / ``rng_state`` are the
    owners' plain state dicts.  With a ``checkpointer``
    (:class:`~apex_tpu_torch.io.AsyncCheckpointer`) the shard is
    snapshot now and written by its worker.  Returns the directory."""
    from apex_tpu_torch.io import checkpoint as ck

    zero = _is_zero(optimizer)
    world = int(world_size) if zero else 1
    rank = _live_rank(optimizer)
    sd = _step_dir(dir_path, step)
    meta = {"elastic": {"kind": ELASTIC_KIND_ZERO if zero else ELASTIC_KIND_REPLICATED,
                        "step": int(step), "dp_world": world,
                        "mesh_axes": {k: int(v) for k, v in (mesh_axes or {}).items()}}}
    if not zero and rank != 0:
        return str(sd)
    tree: Dict[str, Any] = {"opt": optimizer.sharded_state_dict(opt_state) if zero
                            else opt_state}
    if rank == 0:
        tree.update({"params": params, "step": np.int64(step), "scaler": scaler_state,
                     "guard": guard_state, "rng": rng_state})
    if rank == 0:
        ck._write_index(sd, world, extra=meta)
    path = sd / ck._shard_name(rank, world)
    if checkpointer is not None:
        checkpointer.save(path, tree)
    else:
        from apex_tpu_torch.io.async_checkpoint import _snapshot

        sd.mkdir(parents=True, exist_ok=True)
        ck.save_checkpoint(path, _snapshot(tree))
    log_structured(_logger, logging.INFO, "elastic.saved", step=int(step), dp_world=world,
                   rank=rank, path=str(sd))
    return str(sd)


def _shape_free(tree):
    """``tree`` with every leaf a placeholder that carries no shape: the
    structure of a JAX-written shard file whose shard lengths differ
    from the live ones."""
    from apex_tpu_torch.optimizers.tree import tree_map

    return tree_map(lambda _: 0, tree)


def _shard_template(optimizer, opt_state, params, scaler_state, guard_state, rng_state):
    """``template(rank)``: the tree of a shard file (for a JAX-written
    directory, whose structure bytes only jaxlib reads)."""
    opt = _shape_free(optimizer.sharded_state_dict(opt_state)) if _is_zero(optimizer) \
        else opt_state

    def template(rank):
        t = {"opt": opt}
        if rank == 0:
            t.update({"params": params, "step": np.int64(0), "scaler": scaler_state,
                      "guard": guard_state, "rng": rng_state})
        return t

    return template


def restore_elastic_checkpoint(dir_path, *, optimizer, world_size: int,
                               mesh_axes: Optional[Mapping[str, int]] = None,
                               step: Optional[int] = None, opt_state=None, params=None,
                               scaler_state: Optional[dict] = None
                               ) -> Optional[ElasticRestore]:
    """Resume from the newest complete elastic ``step_<N>/`` directory,
    resharding a ZeRO state for the live ``world_size`` (the optimizer
    ``init``-ed at it).  ``None`` when no ``step_*`` directory exists;
    :class:`~apex_tpu_torch.io.AllCheckpointsTornError` when some exist
    but none is complete.  Refuses a model-layout change (``mesh_axes``),
    a replicated/ZeRO kind mismatch, and the engine's own state checks
    (master precision, residual kind, incomplete shard sets).
    ``opt_state`` / ``params`` / ``scaler_state``: the live trees, whose
    structure reads a JAX-written directory (a port-written one needs
    none)."""
    from apex_tpu_torch import io

    if step is None:
        step = io.latest_distributed_step(dir_path)
        if step < 0:
            return None
    sd = _step_dir(dir_path, step)
    index = io.read_index(sd)
    meta = index.get("elastic")
    if meta is None:
        raise ValueError(f"{sd} is a sharded checkpoint but not an ELASTIC one (no 'elastic' "
                         "index metadata): load it with io.load_sharded_checkpoint")
    zero = _is_zero(optimizer)
    want_kind = ELASTIC_KIND_ZERO if zero else ELASTIC_KIND_REPLICATED
    if meta.get("kind") != want_kind:
        raise ValueError(
            f"elastic checkpoint kind {meta.get('kind')!r} does not match this optimizer "
            f"({want_kind!r}): a replicated state cannot restore into a ZeRO optimizer or "
            "vice versa (the --zero flag must agree between save and resume)")
    saved_axes = {k: int(v) for k, v in (meta.get("mesh_axes") or {}).items()}
    live_axes = {k: int(v) for k, v in (mesh_axes or {}).items()}
    if saved_axes != live_axes:
        raise ValueError(
            f"elastic resume is data-parallel-only: checkpoint was saved with model axes "
            f"{saved_axes} but the live layout has {live_axes}")
    saved_world = int(meta.get("dp_world", index["world_size"]))
    if zero and optimizer.world_size is not None and int(optimizer.world_size) != int(world_size):
        raise ValueError(
            f"optimizer was init'd for dp={optimizer.world_size} but the live world is "
            f"{world_size}: init it at the live world before restore")
    template = None
    if opt_state is not None and params is not None:
        template = _shard_template(optimizer, opt_state, params, scaler_state, None, None)
    shards = io.load_sharded_checkpoint(sd, template=template)
    r0 = shards[0]
    if zero:
        from apex_tpu_torch.contrib.optimizers import zero_state_from_numpy

        opt_state = zero_state_from_numpy(optimizer, [d["opt"] for d in shards])
    else:
        opt_state = r0["opt"]
    resharded = zero and saved_world != int(world_size)
    log_structured(_logger, logging.INFO, "elastic.restored", step=int(step),
                   saved_world=saved_world, live_world=int(world_size), resharded=resharded,
                   path=str(sd))
    return ElasticRestore(step=int(np.asarray(r0["step"])), params=r0["params"],
                          opt_state=opt_state, scaler=r0.get("scaler"),
                          guard=r0.get("guard"), rng=r0.get("rng"), saved_world=saved_world,
                          resharded=resharded)


# ---------------------------------------------------------- run controller
def top_of_step(step: int, watchdog=None, chaos=None, rank: int = 0,
                deadline: Optional[float] = None) -> None:
    """A training loop's top-of-iteration hooks, in their one order: the
    watchdog's heartbeat (``deadline`` overrides this interval's
    allowance), then ``chaos``'s faults planned for ``step``: a wedged
    dispatch the watchdog should catch, then a hard kill of ``rank``."""
    if watchdog is not None:
        watchdog.beat(step, deadline=deadline)
    if chaos is not None:
        chaos.maybe_wedge_step(step)
        chaos.maybe_kill(step, rank=rank)


class ElasticRunController:
    """The loop's side of elastic checkpoints: restore-or-fresh, the
    per-step watchdog heartbeat and chaos delivery, saves with bounded
    disk (the JAX module's :464)::

        ctl = ElasticRunController(ckdir, optimizer, world_size=dp,
                                   mesh_axes={"tp": 1, "pp": 1}, checkpointer=ckpt)
        restored = ctl.restore(opt_state=state, params=params)  # None: fresh
        for step in range(start, end):
            ctl.on_step(step)
            ...train...
            ctl.save(step + 1, params, state)

    Every rank runs it: each saves its own shard, and rank 0 prunes.
    ``chaos``: a :class:`~apex_tpu_torch.resilience.chaos.ChaosMonkey`
    whose wedged dispatch and per-rank hard kill :meth:`on_step`
    delivers; ``rank`` is this host's index for its kill plan."""

    def __init__(self, checkpoint_dir, optimizer, world_size: int,
                 mesh_axes: Optional[Mapping[str, int]] = None, checkpointer=None,
                 watchdog: Optional[StepWatchdog] = None, keep: int = 3, chaos=None,
                 rank: int = 0):
        self.dir = checkpoint_dir
        self.optimizer = optimizer
        self.world_size = int(world_size)
        self.mesh_axes = dict(mesh_axes or {})
        self.checkpointer = checkpointer
        self.watchdog = watchdog
        self.keep = max(int(keep), 1)
        self.chaos = chaos
        self.rank = int(rank)

    def __enter__(self):
        if self.watchdog is not None:
            self.watchdog.start()
        return self

    def __exit__(self, *exc):
        if self.watchdog is not None:
            self.watchdog.stop()
        return False

    def on_step(self, step: int, deadline: Optional[float] = None) -> None:
        """Top-of-iteration hook: the watchdog's heartbeat (``deadline``
        overrides this interval's allowance), then the chaos faults
        planned for ``step``: a wedged dispatch the watchdog should
        catch, a hard kill of this rank."""
        top_of_step(step, self.watchdog, self.chaos, self.rank, deadline)

    def restore(self, opt_state=None, params=None, scaler_state=None) -> Optional[ElasticRestore]:
        return restore_elastic_checkpoint(
            self.dir, optimizer=self.optimizer, world_size=self.world_size,
            mesh_axes=self.mesh_axes, opt_state=opt_state, params=params,
            scaler_state=scaler_state)

    def save(self, step: int, params, opt_state, scaler_state=None, guard_state=None,
             rng_state=None) -> str:
        path = save_elastic_checkpoint(
            self.dir, step, params=params, opt_state=opt_state, optimizer=self.optimizer,
            world_size=self.world_size, mesh_axes=self.mesh_axes, scaler_state=scaler_state,
            guard_state=guard_state, rng_state=rng_state, checkpointer=self.checkpointer)
        if _live_rank(self.optimizer) == 0:
            self.prune()
        return path

    def prune(self) -> None:
        """Keep the newest ``keep`` step directories (at least 3 with an
        async checkpointer, whose queue may hold two in flight)."""
        keep = max(self.keep, 3) if self.checkpointer is not None else self.keep
        for d in sorted(Path(self.dir).glob("step_*"))[:-keep]:
            shutil.rmtree(d, ignore_errors=True)
