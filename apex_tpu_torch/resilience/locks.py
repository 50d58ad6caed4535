"""Runtime lock-order sanitizer (counterpart of
:mod:`apex_tpu.resilience.locks`): an ABBA deadlock becomes a named
error instead of a silent hang.

The host side of a training or serving process is multi-threaded: the
step watchdog, the preemption signal path, the async checkpointer's
writer, the supervisor and the metrics registry all take locks.  Two
locks taken in opposite orders on two threads deadlock for good, often
with the watchdog a party to it and unable to report.

- :func:`monitored_lock(name) <monitored_lock>` mints a named lock
  (``kind="lock"`` or ``"rlock"``) that behaves like the ``threading``
  primitive it wraps, at one bool check per acquire, until the
  sanitizer is on.
- :func:`instrument_locks` arms it: every monitored acquire records the
  monitored locks this thread already holds and merges the (held ->
  acquiring) edges into one order graph, with the acquiring stack.  The
  first acquire that closes a cycle raises :class:`LockOrderViolation`
  naming both locks and carrying both stacks: the inconsistent order is
  caught every run, before the unlucky interleaving.
- Re-entering one RLock adds no edge; edges are keyed by lock name.
- :func:`assert_lock_held(lock) <assert_lock_held>` checks a
  caller-holds-the-lock contract at run time (monitored locks by owner,
  ``RLock``-likes by ownership, plain locks by ``locked()``).

Pure ``threading``: nothing here touches a device.  Order inversions
through conditions or queues, and locks not made by
:func:`monitored_lock`, are invisible to it.
"""

import logging
import threading
import traceback
from typing import Dict, List, Optional, Tuple

from apex_tpu_torch.utils.logging import get_logger, log_structured

logger = get_logger(__name__)

__all__ = [
    "LockOrderViolation", "LockContractError", "assert_lock_held",
    "instrument_locks", "instrumentation_enabled", "monitored_lock",
    "reset_lock_monitor",
]


class LockOrderViolation(RuntimeError):
    """Two monitored locks were acquired in inconsistent orders.

    ``first``/``second`` name the locks as the LIVE (violating)
    acquire saw them: this thread holds ``first`` and is acquiring
    ``second``, while ``prior_stack`` shows where some thread
    previously acquired ``first`` while holding ``second``.
    ``this_stack`` is the live acquiring stack."""

    def __init__(self, first: str, second: str,
                 this_stack: str, prior_stack: str,
                 this_thread: str, prior_thread: str):
        self.first = first
        self.second = second
        self.this_stack = this_stack
        self.prior_stack = prior_stack
        super().__init__(
            f"lock-order inversion: thread '{this_thread}' is "
            f"acquiring '{second}' while holding '{first}', but "
            f"thread '{prior_thread}' previously acquired '{first}' "
            f"while holding '{second}' — two threads interleaving "
            f"across these orders deadlock permanently, each holding "
            f"the lock the other wants.\n"
            f"--- this acquisition ('{first}' -> '{second}', "
            f"thread '{this_thread}') ---\n{this_stack}"
            f"--- prior acquisition ('{second}' -> '{first}', "
            f"thread '{prior_thread}') ---\n{prior_stack}")


class LockContractError(RuntimeError):
    """:func:`assert_lock_held` found the lock NOT held by the calling
    thread — the caller-holds-the-lock contract the call documents is
    broken."""


# ------------------------------------------------------------- monitor
_monitor_lock = threading.Lock()
_instrumented = False
#: (earlier, later) -> (stack, thread name) of the acquire that first
#: established the order "later taken while earlier held".
_edges: Dict[Tuple[str, str], Tuple[str, str]] = {}
_tls = threading.local()


def instrument_locks(enable: bool = True) -> bool:
    """Arm (or disarm) the sanitizer process-wide.  Returns the
    previous state, so tests restore it in a finally.  Off (the
    default) costs one bool check per monitored acquire; on, each
    acquire records held-set edges and checks the global order graph
    — debug/chaos-mode overhead, not for the hot path."""
    global _instrumented
    with _monitor_lock:
        prev, _instrumented = _instrumented, bool(enable)
    return prev


def instrumentation_enabled() -> bool:
    return _instrumented


def reset_lock_monitor() -> None:
    """Disarm and clear the recorded order graph (test isolation).
    Per-thread held stacks clear as the holders release."""
    global _instrumented
    with _monitor_lock:
        _instrumented = False
        _edges.clear()


def _held_stack() -> List[str]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _record_acquire(name: str) -> None:
    """Merge this acquire's (held -> name) edges into the global graph
    and raise on the first inversion.  Runs BEFORE the underlying
    acquire: the violation surfaces while this thread still holds only
    its current set, not wedged inside the primitive."""
    held = _held_stack()
    if not held:
        return
    me = threading.current_thread().name
    stack = "".join(traceback.format_stack(limit=16)[:-2])
    with _monitor_lock:
        for h in held:
            if h == name:
                continue  # reentrant RLock re-entry is not an ordering
            prior = _edges.get((name, h))
            if prior is not None:
                prior_stack, prior_thread = prior
                log_structured(
                    logger, logging.ERROR, "lock_order_violation",
                    holding=h, acquiring=name,
                    prior_thread=prior_thread, this_thread=me)
                raise LockOrderViolation(
                    h, name, stack, prior_stack, me, prior_thread)
            _edges.setdefault((h, name), (stack, me))


class _MonitoredLock:
    """A named wrapper over ``threading.Lock``/``RLock`` exposing the
    primitive's interface (``acquire``/``release``/context manager/
    ``locked``) plus owner tracking for :func:`assert_lock_held`.
    Uninstrumented, every method is the primitive's plus one bool
    check."""

    __slots__ = ("name", "kind", "_inner", "_owner", "_count")

    def __init__(self, name: str, kind: str = "lock"):
        if kind not in ("lock", "rlock"):
            raise ValueError(f"kind must be 'lock' or 'rlock', "
                             f"got {kind!r}")
        self.name = name
        self.kind = kind
        self._inner = (threading.RLock() if kind == "rlock"
                       else threading.Lock())
        self._owner: Optional[int] = None
        self._count = 0

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        if _instrumented:
            _record_acquire(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            self._count += 1
            if _instrumented:
                _held_stack().append(self.name)
        return got

    def release(self) -> None:
        self._count -= 1
        if self._count <= 0:
            self._owner = None
        self._inner.release()
        if _instrumented:
            held = _held_stack()
            # remove the LAST occurrence: release order may not mirror
            # acquire order, and an RLock appears once per entry
            for i in range(len(held) - 1, -1, -1):
                if held[i] == self.name:
                    del held[i]
                    break

    def __enter__(self) -> "_MonitoredLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        return self._owner is not None

    def held_by_current_thread(self) -> bool:
        return self._owner == threading.get_ident()

    def __repr__(self) -> str:
        return (f"<monitored_lock {self.name!r} kind={self.kind} "
                f"owner={self._owner}>")


def monitored_lock(name: str, kind: str = "lock") -> _MonitoredLock:
    """Mint a named lock the sanitizer can see.  ``kind="rlock"`` wraps
    an ``RLock`` (re-entry adds no order edge).  Drop-in for the
    ``threading`` primitive at declaration sites:
    ``self._lock = monitored_lock("goodput.lock")``."""
    return _MonitoredLock(name, kind)


def assert_lock_held(lock) -> None:
    """Runtime check of the caller-holds-the-lock contract.

    Monitored locks are checked by owner (held by THIS thread);
    plain ``threading.Lock`` objects only expose ``locked()`` (held by
    somebody), which is still enough to catch the bare-call bug;
    ``RLock``-likes with ``_is_owned`` are checked by ownership.
    Raises :class:`LockContractError` on a provable violation."""
    if isinstance(lock, _MonitoredLock):
        if not lock.held_by_current_thread():
            raise LockContractError(
                f"lock '{lock.name}' is not held by the calling "
                f"thread — the caller-holds-the-lock contract this "
                f"assert documents is broken")
        return
    is_owned = getattr(lock, "_is_owned", None)
    if callable(is_owned):
        if not is_owned():
            raise LockContractError(
                "RLock is not owned by the calling thread")
        return
    locked = getattr(lock, "locked", None)
    if callable(locked) and not locked():
        raise LockContractError(
            "lock is not held (not even by another thread) — the "
            "caller-holds-the-lock contract is broken")
