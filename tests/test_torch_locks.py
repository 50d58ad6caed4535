"""The port's lock-order sanitizer (``apex_tpu_torch.resilience.locks``)
against the JAX package's, on the same programs.

Every case runs once on each package (``impl``): the monitored lock
behaves like its primitive until instrumented; an ABBA order raises
``LockOrderViolation`` naming both locks and carrying both stacks, with
the JAX package's message; ``assert_lock_held`` holds the same
contracts; and the chaos pair of tests/test_locks.py: the same two-lock
inversion across a step watchdog's ``on_fire`` thread and the main
thread raises when instrumented and deadlocks (both acquires time out)
when not.  All exact: the sanitizer is host bookkeeping.
"""

import re
import threading

import pytest

from apex_tpu.resilience import elastic as jax_elastic
from apex_tpu.resilience import locks as jax_locks

from apex_tpu_torch.resilience import elastic as port_elastic
from apex_tpu_torch.resilience import locks as port_locks

IMPLS = {"jax": (jax_locks, jax_elastic, "apex_tpu-step-watchdog"),
         "port": (port_locks, port_elastic, "apex_tpu_torch-step-watchdog")}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    locks, elastic, thread = IMPLS[request.param]
    locks.reset_lock_monitor()
    yield locks, elastic, thread
    locks.reset_lock_monitor()


def test_behaves_like_its_primitive_until_instrumented(impl):
    locks = impl[0]
    lk = locks.monitored_lock("plain")
    assert not locks.instrumentation_enabled()
    assert lk.acquire(blocking=False) and lk.locked()
    assert not lk.acquire(blocking=False)  # not re-entrant
    lk.release()
    assert not lk.locked()
    r = locks.monitored_lock("re", kind="rlock")
    with r, r:
        assert r.held_by_current_thread()
    with pytest.raises(ValueError, match="kind"):
        locks.monitored_lock("x", kind="mutex")
    assert locks.instrument_locks(True) is False
    assert locks.instrument_locks(False) is True


def _abba(locks):
    a, b = locks.monitored_lock("ckpt.lock"), locks.monitored_lock("stats.lock")
    locks.instrument_locks(True)

    def establish_forward_order():
        with a, b:
            pass

    establish_forward_order()
    for _ in range(2):  # the same order again never raises
        establish_forward_order()
    with pytest.raises(locks.LockOrderViolation) as ei:
        with b, a:
            pass
    return ei.value


def test_abba_raises_naming_both_locks_and_stacks(impl):
    err = _abba(impl[0])
    msg = str(err)
    assert (err.first, err.second) == ("stats.lock", "ckpt.lock")
    assert "this acquisition" in msg and "prior acquisition" in msg
    assert "establish_forward_order" in err.prior_stack and err.this_stack


def test_abba_message_is_the_jax_packages():
    """The two packages' violations agree but for the stacks."""
    def head(err):
        return re.sub(r"---.*", "", str(err), flags=re.S)

    jax_locks.reset_lock_monitor()
    port_locks.reset_lock_monitor()
    try:
        assert head(_abba(port_locks)) == head(_abba(jax_locks))
    finally:
        jax_locks.reset_lock_monitor()
        port_locks.reset_lock_monitor()


def test_rlock_reentry_and_out_of_order_release(impl):
    locks = impl[0]
    r, a, b = (locks.monitored_lock(n, kind=k)
               for n, k in (("r", "rlock"), ("a", "lock"), ("b", "lock")))
    locks.instrument_locks(True)
    with r, r:  # re-entry is not an ordering
        pass
    a.acquire()
    b.acquire()
    a.release()  # the outer lock first
    b.release()
    with a:
        pass


def test_assert_lock_held_contracts(impl):
    locks = impl[0]
    lk = locks.monitored_lock("contract")
    with lk:
        locks.assert_lock_held(lk)
    with pytest.raises(locks.LockContractError, match="contract"):
        locks.assert_lock_held(lk)
    held, done = threading.Event(), threading.Event()

    def holder():
        with lk:
            held.set()
            done.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    assert held.wait(5)
    try:
        with pytest.raises(locks.LockContractError):
            locks.assert_lock_held(lk)  # held, but not by this thread
    finally:
        done.set()
        t.join()
    for prim in (threading.Lock(), threading.RLock()):
        with pytest.raises(locks.LockContractError):
            locks.assert_lock_held(prim)
        with prim:
            locks.assert_lock_held(prim)


class _InversionRig:
    """tests/test_locks.py's rig: main takes ckpt -> stats, the watchdog's
    fire path stats -> ckpt; the cross acquires time out asymmetrically
    (fire 0.5 s, main 2 s) so a deadlock is proven, not raced."""

    def __init__(self, violation, ckpt_lock, stats_lock):
        self.violation = violation
        self.ckpt, self.stats = ckpt_lock, stats_lock
        self.main_holds_ckpt = threading.Event()
        self.fire_holds_stats = threading.Event()
        self.main_attempt_done = threading.Event()
        self.fire_error, self.fire_deadlocked = [], []

    def on_fire(self, info):
        try:
            assert self.stats.acquire(timeout=5)
            try:
                self.fire_holds_stats.set()
                self.main_holds_ckpt.wait(5)
                if self.ckpt.acquire(timeout=0.5):
                    self.ckpt.release()
                else:
                    self.fire_deadlocked.append(True)
                    self.main_attempt_done.wait(10)
            finally:
                self.stats.release()
        except self.violation as e:
            self.fire_error.append(e)

    def run_main_side(self):
        with self.ckpt, self.stats:
            pass
        assert self.ckpt.acquire(timeout=5)
        try:
            self.main_holds_ckpt.set()
            self.fire_holds_stats.wait(5)
            if self.stats.acquire(timeout=2.0):
                self.stats.release()
                return False
            return True
        finally:
            self.main_attempt_done.set()
            self.ckpt.release()


def _run_rig(elastic, rig):
    wd = elastic.StepWatchdog(deadline_sec=0.05, poll_sec=0.01, on_fire=rig.on_fire)
    wd.start()
    try:
        return rig.run_main_side()
    finally:
        wd.stop()


@pytest.mark.parametrize("armed", [True, False], ids=["instrumented", "plain"])
def test_inversion_across_the_watchdog_thread(impl, armed):
    """Armed: the fire path's reversed acquire raises before it blocks,
    naming the watchdog thread, and main then gets its lock.  Not armed
    (the same monitored locks): both sides time out, each holding the
    lock the other wants — the hang the sanitizer turns into an error."""
    locks, elastic, thread = impl
    if armed:
        locks.instrument_locks(True)
    rig = _InversionRig(locks.LockOrderViolation, locks.monitored_lock("ckpt.lock"),
                        locks.monitored_lock("stats.lock"))
    main_timed_out = _run_rig(elastic, rig)
    if armed:
        assert rig.fire_error and not rig.fire_deadlocked and main_timed_out is False
        err = rig.fire_error[0]
        assert thread in str(err) and "on_fire" in err.this_stack
        assert "run_main_side" in err.prior_stack
    else:
        assert not rig.fire_error and main_timed_out and rig.fire_deadlocked
