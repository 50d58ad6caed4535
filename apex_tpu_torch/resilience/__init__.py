"""Keep long training and serving runs alive (counterpart of
:mod:`apex_tpu.resilience`):

- :mod:`~apex_tpu_torch.resilience.step_guard` — device-side bad-step
  accounting over the amp finite vote, with a host-side budget;
- :mod:`~apex_tpu_torch.resilience.preemption` — the SIGTERM / deadline
  hook that flushes the async checkpoint queue, and the RNG tracker's
  state dict;
- :mod:`~apex_tpu_torch.resilience.elastic` — elastic checkpoints, the
  step watchdog (exit 75), the run controller, the exit codes and the
  restart backoff;
- :mod:`~apex_tpu_torch.resilience.supervisor` — the restart state
  machine that runs a trainer or server as its child (``--supervise``);
- :mod:`~apex_tpu_torch.resilience.uniformity` — rank-shaping decisions
  recorded and compared across processes (``UniformityError``);
- :mod:`~apex_tpu_torch.resilience.chaos` — deterministic fault
  injection (NaN grads inside a captured step, preemptions, wedges, hard
  kills, checkpoint I/O, supervisor fault scripts);
- :mod:`~apex_tpu_torch.resilience.locks` — the lock-order sanitizer.

The JAX package's kernel fallback registry has no counterpart: the port
never falls back, so a chaos plan that arms a kernel failure raises.
"""

from apex_tpu_torch.resilience.chaos import (
    ChaosHostKilled,
    ChaosIOError,
    ChaosKernelFailure,
    ChaosMonkey,
    ChaosPlan,
    ChaosReplicaKilled,
    SupervisorFault,
    SupervisorFaultScript,
    active_monkey,
    check_io,
    corrupt_newest_checkpoint,
)
from apex_tpu_torch.resilience.elastic import (
    EXIT_KILLED,
    EXIT_WEDGED,
    ElasticRestore,
    ElasticRunController,
    StepWatchdog,
    restart_backoff,
    restore_elastic_checkpoint,
    save_elastic_checkpoint,
)
from apex_tpu_torch.resilience.locks import (
    LockContractError,
    LockOrderViolation,
    assert_lock_held,
    instrument_locks,
    monitored_lock,
)
from apex_tpu_torch.resilience.preemption import (
    PreemptionHandler,
    load_rng_tracker_state_dict,
    rng_tracker_state_dict,
)
from apex_tpu_torch.resilience.step_guard import (
    BadStepBudgetExceeded,
    GuardState,
    StepGuard,
)
from apex_tpu_torch.resilience.supervisor import (
    EXIT_CRASH_LOOP,
    Supervisor,
    add_supervisor_args,
    run_supervised_cli,
    strip_supervisor_argv,
)
from apex_tpu_torch.resilience.uniformity import (
    UniformityError,
    UniformityMonitor,
    assert_uniform,
    check_uniform,
    install_gather,
    register_uniform,
    uniform_digest,
)

__all__ = [
    "BadStepBudgetExceeded", "ChaosHostKilled", "ChaosIOError", "ChaosKernelFailure",
    "ChaosMonkey", "ChaosPlan", "ChaosReplicaKilled", "EXIT_CRASH_LOOP", "EXIT_KILLED",
    "EXIT_WEDGED", "ElasticRestore", "ElasticRunController", "GuardState",
    "LockContractError", "LockOrderViolation", "PreemptionHandler", "StepGuard",
    "StepWatchdog", "Supervisor", "SupervisorFault", "SupervisorFaultScript",
    "UniformityError", "UniformityMonitor", "active_monkey", "add_supervisor_args",
    "assert_lock_held", "assert_uniform", "check_io", "check_uniform",
    "corrupt_newest_checkpoint", "install_gather", "instrument_locks", "load_rng_tracker_state_dict",
    "monitored_lock", "register_uniform", "restart_backoff", "restore_elastic_checkpoint",
    "rng_tracker_state_dict", "run_supervised_cli", "save_elastic_checkpoint",
    "strip_supervisor_argv", "uniform_digest",
]
