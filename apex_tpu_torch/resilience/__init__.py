"""Keep long training runs alive (counterpart of
:mod:`apex_tpu.resilience`).  Ported so far: the step guard
(:mod:`~apex_tpu_torch.resilience.step_guard`), device-side bad-step
accounting over the amp finite vote with a host-side budget; the
preemption handler (:mod:`~apex_tpu_torch.resilience.preemption`); and
the step watchdog (:mod:`~apex_tpu_torch.resilience.elastic`); the RNG
tracker's state dict.  The JAX
package's fallback registry has no counterpart (the port never falls
back); its elastic checkpoints and run controller come with ZeRO, and
its supervisor, chaos, uniformity and lock modules are still to be
ported."""

from apex_tpu_torch.resilience.elastic import (
    EXIT_WEDGED,
    ElasticRestore,
    ElasticRunController,
    StepWatchdog,
    restore_elastic_checkpoint,
    save_elastic_checkpoint,
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

__all__ = ["BadStepBudgetExceeded", "EXIT_WEDGED", "ElasticRestore", "ElasticRunController",
           "GuardState", "PreemptionHandler", "StepGuard", "StepWatchdog",
           "load_rng_tracker_state_dict", "restore_elastic_checkpoint",
           "rng_tracker_state_dict", "save_elastic_checkpoint"]
