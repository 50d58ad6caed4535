"""Keep long training runs alive (counterpart of
:mod:`apex_tpu.resilience`).  Ported so far: the step guard
(:mod:`~apex_tpu_torch.resilience.step_guard`), device-side bad-step
accounting over the amp finite vote with a host-side budget; the
preemption handler (:mod:`~apex_tpu_torch.resilience.preemption`); and
the step watchdog (:mod:`~apex_tpu_torch.resilience.elastic`).  The JAX
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
from apex_tpu_torch.resilience.preemption import PreemptionHandler
from apex_tpu_torch.resilience.step_guard import (
    BadStepBudgetExceeded,
    GuardState,
    StepGuard,
)

__all__ = ["BadStepBudgetExceeded", "EXIT_WEDGED", "ElasticRestore", "ElasticRunController",
           "GuardState", "PreemptionHandler", "StepGuard", "StepWatchdog",
           "restore_elastic_checkpoint", "save_elastic_checkpoint"]
