"""Keep long training runs alive (counterpart of
:mod:`apex_tpu.resilience`).  Ported so far: the step guard
(:mod:`~apex_tpu_torch.resilience.step_guard`), device-side bad-step
accounting over the amp finite vote with a host-side budget.  The JAX
package's fallback registry has no counterpart (the port never falls
back), and its preemption, elastic, supervisor, chaos, uniformity and
lock modules come with the host runtime."""

from apex_tpu_torch.resilience.step_guard import (
    BadStepBudgetExceeded,
    GuardState,
    StepGuard,
)

__all__ = ["GuardState", "StepGuard", "BadStepBudgetExceeded"]
