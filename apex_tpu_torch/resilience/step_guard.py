"""The step guard: bad-step accounting on the device over the amp vote
(counterpart of :mod:`apex_tpu.resilience.step_guard`).

The optimizers predicate their whole update on ``grads_finite`` and the
loss scaler backs off on a non-finite step; the guard is the layer above
them that notices when bad steps stop being transient:

- :class:`GuardState` rides the train step as three 0-d int32 tensors (a
  step counter, the consecutive bad steps, the total skipped), updated
  branch-free on the device, so the step still captures as one CUDA
  graph;
- :meth:`StepGuard.check` is the host-side budget check, run where the
  loop already synchronizes (after its steps, at a checkpoint): at
  ``max_consecutive_bad`` consecutive bad steps it raises
  :class:`BadStepBudgetExceeded`, so that the loop can stop and resume
  from its last checkpoint instead of skipping every step of a diverged
  run.  Before it raises, ``check`` counts the abort
  (``apex_bad_step_budget_aborts_total``) and dumps the installed flight
  recorder (``"step_guard_abort"``), as the JAX module does.
"""

from typing import NamedTuple, Optional

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.observability import flightrec as _flightrec
from apex_tpu_torch.observability import metrics as _metrics

__all__ = ["GuardState", "StepGuard", "BadStepBudgetExceeded"]


class GuardState(NamedTuple):
    step: torch.Tensor             # 0-d int32: steps attempted (skipped ones too)
    consecutive_bad: torch.Tensor  # 0-d int32: the current run of bad steps
    total_skipped: torch.Tensor    # 0-d int32: skipped steps, ever


class BadStepBudgetExceeded(RuntimeError):
    """The budget of consecutive bad steps is spent: stop and resume from
    the last checkpoint.  Carries the guard state it was raised on."""

    def __init__(self, msg: str, state: "GuardState"):
        super().__init__(msg)
        self.guard_state = state


def _state(step, bad, skipped, device) -> GuardState:
    dev = resolve_device(device)
    return GuardState(*(torch.tensor(int(v), dtype=torch.int32, device=dev)
                        for v in (step, bad, skipped)))


class StepGuard:
    """Counts skipped steps on the device; holds the budget on the host."""

    def __init__(self, max_consecutive_bad: int = 10):
        if max_consecutive_bad < 1:
            raise ValueError("max_consecutive_bad must be >= 1")
        self.max_consecutive_bad = int(max_consecutive_bad)

    def init(self, device="cuda") -> GuardState:
        return _state(0, 0, 0, device)

    def update(self, state: GuardState, all_finite_flag) -> GuardState:
        """One step's outcome, branch-free on the device."""
        bad = torch.logical_not(
            torch.as_tensor(all_finite_flag, device=state.step.device).to(torch.bool))
        return GuardState(step=state.step + 1,
                          consecutive_bad=torch.where(bad, state.consecutive_bad + 1, 0),
                          total_skipped=state.total_skipped + bad.to(torch.int32))

    def exhausted(self, state: GuardState) -> torch.Tensor:
        """A 0-d bool on the device: the budget is spent (no host read;
        usable inside a captured step)."""
        return state.consecutive_bad >= self.max_consecutive_bad

    def check(self, state: GuardState) -> GuardState:
        """The host-side budget check: raises :class:`BadStepBudgetExceeded`
        when the run of bad steps reaches the budget, else returns the
        state.  It reads the state, so call it where the loop already
        synchronizes, never inside a captured step."""
        if int(state.consecutive_bad) >= self.max_consecutive_bad:
            _metrics.inc("apex_bad_step_budget_aborts_total",
                         help="runs aborted on the consecutive-bad budget")
            # forensics BEFORE the raise: the abort unwinds to an exit,
            # and the dump is what names the divergence ramp (a no-op
            # without an installed recorder)
            _flightrec.dump_active(
                "step_guard_abort", consecutive_bad=int(state.consecutive_bad),
                total_skipped=int(state.total_skipped), guard_step=int(state.step))
            raise BadStepBudgetExceeded(
                f"{int(state.consecutive_bad)} consecutive non-finite "
                f"steps (budget {self.max_consecutive_bad}); "
                f"{int(state.total_skipped)} skipped of "
                f"{int(state.step)} total — aborting to the last "
                f"checkpoint", state)
        return state

    def state_dict(self, state: GuardState) -> dict:
        return {"step": int(state.step), "consecutive_bad": int(state.consecutive_bad),
                "total_skipped": int(state.total_skipped)}

    def load_state_dict(self, d: Optional[dict], device="cuda") -> GuardState:
        if d is None:
            return self.init(device)
        return _state(d["step"], d["consecutive_bad"], d["total_skipped"], device)
