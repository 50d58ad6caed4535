"""The port's step guard (``apex_tpu_torch.resilience.step_guard``) and
model-parallel grad scaler (``apex_tpu_torch.transformer.amp.
grad_scaler``) against the JAX package's, on the CPU.

- ``StepGuard.update`` over one sequence of finite flags: every state
  equal to JAX's (0-d int32 tensors), ``exhausted`` equal at each step;
- ``check`` returns the state below the budget and raises
  ``BadStepBudgetExceeded`` at it, with JAX's message and the state
  attached; a budget below 1 is refused;
- the state dict round trip, and ``load_state_dict(None)`` as ``init``;
- ``sync_found_inf`` with no process groups returns the vote as given
  (JAX's with no mesh axes agrees); ``GradScaler`` unscales as
  ``DynamicLossScaler`` does and takes the same settings.

All exact: the guard and the vote are integer and boolean state.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.resilience.step_guard import (
    BadStepBudgetExceeded as JaxBudgetExceeded,
    StepGuard as JaxStepGuard,
)
from apex_tpu.transformer.amp.grad_scaler import sync_found_inf as jax_sync_found_inf

from apex_tpu_torch.amp import DynamicLossScaler
from apex_tpu_torch.resilience import BadStepBudgetExceeded, GuardState, StepGuard
from apex_tpu_torch.transformer.amp import GradScaler
from apex_tpu_torch.transformer.amp.grad_scaler import sync_found_inf

FLAGS = [True, False, False, True, False, False, False, True, True, False]


def _tuple(state):
    return tuple(int(np.asarray(v)) for v in state)


@pytest.mark.parametrize("budget", [1, 3, 10])
def test_update_and_exhausted_match_jax(budget):
    tg, jg = StepGuard(budget), JaxStepGuard(budget)
    ts, js = tg.init("cpu"), jg.init()
    assert all(t.dtype == torch.int32 and t.dim() == 0 for t in ts)
    for flag in FLAGS:
        ts, js = tg.update(ts, torch.tensor(flag)), jg.update(js, jnp.bool_(flag))
        assert _tuple(ts) == _tuple(js)
        assert bool(tg.exhausted(ts)) == bool(jg.exhausted(js))
    assert _tuple(ts) == (len(FLAGS), 1, FLAGS.count(False))


def test_check_raises_at_the_budget_with_the_reference_message():
    tg, jg = StepGuard(3), JaxStepGuard(3)
    ts, js = tg.init("cpu"), jg.init()
    for flag in (True, False, False):
        ts, js = tg.update(ts, torch.tensor(flag)), jg.update(js, jnp.bool_(flag))
    assert tg.check(ts) is ts
    ts, js = tg.update(ts, torch.tensor(False)), jg.update(js, jnp.bool_(False))
    with pytest.raises(BadStepBudgetExceeded) as got:
        tg.check(ts)
    with pytest.raises(JaxBudgetExceeded) as want:
        jg.check(js)
    assert str(got.value) == str(want.value)
    assert "3 consecutive non-finite steps (budget 3)" in str(got.value)
    assert isinstance(got.value, RuntimeError) and got.value.guard_state is ts
    with pytest.raises(ValueError, match="max_consecutive_bad"):
        StepGuard(0)


def test_state_dict_round_trip():
    tg, jg = StepGuard(5), JaxStepGuard(5)
    ts, js = tg.init("cpu"), jg.init()
    for flag in FLAGS[:6]:
        ts, js = tg.update(ts, torch.tensor(flag)), jg.update(js, jnp.bool_(flag))
    d = tg.state_dict(ts)
    assert d == jg.state_dict(js) == {"step": 6, "consecutive_bad": 2, "total_skipped": 4}
    back = tg.load_state_dict(d, "cpu")
    assert isinstance(back, GuardState) and _tuple(back) == _tuple(jg.load_state_dict(d))
    assert _tuple(tg.load_state_dict(None, "cpu")) == (0, 0, 0)


@pytest.mark.parametrize("flag", [True, False])
def test_sync_found_inf_without_groups_is_the_vote(flag):
    vote = torch.tensor(flag)
    assert sync_found_inf(vote) is vote and sync_found_inf(vote, ()) is vote
    assert bool(jax_sync_found_inf(jnp.bool_(flag), ())) == flag


def test_grad_scaler_is_the_dynamic_scaler_with_a_synced_vote():
    kw = dict(init_scale=2.0 ** 8, growth_interval=2, hysteresis=2)
    gs, ds = GradScaler(**kw), DynamicLossScaler(**kw)
    assert gs.model_parallel_groups == ()
    grads = {"w": torch.tensor([1.0, 2.0, float("inf")]), "b": torch.ones(2)}
    (g_out, g_fin), (d_out, d_fin) = (s.unscale(s.init("cpu"), grads) for s in (gs, ds))
    assert bool(g_fin) == bool(d_fin) is False
    assert all(torch.equal(a, b) for a, b in zip(g_out.values(), d_out.values()))
    state = gs.init("cpu")
    for flag in (True, False, False, True, True):
        state = gs.update(state, torch.tensor(flag))
    assert (float(state.loss_scale), int(state.growth_tracker), int(state.hysteresis)) == (
        256.0, 0, 2)
