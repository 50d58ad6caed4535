"""The port's scaled GPT train step (``apex_tpu_torch.train_gpt.
make_train_step(loss_scaler=, step_guard=, clip_grad_norm=)``) against
the JAX package's ``make_train_step`` on a 1-device mesh, on the CPU.

The model and scaler are those of tests/test_fp16_flagship.py: GPT with
4 layers, hidden 32, 4 heads, vocab 64, seq 16, and a
``DynamicLossScaler`` starting at 2**127 (backoff 2**-4, growth interval
3), whose first scaled loss saturates fp32 on both sides.  Params come
from the JAX tree (``params_from_numpy``), tokens from a numpy seed;
FusedAdam(lr=1e-2) on the engine on both sides, a ``StepGuard`` on the
same vote.  Each case runs 6 steps, compiled (the static-buffer path on
the CPU), with and without the folded clip.

- fp16 compute with flash attention at 2**127: every scaled backward
  overflows in fp16 on both sides, so every step is skipped (the scale
  backs off by 2**-4 a step, the Adam counter stays 0, the guard counts
  6 bad steps) and the port's params and optimizer state stay bitwise
  as they were;
- fp16 at the fp16 trainer's 2**12: every step finite, the params move;
- fp32 compute: the flagship scaler started at 2**126.  At 2**127 the
  gradients stay finite (the loss saturates, its gradient does not), and
  1/2**127 is an fp32 subnormal: XLA on the CPU flushes it to 0, as a
  TPU does, so the JAX step applies zero gradients, where the port keeps
  2**-127 as apex's CUDA unscale does (tests/test_torch_amp.py holds
  both facts).  At 2**126 the first loss still saturates (its loss is
  above 4), the inverse is normal, and the two agree; the scale grows
  after 3 finite steps, clamped to the 2**24 maximum.

Held equal: the scale after every step, which losses are inf, the
scaler's tracker and hysteresis, the Adam step counter and the guard
state.  Bands on the finite losses: fp32 compute, 1e-5 relative (fp32
on both sides, sums in other orders), as tests/test_torch_gpt_training.py
holds its Adam trajectory; fp16 compute, 2e-3 relative: the port takes
the attention's delta from the fp16 output where the reference takes it
from the fp32 one, and the two frameworks round fp16 matmuls in other
orders (fp16's unit roundoff is 2**-11; 4 layers, 6 Adam steps).  The
params are compared through the losses: Adam turns the rounding noise of
a gradient that is 0 in exact arithmetic (the key bias) into steps of
+-lr, different on the two sides.  A skipped step is held exactly: the
port's params and Adam moments stay bitwise as loaded.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from apex_tpu.amp import DynamicLossScaler as JaxScaler
from apex_tpu.models import gpt as jgpt
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.resilience import StepGuard as JaxStepGuard

from apex_tpu_torch import train_gpt
from apex_tpu_torch.amp import DynamicLossScaler
from apex_tpu_torch.graphs import CapturedStep
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers.base import tree_leaves
from apex_tpu_torch.resilience import StepGuard

STEPS = 6
TINY = dict(vocab_size=64, hidden_size=32, num_layers=4, num_attention_heads=4,
            max_seq_len=16, checkpoint_layers=True, use_flash_attention=True)
BAND = {"float32": 1e-5, "float16": 2e-3}
#: tests/test_fp16_flagship.py make_scaler's settings
FLAGSHIP = dict(init_scale=2.0 ** 127, backoff_factor=2.0 ** -4, growth_factor=2.0,
                growth_interval=3, hysteresis=1)


def _batch(batch=4, seed=0):
    tok = np.random.RandomState(seed).randint(0, TINY["vocab_size"], size=(batch, 16))
    return tok, np.roll(tok, -1, axis=1)


def _jax_run(dtype, scaler_kw, clip):
    config = jgpt.GPTConfig(**TINY, compute_dtype=getattr(jnp, dtype))
    params = jgpt.init_params(config, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    opt, scaler, guard = JaxFusedAdam(lr=1e-2), JaxScaler(**scaler_kw), JaxStepGuard(3)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    step = jgpt.make_train_step(config, opt, mesh, loss_scaler=scaler, step_guard=guard,
                                clip_grad_norm=clip)
    state, sstate, gstate = opt.init(params), scaler.init(), guard.init()
    tok, tgt = (jnp.asarray(a) for a in _batch())
    losses, scales = [], []
    for _ in range(STEPS):
        params, state, sstate, gstate, loss = step(params, state, sstate, gstate, tok, tgt)
        losses.append(float(loss))
        scales.append(float(sstate.loss_scale))
    return tree, {
        "losses": losses, "scales": scales, "adam_step": int(state.step),
        "tracker": int(sstate.growth_tracker), "hysteresis": int(sstate.hysteresis),
        "guard": guard.state_dict(gstate)}


def _port_run(tree, dtype, scaler_kw, clip):
    config = tgpt.GPTConfig(**TINY, compute_dtype=getattr(torch, dtype))
    params = tgpt.params_from_numpy(tree, config, device="cpu", keep_fp32=True)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt, scaler, guard = FusedAdam(lr=1e-2), DynamicLossScaler(**scaler_kw), StepGuard(3)
    step = train_gpt.make_train_step(opt, config, loss_scaler=scaler, step_guard=guard,
                                     clip_grad_norm=clip)
    assert isinstance(step, CapturedStep)
    state, sstate, gstate = opt.init(params), scaler.init("cpu"), guard.init("cpu")
    tok, tgt = (torch.from_numpy(a) for a in _batch())
    losses, scales = [], []
    for _ in range(STEPS):
        losses.append(float(step(params, state, sstate, gstate, tok, tgt)))
        scales.append(float(sstate.loss_scale))
    return {
        "losses": losses, "scales": scales, "adam_step": int(state.step),
        "tracker": int(sstate.growth_tracker), "hysteresis": int(sstate.hysteresis),
        "guard": guard.state_dict(gstate),
        "params": [p.detach().numpy() for p in tree_leaves(params)],
        "opt_zero": all(not t.any() for t in tree_leaves((state.exp_avg, state.exp_avg_sq)))}


def _compare(got, want, band):
    # the scaler's and the guard's decisions are discrete: equal
    assert got["scales"] == want["scales"]
    assert (got["tracker"], got["hysteresis"]) == (want["tracker"], want["hysteresis"])
    assert got["adam_step"] == want["adam_step"]
    assert got["guard"] == want["guard"]
    for g, w in zip(got["losses"], want["losses"], strict=True):
        assert math.isinf(g) == math.isinf(w)
        if not math.isinf(w):
            assert abs(g - w) <= band * abs(w), (got["losses"], want["losses"])


@pytest.mark.parametrize("clip", [None, 1.0], ids=["no_clip", "clip"])
def test_fp16_overflow_steps_match_jax_and_change_nothing(clip):
    tree, want = _jax_run("float16", FLAGSHIP, clip)
    got = _port_run(tree, "float16", FLAGSHIP, clip)
    _compare(got, want, BAND["float16"])
    assert want["scales"] == [2.0 ** (127 - 4 * (i + 1)) for i in range(STEPS)]
    assert math.isinf(want["losses"][0]) and not math.isinf(want["losses"][1])
    assert want["adam_step"] == 0
    assert want["guard"] == {"step": STEPS, "consecutive_bad": STEPS, "total_skipped": STEPS}
    # a skipped step writes back what it read: the params bitwise as loaded
    start = [np.asarray(a, np.float32) for a in jax.tree.leaves(tree)]
    for g, p0 in zip(got["params"], start, strict=True):
        assert np.array_equal(g, p0)
    assert got["opt_zero"]


@pytest.mark.parametrize("clip", [None, 1.0], ids=["no_clip", "clip"])
def test_fp32_scaled_step_matches_jax_make_train_step(clip):
    kw = {**FLAGSHIP, "init_scale": 2.0 ** 126}
    tree, want = _jax_run("float32", kw, clip)
    got = _port_run(tree, "float32", kw, clip)
    _compare(got, want, BAND["float32"])
    # the first scaled loss saturates; three finite steps grow the scale,
    # clamped to max_scale
    assert math.isinf(want["losses"][0]) and want["adam_step"] == STEPS
    assert want["scales"][2:] == [2.0 ** 24] * (STEPS - 2)


@pytest.mark.parametrize("clip", [None, 1.0], ids=["no_clip", "clip"])
def test_fp16_step_at_the_trainer_scale_matches_jax(clip):
    """fp16 compute at the fp16 trainer's 2**12 scale: every step finite
    on both sides, the params moving, the losses within the fp16 band."""
    kw = {"init_scale": 2.0 ** 12}
    tree, want = _jax_run("float16", kw, clip)
    got = _port_run(tree, "float16", kw, clip)
    _compare(got, want, BAND["float16"])
    assert want["adam_step"] == STEPS and want["scales"] == [2.0 ** 12] * STEPS
    assert want["losses"][-1] < want["losses"][0]


# ------------------------------------------------------------- the CLI
ARGV = ["--device", "cpu", "--layers", "2", "--hidden", "64", "--heads", "4", "--vocab", "128",
        "--seq", "32", "--batch", "2", "--steps", "2"]


@pytest.mark.parametrize("extra", [[], ["--step-guard", "3", "--clip-grad-norm", "1.0"],
                                   ["--eager"]], ids=["fp16", "guard_clip", "eager"])
def test_train_gpt_fp16_on_the_cpu(capsys, extra):
    assert train_gpt.main(ARGV + ["--fp16"] + extra) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["compute_dtype"] == "float16"
    assert out["loss_scale"] == [train_gpt.FP16_INIT_SCALE] * 3
    assert out["skipped_steps"] == 0 and out["losses"][-1] < out["losses"][0]
    if "--step-guard" in extra:
        assert out["step_guard"] == {"step": 3, "consecutive_bad": 0, "total_skipped": 0}
        assert out["clip_grad_norm"] == 1.0
    else:
        assert out["step_guard"] is None


def test_train_gpt_fp16_refuses_the_fused_head_and_the_cpu_default():
    with pytest.raises(NotImplementedError, match="fused-CE kernels take float32 or bfloat16"):
        train_gpt.main(ARGV + ["--fp16", "--fused-ce", "--fused-ce-chunk", "8"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_gpt.main(["--fp16", "--layers", "1", "--hidden", "32", "--heads", "4",
                            "--vocab", "64"])


class _NoFusedAdam(FusedAdam):
    """FusedAdam without the fused amp pass: the explicit unscale, vote
    and ``update(grads_finite=)`` path of the scaled step."""

    supports_update_scaled = False


def test_explicit_unscale_path_equals_the_fused_pass():
    """The scaled step with an optimizer that has no ``update_scaled``
    against the engine's fused pass: the same losses and scales bitwise
    (the same fp32 products), an overflow step included; a clip needs the
    fused pass and is refused without it."""
    runs = []
    for cls in (FusedAdam, _NoFusedAdam):
        config = tgpt.GPTConfig(**TINY, compute_dtype=torch.float16)
        tree = jax.tree.map(np.asarray, jgpt.init_params(
            jgpt.GPTConfig(**TINY), jax.random.PRNGKey(0)))
        params = tgpt.params_from_numpy(tree, config, device="cpu", keep_fp32=True)
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        opt, scaler = cls(lr=1e-2), DynamicLossScaler(init_scale=2.0 ** 40,
                                                       backoff_factor=2.0 ** -24)
        step = train_gpt.make_train_step(opt, config, loss_scaler=scaler)
        state, sstate = opt.init(params), scaler.init("cpu")
        tok, tgt = (torch.from_numpy(a) for a in _batch())
        out = [(float(step(params, state, sstate, tok, tgt)), float(sstate.loss_scale))
               for _ in range(3)]
        runs.append((out, int(state.step), [p.detach().clone() for p in tree_leaves(params)]))
    (fused, n_fused, p_fused), (explicit, n_explicit, p_explicit) = runs
    assert fused == explicit and n_fused == n_explicit == 2
    assert fused[0][1] == 2.0 ** 16  # the first step overflowed in the fp16 backward
    assert all(torch.equal(a, b) for a, b in zip(p_fused, p_explicit))
    with pytest.raises(ValueError, match="engine optimizer"):
        train_gpt.make_train_step(_NoFusedAdam(lr=1e-2), config, clip_grad_norm=1.0)
