"""The train step's other options on the CPU: ``remat_policy="dots"``,
``flash_attention(attn_bias=)`` and the in-place (donated) update.

- **Remat**: none, full and dots give the same loss and gradients in the
  port, and each agrees with the JAX package's ``gpt_loss`` under the
  same policy (``tests/test_gpt.py::test_remat_policies_same_loss_and_grads``'s
  model and bands: loss rtol 1e-6, grads rtol 1e-5 and atol 1e-6).  A
  count of the selective policy's decisions shows that dots saves exactly
  the ``aten.mm`` / ``aten.addmm`` outputs, six a layer (q, k, v, out,
  fc1, fc2), and recomputes the batched ``aten.bmm`` of the einsum path.
- **attn_bias**: the three bias shapes of ``tests/test_attention.py``
  (``TestAttnBias``), its gradient and its composition with ``kv_mask``,
  against JAX's scan path: forward rtol 1e-4 and atol 1e-5, gradient
  rtol 2e-4 and atol 2e-5 (that file's bands); a biased call never
  reaches the flash kernels' wrappers and an unbiased one never reaches
  the scan Function.
- **In place**: ``make_train_step``'s donated update (the optimizer
  writes into the params and state it was given) against the copying
  step (``inplace_update=False``), losses and every param and state
  tensor bitwise, for FusedAdam (its ``mt_adam`` writes over what it
  reads; fp32, bf16 compute with the fp16 scaler and a guard, resident
  buckets and a master), the optimizers that copy their results in
  (LAMB, SGD), and the ZeRO optimizers at world 1 (Adam with the fp32
  master, remainders and the int8 wire; LAMB); the functional
  ``update`` still returns new tensors and leaves its inputs alone.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.models import gpt as jgpt
from apex_tpu.ops import attention as jatt

from apex_tpu_torch import train_gpt
from apex_tpu_torch.models import _remat
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.ops import attention as tatt
from apex_tpu_torch.ops import flash_attention as tfa
from apex_tpu_torch.graphs import tensor_leaves as state_tensors
from apex_tpu_torch.optimizers.base import tree_leaves

#: tests/test_gpt.py's CFG
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_attention_heads=4, max_seq_len=16)


def _batch():
    tokens = np.random.RandomState(0).randint(0, CFG["vocab_size"], size=(2, 16))
    return tokens, np.roll(tokens, -1, axis=1)


REMAT = {"none": {"checkpoint_layers": False},
         "full": {"checkpoint_layers": True, "remat_policy": "full"},
         "dots": {"checkpoint_layers": True, "remat_policy": "dots"}}


@pytest.mark.parametrize("flash", [False, True])
def test_remat_policies_against_each_other_and_jax(flash, monkeypatch):
    decisions, policy = [], _remat.dots_policy

    def recording(ctx, op, *args, **kwargs):
        d = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decisions.append((str(op), d))
        return d

    monkeypatch.setattr(_remat, "dots_policy", recording)
    tokens, targets = _batch()
    jp = jgpt.init_params(jgpt.GPTConfig(**CFG, compute_dtype=jnp.float32),
                          jax.random.PRNGKey(0))
    out = {}
    for name, kw in REMAT.items():
        jcfg = jgpt.GPTConfig(**CFG, compute_dtype=jnp.float32, use_flash_attention=flash, **kw)
        tcfg = tgpt.GPTConfig(**CFG, compute_dtype=torch.float32, use_flash_attention=flash,
                              **kw)
        tp = tgpt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", keep_fp32=True)
        decisions.clear()
        loss, grads = train_gpt.loss_and_grads(tp, torch.from_numpy(tokens),
                                               torch.from_numpy(targets), tcfg)
        out[name] = (float(loss), [g.numpy() for g in tree_leaves(grads)])
        jloss, jgrads = jax.value_and_grad(jgpt.gpt_loss)(jp, jnp.asarray(tokens),
                                                          jnp.asarray(targets), jcfg)
        assert np.isclose(out[name][0], float(jloss), rtol=1e-6), name
        for g, w in zip(out[name][1], jax.tree.leaves(jgrads), strict=True):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)
        if name == "dots":
            saved = [op for op, d in decisions if d == _remat.CheckpointPolicy.MUST_SAVE]
            assert len(saved) == 6 * CFG["num_layers"], saved
            assert set(saved) <= {"aten.mm.default", "aten.addmm.default"}
            assert any("bmm" in op for op, _ in decisions)  # seen and recomputed
    for name in ("full", "dots"):
        assert np.isclose(out[name][0], out["none"][0], rtol=1e-6), name
        for a, b in zip(out[name][1], out["none"][1], strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def _qkv(seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(2, 3, 32, 16).astype(np.float32) for _ in range(3))


def _biased_ref(q, k, v, bias):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1]) + bias
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


@pytest.fixture
def no_flash_kernels(monkeypatch):
    """The flash kernels' wrappers, made to fail if a call reaches them."""
    def refuse(*args, **kwargs):
        raise AssertionError("a biased call reached the flash kernels")

    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        monkeypatch.setattr(tfa, name, refuse)


@pytest.mark.parametrize("bias_shape", [(2, 3, 32, 32), (1, 3, 32, 32), (2, 1, 1, 32)])
def test_attn_bias_forward_against_jax(bias_shape, no_flash_kernels):
    q, k, v = _qkv(12)
    bias = np.random.RandomState(13).randn(*bias_shape).astype(np.float32)
    want = jatt.flash_attention(*map(jnp.asarray, (q, k, v)), causal=False,
                                attn_bias=jnp.asarray(bias), impl="scan", block_k=8)
    got = tatt.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                               attn_bias=torch.from_numpy(bias), block_k=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    ref = _biased_ref(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bias_shape", [(2, 3, 32, 32), (1, 1, 32, 32), (2, 1, 1, 32)])
def test_attn_bias_gradient_against_jax(bias_shape, no_flash_kernels):
    q, k, v = _qkv(14)
    bias = np.random.RandomState(15).randn(*bias_shape).astype(np.float32)

    def f(b):
        o = jatt.flash_attention(*map(jnp.asarray, (q, k, v)), causal=False, attn_bias=b,
                                 impl="scan", block_k=16)
        return jnp.sum(jnp.sin(o))

    want = jax.grad(f)(jnp.asarray(bias))
    tb = torch.from_numpy(bias).requires_grad_(True)
    tq = torch.from_numpy(q).requires_grad_(True)
    o = tatt.flash_attention(tq, *map(torch.from_numpy, (k, v)), causal=False, attn_bias=tb,
                             block_k=16)
    torch.sin(o).sum().backward()
    assert tb.grad.shape == bias.shape and tb.grad.dtype == torch.float32
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    jdq = jax.grad(lambda x: jnp.sum(jnp.sin(jatt.flash_attention(
        x, *map(jnp.asarray, (k, v)), causal=False, attn_bias=jnp.asarray(bias), impl="scan",
        block_k=16))))(jnp.asarray(q))
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jdq), rtol=2e-4, atol=2e-5)


def test_attn_bias_composes_with_padding_mask(no_flash_kernels):
    q, k, v = _qkv(16)
    bias = np.random.RandomState(17).randn(2, 3, 32, 32).astype(np.float32)
    mask = np.ones((2, 32), bool)
    mask[1, 20:] = False
    want = jatt.flash_attention(*map(jnp.asarray, (q, k, v)), causal=False,
                                attn_bias=jnp.asarray(bias), kv_mask=jnp.asarray(mask),
                                impl="scan")
    got = tatt.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                               attn_bias=torch.from_numpy(bias),
                               kv_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_unbiased_call_stays_on_the_flash_kernels(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("an unbiased call reached the scan Function")

    monkeypatch.setattr(tatt.ScanAttention, "apply", refuse)
    calls = []
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        orig = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _o=orig, _n=name, **kw: (
            calls.append(_n), _o(*a, **kw))[1])
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _qkv(18))
    tatt.flash_attention(q, k, v, causal=True).sum().backward()
    assert calls == ["flash_fwd", "flash_dq", "flash_dkv"]


# ------------------------------------------------------------- in place
TRAIN = ["--device", "cpu", "--layers", "2", "--hidden", "64", "--heads", "4", "--vocab",
         "128", "--seq", "32", "--batch", "2", "--compute-dtype", "float32"]


def _run_step(make_opt, inplace, steps=2, fp16=False, guard=False, bucketed=False,
              zero=False, bf16=False):
    from apex_tpu_torch.amp.scaler import DynamicLossScaler
    from apex_tpu_torch.optimizers.tree import tree_map
    from apex_tpu_torch.resilience.step_guard import StepGuard

    args = train_gpt.build_args().parse_args(TRAIN + (["--fp16"] if fp16 else []))
    config, params, tokens, targets = train_gpt.setup(args)
    if bf16:
        params = tree_map(lambda t: t.to(torch.bfloat16), params)
    opt = make_opt()
    if zero:
        from apex_tpu_torch.transformer import parallel_state as ps

        state, dp = opt.init(params), ps.get_data_parallel_group()
    else:
        state = opt.init(params, bucketed=True) if bucketed else opt.init(params)
        dp = None
    scaler = DynamicLossScaler(init_scale=2.0 ** 12) if fp16 else None
    sg = StepGuard(max_consecutive_bad=3) if guard else None
    small = ([scaler.init("cpu")] if scaler else []) + ([sg.init("cpu")] if sg else [])
    before = [t.data_ptr() for t in state_tensors((params, state))]
    step = train_gpt.make_train_step(opt, config, loss_scaler=scaler, step_guard=sg,
                                     graphs=False, dp_group=dp, inplace_update=inplace)
    losses = [float(step(params, state, *small, tokens, targets)) for _ in range(steps)]
    assert [t.data_ptr() for t in state_tensors((params, state))] == before
    return losses, [t.clone() for t in state_tensors((params, state, *small))]


def _opt(name, **kw):
    def make():
        from apex_tpu_torch import optimizers

        return getattr(optimizers, name)(**kw)

    return make


def _zero(name, **kw):
    def make():
        from apex_tpu_torch.contrib import optimizers

        return getattr(optimizers, name)(lr=1e-3, weight_decay=0.01, bucket_cap_mb=0.05, **kw)

    return make


#: case -> (optimizer factory, _run_step's options)
IN_PLACE = {
    "fused_adam": (_opt("FusedAdam", lr=1e-3, weight_decay=0.1), {}),
    "fused_adam_fp16_guard": (_opt("FusedAdam", lr=1e-3, weight_decay=0.1),
                              {"fp16": True, "guard": True}),
    "fused_adam_buckets_master": (_opt("FusedAdam", lr=1e-3, master_weights=True),
                                  {"bucketed": True}),
    "fused_lamb": (_opt("FusedLAMB", lr=1e-3, weight_decay=0.01), {}),
    "fused_sgd": (_opt("FusedSGD", lr=1e-2, momentum=0.9), {}),
    "zero_adam": (_zero("DistributedFusedAdam"), {"zero": True}),
    "zero_adam_remainders": (_zero("DistributedFusedAdam", store_param_remainders=True),
                             {"zero": True, "bf16": True}),
    "zero_adam_int8_fp16": (_zero("DistributedFusedAdam", grad_sync_dtype="int8"),
                            {"zero": True, "fp16": True}),
    "zero_lamb": (_zero("DistributedFusedLAMB"), {"zero": True}),
}


@pytest.fixture
def group1():
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    multiproc.initialize_distributed("cpu")
    yield ps.initialize_model_parallel()
    multiproc.destroy_distributed()


@pytest.mark.parametrize("case", list(IN_PLACE))
def test_in_place_step_bitwise_against_copying(case, request):
    make_opt, kw = IN_PLACE[case]
    if kw.get("zero"):
        request.getfixturevalue("group1")
    l_in, t_in = _run_step(make_opt, True, **kw)
    l_copy, t_copy = _run_step(make_opt, False, **kw)
    assert l_in == l_copy and all(np.isfinite(l_in))
    for a, b in zip(t_in, t_copy, strict=True):
        assert torch.equal(a, b), case


def test_functional_update_returns_new_tensors():
    from apex_tpu_torch.optimizers import FusedAdam

    opt = FusedAdam(lr=1e-3)
    params = {"w": torch.randn(5, 3), "b": torch.randn(3)}
    state = opt.init(params)
    grads = {k: torch.randn_like(v) for k, v in params.items()}
    keep = [t.clone() for t in state_tensors((params, state))]
    new_p, new_s = opt.update(grads, state, params)
    assert all(a is not b for a, b in zip(state_tensors((new_p, new_s)),
                                          state_tensors((params, state))))
    assert all(torch.equal(a, b) for a, b in zip(state_tensors((params, state)), keep))
    same_p, same_s = opt.update(grads, state, params, inplace=True)
    assert same_p is params and same_s is state
    for a, b in zip(state_tensors((params, state)), state_tensors((new_p, new_s))):
        assert torch.equal(a, b)
