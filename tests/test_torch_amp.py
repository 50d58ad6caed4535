"""The port's amp (``apex_tpu_torch.amp``), ``fp16_utils`` and the fp16
plain versions of the LayerNorm and flash kernels, against the JAX
package on the CPU.

- ``DynamicLossScaler.update`` over one fixed sequence of finite flags
  (backoff, hysteresis above 1, growth, the min and max clamps) at three
  settings: every state equal to JAX's, step for step;
- ``scale``, ``unscale`` (the grads bitwise equal, the vote equal),
  ``StaticLossScaler``, ``all_finite`` and the ``state_dict`` round
  trips; the inverse of a scale above 2**126 (an fp32 subnormal) kept
  by the port, as apex's CUDA unscale keeps it, where XLA on the CPU
  flushes it to 0;
- ``get_policy`` at O0–O3 for bf16 and fp16, and ``cast_params``' leaf
  dtypes on the GPT param tree, equal to JAX's;
- ``amp.value_and_grad`` on a small function, finite and overflowing:
  the loss and grads within 1e-6 relative (fp32 on both sides), the
  scaler state and the vote equal; ``initialize``, ``state_dict``,
  ``load_state_dict`` and ``master_params``;
- the decorators and the registry (output dtypes equal, with
  ``disable_casts`` and ``set_half_dtype``), and ``init``;
- ``fp16_utils``: the conversions (dtypes and values equal) and
  ``FP16_Optimizer`` over three steps with an overflow: params within
  one fp16 step, the scaler state equal;
- the export lists of ``amp``, ``fp16_utils``,
  ``transformer.amp.grad_scaler`` and ``resilience.step_guard`` equal
  to their JAX counterparts';
- fp16 plain versions: LayerNorm (affine with bias, RMS affine) forward
  and gradients against ``jax.vjp`` of the JAX package's functions in
  fp16 (its jnp path): y and dx within one fp16 step of JAX's (the fp32
  values before the rounding differ by ulps), dw and db within 1e-5 of
  their scale; flash attention forward and backward against the JAX
  scan (``impl="scan"``, the reference's fp16 path) through ``jax.vjp``:
  out within one fp16 step, dq, dk and dv within 2**-10 of their largest
  magnitude: the port's delta is rowsum(do * out) from the fp16 out, the
  reference's from the fp32 one (2**-11 relative each), the rest fp32 in
  both.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import apex_tpu.amp as jamp
import apex_tpu.fp16_utils as jfp16
from apex_tpu.models import gpt as jgpt
from apex_tpu.normalization import fused_layer_norm_affine as jax_ln
from apex_tpu.normalization import fused_rms_norm_affine as jax_rms
from apex_tpu.ops.attention import flash_attention as jax_flash
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
import apex_tpu.resilience.step_guard as jguard
import apex_tpu.transformer.amp.grad_scaler as jgrad_scaler

import apex_tpu_torch.amp as tamp
import apex_tpu_torch.fp16_utils as tfp16
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.normalization import fused_layer_norm_affine, fused_rms_norm_affine
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers.tree import leaves_with_path, tree_leaves
import apex_tpu_torch.resilience.step_guard as tguard
import apex_tpu_torch.transformer.amp.grad_scaler as tgrad_scaler

#: the finite flags of the scaler trajectory: growth, a backoff, runs of
#: overflows long enough to spend hysteresis 3 and reach the min clamp,
#: runs of finite steps long enough to reach the max clamp
FLAGS = ([True] * 5 + [False] + [True] * 2 + [False] * 3 + [True] * 7 + [False] * 9
         + [True] * 24 + [False, True, False, False, True])
SCALER_SETTINGS = [
    dict(init_scale=2.0 ** 4, growth_interval=3, hysteresis=1, min_scale=1.0,
         max_scale=2.0 ** 6),
    dict(init_scale=2.0 ** 10, growth_interval=2, hysteresis=3, backoff_factor=0.25,
         growth_factor=4.0, min_scale=2.0 ** 7, max_scale=2.0 ** 12),
    dict(),  # the defaults
]


def _name(dtype):
    """A dtype's name, for either framework."""
    return str(dtype).replace("torch.", "") if isinstance(dtype, torch.dtype) else \
        np.dtype(dtype).name


def _scaler_tuple(state):
    return tuple(float(np.asarray(v)) for v in state)


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


# ------------------------------------------------------------- the scaler
@pytest.mark.parametrize("kw", SCALER_SETTINGS, ids=["clamps", "hysteresis3", "defaults"])
def test_dynamic_update_matches_jax_step_for_step(kw):
    js, ts = jamp.DynamicLossScaler(**kw), tamp.DynamicLossScaler(**kw)
    jst, tst = js.init(), ts.init("cpu")
    assert _scaler_tuple(tst) == _scaler_tuple(jst)
    assert (tst.loss_scale.dtype, tst.growth_tracker.dtype, tst.hysteresis.dtype) == (
        torch.float32, torch.int32, torch.int32)
    seen = set()
    for flag in FLAGS:
        jst = js.update(jst, jnp.bool_(flag))
        tst = ts.update(tst, torch.tensor(flag))
        assert _scaler_tuple(tst) == _scaler_tuple(jst), flag
        seen.add(float(tst.loss_scale))
    if kw:  # both clamps were reached
        assert kw["min_scale"] in seen and kw["max_scale"] in seen


def test_scale_and_unscale_match_jax():
    rng = np.random.RandomState(0)
    grads = {"w": rng.randn(5, 3).astype(np.float32) * 1e3,
             "b": [rng.randn(7).astype(np.float32)]}
    js, ts = jamp.DynamicLossScaler(init_scale=2.0 ** 10), tamp.DynamicLossScaler(
        init_scale=2.0 ** 10)
    jst, tst = js.init(), ts.init("cpu")
    assert float(ts.scale(tst, torch.tensor(3.5))) == float(js.scale(jst, jnp.float32(3.5)))
    for bad in (None, np.inf, np.nan):
        g = {"w": grads["w"].copy(), "b": [grads["b"][0].copy()]}
        if bad is not None:
            g["w"][2, 1] = bad
        jout, jfin = js.unscale(jst, jax.tree.map(jnp.asarray, g))
        tout, tfin = ts.unscale(tst, {"w": _t(g["w"]), "b": [_t(g["b"][0])]})
        assert bool(tfin) == bool(jfin) == (bad is None)
        for a, b in zip(tree_leaves(tout), jax.tree.leaves(jout)):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_unscale_keeps_a_subnormal_inverse():
    """At a scale of 2**127 the inverse, 2**-127, is an fp32 subnormal:
    the port keeps it, so a gradient scaled by 2**127 comes back exact
    (apex's CUDA unscale does the same); XLA on the CPU flushes the
    inverse to 0, as a TPU does, and its unscaled gradient is 0."""
    g = np.float32(0.75) * np.float32(2.0 ** 127)
    ts, js = tamp.DynamicLossScaler(init_scale=2.0 ** 127), jamp.DynamicLossScaler(
        init_scale=2.0 ** 127)
    tout, _ = ts.unscale(ts.init("cpu"), [torch.tensor(g)])
    jout, _ = js.unscale(js.init(), [jnp.float32(g)])
    assert float(tout[0]) == 0.75
    assert float(jout[0]) == 0.0


def test_static_scaler_all_finite_and_state_dicts():
    for scaler_t, scaler_j in ((tamp.StaticLossScaler(8.0), jamp.StaticLossScaler(8.0)),
                               (tamp.DynamicLossScaler(hysteresis=2),
                                jamp.DynamicLossScaler(hysteresis=2))):
        tst, jst = scaler_t.init("cpu"), scaler_j.init()
        assert _scaler_tuple(tst) == _scaler_tuple(jst)
        for flag in (False, True, False):
            tst = scaler_t.update(tst, torch.tensor(flag))
            jst = scaler_j.update(jst, jnp.bool_(flag))
        d = scaler_t.state_dict(tst)
        assert d == scaler_j.state_dict(jst)
        assert _scaler_tuple(scaler_t.load_state_dict(d, "cpu")) == _scaler_tuple(
            scaler_j.load_state_dict(d))
    assert tamp.StaticLossScaler(8.0).update("state", False) == "state"
    trees = [{"a": np.ones(3, np.float32), "b": [np.zeros((2, 2), np.float32)]},
             {"a": np.array([1.0, np.inf], np.float32)},
             {"a": np.array([np.nan], np.float32), "i": np.arange(3)}, {}]
    for tree in trees:
        want = bool(jamp.all_finite(jax.tree.map(jnp.asarray, tree)))
        got = tamp.all_finite({k: torch.from_numpy(np.asarray(v)) if not isinstance(v, list)
                               else [torch.from_numpy(x) for x in v] for k, v in tree.items()})
        assert bool(got) == want


# ------------------------------------------------------------- the policy
@pytest.mark.parametrize("half", ["bfloat16", "float16", None])
@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_policy_matches_jax(level, half):
    jp = jamp.get_policy(level, half_dtype=None if half is None else getattr(jnp, half))
    tp = tamp.get_policy(level, half_dtype=None if half is None else getattr(torch, half))
    for field in ("param_dtype", "compute_dtype"):
        a, b = getattr(tp, field), getattr(jp, field)
        assert (a is None) == (b is None) and (a is None or _name(a) == _name(b)), field
    for field in ("opt_level", "keep_norm_fp32", "master_weights", "loss_scale",
                  "uses_loss_scaling"):
        assert getattr(tp, field) == getattr(jp, field), field
    assert tamp.get_policy(level, loss_scale=128.0).loss_scale == jamp.get_policy(
        level, loss_scale=128.0).loss_scale
    with pytest.raises(ValueError, match="optimization level"):
        tamp.get_policy("O4")


@pytest.fixture(scope="module")
def gpt_trees():
    """The GPT param tree of both packages (fp32), from one JAX init."""
    base = dict(vocab_size=64, hidden_size=32, num_layers=2, num_attention_heads=4,
                max_seq_len=16)
    jp = jgpt.init_params(jgpt.GPTConfig(**base), jax.random.PRNGKey(0))
    tp = tgpt.params_from_numpy(jax.tree.map(np.asarray, jp), tgpt.GPTConfig(**base),
                                device="cpu", keep_fp32=True)
    return jp, tp


def _dtypes_by_path(tree):
    if isinstance(next(iter(tree_leaves(tree)), None), torch.Tensor):
        return {p: _name(x.dtype) for p, x in leaves_with_path(tree)}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(k): _name(x.dtype) for k, x in flat}


@pytest.mark.parametrize("half", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_cast_params_matches_jax_on_the_gpt_tree(gpt_trees, level, half):
    jp, tp = gpt_trees
    jpol = jamp.get_policy(level, half_dtype=getattr(jnp, half))
    tpol = tamp.get_policy(level, half_dtype=getattr(torch, half))
    got = _dtypes_by_path(tpol.cast_params(tp))
    assert got == _dtypes_by_path(jpol.cast_params(jp))
    assert _dtypes_by_path(tpol.cast_to_compute(tp)) == _dtypes_by_path(
        jpol.cast_to_compute(jp))
    assert set(_dtypes_by_path(tpol.cast_to_fp32(tp)).values()) == {"float32"}
    if level in ("O2", "O3"):  # no GPT path names a norm layer: every leaf in half
        assert set(got.values()) == {half}


# ---------------------------------------------------- the amp front end
def _loss_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return ({"w": rng.randn(6, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)},
            rng.randn(5, 6).astype(np.float32))


def _jloss(p, x, big):
    return big * jnp.mean(jnp.square(x @ p["w"] + p["b"]))


def _tloss(p, x, big):
    return big * torch.mean(torch.square(x @ p["w"] + p["b"]))


@pytest.mark.parametrize("big", [1.0, 1e36], ids=["finite", "overflow"])
def test_value_and_grad_matches_jax(big):
    params, x = _loss_inputs()
    jparams, jamp_ = jamp.initialize(jax.tree.map(jnp.asarray, params), "O1",
                                     half_dtype=jnp.float16)
    tparams, tamp_ = tamp.initialize({k: _t(v) for k, v in params.items()}, "O1",
                                     half_dtype=torch.float16)
    assert isinstance(tamp_.scaler, tamp.DynamicLossScaler)
    jres = jamp.value_and_grad(jamp_, _jloss)(jparams, jamp_.init_state(), jnp.asarray(x), big)
    tres = tamp.value_and_grad(tamp_, _tloss)(tparams, tamp_.init_state(device="cpu"),
                                               _t(x), big)
    assert bool(tres[3]) == bool(jres[3]) == (big == 1.0)
    assert _scaler_tuple(tres[2]) == _scaler_tuple(jres[2])
    np.testing.assert_allclose(float(tres[0]), float(jres[0]), rtol=1e-6)
    for a, b in zip(tree_leaves(tres[1]), jax.tree.leaves(jres[1])):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    # the caller's params are read, not changed
    assert not any(p.requires_grad for p in tree_leaves(tparams))


def test_value_and_grad_without_a_scaler_and_scale_loss():
    params, x = _loss_inputs(1)
    tparams, amp_ = tamp.initialize({k: _t(v) for k, v in params.items()}, "O0")
    jparams, jamp_ = jamp.initialize(jax.tree.map(jnp.asarray, params), "O0")
    assert amp_.scaler is None and amp_.init_state(2) == [None, None]
    tres = tamp.value_and_grad(amp_, _tloss)(tparams, None, _t(x), 1.0)
    jres = jamp.value_and_grad(jamp_, _jloss)(jparams, None, jnp.asarray(x), 1.0)
    assert tres[2] is None and bool(tres[3])
    np.testing.assert_allclose(float(tres[0]), float(jres[0]), rtol=1e-6)
    assert tamp.scale_loss(torch.tensor(2.0), amp_, None) == 2.0
    _, amp16 = tamp.initialize({}, "O1", half_dtype=torch.float16, init_scale=64.0)
    assert float(tamp.scale_loss(torch.tensor(2.0), amp16, amp16.init_state(device="cpu"))) == 128.0


def test_state_dicts_and_master_params():
    _, amp_ = tamp.initialize({}, "O2", half_dtype=torch.float16, init_scale=2.0 ** 8,
                              hysteresis=2)
    _, jamp_ = jamp.initialize({}, "O2", half_dtype=jnp.float16, init_scale=2.0 ** 8,
                               hysteresis=2)
    states = amp_.init_state(2, device="cpu")
    states[1] = amp_.update_scaler(states[1], torch.tensor(False))
    jstates = jamp_.init_state(2)
    jstates[1] = jamp_.update_scaler(jstates[1], jnp.bool_(False))
    d = tamp.state_dict(states)
    assert d == jamp.state_dict(jstates) and sorted(d) == ["loss_scaler0", "loss_scaler1"]
    back = tamp.load_state_dict(d, device="cpu")
    assert [_scaler_tuple(s) for s in back] == [_scaler_tuple(s) for s in states]
    single = tamp.load_state_dict(tamp.state_dict(states[0], destination={}), device="cpu")
    assert _scaler_tuple(single) == _scaler_tuple(states[0])
    params = {"a": torch.ones(3, dtype=torch.float16), "b": torch.zeros(2)}
    opt = FusedAdam(lr=1e-3, master_weights=True)
    masters = list(tamp.master_params(opt.init(params)))
    assert [m.dtype for m in masters] == [torch.float32, torch.float32]
    assert list(tamp.master_params(FusedAdam(lr=1e-3).init(params))) == []


# ------------------------------------------------- decorators, registry
@pytest.fixture
def half_dtypes():
    yield
    tamp.set_half_dtype(torch.bfloat16)
    jamp.set_half_dtype(jnp.bfloat16)


def _mul(a, b):
    return a * b


@pytest.mark.parametrize("half", ["bfloat16", "float16"])
def test_decorators_match_jax(half_dtypes, half):
    tamp.set_half_dtype(getattr(torch, half))
    jamp.set_half_dtype(getattr(jnp, half))
    x = np.arange(4, dtype=np.float32) / 3
    cases = [
        ("half", (np.float32, np.float32)), ("float", (half, half)),
        ("promote", ("bfloat16", np.float32)), ("promote", ("bfloat16", "float16")),
        ("promote", (half, half)),
    ]
    for kind, (da, db) in cases:
        ta = _t(x, getattr(torch, _name(da)))
        tb = _t(x, getattr(torch, _name(db)))
        ja, jb = _j(x, getattr(jnp, _name(da))), _j(x, getattr(jnp, _name(db)))
        got = getattr(tamp, f"{kind}_function")(_mul)(ta, tb)
        want = getattr(jamp, f"{kind}_function")(_mul)(ja, jb)
        assert _name(got.dtype) == _name(want.dtype), (kind, da, db)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    with tamp.disable_casts():
        assert tamp.half_function(_mul)(_t(x), _t(x)).dtype == torch.float32
    assert tamp.half_function(_mul)(_t(x), 2).dtype == getattr(torch, half)
    assert tamp.promote_function(_mul)(2, 3) == 6  # no floating tensor: as given
    tmod, jmod = types.SimpleNamespace(f=_mul, g=_mul, h=_mul), types.SimpleNamespace(
        f=_mul, g=_mul, h=_mul)
    for reg in ("half", "float", "promote"):
        getattr(tamp, f"register_{reg}_function")(tmod, "f" if reg == "half" else
                                                  "g" if reg == "float" else "h")
        getattr(jamp, f"register_{reg}_function")(jmod, "f" if reg == "half" else
                                                  "g" if reg == "float" else "h")
    ta, tb = _t(x, torch.bfloat16), _t(x)
    ja, jb = _j(x, jnp.bfloat16), _j(x)
    for name in ("f", "g", "h"):
        assert _name(getattr(tmod, name)(ta, tb).dtype) == _name(
            getattr(jmod, name)(ja, jb).dtype), name


def test_init_matches_jax(half_dtypes):
    t_amp = tamp.init(half_dtype=torch.float16, init_scale=2.0 ** 10, verbose=True)
    j_amp = jamp.init(half_dtype=jnp.float16, init_scale=2.0 ** 10, verbose=True)
    assert t_amp.policy.opt_level == j_amp.policy.opt_level == "O1"
    assert _scaler_tuple(t_amp.init_state(device="cpu")) == _scaler_tuple(j_amp.init_state())
    assert tamp.half_function(_mul)(torch.ones(2), torch.ones(2)).dtype == torch.float16
    off, joff = tamp.init(enabled=False), jamp.init(enabled=False)
    assert off.scaler is None and joff.scaler is None and off.policy.opt_level == "O0"


# ------------------------------------------------------------ fp16_utils
def test_fp16util_conversions_match_jax(gpt_trees):
    jp, tp = gpt_trees
    tree_t = {"w": torch.ones(3), "norm_w": torch.ones(2),
              "step": torch.arange(3, dtype=torch.int32)}
    tree_j = {"w": jnp.ones(3), "norm_w": jnp.ones(2), "step": jnp.arange(3)}
    for fn, args in (("tofp16", (torch.float16,)), ("network_to_half", ()),
                     ("convert_network", (torch.float16,)), ("BN_convert_float", ())):
        jargs = tuple(getattr(jnp, _name(a)) for a in args)
        for t_tree, j_tree in ((tree_t, tree_j), (tp, jp)):
            assert _dtypes_by_path(getattr(tfp16, fn)(t_tree, *args)) == _dtypes_by_path(
                getattr(jfp16, fn)(j_tree, *jargs)), fn
    half = tfp16.tofp16(tp, torch.float16)
    _, master = tfp16.prep_param_lists(half)
    assert all(m.dtype == torch.float32 for m in tree_leaves(master))
    assert all(m.data_ptr() != h.data_ptr() for m, h in zip(tree_leaves(master),
                                                           tree_leaves(half)))
    _, flat = tfp16.prep_param_lists(tp, flat_master=True)
    _, jflat = jfp16.prep_param_lists(jp, flat_master=True)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    g32 = tfp16.model_grads_to_master_grads(half)
    assert all(g.dtype == torch.float32 for g in tree_leaves(g32))
    back = tfp16.master_params_to_model_params(half, master)
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(tree_leaves(back), tree_leaves(half)))


def test_fp16_model_matches_jax():
    w = np.random.RandomState(2).randn(4, 3).astype(np.float32)
    x = np.random.RandomState(3).randn(2, 4).astype(np.float32)
    with pytest.warns(DeprecationWarning):
        tm = tfp16.FP16Model(lambda p, a: a @ p["w"], {"w": _t(w)}, torch.float16)
    with pytest.warns(DeprecationWarning):
        jm = jfp16.FP16Model(lambda p, a: a @ p["w"], {"w": jnp.asarray(w)}, jnp.float16)
    got, want = tm(_t(x)), jm(jnp.asarray(x))
    assert got.dtype == torch.float16 and _name(want.dtype) == "float16"
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2.0 ** -10, atol=2.0 ** -14)


def test_fp16_optimizer_matches_jax():
    """Three steps of FP16_Optimizer(FusedAdam, dynamic scale) on fp16
    params, the second with an inf gradient: the scaler states and the
    votes equal, the fp16 params within one fp16 step."""
    rng = np.random.RandomState(4)
    p0 = {"w": rng.randn(8, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) * 512 for k, v in p0.items()}
             for _ in range(3)]
    grads[1]["w"][3, 2] = np.inf
    kw = dict(dynamic_loss_scale=True, dynamic_loss_args={"init_scale": 2.0 ** 9})
    topt = tfp16.FP16_Optimizer(FusedAdam(lr=1e-2), **kw)
    jopt = jfp16.FP16_Optimizer(JaxFusedAdam(lr=1e-2), **kw)
    tparams = {k: _t(v, torch.float16) for k, v in p0.items()}
    jparams = {k: _j(v, jnp.float16) for k, v in p0.items()}
    tst, jst = topt.init(tparams), jopt.init(jparams)
    for i, g in enumerate(grads):
        tparams, tst, tfin = topt.step({k: _t(v, torch.float16) for k, v in g.items()},
                                       tst, tparams, max_grad_norm=100.0)
        jparams, jst, jfin = jopt.step({k: _j(v, jnp.float16) for k, v in g.items()},
                                       jst, jparams, max_grad_norm=100.0)
        assert bool(tfin) == bool(jfin) == (i != 1)
        assert _scaler_tuple(tst.scaler) == _scaler_tuple(jst.scaler)
        for k in p0:
            a, b = tparams[k].float().numpy(), np.asarray(jparams[k], np.float32)
            np.testing.assert_allclose(a, b, rtol=2.0 ** -10, atol=2.0 ** -24)
    assert float(topt.scale_loss(tst, torch.tensor(1.0))) == float(jopt.scale_loss(
        jst, jnp.float32(1.0)))
    d = topt.state_dict(tst)
    assert d["loss_scaler"] == jopt.state_dict(jst)["loss_scaler"]
    back = topt.load_state_dict(d, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(tst)))


def test_loss_scaler_aliases_match_jax():
    for name, kw in (("LossScaler", {"scale": 4.0}), ("DynamicLossScaler", {}),
                     ("DynamicLossScaler", {"init_scale": 8.0, "scale_factor": 4.0,
                                            "scale_window": 3})):
        t, j = getattr(tfp16, name)(**kw), getattr(jfp16, name)(**kw)
        tst, jst = t.init("cpu"), j.init()
        for flag in (True, True, True, False):
            tst, jst = t.update(tst, torch.tensor(flag)), j.update(jst, jnp.bool_(flag))
        assert _scaler_tuple(tst) == _scaler_tuple(jst)


# ---------------------------------------------------------------- exports
@pytest.mark.parametrize("port,ref", [
    (tamp, jamp), (tfp16, jfp16), (tguard, jguard), (tgrad_scaler, jgrad_scaler)],
    ids=["amp", "fp16_utils", "step_guard", "grad_scaler"])
def test_exports_match_jax(port, ref):
    names = getattr(ref, "__all__", None) or [
        n for n in vars(ref) if not n.startswith("_") and callable(getattr(ref, n))
        and getattr(getattr(ref, n), "__module__", "") == ref.__name__]
    for name in names:
        assert hasattr(port, name), name
    if hasattr(ref, "__all__"):
        assert sorted(port.__all__) == sorted(ref.__all__)


# ------------------------------------------ fp16 plain versions of kernels
def _ulp16_diff(a, b):
    """Largest distance in fp16 steps between two fp16 tensors."""
    def key(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((key(a) - key(b)).abs().max())


@pytest.mark.parametrize("rms", [False, True], ids=["ln_affine", "rms_affine"])
@pytest.mark.parametrize("shape", [(8, 768), (3, 5, 96)])
def test_fp16_plain_layer_norm_matches_jax(shape, rms):
    rng = np.random.RandomState(5)
    H = shape[-1]
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(H)).astype(np.float32)
    b = (0.1 * rng.randn(H)).astype(np.float32)
    xj, dyj = _j(x, jnp.float16), _j(dy, jnp.float16)
    params = [w] if rms else [w, b]
    jfn = jax_rms if rms else jax_ln
    y_j, vjp = jax.vjp(lambda xx, *ps: jfn(xx, *ps, (H,), 1e-5), xj,
                       *(jnp.asarray(p) for p in params))
    rgrads = vjp(dyj)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).half().requires_grad_()
    pt = [torch.from_numpy(p).requires_grad_() for p in params]
    tfn = fused_rms_norm_affine if rms else fused_layer_norm_affine
    y = tfn(xt, *pt, (H,), 1e-5)
    assert y.dtype == torch.float16
    assert _ulp16_diff(y, _t(y_j, torch.float16)) <= 1
    y.backward(torch.from_numpy(np.asarray(dyj, np.float32)).half())
    assert xt.grad.dtype == torch.float16
    dx_j = np.asarray(rgrads[0], np.float32)
    # dx cancels (gw - m1 - xhat m2): one fp16 step of its scale
    np.testing.assert_allclose(xt.grad.float().numpy(), dx_j, rtol=2.0 ** -10,
                               atol=2.0 ** -10 * np.abs(dx_j).max())
    for p, r in zip(pt, rgrads[1:]):
        r = np.asarray(r)
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize("causal,hkv", [(True, 4), (False, 4), (True, 2)],
                         ids=["causal", "non_causal", "gqa"])
def test_fp16_plain_flash_matches_jax_scan(causal, hkv):
    rng = np.random.RandomState(6)
    B, H, S, D = 2, 4, 96, 32
    q, do = rng.randn(B, H, S, D), rng.randn(B, H, S, D)
    k, v = rng.randn(B, hkv, S, D), rng.randn(B, hkv, S, D)
    qj, kj, vj, doj = (_j(a, jnp.float16) for a in (q, k, v, do))
    out_j, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=causal, impl="scan"),
                         qj, kj, vj)
    dq_j, dk_j, dv_j = vjp(doj)
    qt, kt, vt = (torch.from_numpy(np.asarray(a, np.float32)).half().requires_grad_()
                  for a in (qj, kj, vj))
    out = flash_attention(qt, kt, vt, causal=causal)
    assert out.dtype == torch.float16
    assert _ulp16_diff(out, _t(out_j, torch.float16)) <= 1
    out.backward(torch.from_numpy(np.asarray(doj, np.float32)).half())
    for got, want in ((qt.grad, dq_j), (kt.grad, dk_j), (vt.grad, dv_j)):
        assert got.dtype == torch.float16
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2.0 ** -10 * np.abs(want).max())
