"""The port's six fused optimizers (apex_tpu_torch.optimizers) against the
JAX package's, on the same numpy params and grads, over 5 steps: on the
per-leaf path (``use_buckets=False``), on the engine with tree state
(transparent, the default) and with bucket-resident state
(``init(params, bucketed=True)``).  On the CPU the engine's kernels run
their plain versions.

Bands: Adam, SGD and Adagrad are elementwise in fp32 and bitwise equal
to the JAX package (params and every state slot), as the JAX package
pins its own two paths.  LAMB and NovoGrad (and any step with a clip)
reduce norms, which PyTorch and XLA sum in other orders: rtol 1e-5,
atol 1e-6, the band of ``tests/test_bucketed_engine.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import optimizers as jopt
from apex_tpu.contrib.clip_grad import clip_grad_norm_ as jax_clip_grad_norm_
from apex_tpu.optimizers import bucketing as jbucketing

from apex_tpu_torch import optimizers as topt
from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_
from apex_tpu_torch.optimizers import bucketing
from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map

HYPER = {
    "adam": ("FusedAdam", dict(lr=1e-2, weight_decay=0.01)),
    "adam_l2": ("FusedAdam", dict(lr=1e-2, weight_decay=0.01, adam_w_mode=False)),
    "sgd": ("FusedSGD", dict(lr=1e-2, momentum=0.9, weight_decay=0.01)),
    "sgd_nesterov": ("FusedSGD", dict(lr=1e-2, momentum=0.9, nesterov=True,
                                      weight_decay=0.01)),
    "lamb": ("FusedLAMB", dict(lr=1e-2, weight_decay=0.01)),
    "mp_lamb": ("FusedMixedPrecisionLamb", dict(lr=1e-2, weight_decay=0.01)),
    "adagrad": ("FusedAdagrad", dict(lr=1e-2, weight_decay=0.01)),
    "novograd": ("FusedNovoGrad", dict(lr=1e-2, weight_decay=0.01)),
    "novograd_inf": ("FusedNovoGrad", dict(lr=1e-2, weight_decay=0.01, norm_type=0,
                                           reg_inside_moment=True)),
}
BITWISE = {"adam", "adam_l2", "sgd", "sgd_nesterov", "adagrad"}
MODES = ("per_leaf", "transparent", "resident")


def make(name, side, **kw):
    cls, hyper = HYPER[name]
    mod = topt if side == "torch" else jopt
    return getattr(mod, cls)(**hyper, **kw)


def np_tree(seed=0, mixed=False):
    rng = np.random.RandomState(seed)
    t = {"w": rng.randn(9, 17).astype(np.float32),
         "sub": {"b": rng.randn(33).astype(np.float32),
                 "s": np.float32(rng.randn()).reshape(())}}
    if mixed:
        t["h"] = rng.randn(21).astype(np.float32)
        t["sub"]["h2"] = rng.randn(5, 7).astype(np.float32)
    return t


BF16_KEYS = ("h", "h2")


def to_jax(tree, bf16=()):
    def leaf(path, a):
        return jnp.asarray(a).astype(jnp.bfloat16 if path in bf16 else jnp.float32)
    return _map_with_key(leaf, tree)


def to_torch(tree, bf16=()):
    def leaf(path, a):
        return torch.from_numpy(np.array(a)).to(torch.bfloat16 if path in bf16
                                                else torch.float32)
    return _map_with_key(leaf, tree)


def _map_with_key(fn, tree, key=None):
    if isinstance(tree, dict):
        return {k: _map_with_key(fn, v, k) for k, v in tree.items()}
    return fn(key, tree)


def grad_stream(steps, mixed=False, scale=0.1):
    return [np_tree(10 + i, mixed) for i in range(steps)], scale


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _state_leaves(state, side):
    """Every state leaf in order, resident buckets unpacked to fp32."""
    out = []
    for field in state:
        if field is None:
            continue
        if side == "torch" and isinstance(field, bucketing.Buckets):
            out.extend(tree_leaves(field.unpack(dtype=torch.float32)))
        elif side == "jax" and isinstance(field, jbucketing.Buckets):
            out.extend(jax.tree.leaves(field.unpack(dtype=jnp.float32)))
        elif side == "torch":
            out.extend(tree_leaves(field))
        else:
            out.extend(jax.tree.leaves(field))
    return out


def assert_close(got, want, exact, err=""):
    assert len(got) == len(want), err
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, err
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=err)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=err)


def run_both(name, mode, steps=5, mixed=False, bf16_params=False, update_kw=None, **kw):
    bf16 = BF16_KEYS if mixed else ()
    params = np_tree(0, mixed)
    if bf16_params:
        bf16 = ("w", "b", "s")
    grads, gs = grad_stream(steps, mixed)
    use_buckets = mode != "per_leaf"
    results = {}
    for side in ("jax", "torch"):
        opt = make(name, side, use_buckets=use_buckets, **kw)
        conv = to_jax if side == "jax" else to_torch
        p = conv(params, bf16)
        s = opt.init(p, bucketed=mode == "resident")
        for g in grads:
            gt = conv(tree_map(lambda a: a * gs, g), bf16)
            p, s = opt.update(gt, s, p, **(update_kw or {}))
        results[side] = (p, s)
    return results


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(HYPER))
def test_five_steps_match_jax(name, mode):
    r = run_both(name, mode)
    (jp, js), (tp, ts) = r["jax"], r["torch"]
    exact = name in BITWISE
    assert int(ts.step) == int(js.step) == 5
    assert_close(tree_leaves(tp), jax.tree.leaves(jp), exact, f"{name} {mode} params")
    assert_close(_state_leaves(ts, "torch"), _state_leaves(js, "jax"), exact,
                 f"{name} {mode} state")
    if mode == "resident":
        assert isinstance(getattr(ts, make(name, "torch")._BUCKET_SLOT), bucketing.Buckets)


@pytest.mark.parametrize("name", sorted(HYPER))
def test_mixed_dtype_tree_matches_jax(name):
    """fp32 and bf16 leaves: a two-bucket plan; bf16 params round their
    fp32 result once."""
    r = run_both(name, "transparent", steps=3, mixed=True)
    (jp, js), (tp, ts) = r["jax"], r["torch"]
    for g, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
    assert_close(tree_leaves(tp), jax.tree.leaves(jp), name in BITWISE, name)
    assert_close(_state_leaves(ts, "torch"), _state_leaves(js, "jax"), name in BITWISE, name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(HYPER))
def test_master_weights_bf16_params_match_jax(name, mode):
    """bf16 params with an fp32 master: the math reads and writes the
    master, the params are its bf16 rounding."""
    r = run_both(name, mode, steps=3, bf16_params=True, master_weights=True)
    (jp, js), (tp, ts) = r["jax"], r["torch"]
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))
    assert_close(tree_leaves(tp), jax.tree.leaves(jp), name in BITWISE, f"{name} params")
    assert_close(_state_leaves(ts, "torch"), _state_leaves(js, "jax"), name in BITWISE,
                 f"{name} state and master")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(HYPER))
def test_clip_norm_matches_jax(name, mode):
    """``update(clip_norm=)``: the global-L2 clip folded into the step
    (its norm is summed in another order than XLA's: the band)."""
    r = run_both(name, mode, steps=2, update_kw={"clip_norm": 0.05})
    (jp, js), (tp, ts) = r["jax"], r["torch"]
    assert_close(tree_leaves(tp), jax.tree.leaves(jp), False, f"{name} {mode} clip")
    assert_close(_state_leaves(ts, "torch"), _state_leaves(js, "jax"), False, name)


GROUPED = {
    "adam": {"decay": {"weight_decay": 0.1}, "no_decay": {"weight_decay": 0.0,
                                                          "lr_scale": 0.5}},
    "sgd": {"decay": {"momentum": 0.5, "lr": 3e-3}, "no_decay": {"momentum": 0.0}},
    "lamb": {"decay": {"weight_decay": 0.05}, "no_decay": {"use_trust_ratio": False,
                                                           "weight_decay": 0.0}},
    "adagrad": {"decay": {"lr": 2e-2}, "no_decay": {"weight_decay": 0.0}},
}


def group_fn(path, leaf):
    return "decay" if leaf.ndim >= 2 else "no_decay"


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(GROUPED))
def test_param_groups_match_jax(name, mode):
    """``param_group_fn``/``group_hypers``: per-group lr, lr_scale,
    weight decay, momentum and trust ratio."""
    r = run_both(name, mode, steps=3, param_group_fn=group_fn, group_hypers=GROUPED[name])
    (jp, js), (tp, ts) = r["jax"], r["torch"]
    assert_close(tree_leaves(tp), jax.tree.leaves(jp), name in BITWISE, f"{name} {mode}")
    assert_close(_state_leaves(ts, "torch"), _state_leaves(js, "jax"), name in BITWISE, name)


def test_param_group_paths_are_jax_keystr():
    seen = {}
    for side, mod, conv in (("jax", jopt, to_jax), ("torch", topt, to_torch)):
        paths = []

        def fn(path, leaf, paths=paths):
            paths.append(path)
            return "all"

        opt = mod.FusedAdam(param_group_fn=fn, group_hypers={"all": {}})
        p = conv(np_tree())
        g = conv(np_tree(1))
        opt.update(g, opt.init(p), p)
        seen[side] = paths
    assert seen["torch"][:3] == seen["jax"][:3] == ["['sub']['b']", "['sub']['s']", "['w']"]


@pytest.mark.parametrize("cls", ["FusedAdam", "FusedSGD", "FusedLAMB", "FusedAdagrad"])
def test_group_hypers_errors(cls):
    params = to_torch(np_tree())
    kw = {"lr": 1e-2}
    grads = to_torch(np_tree(1))

    def step(**hyper):
        opt = getattr(topt, cls)(**kw, **hyper)
        opt.update(grads, opt.init(params), params)

    with pytest.raises(ValueError, match="unknown override keys"):
        step(param_group_fn=group_fn, group_hypers={"decay": {"weight_dacay": 0.0}})
    with pytest.raises(ValueError, match="without param_group_fn"):
        step(group_hypers={"decay": {"weight_decay": 0.0}})
    with pytest.raises(ValueError, match="match no param group"):
        step(param_group_fn=group_fn, group_hypers={"typo": {"weight_decay": 0.0}})


@pytest.mark.parametrize("name", sorted(HYPER))
def test_update_scaled_matches_jax(name):
    """fp16 grads scaled by 1024: ``update_scaled`` unscales, clips,
    votes and commits in one pass, as the JAX package's."""
    out = {}
    for side, conv, arr in (("jax", to_jax, jnp.float32), ("torch", to_torch, None)):
        opt = make(name, side)
        p = conv(np_tree())
        g = conv(tree_map(lambda a: a * 0.1 * 1024.0, np_tree(3)))
        if side == "jax":
            g = jax.tree.map(lambda x: x.astype(jnp.float16), g)
            scale = jnp.float32(1024.0)
        else:
            g = tree_map(lambda x: x.to(torch.float16), g)
            scale = torch.tensor(1024.0)
        p1, s1, fin = opt.update_scaled(g, opt.init(p), p, scale=scale, clip_norm=1.0)
        assert bool(fin)
        out[side] = (p1, s1)
    assert_close(tree_leaves(out["torch"][0]), jax.tree.leaves(out["jax"][0]), False, name)


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("name", sorted(HYPER))
def test_nonfinite_step_commits_nothing(name, resident):
    """An inf in the grads: the vote is False, params and every state
    slot keep their values and the step does not advance."""
    opt = make(name, "torch")
    p0 = to_torch(np_tree())
    g = to_torch(tree_map(lambda a: a * 0.1, np_tree(4)))
    p1, s1, fin1 = opt.update_scaled(g, opt.init(p0, bucketed=resident), p0, scale=2.0)
    assert bool(fin1)
    bad = tree_map(lambda x: x.clone(), g)
    bad["w"][3, 4] = math.inf
    p2, s2, fin2 = opt.update_scaled(bad, s1, p1, scale=2.0)
    assert not bool(fin2)
    assert int(s2.step) == int(s1.step) == 1
    assert_close(tree_leaves(p2), tree_leaves(p1), True, f"{name} params moved on inf")
    assert_close(_state_leaves(s2, "torch"), _state_leaves(s1, "torch"), True,
                 f"{name} state moved on inf")


def test_lr_tensor_matches_jax():
    """A 0-d lr tensor (a schedule's value on the device) against a
    traced fp32 lr, with a group lr_scale on top: bitwise."""
    out = {}
    for side, conv in (("jax", to_jax), ("torch", to_torch)):
        opt = make("adam", side, param_group_fn=group_fn,
                   group_hypers={"no_decay": {"lr_scale": 0.3}})
        p = conv(np_tree())
        s = opt.init(p)
        for i in range(3):
            lr = (jnp.float32(0.01 * (i + 1)) if side == "jax"
                  else torch.tensor(0.01 * (i + 1), dtype=torch.float32))
            p, s = opt.update(conv(np_tree(20 + i)), s, p, lr=lr)
        out[side] = p
    assert_close(tree_leaves(out["torch"]), jax.tree.leaves(out["jax"]), True, "lr tensor")


def test_update_is_functional():
    """``update`` modifies nothing it was given, on either state."""
    for resident in (False, True):
        opt = topt.FusedAdam(lr=1e-2, weight_decay=0.1)
        p = to_torch(np_tree())
        g = to_torch(np_tree(1))
        s = opt.init(p, bucketed=resident)
        before = [t.clone() for t in tree_leaves((p, g)) + _state_leaves(s, "torch")]
        opt.update(g, s, p, clip_norm=1.0)
        after = tree_leaves((p, g)) + _state_leaves(s, "torch")
        assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_step_alias():
    opt = topt.FusedSGD(lr=0.1)
    p = to_torch(np_tree())
    p1, s1 = opt.step(to_torch(np_tree(1)), opt.init(p), p)
    assert int(s1.step) == 1


@pytest.mark.parametrize("norm_type", [2.0, math.inf, 3.0])
def test_clip_grad_norm_matches_jax(norm_type):
    g = np_tree(5)
    jc, jn = jax_clip_grad_norm_(to_jax(g), 0.5, norm_type=norm_type)
    tc, tn = clip_grad_norm_(to_torch(g), 0.5, norm_type=norm_type)
    np.testing.assert_allclose(_np(tn), _np(jn), rtol=1e-6)
    assert_close(tree_leaves(tc), jax.tree.leaves(jc), False, "clipped")
    # below the max: a coefficient of 1, the grads unchanged
    tc, _ = clip_grad_norm_(to_torch(g), 1e6, norm_type=norm_type)
    assert_close(tree_leaves(tc), tree_leaves(to_torch(g)), True, "unclipped")


def test_optimizers_export_the_jax_names():
    assert set(topt.__all__) == set(jopt.__all__)
