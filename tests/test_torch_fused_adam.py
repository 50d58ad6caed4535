"""The port's FusedAdam (apex_tpu_torch.optimizers; its default is the
multi-tensor engine, whose CPU path is the ``mt_adam`` kernel's plain
version) against the JAX package's ``FusedAdam``, on the per-leaf path
and on the default bucketed engine (which the JAX package holds
bit-exact with per-leaf in fp32).

Five steps on a fixed numpy grad stream, for AdamW and L2 mode, with
and without weight decay: params, m and v must be bitwise equal, since
both evaluate the same fp32 expressions in the same association
(``(1-b2)*(g*g)``, ``(m/bc1)/(sqrt(v/bc2)+eps)``) element by element.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.optimizers import FusedAdam as JaxFusedAdam

from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers.base import tree_leaves, tree_map

SHAPES = {"a": (4, 5), "b": {"c": (7,), "d": (2, 3, 4)}}


def _tree(rng, scale=1.0):
    def leaf(shape):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return {"a": leaf(SHAPES["a"]),
            "b": {"c": leaf(SHAPES["b"]["c"]), "d": leaf(SHAPES["b"]["d"])}}


def _run_both(steps=5, jax_buckets=False, dtype=np.float32, **hyper):
    rng = np.random.RandomState(0)
    params = tree_map(lambda a: a.astype(dtype), _tree(rng))
    grads = [_tree(rng, scale=0.1 * (i + 1)) for i in range(steps)]
    jopt = JaxFusedAdam(use_buckets=jax_buckets, **hyper)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    topt = FusedAdam(**hyper)
    tp = tree_map(torch.from_numpy, params)
    ts = topt.init(tp)
    for g in grads:
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(tree_map(torch.from_numpy, g), ts, tp)
    return (jp, js), (tp, ts)


def _assert_tree_equal(got, want):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("jax_buckets", [False, True], ids=["per_leaf", "bucketed"])
@pytest.mark.parametrize("adam_w_mode", [True, False], ids=["adamw", "l2"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_five_steps_bitwise_equal_to_jax(jax_buckets, adam_w_mode, weight_decay):
    (jp, js), (tp, ts) = _run_both(jax_buckets=jax_buckets, lr=1e-2,
                                   adam_w_mode=adam_w_mode, weight_decay=weight_decay)
    assert int(ts.step) == int(js.step) == 5
    _assert_tree_equal(tp, jp)
    _assert_tree_equal(ts.exp_avg, js.exp_avg)
    _assert_tree_equal(ts.exp_avg_sq, js.exp_avg_sq)


def test_master_weights_bf16_params_equal_to_jax():
    """bf16 params with an fp32 master: the math reads and writes the
    master, the params are its bf16 rounding."""
    (jp, js), (tp, ts) = _run_both(dtype=np.float32, lr=1e-2, weight_decay=0.1,
                                   master_weights=True)
    _assert_tree_equal(ts.master, js.master)
    rng = np.random.RandomState(1)
    params = _tree(rng)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    tparams = tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), params)
    g = _tree(rng, scale=0.1)
    jopt = JaxFusedAdam(lr=1e-2, master_weights=True, use_buckets=False)
    topt = FusedAdam(lr=1e-2, master_weights=True)
    jnew, jst = jopt.update(jax.tree.map(jnp.asarray, g), jopt.init(jparams), jparams)
    tnew, tst = topt.update(tree_map(torch.from_numpy, g), topt.init(tparams), tparams)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tnew))
    _assert_tree_equal(tnew, jnew)
    _assert_tree_equal(tst.master, jst.master)


def test_predicated_commit_keeps_state_on_overflow():
    rng = np.random.RandomState(2)
    params = tree_map(torch.from_numpy, _tree(rng))
    opt = FusedAdam(lr=1e-2)
    state = opt.init(params)
    grads = tree_map(torch.from_numpy, _tree(rng))
    new, st = opt.update(grads, state, params, grads_finite=torch.tensor(False))
    assert int(st.step) == 0
    for a, b in zip(tree_leaves(new), tree_leaves(params)):
        assert torch.equal(a, b)
    new, st = opt.update(grads, state, params, grads_finite=torch.tensor(True))
    assert int(st.step) == 1


def test_unported_paths_raise():
    """Only AMSGrad raises now: the engine (``use_buckets=True``, the
    default), resident state, per-group hyperparameters, the folded
    clip and ``update_scaled`` are ported and run."""
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(amsgrad=True)
    params = {"w": torch.ones(3), "b": torch.ones(2)}
    grads = {"w": torch.full((3,), 0.5), "b": torch.full((2,), 0.25)}
    opt = FusedAdam(param_group_fn=lambda path, leaf: "bias" if "b" in path else "w",
                    group_hypers={"bias": {"weight_decay": 0.0}})
    assert opt.use_buckets
    for state in (opt.init(params), opt.init(params, bucketed=True)):
        new, st = opt.update(grads, state, params, clip_norm=1.0)
        assert int(st.step) == 1
        new, st, finite = opt.update_scaled(grads, state, params, scale=2.0)
        assert bool(finite) and int(st.step) == 1
