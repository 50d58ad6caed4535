"""The port's multi-tensor ops (apex_tpu_torch.ops.multi_tensor,
apex_tpu_torch.multi_tensor_apply) against the JAX package's, on trees
and on ``Buckets``, and the launch plans of the three kernels.

On the CPU the kernels run their plain versions.  Bands: scale, axpby,
the finite votes and ``tree_where`` only multiply, add and cast, and are
bitwise equal to JAX.  ``multi_tensor_l2norm`` and the L2 blend sum, in
PyTorch's order here and in XLA's there: within 1e-6 relative of the JAX
TREE path, never bitwise against bucket views (the JAX package's own
bucket and tree sums differ by an ulp, ``ROADMAP.md`` section 3).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.amp.scaler import all_finite as jax_all_finite
from apex_tpu.multi_tensor_apply import multi_tensor_applier as jax_applier
from apex_tpu.ops import multi_tensor as jmt
from apex_tpu.optimizers import bucketing as jb

from apex_tpu_torch.multi_tensor_apply import multi_tensor_applier
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers import bucketing as tb
from apex_tpu_torch.optimizers.tree import tree_leaves


def np_tree(seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(9, 17) * scale).astype(np.float32),
            "sub": {"b": (rng.randn(33) * scale).astype(np.float32),
                    "s": np.float32(rng.randn() * scale).reshape(())},
            "h": (rng.randn(21) * scale).astype(np.float32)}


def to_jax(t, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), t)


def to_torch(t, dtype=torch.float32):
    if isinstance(t, dict):
        return {k: to_torch(v, dtype) for k, v in t.items()}
    return torch.from_numpy(np.array(t)).to(dtype)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def assert_leaves_equal(got, want):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(_np(a), _np(b))


def buckets_of(t_torch, t_jax):
    tp, jp = tb.plan_of(t_torch), jb.plan_of(t_jax)
    return tb.Buckets(tp, tb.pack(tp, t_torch)), jb.Buckets(jp, jb.pack(jp, t_jax))


# ------------------------------------------------------------ the ops
@pytest.mark.parametrize("out_dtype", [None, "bfloat16", "float16"])
def test_multi_tensor_scale_matches_jax(out_dtype):
    t = np_tree(0)
    td = None if out_dtype is None else getattr(torch, out_dtype)
    jd = None if out_dtype is None else getattr(jnp, out_dtype)
    tout, tfound = mt.multi_tensor_scale(to_torch(t), 0.37, out_dtype=td)
    jout, jfound = jmt.multi_tensor_scale(to_jax(t), 0.37, out_dtype=jd)
    assert bool(tfound) == bool(jfound) is False
    assert_leaves_equal(tout, jout)
    if td is not None:
        assert all(x.dtype == td for x in tree_leaves(tout))


def test_scale_flags_an_inf_and_an_overflow():
    t = to_torch(np_tree(1))
    t["w"][2, 3] = math.inf
    _, found = mt.multi_tensor_scale(t, 1.0)
    assert bool(found)
    # finite in, but x * mult overflows fp32, or the cast overflows fp16
    _, found = mt.multi_tensor_scale(to_torch(np_tree(1)), 3e38)
    assert bool(found)
    _, found = mt.multi_tensor_scale(to_torch(np_tree(1)), 1e5, out_dtype=torch.float16)
    assert bool(found)
    _, found = mt.multi_tensor_scale(to_torch(np_tree(1)), 1e5, out_dtype=torch.bfloat16)
    assert not bool(found)


def test_scale_on_buckets_returns_buckets():
    tbk, jbk = buckets_of(to_torch(np_tree(2)), to_jax(np_tree(2)))
    tout, tfound = mt.multi_tensor_scale(tbk, 2.5)
    jout, jfound = jmt.multi_tensor_scale(jbk, 2.5)
    assert isinstance(tout, tb.Buckets) and tout.plan is tbk.plan
    assert bool(tfound) == bool(jfound)
    for a, b, spec in zip(tout.arrays, jout.arrays, tbk.plan.buckets):
        np.testing.assert_array_equal(_np(a)[:spec.size], _np(b)[:spec.size])


def test_multi_tensor_axpby_matches_jax():
    x, y = np_tree(3), np_tree(4)
    tout, tfound = mt.multi_tensor_axpby(0.5, to_torch(x), -1.25, to_torch(y))
    jout, jfound = jmt.multi_tensor_axpby(0.5, to_jax(x), -1.25, to_jax(y))
    assert bool(tfound) == bool(jfound) is False
    for a, b in zip(tree_leaves(tout), jax.tree.leaves(jout)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)
    bad = to_torch(x)
    bad["h"][0] = math.nan
    assert bool(mt.multi_tensor_axpby(1.0, bad, 1.0, to_torch(y))[1])


@pytest.mark.parametrize("buckets", [False, True], ids=["tree", "buckets"])
def test_multi_tensor_l2norm_matches_jax_tree(buckets):
    t = np_tree(5)
    tt = to_torch(t)
    if buckets:
        tt = buckets_of(tt, to_jax(t))[0]
    total, per = mt.multi_tensor_l2norm(tt, per_tensor=True)
    jtotal, jper = jmt.multi_tensor_l2norm(to_jax(t), per_tensor=True)
    np.testing.assert_allclose(_np(total), _np(jtotal), rtol=1e-6)
    assert len(per) == len(jper) == 4  # per ORIGINAL leaf, also on buckets
    np.testing.assert_allclose(np.array([_np(x) for x in per]),
                               np.array([_np(x) for x in jper]), rtol=1e-6)
    leaves64 = [np.asarray(a, np.float64) for a in jax.tree.leaves(t)]
    want = math.sqrt(sum(float(np.sum(a * a)) for a in leaves64))
    np.testing.assert_allclose(float(total), want, rtol=1e-6)
    assert float(mt.multi_tensor_l2norm(tt)) == float(total)


def test_l2norm_of_an_empty_tree():
    total, per = mt.multi_tensor_l2norm({}, per_tensor=True)
    assert float(total) == 0.0 and per == []


@pytest.mark.parametrize("norm_type", [2, 0])
@pytest.mark.parametrize("buckets", [False, True], ids=["tree", "buckets"])
def test_norm_blend_matches_jax(norm_type, buckets):
    t = np_tree(6)
    old = [0.5, 1.5, 0.25, 2.0]
    tt = to_torch(t)
    if buckets:
        tt = buckets_of(tt, to_jax(t))[0]
    got = mt.multi_tensor_norm_blend([torch.tensor(v) for v in old], tt, 0.9, 0.1, norm_type)
    want = jmt.multi_tensor_norm_blend([jnp.float32(v) for v in old], to_jax(t), 0.9, 0.1,
                                       norm_type)
    np.testing.assert_allclose(np.array([_np(x) for x in got]),
                               np.array([_np(x) for x in want]), rtol=1e-6)
    with pytest.raises(ValueError, match="norm_type"):
        mt.multi_tensor_norm_blend([torch.tensor(1.0)], to_torch(t), 0.9, 0.1, norm_type=1)


def test_finite_votes_and_tree_where_match_jax():
    t = np_tree(7)
    bad = {**t, "h": t["h"].copy()}
    bad["h"][3] = np.inf
    for tree in (t, bad):
        assert bool(mt.tree_not_finite(to_torch(tree))) == bool(jmt.tree_not_finite(to_jax(tree)))
        assert bool(mt.all_finite(to_torch(tree))) == bool(jax_all_finite(to_jax(tree)))
    assert bool(mt.all_finite({}))
    tbk, jbk = buckets_of(to_torch(bad), to_jax(bad))
    assert bool(mt.tree_not_finite(tbk)) == bool(jmt.tree_not_finite(jbk)) is True
    for pred in (True, False):
        got = mt.tree_where(torch.tensor(pred), to_torch(t), to_torch(bad))
        want = jmt.tree_where(jnp.bool_(pred), to_jax(t), to_jax(bad))
        assert_leaves_equal(got, want)


def test_applier_threads_the_flag_like_jax():
    """The flag ORs each op's vote, stays set across later clean calls,
    and passes through an op without a vote."""
    clean, bad = np_tree(8), np_tree(8)
    bad["w"] = bad["w"].copy()
    bad["w"][0, 0] = np.nan
    flags = {}
    for side, applier, conv in (("torch", multi_tensor_applier, to_torch),
                                ("jax", jax_applier, to_jax)):
        seq = []
        _, f = applier(mt.multi_tensor_scale if side == "torch" else jmt.multi_tensor_scale,
                       None, [conv(clean)], 2.0)
        seq.append(int(f))
        _, f = applier(mt.multi_tensor_scale if side == "torch" else jmt.multi_tensor_scale,
                       f, [conv(bad)], 2.0)
        seq.append(int(f))
        _, f = applier(mt.multi_tensor_axpby if side == "torch" else jmt.multi_tensor_axpby,
                       f, [1.0, conv(clean), 1.0, conv(clean)])
        seq.append(int(f))
        out, f = applier(mt.multi_tensor_l2norm if side == "torch" else jmt.multi_tensor_l2norm,
                         f, [conv(clean)], True)
        seq.append(int(f))
        assert isinstance(out, tuple) and len(out[1]) == 4
        flags[side] = seq
    assert flags["torch"] == flags["jax"] == [0, 1, 1, 1]


# ---------------------------------------------------------- the kernels
def _adam_lists(rng, sizes, p_dtype=torch.float32, master=False):
    def rand(n, dtype=torch.float32, scale=1.0):
        return torch.from_numpy((rng.randn(n) * scale).astype(np.float32)).to(dtype)

    g = [rand(n, scale=0.1) for n in sizes]
    p = [rand(n, p_dtype) for n in sizes]
    m = [rand(n, scale=0.01) for n in sizes]
    v = [rand(n, scale=0.01).abs() for n in sizes]
    src = [x.float() for x in p] if master else p
    outs = ([torch.empty(n, dtype=p_dtype) for n in sizes],
            [torch.empty(n) for n in sizes], [torch.empty(n) for n in sizes],
            [torch.empty(n) for n in sizes] if master else None)
    return g, src, m, v, outs


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_mt_adam_plain_is_the_per_tensor_expression(adam_w_mode):
    """The plain version (pack, one expression, unpack) equals
    ``adam_math`` tensor by tensor, bitwise, with per-tensor lr and wd,
    a clip coefficient, and a false predicate that keeps every value."""
    rng = np.random.RandomState(0)
    sizes = [7, 64, 1, 33]
    g, p, m, v, (po, mo, vo, _) = _adam_lists(rng, sizes)
    bc1, bc2 = torch.tensor(0.19), torch.tensor(0.002997)
    coef = torch.tensor(0.75)
    wd = [0.1, 0.0, 0.1, 0.05]
    lr_abs = [None, 1e-3, None, None]
    lr_scale = [1.0, 1.0, 0.5, 1.0]
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, adam_w_mode=adam_w_mode)
    mt.mt_adam(g, p, m, v, po, mo, vo, None, lr=1e-2, wd=wd, lr_abs=lr_abs,
               lr_scale=lr_scale, bc1=bc1, bc2=bc2, coef=coef, **kw)
    for k in range(len(sizes)):
        lr_k = lr_abs[k] if lr_abs[k] is not None else 1e-2 * lr_scale[k]
        pn, mn, vn = mt.adam_math(g[k] * coef, p[k], m[k], v[k], wd[k], lr_k, bc1, bc2, **kw)
        assert torch.equal(po[k], pn) and torch.equal(mo[k], mn) and torch.equal(vo[k], vn)
    mt.mt_adam(g, p, m, v, po, mo, vo, None, lr=1e-2, wd=wd, bc1=bc1, bc2=bc2,
               pred=torch.tensor(False), **kw)
    for k in range(len(sizes)):
        assert torch.equal(po[k], p[k]) and torch.equal(mo[k], m[k]) and torch.equal(vo[k], v[k])


def test_mt_adam_plain_master_and_bf16():
    rng = np.random.RandomState(1)
    sizes = [5, 40]
    g, src, m, v, (po, mo, vo, wo) = _adam_lists(rng, sizes, torch.bfloat16, master=True)
    kw = dict(lr=1e-2, wd=[0.1, 0.1], bc1=torch.tensor(0.1), bc2=torch.tensor(0.001),
              beta1=0.9, beta2=0.999, eps=1e-8, adam_w_mode=True)
    mt.mt_adam(g, src, m, v, po, mo, vo, wo, **kw)
    for k in range(len(sizes)):
        assert po[k].dtype == torch.bfloat16
        assert torch.equal(po[k], wo[k].to(torch.bfloat16))


def test_mt_scale_and_l2norm_plain():
    rng = np.random.RandomState(2)
    src = [torch.from_numpy(rng.randn(n).astype(np.float32)) for n in (3, 100, 1)]
    out = [torch.empty(n, dtype=torch.bfloat16) for n in (3, 100, 1)]
    found = mt.mt_scale(src, out, torch.tensor(0.5))
    assert not bool(found)
    for s, o in zip(src, out):
        assert torch.equal(o, (s * 0.5).to(torch.bfloat16))
    total, per = mt.mt_l2norm(src)
    assert per.shape == (3,)
    np.testing.assert_allclose(float(total), float(sum(float((s.double() ** 2).sum())
                                                       for s in src)), rtol=1e-6)


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    """A tensor that is not on the CPU (here a meta tensor) goes to the
    kernel's checks, which raise: no plain-version fallback."""
    x = [torch.empty(8, device="meta")]
    with pytest.raises(ValueError, match="CUDA"):
        mt.mt_scale(x, [torch.empty(8, device="meta")], 2.0)
    with pytest.raises(ValueError, match="CUDA"):
        mt.mt_l2norm(x)
    with pytest.raises(ValueError, match="CUDA"):
        mt.mt_adam(x, x, x, x, x, x, x, lr=1e-3, wd=[0.0], bc1=None, bc2=None, beta1=0.9,
                   beta2=0.999, eps=1e-8, adam_w_mode=True)


# ---------------------------------------------------------- launch plans
def _table_bytes(head, per_tensor_arrays, cap):
    """sizeof a ``csrc/multi_tensor.cu`` table: the head, then arrays
    (element size, count) laid out with natural alignment, the struct
    rounded up to 8 bytes."""
    off = head
    for size, count in per_tensor_arrays(cap):
        off = -(-off // size) * size + size * count
    return -(-off // 8) * 8


TABLES = {
    # head bytes; (element size, count) of each array after it
    "adam": (72, lambda c: [(8, 8 * c), (8, c), (4, c + 1), (4, c), (4, c),
                            (1, c), (1, c), (1, c), (1, c)]),
    "scale": (24, lambda c: [(8, c), (8, c), (8, c), (4, c + 1),
                             (1, c), (1, c), (1, c), (1, c)]),
    "l2norm": (48, lambda c: [(8, c), (8, c), (4, c + 1), (1, c), (1, c)]),
}


#: bytes a tensor takes in each table (``k*BytesPerTensor`` in the source)
PER_TENSOR = {"adam": 8 * 8 + 8 + 4 + 4 + 4 + 4, "scale": 2 * 8 + 8 + 4 + 4,
              "l2norm": 8 + 8 + 4 + 1 + 1}


@pytest.mark.parametrize("kind", sorted(TABLES))
def test_capacity_fills_a_4kb_table(kind):
    """The capacity is the source's formula, (4096 - head - 12) / bytes a
    tensor, and the table it gives fits the 4 KB of kernel parameters."""
    head, arrays = TABLES[kind]
    cap = mt.CAPACITY[kind]
    assert cap == (mt.TABLE_BYTES - head - 12) // PER_TENSOR[kind]
    assert _table_bytes(head, arrays, cap) == mt.TABLE_SIZES[kind] <= mt.TABLE_BYTES
    if kind == "l2norm":
        assert cap <= mt.THREADS  # stage 2 gives each leaf a thread


@pytest.mark.parametrize("kind", ["adam", "scale", "l2norm"])
def test_mt_plan(kind):
    cap, C = mt.CAPACITY[kind], mt.CHUNK
    stage2 = kind == "l2norm"
    p = mt.mt_plan(kind, [1, C, C + 1])
    assert (p.capacity, p.chunk, p.threads) == (cap, C, mt.THREADS)
    assert p.chunks == 1 + 1 + 2 and p.launches == 1 + stage2
    sizes = [5] * (2 * cap + 3)
    p = mt.mt_plan(kind, sizes)
    assert p.launches == 3 * (1 + stage2) and p.chunks == len(sizes)
    # an empty group launches no partial or update pass
    p = mt.mt_plan(kind, [0] * cap + [7])
    assert p.launches == 1 + 2 * stage2 and p.chunks == 1
    assert mt.mt_plan(kind, []).launches == 0


def test_plan_of_the_bench_set_and_gpt124m():
    """The two sets chip_smoke.py runs: bench.py's ``make_params``
    shapes (99 tensors, 22,761,768 params, 60 under 64K elements) in 3
    launches, and GPT-124M's params (20 leaves: the layers are stacked)
    in one."""
    from apex_tpu_torch.models.gpt import GPTConfig, init_params

    import chip_smoke

    sizes = [int(np.prod(s)) for _, s in chip_smoke.bench_param_shapes()]
    assert len(sizes) == 99 and sum(sizes) == 22_761_768
    assert sum(n < 65536 for n in sizes) == 60
    assert mt.mt_plan("adam", sizes).launches == 3
    # the leaf count does not depend on the widths: GPT-124M's depth at
    # a small width
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=12, num_attention_heads=4,
                    max_seq_len=16)
    n_leaves = len(tree_leaves(init_params(cfg, 0, "cpu", keep_fp32=True)))
    assert n_leaves == 20
    assert mt.mt_plan("adam", [1] * n_leaves).launches == 1


def test_chip_smoke_gpt_shapes_are_the_models():
    """The GPT-124M leaves chip_smoke.py times the kernels at, as
    ``models.gpt.init_params`` lays them out (checked at a small width)."""
    from apex_tpu_torch.models.gpt import GPTConfig, init_params

    import chip_smoke

    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=3, num_attention_heads=4,
                    max_seq_len=16)
    params = init_params(cfg, 0, "cpu", keep_fp32=True)
    want = [tuple(t.shape) for t in tree_leaves(params)]
    got = chip_smoke._leaf_shapes(chip_smoke.gpt_param_shapes(L=3, H=32, V=64, S=16))
    assert got == want
