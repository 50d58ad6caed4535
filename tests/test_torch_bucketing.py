"""The port's bucket plans (apex_tpu_torch.optimizers.bucketing) against
the JAX package's, on the trees of ``tests/test_bucketed_engine.py``.

Everything but the padding is the JAX layout, exactly: leaf order (dicts
by sorted key), dtype grouping by first appearance, offsets, ``cap_bytes``
splits.  The padding is the port's own rule (16 bytes of the dtype, times
``shard_pad``), checked against its formula, not against the TPU tile.
Pack/unpack round trips, ``per_leaf_reduce`` and the ``seg_*`` helpers
are bitwise equal to JAX's (they only move and cast values); a sum over
a slice is held at rtol 1e-6 (PyTorch and XLA sum in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.optimizers import bucketing as jb

from apex_tpu_torch.optimizers import bucketing as tb
from apex_tpu_torch.optimizers.tree import TreeDef, tree_leaves, tree_structure


def make_np_tree(seed=0, mixed=False):
    rng = np.random.RandomState(seed)
    t = {"w": rng.randn(9, 17).astype(np.float32),
         "sub": {"b": rng.randn(33).astype(np.float32),
                 "s": np.float32(rng.randn()).reshape(())}}
    if mixed:
        t["h"] = rng.randn(21).astype(np.float32)
        t["sub"]["h2"] = rng.randn(5, 7).astype(np.float32)
    return t


def _bf16_keys(mixed):
    return {"h", "h2"} if mixed else set()


def jax_tree(seed=0, mixed=False):
    keys = _bf16_keys(mixed)

    def conv(k, a):
        return jnp.asarray(a).astype(jnp.bfloat16 if k in keys else jnp.float32)
    return _map(conv, make_np_tree(seed, mixed))


def torch_tree(seed=0, mixed=False):
    keys = _bf16_keys(mixed)

    def conv(k, a):
        return torch.from_numpy(np.array(a)).to(torch.bfloat16 if k in keys else torch.float32)
    return _map(conv, make_np_tree(seed, mixed))


def _map(fn, tree, key=None):
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    return fn(key, tree)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _layout(plan):
    return [(b.dtype, b.size, [(bl.leaf_id, tuple(bl.shape), bl.offset) for bl in b.leaves])
            for b in plan.buckets]


@pytest.mark.parametrize("shard_pad", [1, 4])
@pytest.mark.parametrize("cap_bytes", [None, 1 << 20])
@pytest.mark.parametrize("mixed", [False, True])
def test_layout_matches_jax(mixed, cap_bytes, shard_pad):
    jp = jb.plan_of(jax_tree(mixed=mixed), cap_bytes=cap_bytes, shard_pad=shard_pad)
    tp = tb.plan_of(torch_tree(mixed=mixed), cap_bytes=cap_bytes, shard_pad=shard_pad)
    assert _layout(tp) == _layout(jp)
    assert tp.leaf_dtypes == jp.leaf_dtypes
    assert tp.n_leaves == jp.n_leaves
    for b in tp.buckets:
        assert b.total == tb.padded_total(b.size, b.dtype, shard_pad)
        itemsize = torch.empty((), dtype=tb.torch_dtype(b.dtype)).element_size()
        assert (b.total * itemsize) % (tb.ALIGN_BYTES * shard_pad) == 0
        assert (b.total // shard_pad * itemsize) % tb.ALIGN_BYTES == 0
        assert b.total - b.size < 16 // itemsize * shard_pad


@pytest.mark.parametrize("cap_bytes", [400, 1])
def test_cap_bytes_splits_at_leaf_granularity(cap_bytes):
    """A cap below the JAX package's TPU tile splits here (the port's
    unit is 16 bytes): every bucket stays within the cap unless one leaf
    alone exceeds it, leaves keep their order and never span buckets."""
    tt = torch_tree(mixed=True)
    plan = tb.plan_of(tt, cap_bytes=cap_bytes)
    ids = []
    for b in plan.buckets:
        itemsize = torch.empty((), dtype=tb.torch_dtype(b.dtype)).element_size()
        cap = max(cap_bytes // itemsize, 16 // itemsize)
        assert b.size <= cap or len(b.leaves) == 1
        ids.extend(bl.leaf_id for bl in b.leaves)
    assert sorted(ids) == list(range(plan.n_leaves))
    back = tb.unpack(plan, tb.pack(plan, tt))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(tt), tree_leaves(back)))


def test_padded_total_rule():
    assert tb.padded_total(0, "float32") == 0
    assert tb.padded_total(1, "float32") == 4
    assert tb.padded_total(4, "float32") == 4
    assert tb.padded_total(5, "bfloat16") == 8
    assert tb.padded_total(9, "bfloat16", shard_pad=3) == 24
    assert tb.padded_total(13, "float32", shard_pad=2) == 16


def test_plan_is_cached_hashable_and_built_from_shapes():
    t = torch_tree(mixed=True)
    plan = tb.plan_of(t)
    assert tb.plan_of({k: v for k, v in t.items()}) is plan
    hash(plan)
    shapes = [(tuple(x.shape), tb.dtype_name(x.dtype)) for x in tree_leaves(t)]
    assert tb.plan_of_shapes(tree_structure(t), shapes) is plan
    assert isinstance(plan.treedef, TreeDef) and plan.treedef.num_leaves == plan.n_leaves


@pytest.mark.parametrize("mixed", [False, True])
def test_pack_unpack_round_trip_matches_jax(mixed):
    jt, tt = jax_tree(mixed=mixed), torch_tree(mixed=mixed)
    jplan, tplan = jb.plan_of(jt), tb.plan_of(tt)
    jbk, tbk = jb.pack(jplan, jt, scale=0.5), tb.pack(tplan, tt, scale=0.5)
    for jarr, tarr, b in zip(jbk, tbk, tplan.buckets):
        assert tarr.dtype == torch.float32 and tarr.shape == (b.total,)
        np.testing.assert_array_equal(_np(tarr[:b.size]), _np(jarr[:b.size]))
        assert not tarr[b.size:].any()  # the pad is zero
    back = tb.unpack(tplan, tb.pack(tplan, tt))
    for x, y in zip(tree_leaves(tt), tree_leaves(back)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)
    as32 = tb.unpack(tplan, tb.pack(tplan, tt), dtype=torch.float32)
    assert all(x.dtype == torch.float32 for x in tree_leaves(as32))


def test_buckets_is_a_tree_node():
    from apex_tpu_torch.optimizers.tree import tree_map

    tt = torch_tree(mixed=True)
    plan = tb.plan_of(tt)
    bk = tb.Buckets(plan, tb.pack(plan, tt))
    doubled = tree_map(lambda a: a * 2, bk)
    assert isinstance(doubled, tb.Buckets) and doubled.plan is plan
    assert tree_leaves(bk) == list(bk.arrays)
    views = bk.leaf_views()
    for v, x in zip(views, tree_leaves(tt)):
        assert v.numel() == x.numel() and torch.equal(v, x.reshape(-1).float())
        assert v.data_ptr() >= bk.arrays[0].data_ptr() or v.data_ptr() >= bk.arrays[-1].data_ptr()


def test_per_leaf_reduce_matches_jax():
    jt, tt = jax_tree(mixed=True), torch_tree(mixed=True)
    jplan, tplan = jb.plan_of(jt), tb.plan_of(tt)
    jbk, tbk = jb.pack(jplan, jt), tb.pack(tplan, tt)
    jfirst = jb.per_leaf_reduce(jplan, jbk, lambda x: x[0])
    tfirst = tb.per_leaf_reduce(tplan, tbk, lambda x: x[0])
    np.testing.assert_array_equal(np.array([_np(x) for x in tfirst]),
                                  np.array([_np(x) for x in jfirst]))
    jsq = jb.per_leaf_reduce(jplan, jbk, lambda x: jnp.sum(jnp.square(x)))
    tsq = tb.per_leaf_reduce(tplan, tbk, lambda x: torch.sum(torch.square(x)))
    np.testing.assert_allclose(np.array([_np(x) for x in tsq]),
                               np.array([_np(x) for x in jsq]), rtol=1e-6)


def test_seg_helpers_match_jax():
    """Equal over each bucket's payload; the pad (its length is the
    port's rule) is 0 for values and ``n_leaves`` for ids, as in JAX."""
    jt, tt = jax_tree(mixed=True), torch_tree(mixed=True)
    jplan, tplan = jb.plan_of(jt), tb.plan_of(tt)
    per_leaf = [0.1 * (i + 1) for i in range(tplan.n_leaves)]
    same = [0.25] * tplan.n_leaves
    for jbk, tbk in zip(jplan.buckets, tplan.buckets):
        n = tbk.size
        assert tb.seg_values(tbk, same) == jb.seg_values(jbk, same) == 0.25
        tv = _np(tb.seg_values(tbk, per_leaf))
        np.testing.assert_array_equal(tv[:n], _np(jb.seg_values(jbk, per_leaf))[:n])
        assert tv.shape == (tbk.total,) and not tv[n:].any()
        ti = tb.seg_ids(tplan, tbk)
        np.testing.assert_array_equal(ti[:n], jb.seg_ids(jplan, jbk)[:n])
        assert (ti[n:] == tplan.n_leaves).all()
        tens = [torch.tensor(v) for v in per_leaf]
        jvec = _np(jb.seg_broadcast(jbk, [jnp.float32(v) for v in per_leaf]))
        for tvec in (_np(tb.seg_broadcast(tbk, tens)), _np(tb.seg_broadcast(tbk, per_leaf))):
            np.testing.assert_array_equal(tvec[:n], jvec[:n])
            assert tvec.shape == (tbk.total,) and not tvec[n:].any()


@pytest.mark.parametrize("cap_bytes", [None, 200])
def test_buckets_by_stage(cap_bytes):
    """Against JAX where the plans agree (no cap), and against the rule
    (a bucket's stage is its latest leaf's, buckets ascending) where the
    port's cap splits finer."""
    tplan = tb.plan_of(torch_tree(mixed=True), cap_bytes=cap_bytes)
    stages = [i % 3 for i in range(tplan.n_leaves)]
    got = tb.buckets_by_stage(tplan, stages, 3)
    want = [[] for _ in range(3)]
    for bi, b in enumerate(tplan.buckets):
        want[max(stages[bl.leaf_id] for bl in b.leaves)].append(bi)
    assert got == want
    if cap_bytes is None:
        jplan = jb.plan_of(jax_tree(mixed=True))
        assert got == jb.buckets_by_stage(jplan, stages, 3)


def test_tree_structure_round_trip_and_paths():
    from apex_tpu_torch.optimizers.tree import leaves_with_path

    tt = {"b": [torch.zeros(1), (torch.ones(2), None)], "a": torch.zeros(3)}
    td = tree_structure(tt)
    back = td.unflatten(tree_leaves(tt))
    assert [t.shape for t in tree_leaves(back)] == [t.shape for t in tree_leaves(tt)]
    assert back["b"][1][1] is None and isinstance(back["b"][1], tuple)
    jt = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tt)
    jpaths = [jax.tree_util.keystr(kp) for kp, _ in
              jax.tree_util.tree_flatten_with_path(jt)[0]]
    assert [p for p, _ in leaves_with_path(tt)] == jpaths
