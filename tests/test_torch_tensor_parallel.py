"""Tensor and sequence parallelism of the port
(``apex_tpu_torch.transformer.tensor_parallel``, ``transformer.layers``,
``transformer.utils``, ``parallel_state`` at tp > 1) against the JAX
package under ``shard_map`` on a tp mesh of the CPU devices, from the
same numpy inputs.

The port runs one world of 4 ranks (``parallel.multiproc.launch``, gloo)
that computes every case at tp = 4, then re-registers the groups at
tp = 2 (dp = 2) for the layout checks; each test holds rank r's values
to the JAX result's slice at tp index r.  Bands: fp32 sums over other
orders, 1e-6 absolute on O(1) values and 1e-5 relative where the
reference's own tests state 1e-5 (``tests/test_tensor_parallel.py``);
bitwise where nothing is summed (splits, gathers, copies).

Mirrors ``tests/test_tensor_parallel.py:43-230``: the seven mappings
forward and backward, the column and row linears, the sequence-parallel
pair, the vocab-parallel embedding, the vocab-parallel cross entropy
with its gradient at smoothing 0 and 0.1 and its out-of-range targets;
the fused LM-head CE with a tp group (the plain kernel versions) against
the JAX package's, including a target on rank 1's rows that the old
clamp would have put on rank 0's last row; the RNG seeds (key for key
against ``jax.random``), the tracker's state dict and ``checkpoint``'s
replay; the utilities, attributes, memory buffers, ``broadcast_data``,
grad accumulation and the sequence-parallel LayerNorm marking.
"""

import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer import tensor_parallel as jtp
from apex_tpu.transformer.layers import layer_norm as jln
from apex_tpu.transformer.tensor_parallel import random as jrandom
from apex_tpu.transformer import utils as jutils

from apex_tpu_torch.parallel import multiproc
from apex_tpu_torch.transformer import tensor_parallel as ttp
from apex_tpu_torch.transformer import utils as tutils
from apex_tpu_torch.transformer.layers import layer_norm as tln
from apex_tpu_torch.transformer.tensor_parallel import random as trandom

REPO = Path(__file__).resolve().parent.parent
TP = 4
#: fp32 sums in another order; the reference's own tests' band
TOL = {"rtol": 1e-5, "atol": 1e-6}

#: the mappings: name -> (global input shape, input spec, output spec)
MAP_CASES = {
    "copy": ((6, 8), (None, None), (None, None)),
    "reduce": ((4 * TP, 5), ("tp", None), (None, None)),
    "scatter": ((6, 4 * TP), (None, None), (None, "tp")),
    "gather": ((6, 2 * TP), (None, "tp"), (None, None)),
    "seq_scatter": ((2 * TP, 6), (None, None), ("tp", None)),
    "seq_gather": ((2 * TP, 6), ("tp", None), (None, None)),
    "seq_gather_split": ((2 * TP, 6), ("tp", None), (None, None)),
    "seq_reduce_scatter": ((2 * TP, 6), (None, None), ("tp", None)),
}


def local_slice(a, spec, r, n):
    """Rank ``r``'s block of ``a`` under ``spec`` over ``n`` ranks."""
    for d, ax in enumerate(spec):
        if ax == "tp":
            k = a.shape[d] // n
            a = np.take(a, np.arange(r * k, (r + 1) * k), axis=d)
    return a


def local_shape(shape, spec, n):
    return tuple(s // n if ax == "tp" else s for s, ax in zip(shape, spec))


def map_inputs(name):
    """The global input of a mapping case and its cotangent (the local
    output's shape, the same on every rank)."""
    shape, in_spec, out_spec = MAP_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    x = rng.randn(*shape).astype(np.float32)
    y_shape = {"reduce": local_shape(shape, in_spec, TP),
               "scatter": local_shape(shape, out_spec, TP),
               "gather": shape, "seq_gather": shape, "seq_gather_split": shape}.get(
                   name, local_shape(shape, out_spec, TP))
    return x, rng.randn(*y_shape).astype(np.float32)


def layer_inputs():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {"col_x": f(6, 16), "col_w": f(24, 16), "col_b": f(24),
            "row_x": f(6, 16), "row_w": f(10, 16), "row_b": f(10),
            "sp_x": f(8, 16), "sp_w1": f(32, 16), "sp_w2": f(16, 32),
            "emb_w": f(32, 8), "emb_ids": rng.randint(0, 32, size=(4, 6)), "emb_c": f(4, 6, 8),
            "ce_logits": (f(10, 32) * 3).astype(np.float32),
            "ce_t": rng.randint(0, 32, size=(10,)),
            "ce_t_oob": np.array([-1, 32, 35, 0, 31, 7, 8, 15, 16, 40]),
            "fce_x": f(8, 2, 16), "fce_e": (f(32, 16) * 0.5).astype(np.float32),
            "fce_t": rng.randint(0, 32, size=(8, 2)),
            # every id on rank 1's rows (8..15 of 32 over 4 ranks)
            "fce_t_rank1": rng.randint(8, 16, size=(8, 2)),
            "fce_t_oob": np.array([[-1, 32], [40, 3], [8, 15], [16, 0], [31, 24], [7, 9],
                                   [33, -5], [12, 28]]),
            "bcast": f(3, 5), "split1d": f(4, 6), "sp_grads": f(4, 8)}


CHILD = r'''
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from apex_tpu_torch.parallel import initialize_distributed, destroy_distributed
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import tensor_parallel as ttp
from apex_tpu_torch.transformer import utils as tutils
from apex_tpu_torch.transformer.layers import layer_norm as tln
from apex_tpu_torch.ops.fused_ce import fused_lm_head_ce
exec(sys.argv[3])
initialize_distributed("cpu")
ps.initialize_model_parallel(tensor_model_parallel_size_=TP)
g = ps.get_tensor_model_parallel_group()
r = g.rank()
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
out = {}
ops = {"copy": ttp.copy_to_tensor_model_parallel_region,
       "reduce": ttp.reduce_from_tensor_model_parallel_region,
       "scatter": ttp.scatter_to_tensor_model_parallel_region,
       "gather": ttp.gather_from_tensor_model_parallel_region,
       "seq_scatter": ttp.scatter_to_sequence_parallel_region,
       "seq_gather": ttp.gather_from_sequence_parallel_region,
       "seq_gather_split": lambda x: ttp.gather_from_sequence_parallel_region(x, None, False),
       "seq_reduce_scatter": ttp.reduce_scatter_to_sequence_parallel_region}
for name, op in ops.items():
    shape, in_spec, _ = MAP_CASES[name]
    x, c = map_inputs(name)
    xl = T(local_slice(x, in_spec, r, TP)).requires_grad_(True)
    y = op(xl)
    (gx,) = torch.autograd.grad((y * T(c)).sum(), xl)
    out["map_" + name] = (y.detach(), gx)

li = layer_inputs()
def grads_of(loss, *ts):
    return [t.detach() for t in torch.autograd.grad(loss, ts)]
x, w, b = T(li["col_x"]), T(local_slice(li["col_w"], ("tp", None), r, TP)), T(local_slice(li["col_b"], ("tp",), r, TP))
for t in (x, w, b): t.requires_grad_(True)
y = ttp.column_parallel_linear(x, w, b, gather_output=True)
out["column"] = [y.detach()] + grads_of(torch.sin(y).sum() / 100.0, x, w, b)
x, w, b = (T(local_slice(li["row_x"], (None, "tp"), r, TP)), T(local_slice(li["row_w"], (None, "tp"), r, TP)), T(li["row_b"]))
for t in (x, w, b): t.requires_grad_(True)
y = ttp.row_parallel_linear(x, w, b, input_is_parallel=True)
out["row"] = [y.detach()] + grads_of(torch.sin(y).sum() / 100.0, x, w, b)
x = T(local_slice(li["sp_x"], ("tp", None), r, TP)).requires_grad_(True)
w1 = T(local_slice(li["sp_w1"], ("tp", None), r, TP)).requires_grad_(True)
w2 = T(local_slice(li["sp_w2"], (None, "tp"), r, TP)).requires_grad_(True)
h = ttp.column_parallel_linear(x, w1, None, gather_output=False, sequence_parallel_enabled=True)
h = torch.nn.functional.gelu(h)
y = ttp.row_parallel_linear(h, w2, None, input_is_parallel=True, sequence_parallel_enabled=True)
out["sp_pair"] = [y.detach()] + grads_of(torch.sin(y).sum(), x, w1, w2)
w = T(local_slice(li["emb_w"], ("tp", None), r, TP)).requires_grad_(True)
y = ttp.vocab_parallel_embedding(T(li["emb_ids"]), w)
out["embedding"] = [y.detach()] + grads_of((y * T(li["emb_c"])).sum(), w)
for key, t, s in (("ce", "ce_t", 0.0), ("ce_smooth", "ce_t", 0.1), ("ce_oob", "ce_t_oob", 0.0)):
    lg = T(local_slice(li["ce_logits"], (None, "tp"), r, TP)).requires_grad_(True)
    loss = ttp.vocab_parallel_cross_entropy(lg, T(li[t]), s)
    out[key] = [loss.detach()] + grads_of(loss.mean(), lg)
for key, t in (("fce", "fce_t"), ("fce_rank1", "fce_t_rank1"), ("fce_oob", "fce_t_oob")):
    x = T(li["fce_x"]).requires_grad_(True)
    e = T(local_slice(li["fce_e"], ("tp", None), r, TP)).requires_grad_(True)
    loss = fused_lm_head_ce(ttp.copy_to_tensor_model_parallel_region(x), e, T(li[t]), 4, g)
    out[key] = [loss.detach()] + grads_of(loss.mean(), x, e)
out["split1d"] = tutils.split_tensor_into_1d_equal_chunks(T(li["split1d"]))
out["gather1d"] = tutils.gather_split_1d_tensor(out["split1d"])
out["bcast"] = ttp.broadcast_data(["a"], {"a": T(li["bcast"] + r)}, torch.float64)["a"]
grads = {"layers": {"ln1_scale": T(li["sp_grads"][0] + r), "wq": T(li["sp_grads"][1] + r)},
         "final_ln_bias": T(li["sp_grads"][2] + r)}
mask = tln.sequence_parallel_param_mask(grads)
out["sp_allreduce"] = tln.allreduce_sequence_parallel_grads(grads, mask)
out["tp_state"] = (ps.get_tensor_model_parallel_rank(), ps.get_tensor_model_parallel_world_size(),
                   ps.get_data_parallel_rank(), ps.get_data_parallel_world_size(),
                   ps.get_tensor_model_parallel_src_rank(), ps.get_data_parallel_src_rank())
# tp = 2 on the same world: dp = 2, the JAX mesh's layout
ps.destroy_model_parallel()
ps.initialize_model_parallel(tensor_model_parallel_size_=2)
out["tp2_state"] = (ps.get_tensor_model_parallel_rank(), ps.get_tensor_model_parallel_world_size(),
                    ps.get_data_parallel_rank(), ps.get_data_parallel_world_size(),
                    ps.get_tensor_model_parallel_src_rank(), ps.get_data_parallel_src_rank(),
                    ps.get_tensor_model_parallel_group().ranks, ps.get_data_parallel_group().ranks)
v = torch.tensor([float(dist.get_rank())])
out["tp2_sum"] = ttp.reduce_from_tensor_model_parallel_region(v)
torch.save(out, sys.argv[2] + f"/rank{dist.get_rank()}.pt")
destroy_distributed()
'''


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The world-4 child's results, rank by rank."""
    out = tmp_path_factory.mktemp("tp4")
    defs = "\n".join([f"TP = {TP}", f"MAP_CASES = {MAP_CASES!r}",
                      *(inspect.getsource(f) for f in (local_slice, local_shape, map_inputs,
                                                       layer_inputs))])
    multiproc.launch(["-c", CHILD, str(REPO), str(out), defs], TP, timeout=300)
    return [torch.load(out / f"rank{r}.pt") for r in range(TP)]


@pytest.fixture(scope="module")
def mesh(devices8):
    return Mesh(np.array(devices8[:TP]), ("tp",))


def smap(mesh, f, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               **(tol or TOL))


# ------------------------------------------------------------------ mappings
JAX_OPS = {
    "copy": jtp.copy_to_tensor_model_parallel_region,
    "reduce": jtp.reduce_from_tensor_model_parallel_region,
    "scatter": jtp.scatter_to_tensor_model_parallel_region,
    "gather": jtp.gather_from_tensor_model_parallel_region,
    "seq_scatter": jtp.scatter_to_sequence_parallel_region,
    "seq_gather": jtp.gather_from_sequence_parallel_region,
    "seq_gather_split": lambda x: jtp.gather_from_sequence_parallel_region(x, "tp", False),
    "seq_reduce_scatter": jtp.reduce_scatter_to_sequence_parallel_region,
}


@pytest.mark.parametrize("name", sorted(MAP_CASES))
def test_mapping_forward_and_backward(world4, mesh, name):
    """Each region op's output and its input's gradient (of sum(y * c))
    on every rank: bitwise where the op only moves data, within fp32
    ulps where it sums."""
    shape, in_spec, out_spec = MAP_CASES[name]
    x, c = map_inputs(name)
    op = JAX_OPS[name]

    def per_rank(x, c):
        return op(x), jax.grad(lambda x: jnp.sum(op(x) * c))(x)

    y, g = smap(mesh, per_rank, (P(*in_spec), P()), (P(*out_spec), P(*in_spec)))(
        jnp.asarray(x), jnp.asarray(c))
    y, g = np.asarray(y), np.asarray(g)
    # the ops that sum (forward or backward) agree within fp32 ulps, the
    # others move data and agree bitwise
    check = (_close if name in ("reduce", "copy", "seq_gather", "seq_reduce_scatter")
             else lambda got, want: np.testing.assert_array_equal(got.numpy(), want))
    for r, res in enumerate(world4):
        got_y, got_g = res["map_" + name]
        check(got_y, local_slice(y, out_spec, r, TP))
        check(got_g, local_slice(g, in_spec, r, TP))


def test_mapping_values_are_the_reference_tests(world4):
    """The reference tests' closed forms: copy's backward is tp x the
    gradient; the sequence gather's backward of a replicated loss sums tp
    copies; reduce of a row a rank is tp."""
    x, c = map_inputs("copy")
    for res in world4:
        np.testing.assert_allclose(res["map_copy"][1].numpy(), TP * c, rtol=1e-6)
        assert res["map_copy"][0].numpy().tobytes() == x.tobytes()


# -------------------------------------------------------------------- layers
def test_column_parallel_matches_jax(world4, mesh):
    li = layer_inputs()

    def per_rank(x, w, b):
        def loss(x, w, b):
            y = jtp.column_parallel_linear(x, w, b, gather_output=True, axis_name="tp")
            return jnp.sum(jnp.sin(y)) / 100.0, y
        (_, y), gs = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(x, w, b)
        return (y,) + gs

    specs = (P(), P("tp", None), P("tp"))
    y, gx, gw, gb = smap(mesh, per_rank, specs, (P(),) + specs)(
        li["col_x"], li["col_w"], li["col_b"])
    _close(world4[0]["column"][0], li["col_x"] @ li["col_w"].T + li["col_b"], rtol=1e-5,
           atol=1e-5)
    for r, res in enumerate(world4):
        got_y, got_gx, got_gw, got_gb = res["column"]
        _close(got_y, y)
        _close(got_gx, gx)
        _close(got_gw, local_slice(np.asarray(gw), ("tp", None), r, TP))
        _close(got_gb, local_slice(np.asarray(gb), ("tp",), r, TP))


def test_row_parallel_matches_jax(world4, mesh):
    li = layer_inputs()

    def per_rank(x, w, b):
        def loss(x, w, b):
            y = jtp.row_parallel_linear(x, w, b, input_is_parallel=True, axis_name="tp")
            return jnp.sum(jnp.sin(y)) / 100.0, y
        (_, y), gs = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(x, w, b)
        return (y,) + gs

    specs = (P(None, "tp"), P(None, "tp"), P())
    y, gx, gw, gb = smap(mesh, per_rank, specs, (P(),) + specs)(
        li["row_x"], li["row_w"], li["row_b"])
    _close(world4[0]["row"][0], li["row_x"] @ li["row_w"].T + li["row_b"], rtol=1e-5,
           atol=1e-5)
    for r, res in enumerate(world4):
        got_y, got_gx, got_gw, got_gb = res["row"]
        _close(got_y, y)
        _close(got_gx, local_slice(np.asarray(gx), (None, "tp"), r, TP))
        _close(got_gw, local_slice(np.asarray(gw), (None, "tp"), r, TP))
        _close(got_gb, gb)


def test_column_row_pair_sequence_parallel_matches_jax(world4, mesh):
    """The Megatron block: SP in, column (all-gather), gelu, row
    (reduce-scatter), SP out; output and every gradient."""
    li = layer_inputs()

    def per_rank(x, w1, w2):
        def f(x, w1, w2):
            h = jtp.column_parallel_linear(x, w1, None, gather_output=False,
                                           sequence_parallel_enabled=True, axis_name="tp")
            h = jax.nn.gelu(h, approximate=False)
            y = jtp.row_parallel_linear(h, w2, None, input_is_parallel=True,
                                        sequence_parallel_enabled=True, axis_name="tp")
            return jnp.sum(jnp.sin(y)), y
        (_, y), gs = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(x, w1, w2)
        return (y,) + gs

    specs = (P("tp", None), P("tp", None), P(None, "tp"))
    outs = smap(mesh, per_rank, specs, (P("tp", None),) + specs)(
        li["sp_x"], li["sp_w1"], li["sp_w2"])
    for r, res in enumerate(world4):
        for got, want, spec in zip(res["sp_pair"], outs, (("tp", None),) + tuple(
                tuple(s) for s in specs)):
            # the reference test's band (tests/test_tensor_parallel.py:172)
            _close(got, local_slice(np.asarray(want), spec, r, TP), rtol=1e-4, atol=1e-4)


def test_vocab_parallel_embedding_matches_jax(world4, mesh):
    li = layer_inputs()

    def per_rank(ids, w, c):
        def f(w):
            y = jtp.vocab_parallel_embedding(ids, w, axis_name="tp")
            return jnp.sum(y * c), y
        (_, y), gw = jax.value_and_grad(f, has_aux=True)(w)
        return y, gw

    y, gw = smap(mesh, per_rank, (P(), P("tp", None), P()), (P(), P("tp", None)))(
        li["emb_ids"], li["emb_w"], li["emb_c"])
    for r, res in enumerate(world4):
        np.testing.assert_array_equal(res["embedding"][0].numpy(), li["emb_w"][li["emb_ids"]])
        np.testing.assert_array_equal(res["embedding"][0].numpy(), np.asarray(y))
        _close(res["embedding"][1], local_slice(np.asarray(gw), ("tp", None), r, TP))


@pytest.mark.parametrize("key,target,smoothing", [
    ("ce", "ce_t", 0.0), ("ce_smooth", "ce_t", 0.1), ("ce_oob", "ce_t_oob", 0.0)],
    ids=["smoothing0", "smoothing0.1", "out_of_range"])
def test_vocab_parallel_cross_entropy_matches_jax(world4, mesh, key, target, smoothing):
    """Each rank's loss and gradient of its mean loss.  Out-of-range ids (-1, 32, 35,
    40 over a vocab of 32) follow the reference: no rank holds them, the
    target term is 0, the loss is log(sum exp(logits - max))."""
    li = layer_inputs()
    logits, t = li["ce_logits"], li[target]

    def per_rank(lg, t):
        def f(lg):
            loss = jtp.vocab_parallel_cross_entropy(lg, t, smoothing, "tp")
            return jnp.mean(loss), loss
        (_, loss), g = jax.value_and_grad(f, has_aux=True)(lg)
        return loss[None], g

    # each rank's loss: with smoothing its mean log-probability is the
    # partition's own (cross_entropy.py:78-97), so the ranks differ
    loss, g = smap(mesh, per_rank, (P(None, "tp"), P()), (P("tp"), P(None, "tp")))(logits, t)
    for r, res in enumerate(world4):
        _close(res[key][0], np.asarray(loss)[r])
        _close(res[key][1], local_slice(np.asarray(g), (None, "tp"), r, TP))
    if key == "ce_oob":
        shifted = logits - logits.max(axis=1, keepdims=True)
        bad = (t < 0) | (t >= 32)
        _close(world4[0][key][0].numpy()[bad],
               np.log(np.exp(shifted).sum(axis=1))[bad], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("key,target", [("fce", "fce_t"), ("fce_rank1", "fce_t_rank1"),
                                        ("fce_oob", "fce_t_oob")],
                         ids=["in_range", "rank1_targets", "out_of_range"])
def test_fused_lm_head_ce_with_a_tp_group_matches_jax(world4, mesh, key, target):
    """The vocab-parallel fused head (the CE kernels' plain versions on the
    shard, the combine of m, l and tgt) against the JAX package's
    ``fused_lm_head_ce(axis_name="tp")``: the loss, dx (summed by the
    copy-to-region) and each rank's dembed rows.  ``rank1_targets`` puts
    every id on rank 1's rows: clamped into rank 0's shard they would
    count rank 0's last row.  Out-of-range ids miss every shard: loss =
    lse, as in the reference."""
    from apex_tpu.ops.fused_ce import fused_lm_head_ce as jfused

    li = layer_inputs()
    t = li[target]

    def per_rank(x, e, t):
        def f(x, e):
            loss = jfused(jtp.copy_to_tensor_model_parallel_region(x, "tp"), e, t, 4, "tp")
            return jnp.mean(loss), loss
        (_, loss), (gx, ge) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(x, e)
        return loss, gx, ge

    loss, gx, ge = smap(mesh, per_rank, (P(), P("tp", None), P()),
                        (P(), P(), P("tp", None)))(li["fce_x"], li["fce_e"], t)
    logits = li["fce_x"].astype(np.float64) @ li["fce_e"].T.astype(np.float64)
    lse = np.log(np.exp(logits).sum(-1))
    for r, res in enumerate(world4):
        _close(res[key][0], loss)
        _close(res[key][1], gx)
        _close(res[key][2], local_slice(np.asarray(ge), ("tp", None), r, TP))
    ok = (t >= 0) & (t < 32)
    tgt = np.where(ok, np.take_along_axis(logits, np.clip(t, 0, 31)[..., None], -1)[..., 0], 0)
    _close(world4[0][key][0], lse - tgt, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ parallel_state
def test_parallel_state_layout_is_the_jax_mesh(world4, devices8):
    """tp 4 on 4 ranks, then tp 2 x dp 2: each rank's (tp, dp) ranks and
    sizes are the coordinates of the JAX mesh's device of the same
    index; the source ranks and the groups' members follow."""
    for tp, key in ((4, "tp_state"), (2, "tp2_state")):
        jps.initialize_model_parallel(tensor_model_parallel_size_=tp, devices=devices8[:4])
        try:
            devs = jps.get_mesh().devices.reshape(4 // tp, tp)
        finally:
            jps.destroy_model_parallel()
        for r, res in enumerate(world4):
            dp_i, tp_i = map(int, np.argwhere(np.vectorize(lambda d: d.id)(devs)
                                              == devices8[r].id)[0])
            state = res[key]
            assert state[:6] == (tp_i, tp, dp_i, 4 // tp, dp_i * tp, tp_i), (r, state)
            if tp == 2:
                assert state[6] == tuple(range(dp_i * tp, dp_i * tp + tp))
                assert state[7] == tuple(range(tp_i, 4, tp))
                assert float(res["tp2_sum"]) == sum(state[6])


# ---------------------------------------------------------------- utilities
def test_split_and_gather_1d(world4):
    x = layer_inputs()["split1d"]
    for r, res in enumerate(world4):
        want = jutils.split_tensor_into_1d_equal_chunks(jnp.asarray(x), rank=r, world_size=TP)
        np.testing.assert_array_equal(res["split1d"].numpy(), np.asarray(want))
        np.testing.assert_array_equal(res["gather1d"].numpy(), x.reshape(-1))
        got = tutils.split_tensor_into_1d_equal_chunks(torch.from_numpy(x), rank=r,
                                                       world_size=TP)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_broadcast_data_takes_tp_rank0(world4):
    x = layer_inputs()["bcast"]
    for res in world4:
        assert res["bcast"].dtype == torch.float64
        np.testing.assert_array_equal(res["bcast"].numpy(), x.astype(np.float64))


def test_vocab_utility_and_split_along_last_dim():
    for args in ((50304, 1, 4), (32, 3, 4), (12576, 2, 4)):
        assert (ttp.VocabUtility.vocab_range_from_global_vocab_size(*args)
                == tuple(map(int, jtp.VocabUtility.vocab_range_from_global_vocab_size(*args))))
        assert (ttp.VocabUtility.vocab_range_from_per_partition_vocab_size(*args)
                == tuple(map(int,
                             jtp.VocabUtility.vocab_range_from_per_partition_vocab_size(*args))))
    x = np.arange(24, dtype=np.float32).reshape(2, 12)
    for got, want in zip(ttp.split_tensor_along_last_dim(torch.from_numpy(x), 3),
                         jtp.split_tensor_along_last_dim(jnp.asarray(x), 3), strict=True):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        ttp.split_tensor_along_last_dim(torch.from_numpy(x), 5)
    assert tutils.divide(12, 4) == 3
    with pytest.raises(ValueError):
        tutils.ensure_divisibility(10, 4)


def test_attributes_match_jax():
    a = ttp.set_tensor_model_parallel_attributes(True, 0, 1)
    assert vars(a) == vars(jtp.set_tensor_model_parallel_attributes(True, 0, 1))
    assert vars(ttp.set_defaults_if_not_set_tensor_model_parallel_attributes(None)) == vars(
        jtp.set_defaults_if_not_set_tensor_model_parallel_attributes(None))
    for attrs in (None, a, ttp.TensorParallelAttributes()):
        for rank in (0, 1):
            jattrs = None if attrs is None else jtp.TensorParallelAttributes(**vars(attrs))
            assert (ttp.param_is_not_tensor_parallel_duplicate(attrs, rank)
                    == jtp.param_is_not_tensor_parallel_duplicate(jattrs, rank))
    b = ttp.copy_tensor_model_parallel_attributes(a)
    assert b == a and b is not a
    p = ttp.apply_attributes(torch.nn.Parameter(torch.zeros(2)), a)
    assert p.tensor_model_parallel and p.partition_dim == 0 and p.partition_stride == 1
    assert ttp.param_is_not_tensor_parallel_duplicate(p, 3)
    assert not ttp.param_is_not_tensor_parallel_duplicate(torch.zeros(1), 3)
    tree = {"w": torch.zeros(4, 2), "b": {"c": torch.zeros(3)}}
    spec = ttp.attributes_tree(tree, lambda path, leaf: (0, 1) if path == ("w",) else None)
    jspec = jtp.attributes_tree({"w": jnp.zeros((4, 2)), "b": {"c": jnp.zeros(3)}},
                                lambda path, leaf: (0, 1) if "'w'" in jax.tree_util.keystr(path)
                                else None)
    assert vars(spec["w"]) == vars(jspec["w"]) and vars(spec["b"]["c"]) == vars(jspec["b"]["c"])


def test_parallel_modules_hold_their_shards():
    """At tp 1 (the world-1 group of this process is not needed: a
    one-rank AxisGroup) the modules are the dense layers."""
    from apex_tpu_torch.transformer.parallel_state import AxisGroup

    one = AxisGroup("tp", None, 1, 0, (0,))
    gen = torch.Generator().manual_seed(0)
    col = ttp.ColumnParallelLinear(8, 6, axis_name=one, device="cpu", generator=gen)
    row = ttp.RowParallelLinear(6, 4, axis_name=one, device="cpu", generator=gen)
    emb = ttp.VocabParallelEmbedding(10, 8, axis_name=one, device="cpu", generator=gen)
    assert col.weight.shape == (6, 8) and col.weight.partition_dim == 0
    assert row.weight.partition_dim == 1 and not row.bias.tensor_model_parallel
    ids = torch.tensor([[1, 9], [0, 3]])
    x = emb(ids)
    np.testing.assert_array_equal(x.detach().numpy(), emb.weight.detach().numpy()[ids.numpy()])
    y = row(col(x))
    want = (x @ col.weight.T + col.bias) @ row.weight.T + row.bias
    _close(y.detach(), want.detach())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttp.ColumnParallelLinear(8, 6, axis_name=one)


# ---------------------------------------------------------------- random
@pytest.mark.parametrize("seed", [0, 1234, 2 ** 31 - 1])
def test_model_parallel_seed_is_the_jax_keys(seed):
    for tp_rank in range(4):
        for pp_rank in (0, 1):
            dp_key, mp_key = trandom.model_parallel_seed(seed, tp_rank, pp_rank)
            jdp, jmp = jrandom.model_parallel_seed(seed, tp_rank, pp_rank)
            np.testing.assert_array_equal(dp_key, np.asarray(jax.random.key_data(jdp)))
            np.testing.assert_array_equal(mp_key, np.asarray(jax.random.key_data(jmp)))
    key = trandom.prng_key(seed)
    for data in (0, 1, 7, 2 ** 32 - 1):
        want = jax.random.key_data(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        np.testing.assert_array_equal(trandom.fold_in(key, data), np.asarray(want))


def test_rng_tracker_streams_and_state_dict():
    from apex_tpu_torch import resilience

    trandom.model_parallel_cuda_manual_seed(1234, 1, device="cpu")
    tracker = ttp.get_rng_state_tracker()
    assert ttp.get_cuda_rng_tracker() is tracker
    assert sorted(tracker.states_) == ["default", "model-parallel-rng"]
    a = torch.rand(5, generator=tracker.fork())
    b = torch.rand(5, generator=tracker.fork("default"))
    assert not torch.equal(a, b)
    snap = resilience.rng_tracker_state_dict()
    assert snap["counts"] == {"default": 1, "model-parallel-rng": 1}
    after = torch.rand(7, generator=tracker.fork())
    torch.rand(3, generator=tracker.fork())
    resilience.load_rng_tracker_state_dict(snap)
    assert torch.equal(torch.rand(7, generator=tracker.fork()), after)
    assert tracker.counts_["model-parallel-rng"] == 2
    # the model-parallel stream differs by tp rank, the default one not
    other = ttp.RNGStatesTracker(device="cpu")
    dp_key, mp_key = trandom.model_parallel_seed(1234, 2)
    other.add("default", dp_key)
    other.add("model-parallel-rng", mp_key)
    trandom.model_parallel_cuda_manual_seed(1234, 1, device="cpu")
    assert torch.equal(torch.rand(4, generator=other.fork("default")),
                       torch.rand(4, generator=tracker.fork("default")))
    assert not torch.equal(torch.rand(4, generator=other.fork()),
                           torch.rand(4, generator=tracker.fork()))
    with pytest.raises(Exception, match="already exists"):
        other.add("default", 3)
    with pytest.raises(Exception, match="not added"):
        other.fork("nope")


def test_checkpoint_replays_the_tracker_streams():
    """A dropout drawn from the model-parallel stream inside
    ``checkpoint``: the recompute draws the forward's mask, so the
    gradients equal those of the plain function, and the stream ends
    where the plain run's ends."""
    def layer(x, w):
        keep = torch.rand(x.shape, generator=ttp.get_rng_state_tracker().fork()) > 0.3
        return torch.tanh((x * keep) @ w)

    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0), requires_grad=True)
    w = torch.randn(6, 3, generator=torch.Generator().manual_seed(1), requires_grad=True)
    grads = []
    for ckpt in (False, True):
        trandom.model_parallel_cuda_manual_seed(7, 0, device="cpu")
        y = ttp.checkpoint(layer, False, x, w) if ckpt else layer(x, w)
        grads.append(torch.autograd.grad(y.sum(), (x, w)) + (
            ttp.get_rng_state_tracker().get_states()["model-parallel-rng"],))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ------------------------------------------------------------------- memory
def test_memory_buffers():
    from apex_tpu_torch.transformer.tensor_parallel import memory

    memory.reset_mem_buffs()
    buf = ttp.allocate_mem_buff("acts", 10, torch.float32, track_usage=True, device="cpu")
    a = buf.add(torch.arange(4.0).reshape(2, 2))
    b = buf.add(torch.ones(3))
    assert buf.numel_in_use() == 7 and buf.is_in_use()
    np.testing.assert_array_equal(buf.get_data().numpy(), [0, 1, 2, 3, 1, 1, 1])
    assert a.data_ptr() == buf.data.data_ptr() and b.shape == (3,)
    with pytest.raises(AssertionError, match="Not enough"):
        buf.add(torch.ones(4))
    with pytest.raises(AssertionError, match="dtype"):
        buf.add(torch.ones(1, dtype=torch.float64))
    buf.reset()
    assert not buf.is_in_use() and buf.get_data().numel() == 0
    assert buf.total_value == 20.0 and buf.in_use_value == 7.0
    ring = ttp.RingMemBuffer("ring", 2, 4, torch.float32, device="cpu")
    first = ring.get_next_buffer()
    first.add(torch.ones(2))
    assert ring.get_next_buffer() is not first and ring.get_next_buffer() is first
    assert not first.is_in_use()
    assert sorted(ttp.get_mem_buffs()) == ["acts", "ring 0", "ring 1"]
    with pytest.raises(AssertionError, match="already allocated"):
        ttp.allocate_mem_buff("acts", 1, torch.float32)
    trandom.init_checkpointed_activations_memory_buffer(2, 8, 4, 4, 2, 2, False, device="cpu")
    cbuf = ttp.get_mem_buffs()["checkpointed activations"]
    assert cbuf.numel == 2 * 8 * 4 // 2 * 2 and cbuf.dtype == torch.float32
    cbuf.add(torch.ones(3))
    ttp.reset_checkpointed_activations_memory_buffer()
    assert not cbuf.is_in_use()
    memory.reset_mem_buffs()


# ------------------------------------------------------------- grad_accum
def test_accumulate_gradients_matches_jax():
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(8, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    mbs = {"x": rng.randn(6, 5, 8).astype(np.float32), "y": rng.randn(6, 5, 4).astype(np.float32)}

    def jloss(p, mb):
        return jnp.mean((jnp.tanh(mb["x"] @ p["w"] + p["b"]) - mb["y"]) ** 2)

    def tloss(p, mb):
        return torch.mean((torch.tanh(mb["x"] @ p["w"] + p["b"]) - mb["y"]) ** 2)

    tp_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tmbs = {k: torch.from_numpy(v) for k, v in mbs.items()}
    for mean in (True, False):
        jl, jg = jtp.accumulate_gradients(jloss, jax.tree.map(jnp.asarray, params),
                                          jax.tree.map(jnp.asarray, mbs), mean_loss=mean)
        tl, tg = ttp.make_grad_accumulator(tloss, mean_loss=mean)(tp_params, tmbs)
        _close(tl, jl)
        for k in params:
            assert tg[k].dtype == torch.float32
            _close(tg[k], jg[k])


# ----------------------------------------------------------- layer norm
def test_sequence_parallel_layer_norm_marking(world4):
    ln = tln.FusedLayerNorm(8, sequence_parallel_enabled=True, device="cpu")
    assert ln.weight.sequence_parallel_enabled and ln.bias.sequence_parallel_enabled
    assert isinstance(tln.FastLayerNorm(8, device="cpu"), tln.FusedLayerNorm)
    x = torch.randn(3, 8)
    _close(ln(x).detach(), torch.nn.functional.layer_norm(x, (8,)).detach())
    from apex_tpu.models.gpt import GPTConfig as JConfig, init_params as jinit
    from apex_tpu_torch.models import gpt as tgpt

    jparams = jinit(JConfig(vocab_size=16, hidden_size=8, num_layers=1, num_attention_heads=2,
                            max_seq_len=4), jax.random.PRNGKey(0))
    tparams = tgpt.init_params(tgpt.GPTConfig(vocab_size=16, hidden_size=8, num_layers=1,
                                              num_attention_heads=2, max_seq_len=4), 0, "cpu")
    jmask = dict((jax.tree_util.keystr(k), v) for k, v in
                 jax.tree_util.tree_flatten_with_path(jln.sequence_parallel_param_mask(jparams))[0])
    from apex_tpu_torch.optimizers.tree import leaves_with_path

    assert dict(leaves_with_path(tln.sequence_parallel_param_mask(tparams))) == jmask
    # the world-4 sum of the marked leaves only
    g = layer_inputs()["sp_grads"]
    for r, res in enumerate(world4):
        got = res["sp_allreduce"]
        _close(got["layers"]["ln1_scale"], 4 * g[0] + 6)
        np.testing.assert_array_equal(got["layers"]["wq"].numpy(), g[1] + r)
        _close(got["final_ln_bias"], 4 * g[2] + 6)
