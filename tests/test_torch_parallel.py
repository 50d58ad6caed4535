"""Data parallelism of the port (``apex_tpu_torch.transformer.parallel_state``,
``apex_tpu_torch.parallel``) against the JAX package, on the CPU under gloo.

- ``parallel_state``: the axis names are the JAX package's; at world 1
  (an in-process gloo group) every getter answers as the JAX package's
  does on a dp = 1 mesh; tp, pp, cp, a DCN split and the interleaved
  schedule raise, naming their ROADMAP.md queue item;
- ``multiproc``: the backend follows the device, a group already up is
  kept, a mismatched backend raises;
- ``allreduce_gradients`` with each of its three knobs
  (``gradient_average``, ``gradient_predivide_factor``,
  ``allreduce_always_fp32``) at world 2 — two processes started by
  ``multiproc.launch`` — bitwise against the JAX function under
  ``shard_map`` on two virtual devices, on grads whose sums are exact (a
  sum of two values is order-free: the band is bitwise); the
  ``DistributedDataParallel`` wrapper and ``Reducer`` the same; and
  ``sync_found_inf`` over the group: one rank's non-finite vote reaches
  every rank.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.parallel import allreduce_gradients as jax_allreduce
from apex_tpu.transformer import parallel_state as jps

from apex_tpu_torch.parallel import multiproc
from apex_tpu_torch.transformer import parallel_state as ps

REPO = Path(__file__).resolve().parent.parent

#: the cases of the world-2 child: name -> allreduce_gradients kwargs
CASES = {
    "average": {},
    "sum": {"gradient_average": False},
    "predivide": {"gradient_predivide_factor": 2.0},
    "predivide_sum": {"gradient_average": False, "gradient_predivide_factor": 4.0},
    "always_fp32": {"allreduce_always_fp32": True},
}


def grads_of(rank):
    """Rank ``rank``'s grads: fp32 and bf16 leaves of small multiples of
    2^-3 (every sum and division by 2 or 4 exact)."""
    rng = np.random.RandomState(100 + rank)
    ints = lambda *s: (rng.randint(-8, 9, size=s) * 0.125).astype(np.float32)  # noqa: E731
    return {"a": ints(13, 5), "b": {"w": ints(31)}, "h": ints(24, 8)}


BF16_KEYS = ("h",)

CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(1)
from apex_tpu_torch.parallel import (DistributedDataParallel, Reducer, allreduce_gradients,
                                     initialize_distributed, destroy_distributed)
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.amp.grad_scaler import sync_found_inf
import torch.distributed as dist
exec(sys.argv[3])
initialize_distributed("cpu")
group = ps.initialize_model_parallel()
rank = group.rank()
g = {k: (torch.from_numpy(v).to(torch.bfloat16) if k in BF16_KEYS else torch.from_numpy(v))
     if not isinstance(v, dict) else {kk: torch.from_numpy(vv) for kk, vv in v.items()}
     for k, v in grads_of(rank).items()}
out = {"rank": rank, "size": group.size(), "dp_world": ps.get_data_parallel_world_size(),
       "dp_rank": ps.get_data_parallel_rank(), "tp": ps.get_tensor_model_parallel_world_size()}
res = {}
for name, kw in CASES.items():
    res[name] = allreduce_gradients(g, **kw)
res["ddp"] = DistributedDataParallel(gradient_predivide_factor=2.0).sync(g)
from apex_tpu_torch.contrib.optimizers import _quantized_sync as qs
g32 = {k: v.float() if not isinstance(v, dict) else v for k, v in g.items()}
for wire in ("int8", "float8_e4m3fn"):
    res["qpmean_" + wire] = qs.quantized_pmean(g32, group.group, qs.qspec_of(wire), 2)
res["reducer"] = Reducer().reduce(g)
out["vote"] = bool(sync_found_inf(torch.tensor(rank == 0), (group,)))
out["vote_tp_pp"] = bool(sync_found_inf(torch.tensor(rank == 0), ps.get_model_parallel_group()))
torch.save({"meta": out, "res": res}, sys.argv[2] + f"/rank{rank}.pt")
destroy_distributed()
'''


def _src(fn):
    import inspect

    return inspect.getsource(fn)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The world-2 child's results, rank by rank."""
    out = tmp_path_factory.mktemp("par2")
    defs = "\n".join([_src(grads_of), f"BF16_KEYS = {BF16_KEYS!r}", f"CASES = {CASES!r}"])
    multiproc.launch(["-c", CHILD, str(REPO), str(out), defs], 2, timeout=300)
    return [torch.load(out / f"rank{r}.pt") for r in range(2)]


def _jax_allreduce(devices8, **kw):
    """The JAX function on two devices: each rank's grads in, rank 0's
    result out (every rank's is the same)."""
    mesh = Mesh(np.array(devices8[:2]), ("dp",))
    stack = jax.tree.map(lambda *xs: jnp.stack(xs), *[grads_of(r) for r in range(2)])
    stack["h"] = stack["h"].astype(jnp.bfloat16)

    def f(g):
        out = jax_allreduce(jax.tree.map(lambda x: x[0], g), axis_name="dp", **kw)
        return jax.tree.map(lambda x: x[None], out)

    res = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
                                check_vma=False))(stack)
    return jax.tree.map(lambda x: np.asarray(x[0]), res)


def _assert_tree_bitwise(port, want):
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_bitwise(port[k], want[k])
            continue
        got = port[k]
        w = want[k]
        if got.dtype == torch.bfloat16:
            assert w.dtype == jnp.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), w.view(np.int16), k)
        else:
            np.testing.assert_array_equal(got.numpy(), w, k)


@pytest.mark.parametrize("wire", ["int8", "float8_e4m3fn"])
def test_quantized_pmean_world2_against_jax(world2, devices8, wire):
    """The replicated path's quantized all-reduce (no residual) at world
    2 against the JAX function on two devices: the scales from a sum of
    two amaxes, the int8 / fp8 payload summed on the wire (exact here,
    the fp8 sum rounded once), the dequantized mean: bitwise."""
    from apex_tpu.contrib.optimizers import _quantized_sync as jqs

    mesh = Mesh(np.array(devices8[:2]), ("dp",))
    stack = jax.tree.map(lambda *xs: jnp.stack(xs), *[grads_of(r) for r in range(2)])

    def f(g):
        out = jqs.quantized_pmean(jax.tree.map(lambda x: x[0], g), "dp",
                                  jqs.qspec_of(wire), world=2)
        return jax.tree.map(lambda x: x[None], out)

    want = jax.tree.map(lambda x: np.asarray(x[0]), jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"), check_vma=False))(stack))
    for rank in range(2):
        _assert_tree_bitwise(world2[rank]["res"]["qpmean_" + wire], want)


@pytest.mark.parametrize("case", sorted(CASES) + ["ddp", "reducer"])
def test_allreduce_gradients_world2_bitwise_against_jax(world2, devices8, case):
    kw = {"ddp": {"gradient_predivide_factor": 2.0}, "reducer": {}}.get(case, CASES.get(case))
    want = _jax_allreduce(devices8, **kw)
    for rank in range(2):
        _assert_tree_bitwise(world2[rank]["res"][case], want)


def test_world2_group_and_votes(world2):
    for rank, r in enumerate(world2):
        m = r["meta"]
        assert (m["rank"], m["size"], m["dp_world"], m["dp_rank"], m["tp"]) == (rank, 2, 2, rank, 1)
        assert m["vote"] is False  # rank 1's non-finite vote reached rank 0 too
        assert m["vote_tp_pp"] == (rank == 0)  # one-rank axes add no collective


@pytest.fixture
def world1():
    """A one-rank gloo group in this process, torn down after."""
    multiproc.initialize_distributed("cpu")
    yield ps.initialize_model_parallel()
    multiproc.destroy_distributed()


def test_parallel_state_world1_getters_match_jax(world1, devices8):
    for name in ("DATA_AXIS", "PIPELINE_AXIS", "CONTEXT_AXIS", "TENSOR_AXIS", "DCN_AXIS",
                 "DATA_OUTER_AXIS", "DATA_INNER_AXIS", "HIER_DP_AXES", "AXIS_ORDER"):
        assert getattr(ps, name) == getattr(jps, name)
    jps.initialize_model_parallel(devices=devices8[:1])
    try:
        for getter in ("get_data_parallel_world_size", "get_tensor_model_parallel_world_size",
                       "get_pipeline_model_parallel_world_size",
                       "get_context_parallel_world_size", "get_num_distributed_slices",
                       "get_data_parallel_src_rank"):
            assert getattr(ps, getter)() == getattr(jps, getter)(), getter
        assert ps.get_data_parallel_group() == jps.get_data_parallel_group() == "dp"
        assert ps.get_tensor_model_parallel_group() == "tp"
    finally:
        jps.destroy_model_parallel()
    g = ps.get_data_parallel_group()
    assert (g.size(), g.rank(), ps.get_data_parallel_rank()) == (1, 0, 0)
    assert ps.model_parallel_is_initialized()
    assert ps.get_tensor_model_parallel_rank() == ps.get_pipeline_model_parallel_rank() == 0


@pytest.mark.parametrize("kw,item", [
    ({"tensor_model_parallel_size_": 2}, None),
    ({"pipeline_model_parallel_size_": 2}, None),
    ({"context_parallel_size_": 2}, None),
    ({"num_distributed_slices_": 2}, None),
    ({"virtual_pipeline_model_parallel_size_": 2}, None),
], ids=["tp", "pp", "cp", "dcn", "virtual_pp"])
def test_parallel_state_refusals_name_their_queue_item(kw, item, devices8):
    # (The name dates from when cp was refused and named its queue item:
    # every axis is ported now, and each case is the JAX mesh's own rule.)
    if item is None:
        # tensor, pipeline and context parallelism are ported: on a world
        # they do not divide they are refused as the JAX mesh refuses
        # them, and size 1 runs (worlds 2 and 4 in
        # tests/test_torch_tensor_parallel.py,
        # tests/test_torch_pipeline_parallel.py and
        # tests/test_torch_context_parallel.py); the interleaved schedule
        # wants pp of 2 or more, as the JAX package does
        multiproc.initialize_distributed("cpu")
        try:
            if "num_distributed_slices_" in kw:
                # the JAX package's outer dcn axis is ported: slices must
                # divide dp, as the JAX mesh's rule
                with pytest.raises(RuntimeError, match=r"not divisible by slices \(2\)"):
                    ps.initialize_model_parallel(**kw)
                with pytest.raises(RuntimeError, match="not divisible by slices"):
                    jps.initialize_model_parallel(devices=devices8[:1], **kw)
            elif "virtual_pipeline_model_parallel_size_" in kw:
                msg = "greater than 2 with interleaved schedule"
                with pytest.raises(RuntimeError, match=msg):
                    ps.initialize_model_parallel(**kw)
                with pytest.raises(RuntimeError, match=msg):
                    jps.initialize_model_parallel(devices=devices8[:1], **kw)
                with pytest.raises(RuntimeError, match=r"world size \(1\) is not divisible"):
                    ps.initialize_model_parallel(pipeline_model_parallel_size_=2, **kw)
            else:
                with pytest.raises(RuntimeError, match=r"world size \(1\) is not divisible"):
                    ps.initialize_model_parallel(**kw)
                with pytest.raises(RuntimeError, match=r"world size \(1\) is not divisible"):
                    jps.initialize_model_parallel(devices=devices8[:1], **kw)
            ps.initialize_model_parallel(tensor_model_parallel_size_=1,
                                         pipeline_model_parallel_size_=1,
                                         context_parallel_size_=1)
            assert ps.get_context_parallel_world_size() == 1
            assert ps.get_context_parallel_rank() == 0
            assert ps.get_context_parallel_group().ranks == (0,)
            assert ps.get_tensor_model_parallel_world_size() == 1
            assert ps.get_tensor_model_parallel_src_rank() == 0
            assert ps.get_pipeline_model_parallel_world_size() == 1
            assert ps.is_pipeline_first_stage() and ps.is_pipeline_last_stage()
            assert ps.get_pipeline_model_parallel_next_rank() == 0
            assert ps.get_embedding_group().ranks == (0,)
            assert ps.get_virtual_pipeline_model_parallel_world_size() is None
        finally:
            multiproc.destroy_distributed()
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        ps.initialize_model_parallel(**kw)


def test_parallel_state_needs_the_default_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        ps.initialize_model_parallel()
    with pytest.raises(RuntimeError, match="not initialized"):
        ps.get_data_parallel_group()


def test_backend_follows_the_device(world1):
    assert multiproc.backend_for("cuda") == "nccl" and multiproc.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError):
        multiproc.backend_for("meta")
    # a group already up is kept; another backend is refused
    assert multiproc.initialize_distributed("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multiproc.initialize_distributed("cuda")


def test_world1_allreduce_is_the_grads(world1):
    from apex_tpu_torch.parallel import allreduce_gradients

    g = {k: torch.from_numpy(v) for k, v in grads_of(0).items() if k != "b"}
    out = allreduce_gradients(g)
    for k in g:
        assert torch.equal(out[k], g[k])


def test_launch_reports_a_failed_rank():
    code = "import os, sys; sys.exit(3 if os.environ['RANK'] == '1' else 0)"
    with pytest.raises(RuntimeError, match=r"\(1, 3\)"):
        multiproc.launch(["-c", code], 2, timeout=60)
    res = multiproc.launch(["-c", "import os; print(os.environ['RANK'], "
                            "os.environ['WORLD_SIZE'])"], 2, timeout=60)
    assert [json.loads("[" + r.stdout.replace(" ", ",").strip() + "]") for r in res] == \
        [[0, 2], [1, 2]]
