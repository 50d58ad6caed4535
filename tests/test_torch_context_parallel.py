"""The port's context parallelism (``apex_tpu_torch.transformer.
context_parallel``, ``parallel_state``'s cp axis, ``cp_axis`` in the GPT
forward, loss and both train steps) and the flash kernels' ring-chunk
mode's plain versions, against the JAX package.

- The ring-chunk plain versions (bf16 q, k, v; fp32 out; an fp32
  cotangent; fp32 grads) against JAX ``flash_fwd_pallas(out_dtype=f32)``
  and ``flash_bwd_pallas`` (fp32 ``do`` and ``delta``, ``out_dtype=f32``)
  in interpret mode: out, dq and dk within 2^-6 of the largest entry (the
  Pallas kernels round p and ds to bf16, the plain versions do not), dv
  within 1e-4 (fp32 operands in both), lse 1e-4.
- ``ring_attention`` in fp32 at cp 2 and 4, causal and not, on one gloo
  world of 4 ranks (``parallel.multiproc.launch``): out and the grads of
  each rank's ``sum(sin(out))`` against the JAX ``ring_attention`` under
  ``shard_map`` on the CPU devices (1e-5 / 2e-5) and against
  ``mha_reference`` at ``tests/test_attention.py``'s bands
  (``TestRingAttention``, and ``TestRingAttentionPallas`` through the
  chunk kernels' wrappers); the serial and overlapped schedules bitwise
  (``TestRingOverlap``).
- GPT: ``gpt_forward`` at cp 4 against the JAX single-device forward;
  ``make_train_step`` at cp 2 x dp 2 (FusedAdam and ZeRO) and cp 2 x tp 2,
  both heads, learned and rope positions, and ``make_pp_train_step`` at
  pp 2 x cp 2, against the JAX single-device step, in
  ``tests/test_torch_gpt_pp.py``'s bands; the JAX package's refusals.
- ``parallel_state``'s rank layout against the JAX mesh's (dp, pp, cp,
  tp) at every (tp, pp, cp) that fits four ranks.
"""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.models import gpt as jgpt
from apex_tpu.ops.flash_attention_pallas import flash_bwd_pallas, flash_fwd_pallas
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.context_parallel import ring_attention as jax_ring_attention

from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.ops import flash_attention as tfa
from apex_tpu_torch.parallel import multiproc
from apex_tpu_torch.transformer.parallel_state import AxisGroup

REPO = Path(__file__).resolve().parent.parent
#: tests/test_torch_gpt_pp.py's bands: loss relative, grads of the leaf's
#: largest entry, params of its scale or absolute (Adam's band)
BAND = 1e-5
GRAD_BAND = 2e-5
PARAM_ATOL = 5e-4
#: the ring against the JAX ring (out, grads) and against mha_reference
#: (tests/test_attention.py's rtol, atol for out, then grads)
JAX_RING_TOL = (1e-5, 2e-5)
REF_TOL = {"out": (1e-4, 1e-5), "grads": (2e-4, 2e-5)}
#: the ring-chunk plain versions against the Pallas kernels in interpret mode
CHUNK_TOL = {"out": 2.0 ** -6, "dq": 2.0 ** -6, "dk": 2.0 ** -6, "dv": 1e-4, "lse": 1e-4}
LR = 1e-2
CFG = dict(vocab_size=64, hidden_size=32, num_layers=4, num_attention_heads=4, max_seq_len=16,
           checkpoint_layers=True, use_flash_attention=True, fused_ce_chunk=8)
GLOBAL_BATCH = 8
#: ring shapes: B, H, S_local, D
RING = (1, 2, 32, 16)
RING_CPS = (2, 4)
#: gpt_forward at cp 4: name -> config overrides
FWD_CASES = {"learned": {}, "rope": {"position_embedding_type": "rope"},
             "rope_gqa": {"position_embedding_type": "rope", "num_query_groups": 2}}
#: make_train_step: name -> (tp, optimizer, fused head, positions), cp 2
TRAIN_CASES = {f"cp2_{lay}_{opt}_{head}_{pos}": (tp, opt, head == "fused", pos)
               for lay, tp, opts in (("dp2", 1, ("adam", "zero")), ("tp2", 2, ("adam",)))
               for opt in opts for head in ("dense", "fused") for pos in ("learned", "rope")}
#: make_pp_train_step at pp 2 x cp 2, 2 microbatches: name -> (fused head, positions)
PP_CASES = {"pp2_cp2_dense_learned": (False, "learned"), "pp2_cp2_fused_rope": (True, "rope")}
#: the (tp, pp, cp) layouts of four ranks whose cp groups are checked
LAYOUTS = ((1, 1, 2), (1, 1, 4), (2, 1, 2), (1, 2, 2))


def jax_params(**over):
    cfg = jgpt.GPTConfig(**{**CFG, **over}, compute_dtype=jnp.float32)
    return jax.tree.map(np.asarray, jgpt.init_params(cfg, jax.random.PRNGKey(0)))


def batch():
    rng = np.random.RandomState(0)
    tok = rng.randint(0, CFG["vocab_size"], size=(GLOBAL_BATCH, CFG["max_seq_len"] + 1))
    return tok[:, :-1], tok[:, 1:]


def ring_inputs(cp):
    B, H, S, D = RING
    rng = np.random.default_rng(7 + cp)
    return tuple(rng.standard_normal((B, H, S * cp, D), dtype=np.float32) for _ in range(3))


CHILD = r'''
import sys, pickle
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from apex_tpu_torch.parallel import initialize_distributed, destroy_distributed
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.context_parallel import (
    ring_attention, shard_sequence, unshard_sequence)
from apex_tpu_torch.models import gpt
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers.tree import tree_map
from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
from apex_tpu_torch.train_gpt import make_train_step
(params_np, ring_in, CFG, LR, tok, tgt, RING_CPS, FWD_CASES, TRAIN_CASES, PP_CASES,
 LAYOUTS) = pickle.load(open(sys.argv[3], "rb"))
initialize_distributed("cpu")
rank = dist.get_rank()
out = {"layout": {}, "ring": {}, "fwd": {}, "train": {}, "pp": {}}


def setup(tp=1, pp=1, cp=1):
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(tensor_model_parallel_size_=tp, pipeline_model_parallel_size_=pp,
                                 context_parallel_size_=cp)
    return (ps.get_tensor_model_parallel_group(), ps.get_pipeline_model_parallel_group(),
            ps.get_context_parallel_group(), ps.get_data_parallel_group())


class Recording(FusedAdam):
    """FusedAdam that keeps the grads it is handed."""

    def update(self, grads, state, params, **kw):
        self.grads = grads
        return super().update(grads, state, params, **kw)


def cut(a, cp, dp):
    """This rank's rows (dp) and sequence chunk (cp) of the global batch."""
    rows, S = len(a) // dp.size(), a.shape[1] // cp.size()
    return torch.from_numpy(np.ascontiguousarray(
        a[rows * dp.rank():rows * (dp.rank() + 1), S * cp.rank():S * (cp.rank() + 1)]))


def clone(t):
    return tree_map(lambda a: a.detach().clone(), t)


# parallel_state: each layout's coordinates and groups
for tp, pp, cp in LAYOUTS:
    g, pg, cg, dg = setup(tp, pp, cp)
    out["layout"][tp, pp, cp] = {
        "ranks": (dg.rank(), pg.rank(), cg.rank(), g.rank()),
        "cp_group": cg.ranks, "dp_group": dg.ranks, "pp_group": pg.ranks,
        "tp_group": g.ranks, "cp_world": ps.get_context_parallel_world_size(),
        "cp_rank": ps.get_context_parallel_rank()}

# ring attention, fp32: each schedule and impl, out and the grads of the
# local sum(sin(out)), gathered whole
for cp in RING_CPS:
    _, _, cg, _ = setup(cp=cp)
    for causal in (True, False):
        for impl in ("scan", "pallas"):
            for overlap in (False, True):
                q, k, v = (shard_sequence(torch.from_numpy(a), cg).clone().requires_grad_()
                           for a in ring_in[cp])
                o = ring_attention(q, k, v, cg, causal=causal, impl=impl, overlap=overlap)
                gr = torch.autograd.grad(torch.sin(o).sum(), (q, k, v))
                out["ring"][cp, causal, impl, overlap] = tuple(
                    unshard_sequence(t.detach(), cg) for t in (o,) + gr)

# gpt_forward at cp 4: the logits of the rank's chunk, gathered
g, pg, cg, dg = setup(cp=4)
for name, over in FWD_CASES.items():
    cfg = gpt.GPTConfig(**{**CFG, **over}, compute_dtype=torch.float32)
    p = gpt.params_from_numpy(params_np[name], cfg, "cpu")
    logits = gpt.gpt_forward(p, cut(tok, cg, dg), cfg, cp_axis=cg)
    out["fwd"][name] = unshard_sequence(logits, cg, 0)

# make_train_step: one step a case
for name, (tp, kind, fused, pos) in TRAIN_CASES.items():
    g, pg, cg, dg = setup(tp=tp, cp=2)
    over = {} if pos == "learned" else {"position_embedding_type": "rope"}
    cfg = gpt.GPTConfig(**CFG, **over, compute_dtype=torch.float32, fused_ce=fused)
    p = gpt.shard_params(params_np[pos], cfg, g, "cpu", keep_fp32=True)
    opt = Recording(lr=LR) if kind == "adam" else DistributedFusedAdam(lr=LR)
    st = opt.init(p)
    step = make_train_step(opt, cfg, graphs=False, dp_group=dg, tp_group=g, cp_group=cg)
    loss = float(step(p, st, cut(tok, cg, dg), cut(tgt, cg, dg)))
    grads = clone(gpt.gather_params(opt.grads, cfg, g)) if kind == "adam" else None
    out["train"][name] = (loss, grads, clone(gpt.gather_params(p, cfg, g)))

# make_pp_train_step at pp 2 x cp 2 (dp 1)
for name, (fused, pos) in PP_CASES.items():
    g, pg, cg, dg = setup(pp=2, cp=2)
    over = {} if pos == "learned" else {"position_embedding_type": "rope"}
    cfg = gpt.GPTConfig(**CFG, **over, compute_dtype=torch.float32, fused_ce=fused)
    p = gpt.shard_params(params_np[pos], cfg, g, "cpu", keep_fp32=True, pp_group=pg)
    opt = Recording(lr=LR)
    st = opt.init(p)
    step = gpt.make_pp_train_step(cfg, opt, 2, dp_group=dg, tp_group=g, pp_group=pg,
                                  cp_axis=cg, graphs=False)
    loss = float(step(p, st, cut(tok, cg, dg), cut(tgt, cg, dg)))
    out["pp"][name] = (loss, clone(gpt.gather_params(opt.grads, cfg, g, pg)),
                       clone(gpt.gather_params(p, cfg, g, pg)))

# the JAX package's refusals, on a live cp group
g, pg, cg, dg = setup(cp=2)
refused = {}
cfg = gpt.GPTConfig(**CFG, compute_dtype=torch.float32)
opt = DistributedFusedAdam(lr=LR)
try:
    make_train_step(opt, cfg, graphs=False, dp_group=dg, cp_group=cg, overlap_grad_sync=True)
except NotImplementedError as e:
    refused["overlap"] = str(e)
sp = gpt.GPTConfig(**CFG, compute_dtype=torch.float32, sequence_parallel=True)
for what, fn in (("forward", lambda: gpt.gpt_forward({}, tok, sp, cp_axis=cg)),
                 ("train", lambda: make_train_step(FusedAdam(lr=LR), sp, graphs=False,
                                                   cp_group=cg))):
    try:
        fn()
    except ValueError as e:
        refused[what] = str(e)
out["refused"] = refused
torch.save(out, sys.argv[2] + f"/rank{rank}.pt")
destroy_distributed()
'''


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    d = tmp_path_factory.mktemp("cp")
    tok, tgt = batch()
    params = {"learned": jax_params(), "rope": jax_params(position_embedding_type="rope"),
              "rope_gqa": jax_params(position_embedding_type="rope", num_query_groups=2)}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((params, {cp: ring_inputs(cp) for cp in RING_CPS}, CFG, LR, tok, tgt,
                     RING_CPS, FWD_CASES, TRAIN_CASES, PP_CASES, LAYOUTS), f)
    multiproc.launch(["-c", CHILD, str(REPO), str(d), str(d / "in.pkl")], 4, timeout=600)
    return [torch.load(d / f"rank{r}.pt") for r in range(4)]


# ------------------------------------------------------- ring-chunk mode
def _chunk_inputs(S, causal, BH=2, D=16):
    rng = np.random.default_rng(S + int(causal))
    q, k, v = (rng.standard_normal((BH, S, D), dtype=np.float32) for _ in range(3))
    do = rng.standard_normal((BH, S, D), dtype=np.float32)
    return q, k, v, do


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("causal", [True, False], ids=["diag", "full"])
def test_ring_chunk_plain_versions_match_pallas_interpret(causal):
    """The ring-chunk mode's plain versions (``flash_fwd`` /
    ``flash_dq`` / ``flash_dkv`` with ``out_dtype=torch.float32`` on CPU
    tensors: bf16 q, k, v, an fp32 cotangent and the global delta) against
    the Pallas kernels asked the same by the JAX ring, in interpret mode:
    fp32 outputs, out, dq and dk within 2^-6 of their largest entry, dv
    within 1e-4 (both keep p and do in fp32 there), lse 1e-4."""
    S, D = 128, 16
    q, k, v, do = _chunk_inputs(S, causal, D=D)
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jout, jlse = flash_fwd_pallas(jq, jk, jv, scale, causal, 0, 0, interpret=True,
                                  out_dtype=jnp.float32)
    delta = np.sum(do * np.asarray(jout), axis=-1, keepdims=True).astype(np.float32)
    jdq, jdk, jdv = flash_bwd_pallas(jq, jk, jv, None, jlse, jnp.asarray(do), scale, causal,
                                     0, 0, interpret=True, delta=jnp.asarray(delta),
                                     out_dtype=jnp.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    f32 = torch.float32
    out, lse = tfa.flash_fwd(tq, tk, tv, scale, causal, out_dtype=f32)
    args = (tq, tk, tv, torch.from_numpy(do), torch.from_numpy(np.array(jlse)),
            torch.from_numpy(delta), scale, causal)
    dq = tfa.flash_dq(*args, out_dtype=f32)
    dk, dv = tfa.flash_dkv(*args, out_dtype=f32)
    assert all(t.dtype == f32 for t in (out, lse, dq, dk, dv))
    errs = {"out": _rel(out, jout), "dq": _rel(dq, jdq), "dk": _rel(dk, jdk),
            "dv": _rel(dv, jdv), "lse": float(np.abs(lse.numpy() - np.asarray(jlse)).max())}
    assert all(errs[n] <= CHUNK_TOL[n] for n in errs), errs


def test_ring_mode_dtype_rules():
    """``do`` may be fp32 beside bf16 q, k, v only in the ring-chunk mode;
    every other mismatch still raises, and the mode takes bf16 alone."""
    bf, f32, f16 = (torch.zeros(2, 4, 16, dtype=t) for t in
                    (torch.bfloat16, torch.float32, torch.float16))
    named = lambda q, do, k=None: (("q", q), ("k", q if k is None else k), ("v", q),
                                   ("do", do))
    assert tfa.dtype_problem(named(bf, bf)) is None
    assert "do has dtype" in tfa.dtype_problem(named(bf, f32))
    assert tfa.dtype_problem(named(bf, f32), ring=True) is None
    assert "float32 tensor shaped as q" in tfa.dtype_problem(named(bf, bf), ring=True)
    assert "k has dtype" in tfa.dtype_problem(named(bf, f32, k=f32), ring=True)
    assert "takes bfloat16" in tfa.dtype_problem(named(f16, f32), ring=True)
    assert "do must" in tfa.dtype_problem(
        (("q", bf), ("do", torch.zeros(2, 4, 8))), ring=True)
    assert not tfa.ring_mode(bf, None) and not tfa.ring_mode(bf, torch.bfloat16)
    assert tfa.ring_mode(bf, torch.float32) and not tfa.ring_mode(f32, torch.float32)
    with pytest.raises(ValueError, match="out_dtype must be"):
        tfa.ring_mode(bf, torch.float16)


@pytest.mark.parametrize("which", [1, 2])
@pytest.mark.parametrize("d", range(16, 129, 16))
def test_ring_launch_plan_fits_the_card(d, which):
    """The ring-chunk mode's shared memory (dq: do's lo tile more; dkv: the
    fp32 do in each stage and one stage of its hi and lo tiles) fits a
    block at every head dim, 16-byte aligned."""
    plan = tfa.bwd_launch_plan(which, 1024, 1024, d, True, ring=True)
    dense = tfa.bwd_launch_plan(which, 1024, 1024, d, True)
    assert dense.smem_bytes < plan.smem_bytes <= tfa._SMEM_LIMIT
    assert plan.smem_bytes % 16 == 0 and plan[:5] == dense[:5]


# --------------------------------------------------------------- the ring
def _jax_ring(cp, causal, devices8):
    q, k, v = ring_inputs(cp)
    mesh = Mesh(np.array(devices8[:cp]), ("cp",))
    spec = P(None, None, "cp", None)

    def f(q, k, v):
        return jax_ring_attention(q, k, v, "cp", causal=causal)

    out = jax.shard_map(f, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                        check_vma=False)(q, k, v)
    grads = jax.shard_map(jax.grad(lambda q, k, v: jnp.sum(jnp.sin(f(q, k, v))),
                                   argnums=(0, 1, 2)),
                          mesh=mesh, in_specs=(spec,) * 3, out_specs=(spec,) * 3,
                          check_vma=False)(q, k, v)
    return (np.asarray(out),) + tuple(np.asarray(g) for g in grads)


def _mha_reference(cp, causal):
    from apex_tpu_torch.ops.attention import mha_reference

    q, k, v = (torch.from_numpy(a).requires_grad_() for a in ring_inputs(cp))
    out = mha_reference(q, k, v, causal=causal)
    grads = torch.autograd.grad(torch.sin(out).sum(), (q, k, v))
    return (out.detach(),) + grads


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("cp", RING_CPS)
def test_ring_attention_matches_jax_ring(world4, devices8, cp, causal):
    """The ring (scan chunks, serial) at cp 2 and 4: out and the grads of
    each rank's sum(sin(out)) against the JAX ring under ``shard_map``
    (1e-5 / 2e-5), on every rank."""
    want = _jax_ring(cp, causal, devices8)
    for res in world4:
        got = res["ring"][cp, causal, "scan", False]
        for i, (a, b) in enumerate(zip(got, want)):
            tol = JAX_RING_TOL[min(i, 1)]
            np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("cp", RING_CPS)
def test_ring_attention_matches_full_attention(world4, cp, causal, impl):
    """``TestRingAttention`` and ``TestRingAttentionPallas``: out and grads
    against ``mha_reference`` at the reference's bands, with the scan
    chunks and with the chunk kernels' wrappers (their plain versions on
    the CPU)."""
    want = _mha_reference(cp, causal)
    for res in world4:
        got = res["ring"][cp, causal, impl, False]
        for i, (a, b) in enumerate(zip(got, want)):
            rtol, atol = REF_TOL["out" if i == 0 else "grads"]
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("cp", RING_CPS)
def test_ring_overlap_is_bitwise_serial(world4, cp, causal, impl):
    """``TestRingOverlap``: the overlapped schedule consumes the same
    values in the same merge order as the serial one, so fp32 out, dq, dk
    and dv are bitwise equal."""
    for res in world4:
        for a, b in zip(res["ring"][cp, causal, impl, False],
                        res["ring"][cp, causal, impl, True]):
            assert torch.equal(a, b)


def test_ring_attention_refuses_an_unknown_impl():
    from apex_tpu_torch.transformer.context_parallel import ring_attention

    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="impl must be"):
        ring_attention(q, q, q, AxisGroup("cp", None, 1, 0), impl="xla")


# ---------------------------------------------------------- parallel_state
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda t: "tp%d_pp%d_cp%d" % t)
def test_cp_rank_layout_matches_the_jax_mesh(world4, devices8, layout):
    """Each rank's (dp, pp, cp, tp) coordinates and its groups are those of
    the JAX mesh's device of the same index (mesh axes ``AXIS_ORDER``)."""
    tp, pp, cp = layout
    try:
        mesh = jps.initialize_model_parallel(tensor_model_parallel_size_=tp,
                                             pipeline_model_parallel_size_=pp,
                                             context_parallel_size_=cp, devices=devices8[:4])
        ids = np.vectorize(lambda d: d.id)(mesh.devices)  # (dp, pp, cp, tp)
    finally:
        jps.destroy_model_parallel()
    assert mesh.axis_names == ("dp", "pp", "cp", "tp")
    for rank, res in enumerate(world4):
        got = res["layout"][layout]
        d, p, c, t = (int(i[0]) for i in np.nonzero(ids == rank))
        assert got["ranks"] == (d, p, c, t)
        assert got["cp_group"] == tuple(int(i) for i in ids[d, p, :, t])
        assert got["dp_group"] == tuple(int(i) for i in ids[:, p, c, t])
        assert got["pp_group"] == tuple(int(i) for i in ids[d, :, c, t])
        assert got["tp_group"] == tuple(int(i) for i in ids[d, p, c, :])
        assert (got["cp_world"], got["cp_rank"]) == (cp, c)


# --------------------------------------------------------------------- GPT
def _close(got, want, name, band, atol=0.0):
    from apex_tpu_torch.optimizers.tree import leaves_with_path

    want = dict(leaves_with_path(want))
    for path, g in leaves_with_path(got):
        w = want[path]
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g.detach().numpy().astype(np.float64) - w).max())
        assert err <= max(band * scale, atol), (name, path, err, scale)


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's single-device loss, grads and FusedAdam update on the global
    batch at fp32: both heads, learned and rope positions."""
    tok, tgt = batch()
    out = {}
    for pos in ("learned", "rope"):
        over = {} if pos == "learned" else {"position_embedding_type": "rope"}
        params = jax.tree.map(jnp.asarray, jax_params(**over))
        for fused in (False, True):
            cfg = jgpt.GPTConfig(**CFG, **over, compute_dtype=jnp.float32, fused_ce=fused)
            loss, grads = jax.value_and_grad(jgpt.gpt_loss)(params, tok, tgt, cfg)
            opt = JaxFusedAdam(lr=LR)
            new, _ = opt.update(grads, opt.init(params), params)
            out[fused, pos] = (float(loss), jax.tree.map(np.asarray, grads),
                               jax.tree.map(np.asarray, new))
    return out


@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_cp_forward_matches_single_device(world4, name):
    """``gpt_forward`` at cp 4 (each rank its 4 positions of 16; learned
    positions sliced at rank·4, rope at the global positions; GQA repeated
    before the ring): the ranks' logits, gathered, against the JAX
    single-device forward, within 2e-5 of the largest."""
    over = FWD_CASES[name]
    cfg = jgpt.GPTConfig(**{**CFG, **over}, compute_dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, jax_params(**over))
    want = np.asarray(jgpt.gpt_forward(params, batch()[0], cfg))
    for res in world4:
        assert _rel(res["fwd"][name].numpy(), want) <= GRAD_BAND


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_cp_train_step_matches_single_device(world4, jax_reference, name):
    """``make_train_step(cp_group=)`` at cp 2 x dp 2 (FusedAdam, ZeRO) and
    cp 2 x tp 2, each head and position kind: every rank's loss (the mean
    over cp and dp), the grads FusedAdam was handed (averaged over cp and
    dp, gathered over tp) and the new params against the JAX
    single-device step on the global batch."""
    tp, kind, fused, pos = TRAIN_CASES[name]
    loss, grads, params = jax_reference[fused, pos]
    for res in world4:
        got_loss, got_grads, got_params = res["train"][name]
        assert abs(got_loss - loss) <= BAND * abs(loss), (name, got_loss, loss)
        if got_grads is not None:
            _close(got_grads, grads, name, GRAD_BAND)
        _close(got_params, params, name, GRAD_BAND, PARAM_ATOL)


@pytest.mark.parametrize("name", sorted(PP_CASES))
def test_cp_composed_with_pp_matches_single_device(world4, jax_reference, name):
    """``make_pp_train_step(cp_axis=)`` at pp 2 x cp 2 with 2 microbatches:
    cp inside every stage, the loss and grads averaged over cp after the
    schedule; against the JAX single-device step."""
    fused, pos = PP_CASES[name]
    loss, grads, params = jax_reference[fused, pos]
    for res in world4:
        got_loss, got_grads, got_params = res["pp"][name]
        assert abs(got_loss - loss) <= BAND * abs(loss), (name, got_loss, loss)
        _close(got_grads, grads, name, GRAD_BAND)
        _close(got_params, params, name, GRAD_BAND, PARAM_ATOL)


def test_cp_refusals_match_jax(world4):
    """As the JAX package: cp beside sequence parallelism raises
    ValueError (forward and step), and ``overlap_grad_sync`` with cp
    raises NotImplementedError."""
    for res in world4:
        r = res["refused"]
        assert "context parallelism" in r["overlap"], r
        assert "both shard the sequence" in r["forward"], r
        assert "both shard the sequence" in r["train"], r
    with pytest.raises(ValueError, match="cp_axis="):
        tgpt.gpt_forward({}, np.zeros((1, 4)), tgpt.GPTConfig(**CFG), cp_axis="cp")
