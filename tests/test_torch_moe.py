"""The port's mixture of experts (``apex_tpu_torch.transformer.
expert_parallel``, MoE in ``models.gpt`` and both step builders, the
pipeline's aux channel) against the JAX package, on the CPU.

Mirrors ``tests/test_moe.py``'s five classes:

- ``_top_k_mask``: dispatch, combine and the top-1 mask bitwise the JAX
  one's, top-1 and top-2, with drops and without; ``load_balancing_loss``
  within 1e-6; ``moe_init``'s tree and ``is_expert_param``'s leaves as
  the JAX ones';
- ``moe_ffn`` on one rank: out within 1e-6 of the largest entry in fp32
  and within 2^-6 of it in bf16 (two bf16 ulps: the experts' bf16 ops
  round in other orders);
  the grads of every param and of x within 1e-6 of the leaf's largest
  entry in fp32 and 2^-5 in bf16 (the expert matmuls round their bf16
  outputs in other orders);
- ``moe_ffn`` split over ep 4 and ep 2 (the data-parallel group of one
  gloo world of 4 ranks, ``parallel.multiproc.launch``) against the JAX
  ``moe_ffn`` under ``shard_map``: out, the experts' grads complete on
  their owner, the router's summed over ep (1e-5 of the largest);
- the MoE GPT forward and loss (dense and fused head, remat on and off)
  and every gradient against JAX (1e-5 / 2e-5);
- ``make_train_step`` on one device against the JAX single-device loss
  and FusedAdam update, and at dp 4 (= ep 4) and dp 2 x tp 2 against the JAX
  step on the same mesh layout (2 steps, capacity 1.25 with drops, the
  aux in the loss, one case with a clip): losses 1e-5 relative, params
  2e-5 of the leaf's scale or 5e-4; at ample capacity and no aux, the dp
  4 loss against the single-device one (``test_moe.py``'s CE-only
  comparison: the aux is a per-shard product of means);
- ``make_pp_train_step`` at pp 2 x dp 2 with ``FusedSGD`` against the
  JAX single-device oracle at ``test_moe.py``'s pipeline bands (loss
  1e-4 relative, params 5e-3 / 5e-5);
- ``make_train_step`` at cp 2 x dp 2, ample capacity and no aux, against
  the JAX single-device loss, grads and FusedAdam update;
- every refusal of the JAX package, the same exception type with the
  same message.
"""

import dataclasses
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
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.transformer import expert_parallel as jep

from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.parallel import multiproc
from apex_tpu_torch.transformer import expert_parallel as tep

REPO = Path(__file__).resolve().parent.parent
#: fp32 bands of tests/test_torch_gpt_tp.py: loss relative, grads of the
#: leaf's largest entry, params of its scale or absolute (Adam's band)
BAND = 1e-5
GRAD_BAND = 2e-5
PARAM_ATOL = 5e-4
#: moe_ffn on one rank against JAX, fp32: of the largest entry
FFN_BAND = 1e-6
#: bf16, of the largest entry: out (two bf16 ulps: the experts' bf16
#: matmuls, bias and GELU round in other orders in the two frameworks,
#: and top-1 scales their outputs by a router prob) and the grads
BF16_OUT_BAND = 2.0 ** -6
BF16_GRAD_BAND = 2.0 ** -5
#: tests/test_moe.py's expert-parallel band
EP_BAND = 1e-5
#: tests/test_moe.py's pipeline bands: loss relative, params (rtol, atol)
PP_LOSS_BAND = 1e-4
PP_PARAM_TOL = (5e-3, 5e-5)
LR = 1e-2
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_attention_heads=4, max_seq_len=16,
           checkpoint_layers=True, use_flash_attention=True, fused_ce_chunk=8,
           moe_num_experts=8, moe_top_k=2)
#: the pipeline case: tests/test_moe.py TestMoEPipeline's config
PP_CFG = dict(CFG, num_layers=4, moe_num_experts=4, moe_capacity_factor=4.0)
#: ample capacity (every token kept: C = T) and no aux, for the
#: comparisons against one device
AMPLE = dict(moe_capacity_factor=4.0, moe_aux_coef=0.0)
GLOBAL_BATCH = 8
STEPS = 2
#: moe_ffn at ep 4 and 2: tokens, hidden, ffn, experts
EP_SHAPE = (64, 16, 32, 8)
EP_CASES = {"ample": (2, 8.0), "drops": (2, 1.25), "top1": (1, 8.0)}
#: make_train_step: name -> (tp, fused head, clip, config overrides)
STEP_CASES = {"dp4": (1, False, None, {}), "dp4_clip": (1, False, 1.0, {}),
              "dp2_tp2_fused": (2, True, None, {}), "dp4_ample": (1, False, None, AMPLE)}


def jax_params(**over):
    cfg = jgpt.GPTConfig(**{**CFG, **over}, compute_dtype=jnp.float32)
    return jax.tree.map(np.asarray, jgpt.init_params(cfg, jax.random.PRNGKey(0)))


def batch(i=0):
    rng = np.random.RandomState(i)
    tok = rng.randint(0, CFG["vocab_size"], size=(GLOBAL_BATCH, CFG["max_seq_len"] + 1))
    return tok[:, :-1], tok[:, 1:]


def ep_inputs():
    T, H, F, E = EP_SHAPE
    x = np.random.RandomState(0).randn(T, H).astype(np.float32)
    params = jax.tree.map(np.array, jep.moe_init(jax.random.PRNGKey(0), H, F, E))
    return x, params


CHILD = r'''
import sys, pickle
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from apex_tpu_torch.parallel import initialize_distributed, destroy_distributed
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import expert_parallel as ep_mod
from apex_tpu_torch.models import gpt
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD
from apex_tpu_torch.optimizers.tree import tree_map
from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
from apex_tpu_torch.train_gpt import make_train_step
(params_np, pp_np, ample_np, ep_in, CFG, PP_CFG, AMPLE, LR, batches, EP_CASES, STEP_CASES,
 STEPS) = pickle.load(open(sys.argv[3], "rb"))
initialize_distributed("cpu")
rank = dist.get_rank()
out = {"ep": {}, "step": {}}


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


def cut(a, dp, cp=None):
    """This rank's rows (dp) and sequence chunk (cp) of the global batch."""
    rows = len(a) // dp.size()
    a = a[rows * dp.rank():rows * (dp.rank() + 1)]
    if cp is not None:
        n = a.shape[1] // cp.size()
        a = a[:, n * cp.rank():n * (cp.rank() + 1)]
    return torch.from_numpy(np.ascontiguousarray(a))


def clone(t):
    return tree_map(lambda a: a.detach().clone(), t)


# moe_ffn over the dp group at ep 4 and 2: this rank's rows, its experts
x_np, p_np = ep_in
for ep in (4, 2):
    g, pg, cg, dg = setup(tp=4 // ep)
    Tl = len(x_np) // ep
    x = torch.from_numpy(x_np[Tl * dg.rank():Tl * (dg.rank() + 1)]).requires_grad_()
    E = p_np["w1"].shape[0]
    lo, hi = E // ep * dg.rank(), E // ep * (dg.rank() + 1)
    p = {k: torch.from_numpy(np.ascontiguousarray(v if k == "router" else v[lo:hi]))
         .requires_grad_() for k, v in p_np.items()}
    for name, (k, cf) in EP_CASES.items():
        before = ep_mod.A2A_LAUNCHES
        o, aux = ep_mod.moe_ffn(x, p, top_k=k, capacity_factor=cf, ep_group=dg)
        grads = torch.autograd.grad((o ** 2).sum(), [p[n] for n in sorted(p)] + [x])
        out["ep"][ep, name] = (o.detach(), dict(zip(sorted(p), grads[:-1])), grads[-1],
                               ep_mod.A2A_LAUNCHES - before)

# make_train_step: dp 4 (= ep 4) and dp 2 x tp 2, STEPS steps
for name, (tp, fused, clip, over) in STEP_CASES.items():
    g, pg, cg, dg = setup(tp=tp)
    cfg = gpt.GPTConfig(**{**CFG, **over}, compute_dtype=torch.float32, fused_ce=fused)
    tree = ample_np if over else params_np
    p = gpt.shard_params(tree, cfg, g, "cpu", keep_fp32=True, ep_group=dg)
    opt = Recording(lr=LR)
    st = opt.init(p)
    step = make_train_step(opt, cfg, clip_grad_norm=clip, graphs=False, dp_group=dg,
                           tp_group=g)
    losses = [float(step(p, st, cut(a, dg), cut(b, dg))) for a, b in batches[:STEPS]]
    out["step"][name] = (losses, clone(gpt.gather_params(p, cfg, g, ep_group=dg)))

# make_pp_train_step at pp 2 x dp 2, FusedSGD, 2 microbatches
g, pg, cg, dg = setup(pp=2)
cfg = gpt.GPTConfig(**PP_CFG, compute_dtype=torch.float32)
p = gpt.shard_params(pp_np, cfg, g, "cpu", keep_fp32=True, pp_group=pg, ep_group=dg)
opt = FusedSGD(lr=LR, momentum=0.0)
st = opt.init(p)
step = gpt.make_pp_train_step(cfg, opt, 2, dp_group=dg, tp_group=g, pp_group=pg, graphs=False)
tok, tgt = batches[0]
loss = float(step(p, st, cut(tok, dg), cut(tgt, dg)))
out["pp"] = (loss, clone(gpt.gather_params(p, cfg, g, pg, dg)))

# cp 2 x dp 2, ample capacity, no aux
g, pg, cg, dg = setup(cp=2)
cfg = gpt.GPTConfig(**{**CFG, **AMPLE}, compute_dtype=torch.float32)
p = gpt.shard_params(ample_np, cfg, g, "cpu", keep_fp32=True, ep_group=dg)
opt = Recording(lr=LR)
st = opt.init(p)
step = make_train_step(opt, cfg, graphs=False, dp_group=dg, tp_group=g, cp_group=cg)
loss = float(step(p, st, cut(tok, dg, cg), cut(tgt, dg, cg)))
out["cp"] = (loss, clone(gpt.gather_params(opt.grads, cfg, g, ep_group=dg)),
             clone(gpt.gather_params(p, cfg, g, ep_group=dg)))

# the JAX package's refusals, on live groups
g, pg, cg, dg = setup()
refused = {}
cfg = gpt.GPTConfig(**CFG, compute_dtype=torch.float32)
odd = gpt.GPTConfig(**{**CFG, "moe_num_experts": 6}, compute_dtype=torch.float32)
cases = {
    "indivisible": lambda: make_train_step(FusedAdam(lr=LR), odd, graphs=False, dp_group=dg),
    "zero": lambda: make_train_step(DistributedFusedAdam(lr=LR), cfg, graphs=False,
                                    dp_group=dg),
    "grad_sync_dtype": lambda: make_train_step(FusedAdam(lr=LR), cfg, graphs=False,
                                               dp_group=dg, grad_sync_dtype=torch.int8),
    "hierarchical": lambda: make_train_step(FusedAdam(lr=LR), cfg, graphs=False,
                                            dp_group=(dg, dg)),
    "overlap": lambda: make_train_step(FusedAdam(lr=LR), cfg, graphs=False, dp_group=dg,
                                       overlap_grad_sync=True),
    "pp_no_dp": lambda: gpt.make_pp_train_step(cfg, FusedAdam(lr=LR), 2, pp_group=pg,
                                               graphs=False),
    "pp_zero": lambda: gpt.make_pp_train_step(cfg, DistributedFusedAdam(lr=LR), 2,
                                              dp_group=dg, pp_group=pg, graphs=False),
}
for what, fn in cases.items():
    try:
        fn()
        refused[what] = None
    except Exception as e:  # noqa: BLE001 - the type is what the test reads
        refused[what] = (type(e).__name__, str(e))
out["refused"] = refused
torch.save(out, sys.argv[2] + f"/rank{rank}.pt")
destroy_distributed()
'''


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe")
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((jax_params(), jax.tree.map(np.asarray, jgpt.init_params(
            jgpt.GPTConfig(**PP_CFG, compute_dtype=jnp.float32), jax.random.PRNGKey(0))),
            jax_params(**AMPLE), ep_inputs(), CFG, PP_CFG, AMPLE, LR,
            [batch(i) for i in range(STEPS)], EP_CASES, STEP_CASES, STEPS), f)
    multiproc.launch(["-c", CHILD, str(REPO), str(d), str(d / "in.pkl")], 4, timeout=600)
    return [torch.load(d / f"rank{r}.pt") for r in range(4)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _close(got, want, name, band, atol=0.0):
    from apex_tpu_torch.optimizers.tree import leaves_with_path

    want = dict(leaves_with_path(want))
    got = list(leaves_with_path(got))
    assert sorted(p for p, _ in got) == sorted(want), name
    for path, g in got:
        w = np.asarray(want[path])
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g.detach().numpy().astype(np.float64) - w).max())
        assert err <= max(band * scale, atol), (name, path, err, scale)


# --------------------------------------------------------- the router mask
@pytest.mark.parametrize("top_k,capacity", [(1, 3), (2, 3), (2, 2), (1, 32), (2, 32)])
def test_top_k_mask_is_bitwise_jax(top_k, capacity):
    """Dispatch, combine and the top-1 mask bitwise the JAX ones (GShard
    slot priority, capacity drops, top-1 raw and top-2 renormalised
    weights), with ``test_moe.py``'s invariants: at most ``capacity``
    tokens an expert, one token a slot, combine only where dispatched."""
    probs = jax.nn.softmax(jnp.asarray(np.random.RandomState(0).randn(16, 4)), -1)
    probs = probs.astype(jnp.float32)
    want = [np.asarray(a) for a in jep._top_k_mask(probs, top_k, capacity)]
    got = [a.numpy() for a in tep._top_k_mask(torch.from_numpy(np.array(probs)), top_k,
                                              capacity)]
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    dispatch, combine, _ = got
    assert (dispatch.sum(axis=(0, 2)) <= capacity).all()
    assert (dispatch.sum(axis=0) <= 1).all()
    assert np.where(dispatch == 0, combine, 0.0).max() == 0.0
    if capacity >= 16:
        assert dispatch.sum() == 16 * top_k  # every token in every slot


def test_load_balancing_loss_matches_jax():
    """The aux on random probs and a top-1 mask within 1e-6 of JAX's, and
    1 under perfectly uniform routing (``test_moe.py``)."""
    rng = np.random.RandomState(1)
    probs = np.array(jax.nn.softmax(jnp.asarray(rng.randn(64, 8), jnp.float32), -1))
    m1 = np.eye(8, dtype=np.float32)[probs.argmax(-1)]
    want = float(jep.load_balancing_loss(jnp.asarray(probs), jnp.asarray(m1)))
    got = float(tep.load_balancing_loss(torch.from_numpy(probs), torch.from_numpy(m1)))
    assert abs(got - want) <= 1e-6 * abs(want)
    uniform = tep.load_balancing_loss(torch.full((64, 8), 1.0 / 8),
                                      torch.eye(8)[torch.arange(64) % 8])
    assert abs(float(uniform) - 1.0) <= 1e-6


# ------------------------------------------------------- moe_ffn, one rank
FFN_CASES = {"top2_drops": (2, 1.25), "top2_ample": (2, 8.0), "top1": (1, 1.0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_jax(case, dtype):
    """``moe_ffn`` on 32 tokens of width 16, 8 experts of 32: out and aux
    against the JAX ``moe_ffn`` (1e-6 of the largest in fp32, 2^-6 in
    bf16), and the grads of ``sum(sin(out)) +
    aux`` for every param and x (fp32 1e-6, bf16 2^-5 of the leaf's
    largest)."""
    top_k, cf = FFN_CASES[case]
    rng = np.random.RandomState(3)
    x = rng.randn(32, 16).astype(np.float32)
    params = jax.tree.map(np.array, jep.moe_init(jax.random.PRNGKey(1), 16, 32, 8))
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)

    def jloss(p, xx):
        o, a = jep.moe_ffn(xx, p, top_k=top_k, capacity_factor=cf)
        return jnp.sum(jnp.sin(o.astype(jnp.float32))) + a, (o, a)

    (_, (jo, ja)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                           has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x).astype(jd))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).to(td).requires_grad_()
    o, a = tep.moe_ffn(tx, tp, top_k=top_k, capacity_factor=cf)
    assert o.dtype == td and a.dtype == torch.float32
    grads = torch.autograd.grad(torch.sin(o.float()).sum() + a, [tp[k] for k in sorted(tp)] +
                                [tx])
    jo = np.asarray(jo.astype(jnp.float32))
    got = o.detach().float().numpy()
    assert abs(float(a.detach()) - float(ja)) <= 1e-6 * abs(float(ja))
    if dtype == "float32":
        assert _rel(got, jo) <= FFN_BAND
    else:
        assert _rel(got, jo) <= BF16_OUT_BAND
    band = FFN_BAND if dtype == "float32" else BF16_GRAD_BAND
    for name, g in zip(sorted(tp) + ["x"], grads, strict=True):
        want = jgx if name == "x" else jgp[name]
        assert _rel(g.float().numpy(), np.asarray(want.astype(jnp.float32))) <= band, name


def test_top1_matches_manual():
    """``TestDenseMoE.test_top1_matches_manual``: at top-1 with room for
    every token, each token's output is its argmax expert's FFN times
    that expert's router prob."""
    x, params = ep_inputs()
    x, p = torch.from_numpy(x[:32]), {k: torch.from_numpy(v) for k, v in params.items()}
    out, _ = tep.moe_ffn(x, p, top_k=1, capacity_factor=8.0)
    probs = torch.softmax(x @ p["router"], -1)
    e = probs.argmax(-1)
    h = torch.nn.functional.gelu(torch.einsum("th,tfh->tf", x, p["w1"][e]) + p["b1"][e],
                                 approximate="tanh")
    y = torch.einsum("tf,thf->th", h, p["w2"][e]) + p["b2"][e]
    want = probs.gather(1, e[:, None]) * y
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_moe_init_and_expert_params_match_jax():
    """``moe_init`` draws the JAX tree (shapes, zero biases, ``w2``'s
    1/sqrt(2) scale) and ``is_expert_param`` picks the same leaves of the
    MoE GPT's tree as the JAX one, from the same key paths."""
    want = jep.moe_init(jax.random.PRNGKey(0), 16, 32, 8, layers=3)
    got = tep.moe_init(torch.Generator().manual_seed(0), 16, 32, 8, layers=3)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert not got["b1"].any() and not got["b2"].any()
    ratio = float(got["w2"].std() / got["w1"].std())
    assert abs(ratio * np.sqrt(2.0) - 1.0) < 0.05
    paths = jax.tree_util.tree_leaves_with_path(jax_params())
    picked = [jax.tree_util.keystr(p) for p, _ in paths if tep.is_expert_param(p)]
    assert picked == [jax.tree_util.keystr(p) for p, _ in paths if jep.is_expert_param(p)]
    assert len(picked) == 4


def test_dispatch_and_combine_are_deterministic():
    """Two backward passes of the same layer are bitwise equal (each
    write goes to a unique row; the k-term sums run in slot order)."""
    x, params = ep_inputs()
    runs = []
    for _ in range(2):
        p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
        tx = torch.from_numpy(x).requires_grad_()
        o, a = tep.moe_ffn(tx, p, top_k=2, capacity_factor=1.25)
        runs.append(torch.autograd.grad((o ** 2).sum() + a, list(p.values()) + [tx]))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ------------------------------------------------- moe_ffn over the ep group
def _jax_ep(ep, top_k, cf, devices):
    """The JAX ``moe_ffn`` under ``shard_map`` over ``ep`` devices: out,
    the expert grads (complete on their owner, gathered) and the router's
    summed over ep, of ``sum(out ** 2)``, and x's."""
    x, params = ep_inputs()
    mesh = Mesh(np.array(devices[:ep]), ("ep",))
    pspecs = {"router": P(None, None), "w1": P("ep", None, None), "b1": P("ep", None),
              "w2": P("ep", None, None), "b2": P("ep", None)}
    kw = dict(top_k=top_k, capacity_factor=cf, ep_axis="ep")

    def local(xx, pp):
        o = jep.moe_ffn(xx, pp, **kw)[0]
        gp, gx = jax.grad(lambda p, z: jnp.sum(jep.moe_ffn(z, p, **kw)[0] ** 2),
                          argnums=(0, 1))(pp, xx)
        gp = {**gp, "router": jax.lax.psum(gp["router"], "ep")}
        return o, gp, gx

    specs_out = {**pspecs, "router": P(None, None)}
    o, gp, gx = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P("ep", None), pspecs),
                                      out_specs=(P("ep", None), specs_out, P("ep", None)),
                                      check_vma=False))(jnp.asarray(x),
                                                        jax.tree.map(jnp.asarray, params))
    return np.asarray(o), jax.tree.map(np.asarray, gp), np.asarray(gx)


@pytest.mark.parametrize("case", sorted(EP_CASES))
@pytest.mark.parametrize("ep", [4, 2])
def test_expert_parallel_matches_jax_shard_map(world4, devices8, ep, case):
    """``moe_ffn(ep_group=)`` over the dp group (ep 4; ep 2 on each tp
    rank of a dp 2 x tp 2 world): every rank's out rows, its experts'
    grads (complete on the owner: the exchange's backward brings every
    cotangent home) and the router's grad summed over ep against the JAX
    run, within 1e-5 of the largest; two exchanges forward and two
    backward."""
    top_k, cf = EP_CASES[case]
    want_o, want_g, want_x = _jax_ep(ep, top_k, cf, devices8)
    T, _, _, E = EP_SHAPE
    Tl, El = T // ep, E // ep
    router = [None] * ep
    for rank, res in enumerate(world4):
        d = rank // (4 // ep)  # the rank's dp (= ep) index
        o, g, gx, a2a = res["ep"][ep, case]
        assert a2a == 4
        assert _rel(o.numpy(), want_o[d * Tl:(d + 1) * Tl]) <= EP_BAND
        assert _rel(gx.numpy(), want_x[d * Tl:(d + 1) * Tl]) <= EP_BAND
        for k in tep.EXPERT_PARAM_KEYS:
            assert _rel(g[k].numpy(), want_g[k][d * El:(d + 1) * El]) <= EP_BAND, k
        router[d] = g["router"]
    assert _rel(sum(router).numpy(), want_g["router"]) <= EP_BAND


# ---------------------------------------------------------------- MoE GPT
@pytest.fixture(scope="module")
def jax_gpt():
    """The JAX single-device MoE GPT on ``batch(0)`` (fp32, no remat: the
    values are remat's): per head, the loss and grads and the logits and
    aux; and at ample capacity without aux, the loss, grads and one
    FusedAdam update."""
    tree = jax.tree.map(jnp.asarray, jax_params())
    tok, tgt = batch()
    out = {}
    for fused in (False, True):
        jcfg = jgpt.GPTConfig(**{**CFG, "checkpoint_layers": False}, compute_dtype=jnp.float32,
                              fused_ce=fused)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, t, y: jgpt.gpt_loss(p, t, y, jcfg)))(tree, tok, tgt)
        logits, aux = jax.jit(lambda p, t: jgpt.gpt_forward(p, t, jcfg, return_aux=True))(
            tree, tok)
        out[fused] = (float(loss), jax.tree.map(np.asarray, grads), np.asarray(logits),
                      float(aux))
        if not fused:
            opt = JaxFusedAdam(lr=LR)
            new, _ = opt.update(grads, opt.init(tree), tree)
            out["step"] = jax.tree.map(np.asarray, new)
    jcfg = jgpt.GPTConfig(**{**CFG, **AMPLE}, compute_dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, jax_params(**AMPLE))
    loss, grads = jax.jit(jax.value_and_grad(lambda p, t, y: jgpt.gpt_loss(p, t, y, jcfg)))(
        params, tok, tgt)
    opt = JaxFusedAdam(lr=LR)
    new, _ = opt.update(grads, opt.init(params), params)
    out["ample"] = (float(loss), jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, new))
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_moe_gpt_loss_and_grads_match_jax(jax_gpt, fused, remat):
    """``gpt_loss`` of the MoE GPT (the aux term in, the dense and the
    fused CE head, remat on and off) and every gradient against JAX on
    one device (1e-5 / 2e-5); the tree carries ``layers.moe`` and no
    ``fc*``; ``gpt_forward(return_aux=True)`` returns the summed aux."""
    tcfg = tgpt.GPTConfig(**{**CFG, "checkpoint_layers": remat}, compute_dtype=torch.float32,
                          fused_ce=fused)
    tree = jax_params()
    assert "moe" in tree["layers"] and "fc1" not in tree["layers"]
    tok, tgt = batch()
    loss, grads, jlogits, jaux = jax_gpt[fused]
    from apex_tpu_torch.train_gpt import loss_and_grads

    p = tgpt.params_from_numpy(tree, tcfg, "cpu", keep_fp32=True)
    got, got_grads = loss_and_grads(p, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg)
    assert abs(float(got) - loss) <= BAND * abs(loss)
    _close(got_grads, grads, "grads", GRAD_BAND)
    with torch.no_grad():
        logits, aux = tgpt.gpt_forward(p, torch.from_numpy(tok), tcfg, return_aux=True)
    assert _rel(logits.numpy(), jlogits) <= GRAD_BAND
    assert abs(float(aux) - jaux) <= BAND * abs(jaux)


def test_moe_train_step_on_one_device_matches_jax(jax_gpt):
    """``make_train_step`` with MoE and no dp group (every expert local,
    no exchange), compiled on the CPU's static buffers: the loss and the
    FusedAdam update against the JAX single-device ``gpt_loss`` and
    update (1e-5; params 2e-5 of the leaf's scale or 5e-4)."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.train_gpt import make_train_step
    from apex_tpu_torch.transformer import expert_parallel

    tcfg = tgpt.GPTConfig(**CFG, compute_dtype=torch.float32)
    p = tgpt.params_from_numpy(jax_params(), tcfg, "cpu", keep_fp32=True)
    opt = FusedAdam(lr=LR)
    state = opt.init(p)
    for leaf in jax.tree.leaves(p):
        leaf.requires_grad_(True)
    step = make_train_step(opt, tcfg)
    tok, tgt = batch()
    a2a = expert_parallel.A2A_LAUNCHES
    loss = float(step(p, state, torch.from_numpy(tok), torch.from_numpy(tgt)))
    assert expert_parallel.A2A_LAUNCHES == a2a
    assert abs(loss - jax_gpt[False][0]) <= BAND * abs(jax_gpt[False][0])
    _close(p, jax_gpt["step"], "dp1 params", GRAD_BAND, PARAM_ATOL)


def test_init_params_carries_the_moe_tree():
    """``init_params`` draws the JAX tree's shapes: ``layers.moe`` with
    the router (L, H, E), experts (L, E, ...), and no ``fc*`` leaves."""
    cfg = tgpt.GPTConfig(**CFG, compute_dtype=torch.float32)
    from apex_tpu_torch.optimizers.tree import leaves_with_path

    p = tgpt.init_params(cfg, 0, "cpu")
    want = {path: a.shape for path, a in leaves_with_path(jax_params())}
    assert {path: tuple(a.shape) for path, a in leaves_with_path(p)} == want
    assert p["layers"]["moe"]["w1"].dtype == torch.float32  # compute_dtype fp32


# ----------------------------------------------------------- train steps
@pytest.fixture(scope="module")
def jax_steps(devices8):
    """JAX ``make_train_step`` on the (dp, tp) mesh of each step case."""
    out = {}
    for name, (tp, fused, clip, over) in STEP_CASES.items():
        jcfg = jgpt.GPTConfig(**{**CFG, **over}, compute_dtype=jnp.float32, fused_ce=fused)
        params = jax.tree.map(jnp.asarray, jax_params(**over))
        opt = JaxFusedAdam(lr=LR)
        state = opt.init(params)
        mesh = Mesh(np.array(devices8[:4]).reshape(4 // tp, tp), ("dp", "tp"))
        step = jgpt.make_train_step(jcfg, opt, mesh, clip_grad_norm=clip)
        losses = []
        for i in range(STEPS):
            tok, tgt = batch(i)
            params, state, loss = step(params, state, jnp.asarray(tok), jnp.asarray(tgt))
            losses.append(float(loss))
        out[name] = (losses, jax.tree.map(np.asarray, params))
    return out


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_moe_train_step_matches_jax(world4, jax_steps, name):
    """``make_train_step`` with MoE at dp 4 (ep 4) and dp 2 x tp 2
    (experts over dp, replicated over tp): every rank's losses within
    1e-5 relative of the JAX step's on the same layout, and the params
    (gathered over tp and ep) within 2e-5 of the leaf's scale or 5e-4."""
    losses, params = jax_steps[name]
    for res in world4:
        got, got_params = res["step"][name]
        for a, b in zip(got, losses, strict=True):
            assert abs(a - b) <= BAND * abs(b), (name, got, losses)
        _close(got_params, params, name, GRAD_BAND, PARAM_ATOL)


def test_sharded_loss_matches_dense(world4, jax_gpt):
    """``TestMoEGPT.test_sharded_loss_matches_dense``: at ample capacity
    and no aux, the dp 4 step's first loss (the mean over the ranks' CE)
    equals the single-device loss on the global batch."""
    dense = jax_gpt["ample"][0]
    for res in world4:
        assert abs(res["step"]["dp4_ample"][0][0] - dense) <= BAND * abs(dense)


def test_pp_moe_matches_single_device(world4):
    """``TestMoEPipeline``: ``make_pp_train_step`` at pp 2 x dp 2 (2
    microbatches; the aux through the schedule's aux channel, experts
    over dp) with FusedSGD against the JAX single-device loss and SGD
    update, at ``test_moe.py``'s bands (loss 1e-4 relative, params rtol
    5e-3, atol 5e-5)."""
    cfg = jgpt.GPTConfig(**PP_CFG, compute_dtype=jnp.float32)
    params = jgpt.init_params(cfg, jax.random.PRNGKey(0))
    tok, tgt = batch(0)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, t, y: jgpt.gpt_loss(p, t, y, cfg)))(
        params, tok, tgt)
    opt = JaxFusedSGD(lr=LR, momentum=0.0)
    want, _ = opt.update(grads, opt.init(params), params)
    from apex_tpu_torch.optimizers.tree import leaves_with_path

    want = dict(leaves_with_path(jax.tree.map(np.asarray, want)))
    for res in world4:
        got_loss, got_params = res["pp"]
        assert abs(got_loss - float(loss)) <= PP_LOSS_BAND * abs(float(loss))
        for path, a in leaves_with_path(got_params):
            np.testing.assert_allclose(a.numpy(), want[path], rtol=PP_PARAM_TOL[0],
                                       atol=PP_PARAM_TOL[1], err_msg=str(path))


def test_cp_moe_matches_single_device(world4, jax_gpt):
    """``make_train_step(cp_group=)`` at cp 2 x dp 2 with MoE (ample
    capacity, no aux: each cp rank routes its own chunk): the loss, the
    grads FusedAdam was handed (averaged over cp; the experts' summed
    over dp by the exchange and scaled by 1/dp) and the new params
    against the JAX single-device step on the global batch."""
    loss, grads, new = jax_gpt["ample"]
    for res in world4:
        got_loss, got_grads, got_params = res["cp"]
        assert abs(got_loss - loss) <= BAND * abs(loss)
        _close(got_grads, grads, "cp grads", GRAD_BAND)
        _close(got_params, new, "cp params", GRAD_BAND, PARAM_ATOL)


# --------------------------------------------------------------- refusals
def _jax_refusal(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what the test reads
        return type(e).__name__, str(e)
    return None


@pytest.fixture(scope="module")
def jax_refusals(devices8):
    """The JAX package's refusals of the same calls, on a (4, 1) mesh."""
    from apex_tpu.contrib.optimizers import DistributedFusedAdam as JaxZero

    cfg = jgpt.GPTConfig(**CFG, compute_dtype=jnp.float32)
    odd = dataclasses.replace(cfg, moe_num_experts=6)
    mesh = Mesh(np.array(devices8[:4]).reshape(4, 1), ("dp", "tp"))
    hier = Mesh(np.array(devices8[:4]).reshape(2, 2, 1), ("dp_out", "dp_in", "tp"))
    pp_mesh = Mesh(np.array(devices8[:4]).reshape(1, 4, 1), ("dp", "pp", "tp"))
    return {
        "indivisible": _jax_refusal(lambda: jgpt.make_train_step(odd, JaxFusedAdam(lr=LR),
                                                                 mesh)),
        "zero": _jax_refusal(lambda: jgpt.make_train_step(cfg, JaxZero(lr=LR), mesh)),
        "grad_sync_dtype": _jax_refusal(lambda: jgpt.make_train_step(
            cfg, JaxFusedAdam(lr=LR), mesh, grad_sync_dtype=jnp.int8)),
        "hierarchical": _jax_refusal(lambda: jgpt.make_train_step(
            cfg, JaxFusedAdam(lr=LR), hier, dp_axis=("dp_out", "dp_in"))),
        "overlap": _jax_refusal(lambda: jgpt.make_train_step(
            cfg, JaxFusedAdam(lr=LR), mesh, overlap_grad_sync=True)),
        "pp_no_dp": _jax_refusal(lambda: jgpt.make_pp_train_step(
            cfg, JaxFusedAdam(lr=LR), pp_mesh, num_microbatches=2, dp_axis=None)),
        "pp_zero": _jax_refusal(lambda: jgpt.make_pp_train_step(
            cfg, JaxZero(lr=LR), pp_mesh, num_microbatches=2)),
    }


@pytest.mark.parametrize("what", ["indivisible", "zero", "grad_sync_dtype", "hierarchical",
                                  "overlap", "pp_no_dp", "pp_zero"])
def test_step_refusals_match_jax(world4, jax_refusals, what):
    """Each step builder refuses what the JAX one refuses, with the same
    exception type and message: experts that do not divide over dp, ZeRO
    (both steps), ``grad_sync_dtype``, a hierarchical dp split,
    ``overlap_grad_sync``, and the pipeline without a dp group."""
    want = jax_refusals[what]
    assert want is not None, what
    for res in world4:
        assert res["refused"][what] == want, (what, res["refused"][what], want)


def test_model_refusals_match_jax():
    """MoE with sequence parallelism raises ValueError in ``gpt_forward``,
    and MoE decoding NotImplementedError in ``forward_decode`` and the
    scheduler, with the JAX messages."""
    from apex_tpu.inference import ContinuousBatchingScheduler as JaxScheduler
    from apex_tpu.inference import DecodeConfig as JaxDecodeConfig
    from apex_tpu_torch.inference import ContinuousBatchingScheduler, DecodeConfig

    jcfg = jgpt.GPTConfig(**CFG, compute_dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**CFG, compute_dtype=torch.float32)
    sp = (dataclasses.replace(jcfg, sequence_parallel=True),
          dataclasses.replace(tcfg, sequence_parallel=True))
    jp = jax.tree.map(jnp.asarray, jax_params())
    tp = tgpt.params_from_numpy(jax_params(), tcfg, "cpu")
    want = _jax_refusal(lambda: jgpt.gpt_forward(jp, jnp.zeros((1, 8), jnp.int32), sp[0],
                                                 axis_name="tp"))
    assert want[0] == "ValueError"
    assert _jax_refusal(lambda: tgpt.gpt_forward(tp, torch.zeros(1, 8), sp[1])) == want
    z = np.zeros(2, np.int32)
    want = _jax_refusal(lambda: jgpt.forward_decode(jp, z, z, z > 0, {}, None, jcfg))
    assert want[0] == "NotImplementedError"
    tz = torch.zeros(2, dtype=torch.int32)
    assert _jax_refusal(lambda: tgpt.forward_decode(tp, tz, tz, tz > 0, {}, None,
                                                    tcfg)) == want
    want = _jax_refusal(lambda: JaxScheduler(jp, jcfg, JaxDecodeConfig(max_prompt_len=8)))
    assert want[0] == "NotImplementedError"
    assert _jax_refusal(lambda: ContinuousBatchingScheduler(
        tp, tcfg, DecodeConfig(max_prompt_len=8), device="cpu")) == want
