"""The port's GPT under pipeline parallelism (``apex_tpu_torch.models.gpt
.make_pp_train_step``, ``shard_params`` / ``gather_params`` with a
pipeline group, ``params_to_vpp_layout``, ``clip_sumsq_reduce`` over pp)
against the JAX package's single-device ``gpt_loss`` plus the FusedAdam
update, and against its ``make_pp_train_step`` on a (dp, pp, tp) mesh.

Mirrors ``tests/test_gpt_3d.py``: one world of 4 ranks under gloo
(``parallel.multiproc.launch``) takes one step in each layout -- dp 2 x
pp 2, pp 2 x tp 2 with and without sequence parallelism (the fused head
with it), pp 4, pp 2 with vpp 2 after ``params_to_vpp_layout``, pp 2 x
tp 2 with a clip -- and each rank's loss, its grads (the ones the
optimizer was handed, gathered whole over pp and tp) and its new params
are held against the JAX single-device step on the same global batch.
The pp 2 x tp 2 run is also held against JAX ``make_pp_train_step`` on a
(1, 2, 2) mesh of CPU devices with the same two microbatches.  An fp16
step whose grads are made non-finite on the first stage only is skipped
on every stage (the found-inf vote over pp and tp); at pp 1 the step
with one microbatch equals ``make_train_step`` bitwise.  Bands: fp32
throughout; the loss within 1e-5 relative (``tests/test_torch_gpt_tp.py``
``BAND``), grads within 2e-5 of the leaf's largest entry, params within
2e-5 of the leaf's scale or 5e-4 (the reference's dp 2 x tp 2 Adam band,
``tests/test_gpt.py``: a gradient that is rounding noise in exact
arithmetic, ``bk``'s, moves Adam's update).
"""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from apex_tpu.models import gpt as jgpt
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam

from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.parallel import multiproc

REPO = Path(__file__).resolve().parent.parent
BAND = 1e-5
GRAD_BAND = 2e-5
PARAM_ATOL = 5e-4
LR = 1e-2
CFG = dict(vocab_size=64, hidden_size=32, num_layers=4, num_attention_heads=4, max_seq_len=16,
           checkpoint_layers=True, use_flash_attention=True, fused_ce_chunk=8)
#: name -> (tp, pp, vpp, microbatches, fused head, sequence parallel, clip)
CASES = {
    "dp2_pp2": (1, 2, 1, 2, False, False, None),
    "pp2_tp2": (2, 2, 1, 2, False, False, None),
    "pp2_tp2_sp_fused": (2, 2, 1, 2, True, True, None),
    "pp4": (1, 4, 1, 4, False, False, None),
    "dp2_pp2_vpp2": (1, 2, 2, 2, False, False, None),
    "pp2_tp2_clip": (2, 2, 1, 2, False, False, 0.05),
}
GLOBAL_BATCH = 8


def jax_params():
    cfg = jgpt.GPTConfig(**CFG, compute_dtype=jnp.float32)
    return jax.tree.map(np.asarray, jgpt.init_params(cfg, jax.random.PRNGKey(0)))


def batch():
    rng = np.random.RandomState(0)
    tok = rng.randint(0, CFG["vocab_size"], size=(GLOBAL_BATCH, CFG["max_seq_len"] + 1))
    return tok[:, :-1], tok[:, 1:]


CHILD = r'''
import sys, pickle
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from apex_tpu_torch.parallel import initialize_distributed, destroy_distributed
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.models import gpt
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map
from apex_tpu_torch.amp import DynamicLossScaler
params_np, cases, CFG, LR, tok, tgt = pickle.load(open(sys.argv[3], "rb"))
initialize_distributed("cpu")
out = {}


class Recording(FusedAdam):
    """FusedAdam that keeps the grads it is handed (and, with poison, makes
    one of them non-finite on the first stage)."""
    poison = False

    def update(self, grads, state, params, **kw):
        self.grads = grads
        return super().update(grads, state, params, **kw)

    def update_scaled(self, grads, state, params, **kw):
        if self.poison and ps.get_pipeline_model_parallel_rank() == 0:
            grads = {**grads, "layers": {**grads["layers"],
                                         "fc1": grads["layers"]["fc1"] * float("inf")}}
        self.grads = grads
        return super().update_scaled(grads, state, params, **kw)


def setup(tp, pp, vpp=None):
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(tensor_model_parallel_size_=tp, pipeline_model_parallel_size_=pp,
                                 virtual_pipeline_model_parallel_size_=vpp)
    return (ps.get_tensor_model_parallel_group(), ps.get_pipeline_model_parallel_group(),
            ps.get_data_parallel_group())


for name, (tp, pp, vpp, M, fused, sp, clip) in cases.items():
    g, pg, dp = setup(tp, pp, vpp if vpp > 1 else None)
    cfg = gpt.GPTConfig(**CFG, compute_dtype=torch.float32, fused_ce=fused, sequence_parallel=sp)
    tree = params_np if vpp == 1 else gpt.params_to_vpp_layout(params_np, pp, vpp)
    p = gpt.shard_params(tree, cfg, g, "cpu", keep_fp32=True, pp_group=pg)
    opt = Recording(lr=LR)
    st = opt.init(p)
    step = gpt.make_pp_train_step(cfg, opt, M, vpp, clip_grad_norm=clip, dp_group=dp,
                                  tp_group=g, graphs=False)
    rows = len(tok) // dp.size()
    r = slice(rows * dp.rank(), rows * (dp.rank() + 1))
    loss = float(step(p, st, torch.from_numpy(tok[r]), torch.from_numpy(tgt[r])))
    grads = gpt.gather_params(opt.grads, cfg, g, pg)
    new = gpt.gather_params(p, cfg, g, pg)
    if vpp > 1:
        grads, new = (gpt.params_from_vpp_layout(t, pp, vpp) for t in (grads, new))
    out[name] = (loss, tree_map(lambda a: a.detach().clone(), grads),
                 tree_map(lambda a: a.detach().clone(), new))

# fp16 at pp 2 x tp 2: a step, then one whose grads are non-finite on the
# first stage only
g, pg, dp = setup(2, 2)
cfg = gpt.GPTConfig(**CFG, compute_dtype=torch.float16)
p = gpt.shard_params(params_np, cfg, g, "cpu", keep_fp32=True, pp_group=pg)
opt = Recording(lr=LR)
st = opt.init(p)
scaler = DynamicLossScaler(init_scale=2.0 ** 12)
sst = scaler.init("cpu")
step = gpt.make_pp_train_step(cfg, opt, 2, loss_scaler=scaler, dp_group=dp, tp_group=g,
                              graphs=False)
l1 = float(step(p, st, sst, torch.from_numpy(tok[:4]), torch.from_numpy(tgt[:4])))
before = [t.clone() for t in tree_leaves((p, st))]
opt.poison = True
l2 = float(step(p, st, sst, torch.from_numpy(tok[:4]), torch.from_numpy(tgt[:4])))
same = all(torch.equal(a, b) for a, b in zip(before, tree_leaves((p, st))))
out["fp16"] = (l1, l2, same, int(st.step), float(sst.loss_scale))

# pp 1 (dp 4): the pipelined step with one microbatch against
# make_train_step, three steps from the same params on the same rows
from apex_tpu_torch.train_gpt import make_train_step
g, pg, dp = setup(1, 1)
cfg = gpt.GPTConfig(**CFG, compute_dtype=torch.float32)
r = slice(2 * dp.rank(), 2 * dp.rank() + 2)
m1 = {}
for kind in ("make_train_step", "pp_m1"):
    p = gpt.shard_params(params_np, cfg, g, "cpu", keep_fp32=True, pp_group=pg)
    opt = FusedAdam(lr=LR)
    st = opt.init(p)
    step = (make_train_step(opt, cfg, graphs=False, dp_group=dp) if kind == "make_train_step"
            else gpt.make_pp_train_step(cfg, opt, 1, dp_group=dp, tp_group=g, graphs=False))
    losses = [float(step(p, st, torch.from_numpy(tok[r]), torch.from_numpy(tgt[r])))
              for _ in range(3)]
    m1[kind] = (losses, [t.detach().clone() for t in tree_leaves(p)])
out["m1"] = m1
torch.save(out, sys.argv[2] + f"/rank{dist.get_rank()}.pt")
destroy_distributed()
'''


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    d = tmp_path_factory.mktemp("gpt_pp")
    tok, tgt = batch()
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((jax_params(), CASES, CFG, LR, tok, tgt), f)
    multiproc.launch(["-c", CHILD, str(REPO), str(d), str(d / "in.pkl")], 4, timeout=600)
    return [torch.load(d / f"rank{r}.pt") for r in range(4)]


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's single-device loss, grads and FusedAdam update (with and
    without the clip) on the global batch, at fp32, the dense and the
    fused head."""
    params = jax.tree.map(jnp.asarray, jax_params())
    tok, tgt = batch()
    out = {}
    for fused in (False, True):
        cfg = jgpt.GPTConfig(**CFG, compute_dtype=jnp.float32, fused_ce=fused)
        loss, grads = jax.value_and_grad(jgpt.gpt_loss)(params, tok, tgt, cfg)
        opt = JaxFusedAdam(lr=LR)
        for clip in (None, 0.05):
            kw = {} if clip is None else {"clip_norm": clip}
            new, _ = opt.update(grads, opt.init(params), params, **kw)
            out[fused, clip] = (float(loss), jax.tree.map(np.asarray, grads),
                                jax.tree.map(np.asarray, new))
    return out


def _close(got, want, name, band, atol=0.0):
    from apex_tpu_torch.optimizers.tree import leaves_with_path

    want = dict(leaves_with_path(want))
    for path, g in leaves_with_path(got):
        w = want[path]
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g.detach().numpy().astype(np.float64) - w).max())
        assert err <= max(band * scale, atol), (name, path, err, scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipelined_step_matches_jax_single_device(world4, jax_reference, name):
    """Every rank of each layout: the loss, the grads the optimizer took
    (summed over the stages for the shared leaves, gathered whole) and
    the new params against JAX's single-device step."""
    tp, pp, vpp, M, fused, sp, clip = CASES[name]
    loss, grads, params = jax_reference[fused, clip]
    for res in world4:
        got_loss, got_grads, got_params = res[name]
        assert abs(got_loss - loss) <= BAND * abs(loss), (name, got_loss, loss)
        _close(got_grads, grads, name, GRAD_BAND)
        _close(got_params, params, name, GRAD_BAND, PARAM_ATOL)


def test_pp2_tp2_matches_jax_make_pp_train_step(world4, devices8):
    """pp 2 x tp 2 against the JAX package's own pipelined step on a
    (1, 2, 2) mesh of CPU devices with the same 2 microbatches."""
    cfg = jgpt.GPTConfig(**CFG, compute_dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, jax_params())
    opt = JaxFusedAdam(lr=LR)
    mesh = Mesh(np.array(devices8[:4]).reshape(1, 2, 2), ("dp", "pp", "tp"))
    step = jgpt.make_pp_train_step(cfg, opt, mesh, num_microbatches=2)
    tok, tgt = batch()
    new, _, loss = step(params, opt.init(params), jnp.asarray(tok), jnp.asarray(tgt))
    new = jax.tree.map(np.asarray, new)
    for res in world4:
        got_loss, _, got_params = res["pp2_tp2"]
        assert abs(got_loss - float(loss)) <= BAND * abs(float(loss))
        _close(got_params, new, "jax_pp", GRAD_BAND, PARAM_ATOL)


def test_fp16_skip_holds_on_every_stage(world4):
    """The fp16 step at pp 2 x tp 2: a finite step moves the scale not and
    the optimizer's step to 1; the next, non-finite on the first stage
    only, leaves params and state bitwise as they were on every rank
    (the last stage's finite grads included) and backs the scale off."""
    for res in world4:
        l1, l2, same, opt_step, scale = res["fp16"]
        assert np.isfinite(l1) and np.isfinite(l2)
        assert same and opt_step == 1 and scale == 2.0 ** 11, res["fp16"]
    assert len({res["fp16"] for res in world4}) == 1


def test_one_microbatch_at_pp_1_equals_make_train_step(world4):
    """The pipelined step at pp 1 with one microbatch is ``make_train_step``
    (dp 4, three steps from the same params): the same losses and the
    same params, bitwise.  Only the microbatch split, whose grads are
    summed microbatch by microbatch, sets the two apart."""
    for r in world4:
        (want, want_p), (got, got_p) = r["m1"]["make_train_step"], r["m1"]["pp_m1"]
        assert got == want
        for a, b in zip(got_p, want_p):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_vpp_layout_round_trips_and_refusals():
    """``params_to_vpp_layout`` puts stage s's chunks back to back (numpy
    and tensors alike, as the JAX package's) and its inverse undoes it;
    the layer split and the interleaved microbatch rule refuse as the
    JAX step does.  (The name dates from when ``cp_axis`` was refused
    too: cp inside the pipeline step is ported, its run in
    tests/test_torch_context_parallel.py; what is left is the JAX step's
    own refusal of cp beside sequence parallelism.)"""
    params = jax_params()
    for pp, vpp in ((2, 2), (4, 1), (1, 4)):
        want = jgpt.params_to_vpp_layout(params, pp, vpp)
        got = tgpt.params_to_vpp_layout(params, pp, vpp)
        gott = tgpt.params_to_vpp_layout(
            {"layers": {k: torch.tensor(v) for k, v in params["layers"].items()}}, pp, vpp)
        for k in params["layers"]:
            np.testing.assert_array_equal(got["layers"][k], np.asarray(want["layers"][k]))
            np.testing.assert_array_equal(gott["layers"][k].numpy(), got["layers"][k])
            np.testing.assert_array_equal(
                tgpt.params_from_vpp_layout(got, pp, vpp)["layers"][k], params["layers"][k])
    cfg = tgpt.GPTConfig(**CFG)
    with pytest.raises(ValueError, match=r"must divide into pp \(3\) x vpp \(1\)"):
        tgpt.check_pp(cfg, 3)
    with pytest.raises(ValueError, match=r"pp \(2\) x vpp \(4\)"):
        tgpt.check_pp(cfg, 2, 4)
    from apex_tpu_torch.optimizers import FusedAdam

    from apex_tpu_torch.transformer.parallel_state import AxisGroup

    with pytest.raises(ValueError, match="both shard the sequence"):
        tgpt.make_pp_train_step(tgpt.GPTConfig(**CFG, sequence_parallel=True),
                                FusedAdam(lr=LR), 2, cp_axis=AxisGroup("cp", None, 1, 0))
