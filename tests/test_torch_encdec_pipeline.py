"""The port's encoder/decoder pipeline (``transformer.pipeline_parallel
.schedules.tick_schedule_encdec``, ``models.t5.make_pp_train_step``,
``parallel_state``'s split-rank parts) and T5 trainer
(``apex_tpu_torch.pretrain_t5``) against the JAX package on the CPU.

Mirrors ``tests/test_encdec_pipeline.py``:

- ``pad_stage_layout_encdec`` / ``unpad_stage_layout_encdec`` bitwise
  the JAX functions on the same arrays, and their refusal of a bad
  split;
- one world of 4 ranks under gloo (``parallel.multiproc.launch``) takes
  one step in each layout of :data:`CASES` (pp 4 split 2; pp 2 split 1 x
  tp 2, with the fused head; pp 4 split 1 with 2 encoder and 6 decoder
  layers; dp 2 x pp 2 split 1; tp 2 x dp 2 through ``make_train_step``),
  and each rank's loss, the grads the optimizer was handed (gathered
  whole over pp and tp) and its new params are held against the JAX
  single-device ``t5_loss``, its grads and the FusedAdam update at
  ``tests/test_torch_gpt_pp.py``'s bands (fp32: the loss within 1e-5
  relative, grads within 2e-5 of the leaf's largest entry, params within
  2e-5 of it or 5e-4); the padded zero chunks stay exactly zero;
- the loss-scaled run of ``test_fp16_loss_scaling_matches_oracle`` (the
  same scaler, 6 steps at pp 4 split 2), its first step's grads made
  non-finite on the first stage alone and the oracle's likewise: the
  first step skipped on every stage with the Adam counter held, the
  loss scales and counters equal to the JAX oracle's, the losses within
  1e-4;
- the split read from ``parallel_state`` (its predicates, the
  relative-position-embedding groups, the setter), and a missing split
  refused with the JAX ValueError;
- ``pretrain_t5`` at world 1 on ``--device cpu``: the loss falls over 6
  steps; ``--fp16`` without a pipeline refuses.
"""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.models import t5 as jt5
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.transformer.pipeline_parallel.schedules import tick_schedule_encdec as jsched

from apex_tpu_torch.models import t5 as tt5
from apex_tpu_torch.parallel import multiproc
from apex_tpu_torch.transformer.pipeline_parallel.schedules import tick_schedule_encdec as tsched

REPO = Path(__file__).resolve().parent.parent
BAND = 1e-5
GRAD_BAND = 2e-5
PARAM_ATOL = 5e-4
#: the loss-scaled run's losses after its overflow (the JAX test's rtol)
FP16_BAND = 1e-4
LR = 1e-2
SIZES = dict(vocab_size=64, hidden_size=32, num_encoder_layers=4, num_decoder_layers=4,
             num_attention_heads=4, max_src_len=16, max_tgt_len=12, fused_ce_chunk=4)
UNEVEN = {"num_encoder_layers": 2, "num_decoder_layers": 6}
#: name -> (tp, pp, split, microbatches, fused head, layer counts)
CASES = {
    "pp4_split2": (1, 4, 2, 4, False, {}),
    "pp2_split1_tp2_fused": (2, 2, 1, 2, True, {}),
    "pp4_split1_uneven": (1, 4, 1, 4, False, UNEVEN),
    "dp2_pp2_split1": (1, 2, 1, 2, False, {}),
    "tp2_dp2": (2, 1, None, 1, False, {}),
}
GLOBAL_BATCH = 8
SCALER = dict(init_scale=2.0 ** 127, backoff_factor=2.0 ** -4, growth_factor=2.0,
              growth_interval=3, hysteresis=1)
FP16_STEPS = 6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the model is tiny, and a CPU shared by
    parallel test workers slows many-thread kernels."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jcfg(**kw):
    return jt5.T5Config(**{**SIZES, "compute_dtype": jnp.float32, "checkpoint_layers": False,
                           **kw})


def data(B=GLOBAL_BATCH, seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(0, SIZES["vocab_size"], size=(B, SIZES["max_src_len"]))
    tgt = rng.randint(0, SIZES["vocab_size"], size=(B, SIZES["max_tgt_len"]))
    dec_in = np.roll(tgt, 1, axis=1)
    dec_in[:, 0] = 0
    return src, dec_in, tgt


def jax_params(layers):
    return jax.tree.map(np.asarray, jt5.init_params(jcfg(**layers), jax.random.PRNGKey(0)))


def test_pad_layout_matches_jax_bitwise():
    params = jax_params({})
    for pp, split in ((4, 2), (2, 1), (4, 1), (4, 3)):
        L = {(4, 1): (1, 3), (4, 3): (3, 1)}.get((pp, split))
        enc, dec = params["enc_layers"], params["dec_layers"]
        if L is not None:  # layer counts that divide over this split
            enc = {k: np.concatenate([v] * 3)[:L[0] * 2] for k, v in enc.items()}
            dec = {k: np.concatenate([v] * 3)[:L[1] * 2] for k, v in dec.items()}
        want = jsched.pad_stage_layout_encdec(enc, dec, pp, split)
        got = tsched.pad_stage_layout_encdec(enc, dec, pp, split)
        gott = tsched.pad_stage_layout_encdec({k: torch.tensor(v) for k, v in enc.items()},
                                              {k: torch.tensor(v) for k, v in dec.items()},
                                              pp, split)
        for w, g, gt in zip(want, got, gott):
            for k in w:
                np.testing.assert_array_equal(g[k], np.asarray(w[k]))
                np.testing.assert_array_equal(gt[k].numpy(), g[k])
        back = tsched.unpad_stage_layout_encdec(*got, pp, split)
        wback = jsched.unpad_stage_layout_encdec(*want, pp, split)
        for side, orig, wb in zip(back, (enc, dec), wback):
            for k in orig:
                np.testing.assert_array_equal(side[k], orig[k])
                np.testing.assert_array_equal(side[k], np.asarray(wb[k]))
    for split in (0, 4):
        with pytest.raises(ValueError, match=rf"split must be in \(0, 4\); got {split}"):
            tsched.pad_stage_layout_encdec(params["enc_layers"], params["dec_layers"], 4, split)
    with pytest.raises(ValueError, match="4 layers do not divide over 3 stages"):
        tsched.pad_stage_layout_encdec(params["enc_layers"], params["dec_layers"], 4, 3)


def test_missing_split_refused():
    """No split and no registered one: the JAX step's ValueError."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.parallel_state import AxisGroup

    pg = AxisGroup("pp", None, 4, 0, (0, 1, 2, 3))
    cfg = tt5.T5Config(**SIZES)
    with pytest.raises(ValueError, match="pass split= or initialize_model_parallel"):
        tt5.make_pp_train_step(cfg, FusedAdam(lr=LR), 2, pp_group=pg)
    with pytest.raises(ValueError, match=r"split must be in \(0, 4\); got 4"):
        tt5.make_pp_train_step(cfg, FusedAdam(lr=LR), 2, 4, pp_group=pg)


CHILD = r'''
import sys, pickle
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from apex_tpu_torch.parallel import initialize_distributed, destroy_distributed
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.models import t5
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers.tree import tree_map
from apex_tpu_torch.amp import DynamicLossScaler
from apex_tpu_torch.graphs import tensor_leaves
trees, cases, SIZES, LR, (src, dec_in, tgt), SCALER, FP16_STEPS = pickle.load(
    open(sys.argv[3], "rb"))
initialize_distributed("cpu")
out = {}


class Recording(FusedAdam):
    """FusedAdam that keeps the grads it is handed."""

    def update(self, grads, state, params, **kw):
        self.grads = grads
        return super().update(grads, state, params, **kw)


def setup(tp, pp, split=None):
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(tensor_model_parallel_size_=tp, pipeline_model_parallel_size_=pp,
                                 pipeline_model_parallel_split_rank_=split)
    return (ps.get_tensor_model_parallel_group(), ps.get_pipeline_model_parallel_group(),
            ps.get_data_parallel_group())


def t(a, rows):
    return torch.from_numpy(np.ascontiguousarray(a[rows]))


def clone(tree):
    return tree_map(lambda a: a.detach().clone(), tree)


for name, (tp, pp, split, M, fused, layers) in cases.items():
    g, pg, dp = setup(tp, pp, split)
    cfg = t5.T5Config(**{**SIZES, **layers}, compute_dtype=torch.float32,
                      checkpoint_layers=True, fused_ce=fused)
    tree = trees[str(sorted(layers.items()))]
    opt = Recording(lr=LR)
    if pp > 1:
        p = t5.shard_params(t5.params_to_pp_layout(tree, pp, split), cfg, g, "cpu", pg)
        step = t5.make_pp_train_step(cfg, opt, M, split, dp_group=dp, tp_group=g, pp_group=pg,
                                     graphs=False)
    else:
        p = t5.shard_params(tree, cfg, g, "cpu")
        step = t5.make_train_step(cfg, opt, dp_group=dp, tp_group=g, graphs=False)
    st = opt.init(p)
    rows = len(src) // dp.size()
    r = slice(rows * dp.rank(), rows * (dp.rank() + 1))
    loss = float(step(p, st, t(src, r), t(dec_in, r), t(tgt, r)))
    out[name] = (loss, clone(t5.gather_params(opt.grads, cfg, g, pg if pp > 1 else None)),
                 clone(t5.gather_params(p, cfg, g, pg if pp > 1 else None)))

# the loss-scaled run at pp 4 split 2: the JAX test's scaler, 6 steps,
# the first with non-finite grads on the first stage only


class Poisoned(FusedAdam):
    """FusedAdam whose first scaled update gets one non-finite grad leaf on
    the first pipeline stage (an encoder stage) alone."""
    calls = 0

    def update_scaled(self, grads, state, params, **kw):
        if self.calls == 0 and ps.get_pipeline_model_parallel_rank() == 0:
            enc = {**grads["enc_layers"], "fc1": grads["enc_layers"]["fc1"] * float("inf")}
            grads = {**grads, "enc_layers": enc}
        self.calls += 1
        return super().update_scaled(grads, state, params, **kw)


g, pg, dp = setup(1, 4, 2)
cfg = t5.T5Config(**SIZES, compute_dtype=torch.float32, checkpoint_layers=False)
p = t5.shard_params(t5.params_to_pp_layout(trees["fp16"], 4, 2), cfg, g, "cpu", pg)
opt = Poisoned(lr=LR)
st = opt.init(p)
scaler = DynamicLossScaler(**SCALER)
sst = scaler.init("cpu")
step = t5.make_pp_train_step(cfg, opt, 4, loss_scaler=scaler, tp_group=g, graphs=False)
everything = slice(None)
fp16 = []
before = [a.detach().clone() for a in tensor_leaves((p, st))]
for i in range(FP16_STEPS):
    loss = float(step(p, st, sst, t(src, everything), t(dec_in, everything),
                      t(tgt, everything)))
    fp16.append((loss, float(sst.loss_scale), int(st.step)))
    if i == 0:
        unchanged = all(torch.equal(a, b) for a, b in zip(before, tensor_leaves((p, st))))
out["fp16"] = (fp16, unchanged, clone(t5.gather_params(p, cfg, g, pg)))

# the split read from parallel_state: its predicates and groups, and the
# step without split=
g, pg, dp = setup(1, 4, 2)
me = pg.rank()
facts = {
    "before": [ps.is_pipeline_stage_before_split(s) for s in range(4)],
    "after": [ps.is_pipeline_stage_after_split(stage=s) for s in range(4)],
    "at": [ps.is_pipeline_stage_at_split(stage=s) for s in range(4)],
    "enc_member": [ps.is_rank_in_encoder_relative_position_embedding_group(stage=s)
                   for s in range(4)],
    "dec_member": [ps.is_rank_in_decoder_relative_position_embedding_group(stage=s)
                   for s in range(4)],
    "enc_group": ps.get_encoder_relative_position_embedding_group().ranks,
    "dec_group": ps.get_decoder_relative_position_embedding_group().ranks,
    "embedding": ps.get_embedding_group().ranks,
}
try:
    ps.is_pipeline_stage_before_split()
except ValueError as e:
    facts["no_stage"] = str(e)
x = torch.full((1,), float(dist.get_rank()))
grp = ps.get_decoder_relative_position_embedding_group()
if grp.size():
    dist.all_reduce(x, group=grp.group)
facts["dec_sum"] = float(x)
cfg = t5.T5Config(**SIZES, compute_dtype=torch.float32, checkpoint_layers=False)
p = t5.shard_params(t5.params_to_pp_layout(trees["fp16"], 4, 2), cfg, g, "cpu", pg)
opt = FusedAdam(lr=LR)
step = t5.make_pp_train_step(cfg, opt, 2, graphs=False)
facts["loss"] = float(step(p, opt.init(p), t(src, everything), t(dec_in, everything),
                           t(tgt, everything)))
ps.set_pipeline_model_parallel_split_rank(1)
facts["set_split"] = (ps.get_encoder_relative_position_embedding_group().ranks,
                      ps.get_decoder_relative_position_embedding_group().ranks,
                      ps.is_pipeline_stage_at_split(stage=0), ps.get_embedding_group().ranks)
g, pg, dp = setup(1, 4)
try:
    t5.make_pp_train_step(cfg, FusedAdam(lr=LR), 2, graphs=False)
except ValueError as e:
    facts["missing"] = str(e)
facts["no_split_groups"] = (ps.get_encoder_relative_position_embedding_group().ranks,
                            ps.is_pipeline_stage_before_split(stage=3),
                            ps.is_pipeline_stage_at_split(stage=1))
out["facts"] = facts
torch.save(out, sys.argv[2] + f"/rank{dist.get_rank()}.pt")
destroy_distributed()
'''


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    d = tmp_path_factory.mktemp("encdec_pp")
    trees = {str(sorted(layers.items())): jax_params(layers) for layers in ({}, UNEVEN)}
    trees["fp16"] = jax.tree.map(np.asarray, jt5.init_params(jcfg(), jax.random.PRNGKey(7)))
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((trees, CASES, SIZES, LR, data(), SCALER, FP16_STEPS), f)
    multiproc.launch(["-c", CHILD, str(REPO), str(d), str(d / "in.pkl")], 4, timeout=600)
    return [torch.load(d / f"rank{r}.pt") for r in range(4)]


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's single-device loss, grads and FusedAdam update on the global
    batch (fp32) for each (layer counts, head) the cases take."""
    src, dec_in, tgt = data()
    out = {}
    for layers, fused in (({}, False), ({}, True), (UNEVEN, False)):
        params = jax.tree.map(jnp.asarray, jax_params(layers))
        cfg = jcfg(**layers, fused_ce=fused)
        opt = JaxFusedAdam(lr=LR)

        @jax.jit
        def step(params):
            loss, grads = jax.value_and_grad(jt5.t5_loss)(params, src, dec_in, tgt, cfg)
            return loss, grads, opt.update(grads, opt.init(params), params)[0]

        loss, grads, new = step(params)
        out[str(sorted(layers.items())), fused] = (
            float(loss), jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, new))
    return out


def _close(got, want, name, band, atol=0.0):
    from apex_tpu_torch.optimizers.tree import leaves_with_path

    want = dict(leaves_with_path(want))
    for path, g in leaves_with_path(got):
        w = want[path]
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g.detach().numpy().astype(np.float64) - w).max())
        assert err <= max(band * scale, atol), (name, path, err, scale)


def _unpad(tree, pp, split):
    """The padded tree back in the layout without a pipeline, after
    checking that its zero chunks are exactly zero."""
    enc, dec = tree["enc_layers"], tree["dec_layers"]
    for side, real in ((enc, range(split)), (dec, range(split, pp))):
        for k, a in side.items():
            lpc = a.shape[0] // pp
            for s in set(range(pp)) - set(real):
                assert torch.count_nonzero(a[s * lpc:(s + 1) * lpc]) == 0, (k, s)
    enc, dec = tsched.unpad_stage_layout_encdec(enc, dec, pp, split)
    return {**tree, "enc_layers": enc, "dec_layers": dec}


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_matches_jax_single_device(world4, jax_reference, name):
    """Every rank of each layout: the loss, the grads the optimizer took
    (summed over the stages for the shared leaves, gathered whole) and
    the new params against JAX's single-device step."""
    tp, pp, split, M, fused, layers = CASES[name]
    loss, grads, params = jax_reference[str(sorted(layers.items())), fused]
    for res in world4:
        got_loss, got_grads, got_params = res[name]
        if pp > 1:
            got_grads, got_params = (_unpad(t, pp, split) for t in (got_grads, got_params))
        assert abs(got_loss - loss) <= BAND * abs(loss), (name, got_loss, loss)
        _close(got_grads, grads, name, GRAD_BAND)
        _close(got_params, params, name, GRAD_BAND, PARAM_ATOL)


def test_loss_scaled_pipeline_matches_jax_oracle(world4):
    """``test_fp16_loss_scaling_matches_oracle`` with a skipped first step:
    the JAX single-device scaled step and the port's pp 4 split 2 step,
    each with the first step's grads made non-finite (the port's on the
    first stage alone), take the same scaler decisions over 6 steps:
    the first step skipped on every stage (params and optimizer state
    bitwise unchanged, the Adam counter held), the same loss scales and
    Adam counters after each step, the losses within 1e-4 (the scaled
    loss of the first steps overflows at 2**127 on both sides), and the
    params after 6 steps within the params band."""
    from apex_tpu.amp import DynamicLossScaler

    scaler = DynamicLossScaler(**SCALER)
    params = jt5.init_params(jcfg(), jax.random.PRNGKey(7))
    opt = JaxFusedAdam(lr=LR)
    src, dec_in, tgt = data()

    @jax.jit
    def oracle_step(p, s, ss, poison):
        def f(p):
            return jt5.t5_loss(p, src, dec_in, tgt, jcfg()) * ss.loss_scale

        sloss, grads = jax.value_and_grad(f)(p)
        fc1 = grads["enc_layers"]["fc1"] * jnp.where(poison, jnp.inf, 1.0)
        grads = {**grads, "enc_layers": {**grads["enc_layers"], "fc1": fc1}}
        grads, finite = scaler.unscale(ss, grads)
        p, s = opt.update(grads, s, p, grads_finite=finite)
        return p, s, scaler.update(ss, finite), sloss / ss.loss_scale

    p, s, ss = params, opt.init(params), scaler.init()
    want = []
    for i in range(FP16_STEPS):
        p, s, ss, loss = oracle_step(p, s, ss, i == 0)
        want.append((float(loss), float(ss.loss_scale), int(s.step)))
    assert want[0][2] == 0 and want[0][1] < SCALER["init_scale"]
    for res in world4:
        got, unchanged, new = res["fp16"]
        assert unchanged, got
        assert [g[1:] for g in got] == [w[1:] for w in want], (got, want)
        np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want], rtol=FP16_BAND)
        assert got[-1][0] < min(g[0] for g in got[:-1])
        _close(_unpad(new, 4, 2), jax.tree.map(np.asarray, p), "fp16", GRAD_BAND, PARAM_ATOL)


def test_split_from_parallel_state(world4):
    """The split registered in ``parallel_state`` (pp 4, split 2): the
    predicates by stage, the encoder's and decoder's
    relative-position-embedding groups (an all-reduce over the decoder's
    sums its ranks), the step built without ``split=``; the setter
    rebuilds the groups; with no split the step raises the JAX ValueError
    and both groups are stage 0 alone."""
    for rank, res in enumerate(world4):
        f = res["facts"]
        assert f["before"] == [True, True, False, False]
        assert f["after"] == [False, False, True, True]
        assert f["at"] == [False, True, False, False]
        assert f["enc_member"] == [True, True, False, False]
        assert f["dec_member"] == [False, False, True, True]
        assert f["enc_group"] == ((0, 1) if rank < 2 else ())
        assert f["dec_group"] == ((2, 3) if rank >= 2 else ())
        assert f["embedding"] == ((0, 2, 3) if rank in (0, 2, 3) else ())
        assert f["no_stage"] == "pass the static pipeline stage index"
        assert f["dec_sum"] == (5.0 if rank >= 2 else float(rank))
        assert np.isfinite(f["loss"])
        assert f["set_split"] == (((0,) if rank == 0 else ()),
                                  ((1, 2, 3) if rank else ()), True,
                                  ((0, 1, 3) if rank != 2 else ()))
        assert f["missing"].startswith("pass split= or initialize_model_parallel")
        assert f["no_split_groups"] == (((0,) if rank == 0 else ()), True, False)


def test_pretrain_t5_world1_loss_falls(capsys):
    """``python -m apex_tpu_torch.pretrain_t5 --device cpu`` at world 1 (a
    short sequence): 6 steps, the JAX driver's lines, the loss falling;
    ``--fp16`` without ``--pp`` refuses with the JAX driver's assertion."""
    from apex_tpu_torch import pretrain_t5

    report = pretrain_t5.main(["--device", "cpu", "--steps", "6", "--seq", "16"])
    out = capsys.readouterr().out
    assert "step 5: loss=" in out and "6 steps in" in out and "tokens/s)" in out
    losses = report["losses"]
    assert len(losses) == 6 and all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    with pytest.raises(AssertionError, match="--fp16 demo path requires --pp > 1"):
        pretrain_t5.main(["--device", "cpu", "--steps", "1", "--seq", "16", "--fp16"])
