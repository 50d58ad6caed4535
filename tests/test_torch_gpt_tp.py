"""The port's GPT under tensor and sequence parallelism
(``apex_tpu_torch.models.gpt`` with ``axis_name``, ``shard_params``,
``sp_grad_sync``, ``clip_sumsq_reduce``; ``train_gpt.make_train_step``
with ``tp_group``) against the JAX package's ``gpt_loss`` under
``shard_map`` on a tp mesh and its ``make_train_step`` on a dp x tp
mesh, from the same numpy params (the JAX tree, sliced by
``shard_params`` as ``shard_map`` slices it).

Mirrors ``tests/test_gpt.py:103-180,240-300,392-410``: the logits, loss
and every gradient at tp 4 with both heads (the fused head through the
CE kernels' plain versions), with and without sequence parallelism,
against the JAX tp run and the single-device model; GQA at tp 2; tp
above the kv heads refused; dp 2 x tp 2 train steps (FusedAdam, with a
clip over the split and replicated leaves) against the JAX step.  The
port runs one world of 4 ranks under gloo (``parallel.multiproc
.launch``).  Bands: fp32 throughout; the loss within 1e-5 relative
(``tests/test_torch_pretrain.py`` ``BAND``), the grads within 2e-5 of
the largest gradient entry of the leaf (sums over other orders and
other row splits), the train losses within 1e-5 relative.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.models import gpt as jgpt
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam

from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.parallel import multiproc

REPO = Path(__file__).resolve().parent.parent
#: the fp32 loss band of tests/test_torch_pretrain.py
BAND = 1e-5
#: grads: of the leaf's largest entry
GRAD_BAND = 2e-5
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_attention_heads=4, max_seq_len=16,
           checkpoint_layers=True, use_flash_attention=True, fused_ce_chunk=8)
#: the model cases at tp 4: name -> (fused head, sequence parallel)
TP4_CASES = {"dense": (False, False), "dense_sp": (False, True), "fused": (True, False),
             "fused_sp": (True, True)}
#: the train-step cases at dp 2 x tp 2: name -> (fused head, sp, clip)
STEP_CASES = {"dense_sp_clip": (False, True, 1.0), "fused": (True, False, None)}
STEPS = 4
LR = 1e-2


def jax_params(cfg):
    """The JAX package's init at PRNGKey(0), as numpy."""
    return jax.tree.map(np.asarray, jgpt.init_params(cfg, jax.random.PRNGKey(0)))


def batch(seed=0, b=4, s=16, v=64):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, v, size=(b, s + 1))
    return tok[:, :-1], tok[:, 1:]


CHILD = r'''
import sys, dataclasses, pickle
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from apex_tpu_torch.parallel import initialize_distributed, destroy_distributed
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.models import gpt
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers.tree import tree_leaves, tree_unflatten
from apex_tpu_torch.train_gpt import make_train_step
params_np, gqa_np, cases, step_cases, CFG, STEPS, LR, batches = pickle.load(open(sys.argv[3], "rb"))
initialize_distributed("cpu")
out = {}

def loss_grads(tree, cfg, g, tok, tgt):
    p = gpt.shard_params(tree, cfg, g, "cpu", keep_fp32=True)
    leaves = tree_leaves(p)
    for l in leaves: l.requires_grad_(True)
    loss = gpt.gpt_loss(p, torch.from_numpy(tok), torch.from_numpy(tgt), cfg, axis_name=g)
    grads = tree_unflatten(p, list(torch.autograd.grad(loss, leaves)))
    if cfg.sequence_parallel:
        grads = gpt.sp_grad_sync(grads, g)
    return float(loss), gpt.gather_params(grads, cfg, g)

tok, tgt = batches[0]
ps.initialize_model_parallel(tensor_model_parallel_size_=4)
g = ps.get_tensor_model_parallel_group()
for name, (fused, sp) in cases.items():
    cfg = gpt.GPTConfig(**CFG, compute_dtype=torch.float32, fused_ce=fused, sequence_parallel=sp)
    out[name] = loss_grads(params_np, cfg, g, tok, tgt)
cfg = gpt.GPTConfig(**CFG, compute_dtype=torch.float32)
with torch.no_grad():
    out["logits"] = gpt.gpt_forward(gpt.shard_params(params_np, cfg, g, "cpu", keep_fp32=True),
                                    torch.from_numpy(tok), cfg, axis_name=g)
gqa = gpt.GPTConfig(**CFG, compute_dtype=torch.float32, num_query_groups=2)
try:
    gpt.shard_params(gqa_np, gqa, g, "cpu")
    out["gqa_tp4"] = None
except ValueError as e:
    out["gqa_tp4"] = str(e)
ps.destroy_model_parallel()

# dp 2 x tp 2
ps.initialize_model_parallel(tensor_model_parallel_size_=2)
g, dp = ps.get_tensor_model_parallel_group(), ps.get_data_parallel_group()
out["gqa"] = loss_grads(gqa_np, dataclasses.replace(gqa, sequence_parallel=True), g, tok, tgt)
for name, (fused, sp, clip) in step_cases.items():
    cfg = gpt.GPTConfig(**CFG, compute_dtype=torch.float32, fused_ce=fused, sequence_parallel=sp)
    p = gpt.shard_params(params_np, cfg, g, "cpu", keep_fp32=True)
    opt = FusedAdam(lr=LR)
    st = opt.init(p)
    for l in tree_leaves(p): l.requires_grad_(True)
    step = make_train_step(opt, cfg, clip_grad_norm=clip, dp_group=dp, tp_group=g, graphs=False)
    rows = slice(2 * dp.rank(), 2 * dp.rank() + 2)
    losses = [float(step(p, st, torch.from_numpy(a[rows]), torch.from_numpy(b[rows])))
              for a, b in batches[:STEPS]]
    out["step_" + name] = (losses, gpt.gather_params(p, cfg, g))
torch.save(out, sys.argv[2] + f"/rank{dist.get_rank()}.pt")
destroy_distributed()
'''


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    import pickle

    d = tmp_path_factory.mktemp("gpt_tp")
    jcfg = jgpt.GPTConfig(**CFG, compute_dtype=jnp.float32)
    payload = (jax_params(jcfg), jax_params(dataclasses.replace(jcfg, num_query_groups=2)),
               TP4_CASES, STEP_CASES, CFG, STEPS, LR, [batch(i) for i in range(STEPS)])
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(payload, f)
    multiproc.launch(["-c", CHILD, str(REPO), str(d), str(d / "in.pkl")], 4, timeout=400)
    return [torch.load(d / f"rank{r}.pt") for r in range(4)]


def jax_loss_grads(jcfg, devices, tp, params):
    """value_and_grad(gpt_loss) under shard_map on a ``tp`` mesh, with
    the SP grad sync when the config asks for it."""
    mesh = Mesh(np.array(devices[:tp]), ("tp",))
    specs = jgpt.param_specs(jcfg)
    tok, tgt = batch()

    def f(p, t, y):
        loss, grads = jax.value_and_grad(
            lambda p: jgpt.gpt_loss(p, t, y, jcfg, axis_name="tp"))(p)
        if jcfg.sequence_parallel:
            grads = jgpt.sp_grad_sync(grads, "tp")
        return loss, grads

    loss, grads = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(specs, P(), P()),
                                        out_specs=(P(), specs), check_vma=False))(
        params, tok, tgt)
    return float(loss), jax.tree.map(np.asarray, grads)


def _grads_close(got, want, name, atol=0.0):
    from apex_tpu_torch.optimizers.tree import leaves_with_path

    want = dict(leaves_with_path(want))
    for path, g in leaves_with_path(got):
        w = want[path]
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g.detach().numpy().astype(np.float64) - w).max())
        assert err <= max(GRAD_BAND * scale, atol), (name, path, err, scale)


@pytest.mark.parametrize("name", sorted(TP4_CASES))
def test_tp4_loss_and_grads_match_jax(world4, devices8, name):
    """tp 4, each head, with and without SP: every rank's loss against the
    JAX tp run (and the single-device model), the grads (SP-synced,
    gathered whole) against JAX's on every rank."""
    fused, sp = TP4_CASES[name]
    jcfg = jgpt.GPTConfig(**CFG, compute_dtype=jnp.float32, fused_ce=fused,
                          sequence_parallel=sp)
    params = jax_params(jcfg)
    loss, grads = jax_loss_grads(jcfg, devices8, 4, params)
    tok, tgt = batch()
    single = float(jgpt.gpt_loss(params, tok, tgt, dataclasses.replace(jcfg,
                                                                        sequence_parallel=False)))
    for res in world4:
        got_loss, got_grads = res[name]
        assert abs(got_loss - loss) <= BAND * abs(loss), (name, got_loss, loss)
        assert abs(got_loss - single) <= BAND * abs(single), (name, got_loss, single)
        _grads_close(got_grads, grads, name)


def test_tp4_logits_are_vocab_local(world4, devices8):
    jcfg = jgpt.GPTConfig(**CFG, compute_dtype=jnp.float32)
    params = jax_params(jcfg)
    tok, _ = batch()
    full = np.asarray(jgpt.gpt_forward(params, tok, jcfg))
    for r, res in enumerate(world4):
        got = res["logits"].numpy()
        assert got.shape == (16, 4, 16)
        np.testing.assert_allclose(got, full[..., 16 * r:16 * (r + 1)], rtol=2e-4, atol=2e-4)


def test_gqa_under_tp2_matches_jax(world4, devices8):
    """GQA (2 kv heads) at tp 2 with sequence parallelism, on both dp
    replicas of the world."""
    jcfg = jgpt.GPTConfig(**CFG, compute_dtype=jnp.float32, num_query_groups=2,
                          sequence_parallel=True)
    loss, grads = jax_loss_grads(jcfg, devices8, 2, jax_params(jcfg))
    for res in world4:
        got_loss, got_grads = res["gqa"]
        assert abs(got_loss - loss) <= BAND * abs(loss)
        _grads_close(got_grads, grads, "gqa")


def test_tp_larger_than_kv_heads_is_refused(world4):
    """tp 4 over 2 kv heads raises, as tests/test_gpt.py:293 has the JAX
    package raise."""
    for res in world4:
        assert "num_query_groups (2) must be divisible by the tensor-parallel size (4)" in \
            res["gqa_tp4"]
    cfg = tgpt.GPTConfig(**CFG, num_query_groups=2)
    with pytest.raises(ValueError, match="kv heads shard over tp"):
        tgpt.check_tp(cfg, 4)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_dp2_tp2_train_steps_match_jax(world4, devices8, name):
    """make_train_step at dp 2 x tp 2 (the 4 ranks in the JAX mesh's
    layout) against JAX make_train_step on a (2, 2) mesh: FusedAdam,
    4 steps, the losses within 1e-5 relative on every rank and the final
    params within 2e-5 of each leaf's scale or 5e-4; the dense head with SP and
    a clip (its Σx² over split and replicated leaves), the fused head
    without."""
    fused, sp, clip = STEP_CASES[name]
    jcfg = jgpt.GPTConfig(**CFG, compute_dtype=jnp.float32, fused_ce=fused,
                          sequence_parallel=sp)
    params = jax.tree.map(jnp.asarray, jax_params(jcfg))
    opt = JaxFusedAdam(lr=LR)
    state = opt.init(params)
    mesh = Mesh(np.array(devices8[:4]).reshape(2, 2), ("dp", "tp"))
    step = jgpt.make_train_step(jcfg, opt, mesh, clip_grad_norm=clip)
    losses = []
    for i in range(STEPS):
        tok, tgt = batch(i)
        params, state, loss = step(params, state, jnp.asarray(tok), jnp.asarray(tgt))
        losses.append(float(loss))
    for res in world4:
        got, got_params = res["step_" + name]
        for a, b in zip(got, losses, strict=True):
            assert abs(a - b) <= BAND * abs(b), (name, got, losses)
        # the reference's own dp 2 x tp 2 Adam test holds params to 5e-4
        # (tests/test_gpt.py test_dp2_tp2_adam): bk's gradient is rounding
        # noise (0 in exact arithmetic), which Adam's update scales up
        _grads_close(got_params, jax.tree.map(np.asarray, params), name, atol=5e-4)
