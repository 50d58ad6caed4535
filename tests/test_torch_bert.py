"""The port's BERT (``apex_tpu_torch.models.bert``) against the JAX
package's on the CPU.

The JAX package's ``CFG`` of ``tests/test_bert.py`` (vocab 64, hidden
32, 2 layers, 4 heads, S 16, fp32), 2 x 16 tokens with a padded row,
params from ``apex_tpu.models.bert.init_params`` loaded through
``params_from_numpy``:

- ``bert_forward`` (with and without ``token_types``) and
  ``bert_mlm_loss`` with every gradient, dense head, within 1e-5 (grads
  of each leaf's largest entry); the fused head (the CE kernels' plain
  versions) against the JAX fused head at ``tests/test_fused_ce.py``'s
  bands (loss 1e-6, grads rtol 1e-5 / atol 1e-6);
- ``test_padding_mask_blocks_attention``'s check;
- ``checkpoint_layers`` under ``"full"`` and ``"dots"`` equal to no remat;
- tp 2 on a gloo world of 2 (``parallel.multiproc.launch``): the
  gathered logits against the JAX single device at
  ``test_tp_matches_single_device``'s 2e-4, with the loss and grads;
- ``make_train_step`` with FusedLAMB: one step against the JAX FusedLAMB
  step from the same params (1e-5), and 12 steps that lower the loss;
- the config's refusals.
"""

import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.models import bert as jbert
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB

from apex_tpu_torch.models import bert as tbert
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.optimizers.tree import tree_leaves
from apex_tpu_torch.parallel import multiproc

REPO = Path(__file__).resolve().parent.parent
SIZES = dict(vocab_size=64, hidden_size=32, num_layers=2, num_attention_heads=4,
             max_seq_len=16, checkpoint_layers=False)
JCFG = jbert.BertConfig(**SIZES, compute_dtype=jnp.float32)
TCFG = tbert.BertConfig(**SIZES, compute_dtype=torch.float32)
#: dense head: loss relative, grads of each leaf's largest entry
BAND = 1e-5
#: tests/test_fused_ce.py's bands (loss rtol; grads rtol, atol)
FUSED_LOSS = 1e-6
FUSED_GRADS = (1e-5, 1e-6)
#: test_tp_matches_single_device's band
TP_TOL = 2e-4
LR = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: a CPU shared by parallel test workers slows
    many-thread kernels by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jbert.init_params(JCFG, jax.random.PRNGKey(0)))


def _batch():
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, SIZES["vocab_size"], size=(2, 16))
    pad = np.array([[True] * 16, [True] * 12 + [False] * 4])
    rng = np.random.RandomState(1)
    loss_mask = (rng.rand(2, 16) < 0.3).astype(np.float32)
    targets = rng.randint(0, SIZES["vocab_size"], size=(2, 16))
    types = np.array([[0] * 8 + [1] * 8, [0] * 6 + [1] * 10])
    return tokens, pad, loss_mask, targets, types


def _params(jparams, cfg=TCFG):
    p = tbert.params_from_numpy(jparams, cfg, "cpu")
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    return p


def _port_loss_grads(p, cfg):
    tokens, pad, loss_mask, targets, _ = _batch()
    loss = tbert.bert_mlm_loss(p, tokens, targets, loss_mask, cfg, pad_mask=torch.from_numpy(pad))
    grads = torch.autograd.grad(loss, tree_leaves(p), materialize_grads=True)
    return float(loss.detach()), [g.numpy() for g in grads]


_JAX_VG = jax.jit(jax.value_and_grad(jbert.bert_mlm_loss), static_argnums=4)
_JAX_CACHE = {}


def _jax_loss_grads(jparams, cfg):
    """The JAX loss and grads (jitted, once a config)."""
    if cfg not in _JAX_CACHE:
        tokens, pad, loss_mask, targets, _ = _batch()
        loss, g = _JAX_VG(jparams, jnp.asarray(tokens), jnp.asarray(targets),
                          jnp.asarray(loss_mask), cfg, None, jnp.asarray(pad))
        _JAX_CACHE[cfg] = float(loss), [np.asarray(a) for a in jax.tree.leaves(g)]
    return _JAX_CACHE[cfg]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-6)


@pytest.mark.parametrize("types", [False, True], ids=["no_types", "token_types"])
def test_forward_matches_jax(jparams, types):
    tokens, pad, _, _, tt = _batch()
    ref = jbert.bert_forward(jparams, jnp.asarray(tokens),
                             token_types=jnp.asarray(tt) if types else None,
                             pad_mask=jnp.asarray(pad), config=JCFG)
    got = tbert.bert_forward(tbert.params_from_numpy(jparams, TCFG, "cpu"), tokens,
                             token_types=torch.from_numpy(tt) if types else None,
                             pad_mask=torch.from_numpy(pad), config=TCFG)
    assert got.shape == (16, 2, SIZES["vocab_size"]) and got.dtype == torch.float32
    assert _rel(got.detach(), ref) < BAND


def test_return_hidden_matches_jax(jparams):
    tokens, pad, _, _, _ = _batch()
    ref = jbert.bert_forward(jparams, jnp.asarray(tokens), pad_mask=jnp.asarray(pad),
                             config=JCFG, return_hidden=True)
    got = tbert.bert_forward(tbert.params_from_numpy(jparams, TCFG, "cpu"), tokens,
                             pad_mask=torch.from_numpy(pad), config=TCFG, return_hidden=True)
    assert got.shape == (16, 2, SIZES["hidden_size"])
    assert _rel(got.detach(), ref) < BAND


def test_mlm_loss_and_grads_match_jax_dense(jparams):
    want_loss, want = _jax_loss_grads(jparams, JCFG)
    got_loss, got = _port_loss_grads(_params(jparams), TCFG)
    assert abs(got_loss - want_loss) <= BAND * abs(want_loss)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _rel(a, b) < BAND


def test_mlm_loss_and_grads_match_jax_fused(jparams):
    jcfg = dataclasses.replace(JCFG, fused_ce=True, fused_ce_chunk=8)
    tcfg = dataclasses.replace(TCFG, fused_ce=True, fused_ce_chunk=8)
    want_loss, want = _jax_loss_grads(jparams, jcfg)
    got_loss, got = _port_loss_grads(_params(jparams, tcfg), tcfg)
    np.testing.assert_allclose(got_loss, want_loss, rtol=FUSED_LOSS)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=FUSED_GRADS[0], atol=FUSED_GRADS[1])


def test_padding_mask_blocks_attention(jparams):
    """A padded position's token changes nothing at the valid ones."""
    tokens, pad, _, _, _ = _batch()
    p = tbert.params_from_numpy(jparams, TCFG, "cpu")
    base = tbert.bert_forward(p, tokens, pad_mask=torch.from_numpy(pad), config=TCFG)
    tokens2 = tokens.copy()
    tokens2[1, 14] = (tokens[1, 14] + 5) % SIZES["vocab_size"]
    out2 = tbert.bert_forward(p, tokens2, pad_mask=torch.from_numpy(pad), config=TCFG)
    np.testing.assert_allclose(base[:12, 1].detach().numpy(), out2[:12, 1].detach().numpy(),
                               rtol=1e-4, atol=1e-5)
    assert not torch.equal(base[12:, 1], out2[12:, 1])


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_checkpoint_layers_equal_no_remat(jparams, policy):
    want_loss, want = _port_loss_grads(_params(jparams), TCFG)
    cfg = dataclasses.replace(TCFG, checkpoint_layers=True, remat_policy=policy)
    got_loss, got = _port_loss_grads(_params(jparams, cfg), cfg)
    assert got_loss == want_loss
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


def test_config_refusals():
    with pytest.raises(ValueError, match="remat_policy"):
        tbert.BertConfig(remat_policy="everything")
    with pytest.raises(ValueError, match="impl"):
        tbert.BertConfig(fused_ce_impl="off")
    if not torch.cuda.is_available():  # the entry point defaults to the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbert.init_params(TCFG)


def test_init_params_tree_matches_jax(jparams):
    p = tbert.init_params(TCFG, torch.Generator().manual_seed(3), device="cpu")
    assert [tuple(v.shape) for v in tree_leaves(p)] == [a.shape for a in
                                                         jax.tree.leaves(jparams)]
    assert float(p["layers"]["ln1_scale"].min()) == 1.0
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3


@pytest.fixture(scope="module")
def jax_lamb_step(jparams):
    """The JAX FusedLAMB step's new params from the JAX grads."""
    opt = JaxFusedLAMB(lr=LR, weight_decay=0.01)
    grads = jax.tree.unflatten(jax.tree.structure(jparams), _jax_loss_grads(jparams, JCFG)[1])
    new, _ = jax.jit(opt.update)(grads, opt.init(jparams), jparams)
    return [np.asarray(a) for a in jax.tree.leaves(new)]


@pytest.mark.parametrize("use_buckets", [True, False], ids=["engine", "per_leaf"])
def test_lamb_step_matches_jax_and_trains(jparams, jax_lamb_step, use_buckets):
    tokens, pad, loss_mask, targets, _ = _batch()
    want = jax_lamb_step
    p = _params(jparams)
    opt = FusedLAMB(lr=LR, weight_decay=0.01, use_buckets=use_buckets)
    state = opt.init(p)
    step = tbert.make_train_step(opt, TCFG, graphs=False)
    batch = [torch.from_numpy(a) for a in (tokens, targets, loss_mask, pad)]
    losses = [float(step(p, state, *batch))]
    for a, b in zip(tree_leaves(p), want):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=BAND, atol=BAND * LR)
    for _ in range(11):
        losses.append(float(step(p, state, *batch)))
    assert losses[-1] < losses[0]
    assert int(state.step) == 12


CHILD = r'''
import sys, pickle
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from apex_tpu_torch.parallel import initialize_distributed, destroy_distributed
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel.mappings import all_gather_dim
from apex_tpu_torch.models import bert
from apex_tpu_torch.optimizers.tree import tree_leaves, tree_unflatten
params_np, SIZES, tokens, pad, loss_mask, targets, types = pickle.load(open(sys.argv[3], "rb"))
initialize_distributed("cpu")
ps.initialize_model_parallel(tensor_model_parallel_size_=2)
g = ps.get_tensor_model_parallel_group()
out = {}
for fused in (False, True):
    cfg = bert.BertConfig(**SIZES, compute_dtype=torch.float32, fused_ce=fused,
                          fused_ce_chunk=8)
    p = bert.shard_params(params_np, cfg, g, "cpu")
    if not fused:
        logits = bert.bert_forward(p, tokens, token_types=types, pad_mask=pad, config=cfg,
                                   axis_name=g)
        out["logits"] = all_gather_dim(logits.detach(), g, 2)
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    loss = bert.bert_mlm_loss(p, tokens, targets, loss_mask, cfg, axis_name=g, pad_mask=pad)
    grads = torch.autograd.grad(loss, tree_leaves(p), materialize_grads=True)
    whole = bert.gather_params(tree_unflatten(p, list(grads)), cfg, g)
    out["fused" if fused else "dense"] = (float(loss), [t.clone() for t in tree_leaves(whole)])
torch.save(out, sys.argv[2] + f"/rank{dist.get_rank()}.pt")
destroy_distributed()
'''


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jparams):
    d = tmp_path_factory.mktemp("bert_tp")
    tokens, pad, loss_mask, targets, types = _batch()
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((jparams, SIZES, torch.from_numpy(tokens), torch.from_numpy(pad),
                     torch.from_numpy(loss_mask), torch.from_numpy(targets),
                     torch.from_numpy(types)), f)
    multiproc.launch(["-c", CHILD, str(REPO), str(d), str(d / "in.pkl")], 2, timeout=300)
    return [torch.load(d / f"rank{r}.pt") for r in range(2)]


def test_tp2_forward_matches_jax_single_device(world2, jparams):
    tokens, pad, _, _, types = _batch()
    ref = np.asarray(jbert.bert_forward(jparams, jnp.asarray(tokens),
                                        token_types=jnp.asarray(types),
                                        pad_mask=jnp.asarray(pad), config=JCFG))
    for rank in world2:
        np.testing.assert_allclose(rank["logits"].numpy(), ref, rtol=TP_TOL, atol=TP_TOL)


@pytest.mark.parametrize("head", ["dense", "fused"])
def test_tp2_loss_and_grads_match_jax_single_device(world2, jparams, head):
    cfg = dataclasses.replace(JCFG, fused_ce=head == "fused", fused_ce_chunk=8)
    want_loss, want = _jax_loss_grads(jparams, cfg)
    for rank in world2:
        loss, grads = rank[head]
        np.testing.assert_allclose(loss, want_loss, rtol=TP_TOL)
        for a, b in zip(grads, want):
            np.testing.assert_allclose(a.numpy(), b, rtol=TP_TOL, atol=TP_TOL)


def test_shard_tree_is_shard_map_block(jparams):
    """Each rank's slice is the block ``shard_map`` gives the device at
    that tp index under the JAX ``param_specs``."""
    specs = jbert.param_specs(JCFG)
    flat_specs = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(
        s, jax.sharding.PartitionSpec))
    for rank in range(2):
        got = tree_leaves(tbert.shard_tree(jparams, TCFG, rank, 2))
        for a, full, spec in zip(got, jax.tree.leaves(jparams), flat_specs):
            dims = [i for i, ax in enumerate(spec) if ax == "tp"]
            if not dims:
                np.testing.assert_array_equal(a, full)
                continue
            n = full.shape[dims[0]] // 2
            np.testing.assert_array_equal(
                a, np.take(full, np.arange(rank * n, (rank + 1) * n), axis=dims[0]))
    with pytest.raises(ValueError, match="divisible"):
        tbert.shard_tree(jparams, TCFG, 0, 3)
