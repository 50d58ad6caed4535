"""The port's GPT training step against the JAX package, on the CPU.

A small GPT (2 layers, hidden 64, 4 heads, vocab 128, seq 32, batch 2,
fp32) with the JAX package's params carried over by
``params_from_numpy(keep_fp32=True)``:

- the loss and every gradient leaf of ``gpt_loss`` against
  ``jax.value_and_grad(apex_tpu.models.gpt.gpt_loss)``, with flash
  attention on and off, learned and rope positions, and GQA;
- layer remat on and off give the same gradients;
- a 3-step loss trajectory of ``train_gpt`` (``--device cpu``) against
  bench.py's JAX loop (``value_and_grad(gpt_loss)`` + ``FusedAdam``),
  with the dense head and with the fused LM-head CE (``--fused-ce``);
- with ``fused_ce=True`` the loss and every gradient leaf again, for S
  divisible by ``fused_ce_chunk`` (the fused head, the chunked scan on
  the JAX side) and not (the dense head on both sides);
- the options the port does not run raise, and ``remat_policy="dots"``
  runs (its step bitwise full remat's).

Bands: the loss within 1e-6 relative; each gradient leaf within 1e-5 of
the largest gradient magnitude of the model (fp32 on both sides, sums
in other orders; leaves whose gradient is 0 in exact arithmetic, like
the key bias, hold only rounding noise, so a per-leaf relative measure
would compare noise with noise); losses over 3 Adam steps within 1e-5
relative.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.models import gpt as jgpt
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam

from apex_tpu_torch import train_gpt
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.optimizers.base import tree_leaves

SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_attention_heads=4,
             max_seq_len=32)
B, S = 2, 32


def _configs(**kw):
    base = {**SMALL, **kw}
    return (jgpt.GPTConfig(**base, compute_dtype=jnp.float32),
            tgpt.GPTConfig(**base, compute_dtype=torch.float32))


def _batch(seed=1):
    tokens = np.random.RandomState(seed).randint(0, SMALL["vocab_size"], size=(B, S))
    return tokens, np.roll(tokens, -1, axis=1)


def _assert_grads_close(got_tree, want_tree):
    got = [g.detach().numpy() for g in tree_leaves(got_tree)]
    want = [np.asarray(w) for w in jax.tree.leaves(want_tree)]
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("flash,pet,gqa", [
    (True, "learned", None), (False, "learned", None), (True, "rope", None),
    (False, "rope", None), (True, "rope", 2), (False, "learned", 2)])
def test_loss_and_grads_match_jax(flash, pet, gqa):
    jcfg, tcfg = _configs(use_flash_attention=flash, position_embedding_type=pet,
                          num_query_groups=gqa)
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tgpt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                                keep_fp32=True)
    assert all(t.dtype == torch.float32 for t in tree_leaves(tp))
    tokens, targets = _batch()
    jloss, jgrads = jax.value_and_grad(jgpt.gpt_loss)(jp, jnp.asarray(tokens),
                                                      jnp.asarray(targets), jcfg)
    tloss, tgrads = train_gpt.loss_and_grads(tp, torch.from_numpy(tokens),
                                             torch.from_numpy(targets), tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    _assert_grads_close(tgrads, jgrads)


def test_remat_on_and_off_give_the_same_grads():
    _, on = _configs(use_flash_attention=True, checkpoint_layers=True)
    _, off = _configs(use_flash_attention=True, checkpoint_layers=False)
    tokens, targets = _batch(2)
    t, y = torch.from_numpy(tokens), torch.from_numpy(targets)
    grads = []
    for cfg in (on, off):
        params = tgpt.init_params(cfg, seed=3, device="cpu", keep_fp32=True)
        grads.append(train_gpt.loss_and_grads(params, t, y, cfg))
    assert torch.equal(grads[0][0], grads[1][0])
    for a, b in zip(tree_leaves(grads[0][1]), tree_leaves(grads[1][1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [False, True])
def test_three_step_trajectory_matches_bench_loop(capsys, fused):
    argv = ["--device", "cpu", "--layers", "2", "--hidden", "64", "--heads", "4",
            "--vocab", "128", "--seq", "32", "--batch", "2", "--steps", "3",
            "--warmup", "0", "--compute-dtype", "float32"]
    if fused:
        argv += ["--fused-ce", "--fused-ce-chunk", "8"]
    args = train_gpt.build_args().parse_args(argv)
    tree = tgpt._init_numpy(train_gpt.make_config(args), args.seed)
    report, _, _ = train_gpt.run(args, params_tree=tree)

    # bench.py:401-436, the step the JAX package times, at this shape (on
    # the CPU its fused head is the fp32 chunked scan)
    cfg = jgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                         num_attention_heads=4, max_seq_len=32, compute_dtype=jnp.float32,
                         use_flash_attention=True, checkpoint_layers=True,
                         fused_ce=fused, fused_ce_chunk=8)
    opt = JaxFusedAdam(lr=3e-4, weight_decay=0.1)
    params = jax.tree.map(jnp.asarray, tree)
    state = opt.init(params)
    tokens, targets = (jnp.asarray(a) for a in train_gpt.make_batch(args))

    @jax.jit
    def step(params, state):
        loss, grads = jax.value_and_grad(jgpt.gpt_loss)(params, tokens, targets, cfg)
        params, state = opt.update(grads, state, params)
        return params, state, loss

    losses = []
    for _ in range(3):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    np.testing.assert_allclose(report["losses"], losses, rtol=1e-5)
    assert report["losses"][-1] < report["losses"][0]

    assert train_gpt.main(argv) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["device"] == "cpu" and len(printed["losses"]) == 3
    assert printed["peak_memory_gb"] is None
    assert printed["model"]["fused_ce"] is fused


@pytest.mark.parametrize("pet,seq,chunk", [("learned", 32, 8), ("rope", 32, 16),
                                            ("learned", 24, 16), ("rope", 20, 8)])
def test_fused_ce_loss_and_grads_match_jax(pet, seq, chunk):
    """fused_ce=True: S % fused_ce_chunk == 0 takes the fused head (the
    plain CE kernels here, the chunked scan in JAX on the CPU); otherwise
    both packages take the dense head."""
    jcfg, tcfg = _configs(use_flash_attention=True, position_embedding_type=pet,
                          fused_ce=True, fused_ce_chunk=chunk)
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(1))
    tp = tgpt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                                keep_fp32=True)
    tokens, targets = _batch(4)
    tokens, targets = tokens[:, :seq], targets[:, :seq]
    jloss, jgrads = jax.value_and_grad(jgpt.gpt_loss)(jp, jnp.asarray(tokens),
                                                      jnp.asarray(targets), jcfg)
    from apex_tpu_torch.ops import fused_ce

    calls = []
    orig = fused_ce.fused_lm_head_ce

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    tgpt.fused_lm_head_ce = spy
    try:
        tloss, tgrads = train_gpt.loss_and_grads(tp, torch.from_numpy(tokens),
                                                 torch.from_numpy(targets), tcfg)
    finally:
        tgpt.fused_lm_head_ce = orig
    assert len(calls) == (seq % chunk == 0)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    _assert_grads_close(tgrads, jgrads)


def test_unported_options_raise():
    for impl in ("interpret", "off"):
        with pytest.raises(ValueError, match=impl):
            _configs(fused_ce=True, fused_ce_impl=impl)
    with pytest.raises(ValueError, match="remat_policy"):
        tgpt.GPTConfig(remat_policy="none")
    # "dots" is ported: the step's loss and gradients equal full remat's
    tokens, targets = _batch()
    out = {}
    for policy in ("full", "dots"):
        jcfg, tcfg = _configs(checkpoint_layers=True, remat_policy=policy,
                              use_flash_attention=True)
        tp = tgpt.init_params(tcfg, 0, "cpu", keep_fp32=True)
        out[policy] = train_gpt.loss_and_grads(tp, torch.from_numpy(tokens),
                                               torch.from_numpy(targets), tcfg)
    assert float(out["dots"][0]) == float(out["full"][0])
    for a, b in zip(tree_leaves(out["dots"][1]), tree_leaves(out["full"][1]), strict=True):
        assert torch.equal(a, b)


def test_train_gpt_defaults_to_cuda_and_raises_without_it():
    args = train_gpt.build_args().parse_args([])
    assert (args.device, args.layers, args.hidden, args.heads, args.vocab, args.seq,
            args.batch, args.lr) == ("cuda", 12, 768, 12, 50304, 1024, 8, 3e-4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_gpt.main(["--layers", "1", "--hidden", "32", "--heads", "4", "--vocab", "64",
                        "--seq", "8", "--batch", "1"])
