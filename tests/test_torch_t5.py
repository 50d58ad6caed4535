"""The port's T5 (``apex_tpu_torch.models.t5``) against the JAX package's
on the CPU.

The JAX package's ``CFG`` of ``tests/test_encdec_pipeline.py`` (vocab 64,
hidden 32, 4 + 4 layers, 4 heads, S_src 16, S_tgt 12), params from
``apex_tpu.models.t5.init_params`` loaded through ``params_from_numpy``,
token ids from ``np.random.RandomState``:

- fp32, at ``tests/test_torch_gpt_pp.py``'s bands: ``t5_forward``'s
  logits and pre-head stream; ``t5_loss`` within 1e-5 relative and every
  grad leaf within 2e-5 of the leaf's largest entry, with remat off,
  ``"full"`` and ``"dots"``, the dense head and the fused one
  (``fused_ce_chunk`` 4: the CE kernels' plain versions against the JAX
  fused head), each against JAX's ``value_and_grad`` with that head;
- bf16 (compute dtype; fp32 params): the loss within :data:`BF16_LOSS`
  relative and the logits within :data:`BF16_LOGITS` of their largest
  entry (both sides round every activation to bf16, in different
  orders of the same sums);
- ``TestT5Oracle.test_loss_finite_and_causal``'s checks on the port;
- five ``make_train_step`` steps (FusedAdam) against JAX's
  ``make_train_step``, losses within 1e-5 relative;
- ``param_specs`` and the shard of each leaf against the JAX specs;
- the refusals: fp16 with the fused head, a bad remat policy, a ZeRO
  optimizer.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.models import t5 as jt5
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam

from apex_tpu_torch.models import t5 as tt5
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers.tree import leaves_with_path, tree_leaves

SIZES = dict(vocab_size=64, hidden_size=32, num_encoder_layers=4, num_decoder_layers=4,
             num_attention_heads=4, max_src_len=16, max_tgt_len=12, fused_ce_chunk=4)
#: the loss relative; the grads of each leaf's largest entry
BAND = 1e-5
GRAD_BAND = 2e-5
#: bf16 compute: the loss relative, the logits of the largest |logit|
BF16_LOSS = 2e-3
BF16_LOGITS = 2.0 ** -6


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


def tcfg(**kw):
    return tt5.T5Config(**{**SIZES, "compute_dtype": torch.float32, "checkpoint_layers": False,
                           **kw})


def data(B=8, seed=0):
    """The JAX test's ``_data``: source, shifted-right decoder input (BOS
    0) and targets."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, SIZES["vocab_size"], size=(B, SIZES["max_src_len"]))
    tgt = rng.randint(0, SIZES["vocab_size"], size=(B, SIZES["max_tgt_len"]))
    dec_in = np.roll(tgt, 1, axis=1)
    dec_in[:, 0] = 0
    return src, dec_in, tgt


def jax_tree(seed=0):
    return jax.tree.map(np.asarray, jt5.init_params(jcfg(), jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def jparams():
    return jax_tree()


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _port(tree, cfg):
    p = tt5.params_from_numpy(tree, cfg, "cpu")
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    return p


def _close(got, want, name, band):
    want = dict(leaves_with_path(want))
    for path, g in leaves_with_path(got):
        w = np.asarray(want[path])
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g.detach().numpy().astype(np.float64) - w).max())
        assert err <= band * scale, (name, path, err, scale)


def test_forward_matches_jax(jparams):
    src, dec_in, _ = data()
    p = tt5.params_from_numpy(jparams, tcfg(), "cpu")
    for hidden in (False, True):
        want = np.asarray(jt5.t5_forward(jparams, src, dec_in, jcfg(), return_hidden=hidden))
        with torch.no_grad():
            got = tt5.t5_forward(p, *_t(src, dec_in), tcfg(), return_hidden=hidden).numpy()
        assert got.shape == want.shape == (12, 8, 32 if hidden else 64)
        assert np.abs(got - want).max() <= BAND * np.abs(want).max()


@pytest.fixture(scope="module")
def jax_loss_and_grads(jparams):
    """JAX's ``value_and_grad(t5_loss)`` by head, computed once each: JAX's
    remat policies recompute the same fp32 values."""
    out = {}

    def get(head):
        if head not in out:
            src, dec_in, tgt = data()
            loss, grads = jax.value_and_grad(jt5.t5_loss)(
                jax.tree.map(jnp.asarray, jparams), src, dec_in, tgt,
                jcfg(fused_ce=head == "fused"))
            out[head] = (float(loss), jax.tree.map(np.asarray, grads))
        return out[head]

    return get


@pytest.mark.parametrize("head", ["dense", "fused"])
@pytest.mark.parametrize("remat", ["off", "full", "dots"])
def test_loss_and_grads_match_jax(jparams, jax_loss_and_grads, remat, head):
    """``t5_loss`` and every grad under each remat policy against JAX's
    ``value_and_grad`` with the same head."""
    from apex_tpu_torch.optimizers.tree import tree_unflatten

    kw = {"fused_ce": head == "fused", "checkpoint_layers": remat != "off",
          "remat_policy": "full" if remat == "off" else remat}
    want_loss, want_grads = jax_loss_and_grads(head)
    p = _port(jparams, tcfg(**kw))
    loss = tt5.t5_loss(p, *_t(*data()), tcfg(**kw))
    grads = torch.autograd.grad(loss, tree_leaves(p))
    assert abs(float(loss.detach()) - want_loss) <= BAND * abs(want_loss)
    _close(tree_unflatten(p, list(grads)), want_grads, remat, GRAD_BAND)


def test_bf16_matches_jax(jparams):
    src, dec_in, tgt = data()
    jc, tc = jcfg(compute_dtype=jnp.bfloat16), tcfg(compute_dtype=torch.bfloat16)
    want_logits = np.asarray(jt5.t5_forward(jparams, src, dec_in, jc)).astype(np.float32)
    want_loss = float(jt5.t5_loss(jparams, src, dec_in, tgt, jc))
    p = tt5.params_from_numpy(jparams, tc, "cpu")
    with torch.no_grad():
        logits = tt5.t5_forward(p, *_t(src, dec_in), tc)
        loss = float(tt5.t5_loss(p, *_t(src, dec_in, tgt), tc))
    assert logits.dtype == torch.float32
    assert abs(loss - want_loss) <= BF16_LOSS * abs(want_loss), (loss, want_loss)
    err = np.abs(logits.numpy() - want_logits).max()
    assert err <= BF16_LOGITS * np.abs(want_logits).max(), err


def test_loss_finite_and_causal():
    """``TestT5Oracle.test_loss_finite_and_causal`` on the port: a change
    of the last decoder input leaves the first position's logits as they
    were and moves the last's, and another source moves the loss."""
    tree = jax_tree(5)
    src, dec_in, tgt = data(B=2, seed=5)
    p = tt5.params_from_numpy(tree, tcfg(), "cpu")
    with torch.no_grad():
        logits = tt5.t5_forward(p, *_t(src, dec_in), tcfg()).numpy()
        assert np.all(np.isfinite(logits))
        dec_in2 = dec_in.copy()
        dec_in2[:, -1] = (dec_in[:, -1] + 1) % SIZES["vocab_size"]
        logits2 = tt5.t5_forward(p, *_t(src, dec_in2), tcfg()).numpy()
        np.testing.assert_allclose(logits[0], logits2[0], atol=1e-5)
        assert np.max(np.abs(logits[-1] - logits2[-1])) > 1e-6
        l1 = float(tt5.t5_loss(p, *_t(src, dec_in, tgt), tcfg()))
        l2 = float(tt5.t5_loss(p, *_t((src + 1) % SIZES["vocab_size"], dec_in, tgt), tcfg()))
    assert abs(l1 - l2) > 1e-6


@pytest.mark.parametrize("graphs", [None, False])
def test_train_step_matches_jax(graphs):
    """Five ``make_train_step`` steps (FusedAdam 1e-3) from the JAX params
    of ``test_single_device_train_step`` against JAX's step: every loss
    within 1e-5 relative, falling.  ``graphs=None`` runs the compiled
    step (its static buffers, on the CPU without capture)."""
    tree = jax_tree(6)
    src, dec_in, tgt = data(B=4, seed=6)
    jopt = JaxFusedAdam(lr=1e-3)
    jstep = jt5.make_train_step(jcfg(), jopt)
    jp, js = jax.tree.map(jnp.asarray, tree), jopt.init(jax.tree.map(jnp.asarray, tree))
    want = []
    for _ in range(5):
        jp, js, loss = jstep(jp, js, src, dec_in, tgt)
        want.append(float(loss))
    opt = FusedAdam(lr=1e-3)
    p = _port(tree, tcfg())
    state = opt.init(p)
    step = tt5.make_train_step(tcfg(), opt, graphs=graphs)
    got = [float(step(p, state, *_t(src, dec_in, tgt))) for _ in range(5)]
    for g, w in zip(got, want):
        assert abs(g - w) <= BAND * abs(w), (got, want)
    assert got[-1] < got[0]


def test_param_specs_and_shards_match_jax(jparams):
    """Every leaf's spec is the JAX spec, and ``shard_tree`` at tp 2 cuts
    the block ``shard_map`` gives each tp index."""
    want = jt5.param_specs(jcfg())
    got = tt5.param_specs(tcfg())
    jl = dict(leaves_with_path(jax.tree.map(tuple, want,
                                            is_leaf=lambda s: type(s).__name__ ==
                                            "PartitionSpec")))
    for path, spec in leaves_with_path(jax.tree.map(tuple, got, is_leaf=lambda s: isinstance(
            s, type(got["embed"])))):
        assert tuple(spec) == tuple(jl[path]) + (None,) * (len(spec) - len(jl[path])), path
    for rank in range(2):
        shard = tt5.shard_tree(jparams, tcfg(), rank, 2)
        assert shard["embed"].shape == (32, 32)
        np.testing.assert_array_equal(shard["enc_layers"]["wq"],
                                      jparams["enc_layers"]["wq"][:, 16 * rank:16 * (rank + 1)])
        np.testing.assert_array_equal(shard["dec_layers"]["co"],
                                      jparams["dec_layers"]["co"][:, :, 16 * rank:16 * (rank + 1)])
        np.testing.assert_array_equal(shard["pos_dec"], jparams["pos_dec"])


def test_init_params_tree_matches_jax(jparams):
    """The port's own init has the JAX tree's names, shapes and scales."""
    p = tt5.init_params(tcfg(), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in leaves_with_path(p)}
    assert shapes == {k: tuple(v.shape) for k, v in leaves_with_path(jparams)}
    assert torch.equal(p["dec_layers"]["lnm_scale"], torch.ones(4, 32))
    assert abs(float(p["enc_layers"]["fc2"].std()) - 128 ** -0.5) < 0.01


def test_config_refusals():
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam

    with pytest.raises(NotImplementedError, match="fused_ce with compute_dtype torch.float16"):
        tt5.T5Config(fused_ce=True, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="remat_policy must be one of"):
        tt5.T5Config(remat_policy="everything")
    for build in (lambda o: tt5.make_train_step(tcfg(), o),
                  lambda o: tt5.make_pp_train_step(tcfg(), o, 2, 1)):
        with pytest.raises(ValueError, match="replicated optimizer state"):
            build(DistributedFusedAdam(lr=1e-3))
    with pytest.raises(ValueError, match="tensor-parallel size"):
        tt5.check_tp(tcfg(), 3)
