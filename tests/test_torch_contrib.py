"""The port's contrib modules (``apex_tpu_torch.contrib``) against the
JAX package's on the CPU, at small sizes (two or four heads of 16,
sequences of 16 to 24), inputs from numpy seeds.  On the CPU the flash
wrappers run their plain versions, and the JAX functions their scan or
XLA paths.  Tolerances (each stated beside its check):

- fp32 forward and gradients within ``TOL`` = 1e-5 of the largest
  entry of the JAX value (absolute when that is below 1);
- ``fast_mask_softmax_dropout_func`` without dropout within 1e-6; with
  dropout only the structure (each entry 0 or the probability over the
  keep rate) is checked, since the two draw from other generators;
- ``FusedAdamSWA``: five steps with the third skipped (``grads_finite``
  false), params, moments and SWA copies within 1e-7, ``n_averaged``
  exact;
- the transducer loss also against a brute-force alpha recursion in
  float64 numpy (``tests/test_contrib_tail.py``'s oracle), within 1e-5
  relative.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jcbr = importlib.import_module("apex_tpu.contrib.conv_bias_relu.conv_bias_relu")
jfmha = importlib.import_module("apex_tpu.contrib.fmha.fmha")
jfocal = importlib.import_module("apex_tpu.contrib.focal_loss.focal_loss")
jgn = importlib.import_module("apex_tpu.contrib.group_norm.group_norm")
jimul = importlib.import_module("apex_tpu.contrib.index_mul_2d.index_mul_2d")
jmsd = importlib.import_module("apex_tpu.contrib.multihead_attn.mask_softmax_dropout_func")
jmha = importlib.import_module("apex_tpu.contrib.multihead_attn.self_multihead_attn")
jswa = importlib.import_module("apex_tpu.contrib.openfold_triton.fused_adam_swa")
jof = importlib.import_module("apex_tpu.contrib.openfold_triton.mha")
jtr = importlib.import_module("apex_tpu.contrib.transducer.transducer")
jxent = importlib.import_module("apex_tpu.contrib.xentropy.softmax_xentropy")

import apex_tpu_torch.contrib as tcontrib
tcbr = importlib.import_module("apex_tpu_torch.contrib.conv_bias_relu.conv_bias_relu")
tfmha = importlib.import_module("apex_tpu_torch.contrib.fmha.fmha")
tfocal = importlib.import_module("apex_tpu_torch.contrib.focal_loss.focal_loss")
tgn = importlib.import_module("apex_tpu_torch.contrib.group_norm.group_norm")
timul = importlib.import_module("apex_tpu_torch.contrib.index_mul_2d.index_mul_2d")
tmsd = importlib.import_module("apex_tpu_torch.contrib.multihead_attn.mask_softmax_dropout_func")
tmha = importlib.import_module("apex_tpu_torch.contrib.multihead_attn.self_multihead_attn")
tswa = importlib.import_module("apex_tpu_torch.contrib.openfold_triton.fused_adam_swa")
tof = importlib.import_module("apex_tpu_torch.contrib.openfold_triton.mha")
ttr = importlib.import_module("apex_tpu_torch.contrib.transducer.transducer")
txent = importlib.import_module("apex_tpu_torch.contrib.xentropy.softmax_xentropy")

#: fp32 forward and gradients, of the largest JAX entry (absolute below 1)
TOL = 1e-5
#: mask + softmax without dropout
SOFTMAX_TOL = 1e-6
#: FusedAdamSWA's params, moments and SWA copies
SWA_TOL = 1e-7


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def check(got, want, tol=TOL, name=""):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (name, err, tol * scale)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def vjp_both(jfn, tfn, args, cot, diff):
    """``(jax_out, jax_grads, torch_out, torch_grads)`` of ``fn(*args)``
    with cotangent ``cot`` for the args at positions ``diff``."""
    jargs = [jnp.asarray(a) for a in args]

    def jf(*d):
        full = list(jargs)
        for i, x in zip(diff, d):
            full[i] = x
        return jfn(*full)

    jout, pull = jax.vjp(jax.jit(jf), *[jargs[i] for i in diff])
    jgrads = pull(jnp.asarray(cot))
    targs = [_t(a, grad=i in diff and np.asarray(a).dtype.kind == "f")
             for i, a in enumerate(args)]
    tout = tfn(*targs)
    tgrads = torch.autograd.grad(tout, [targs[i] for i in diff], _t(cot))
    return jout, jgrads, tout, tgrads


# ------------------------------------------------------------------ fmha

def _lengths_mask(lengths, S):
    return np.arange(S)[None, :] < np.asarray(lengths)[:, None]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_fmha_matches_jax(causal, masked):
    rng = np.random.RandomState(0)
    B, S, H, D = 3, 16, 2, 16
    qkv = rng.randn(B, S, 3, H, D).astype(np.float32)
    cot = rng.randn(B, S, H, D).astype(np.float32)
    mask = _lengths_mask([16, 9, 1], S) if masked else None
    jout, (jg,), tout, (tg,) = vjp_both(
        lambda x: jfmha.fmha(x, None if mask is None else jnp.asarray(mask), causal=causal),
        lambda x: tfmha.fmha(x, None if mask is None else torch.tensor(mask), causal=causal),
        [qkv], cot, [0])
    check(tout, jout, name="out")
    check(tg, jg, name="dqkv")
    if masked:
        assert not _np(tout)[2, 1:].any()  # padded query rows are zero


@pytest.mark.parametrize("case", ["ragged", "empty_sequence", "max_s_clamp"])
def test_fmha_varlen_matches_jax(case):
    """Packed sequences; an empty one (two equal ``cu_seqlens``); one
    longer than ``max_s``, whose rows past it repeat JAX's clamped
    gathers."""
    lengths, max_s = {"ragged": ([5, 12, 7], 12), "empty_sequence": ([6, 0, 9], 12),
                      "max_s_clamp": ([5, 14, 3], 10)}[case]
    rng = np.random.RandomState(1)
    H, D = 2, 16
    cu = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    total = int(cu[-1])
    qkv = rng.randn(total, 3, H, D).astype(np.float32)
    cot = rng.randn(total, H, D).astype(np.float32)
    jout, (jg,), tout, (tg,) = vjp_both(
        lambda x: jfmha.fmha_varlen(x, jnp.asarray(cu), max_s),
        lambda x: tfmha.fmha_varlen(x, torch.tensor(cu), max_s),
        [qkv], cot, [0])
    check(tout, jout, name="out")
    check(tg, jg, name="dqkv")


# ----------------------------------------------------------- multihead_attn

def _flax_params(module, *inputs):
    v = module.init(jax.random.PRNGKey(0), *inputs, train=False)
    return jax.tree.map(np.asarray, v["params"])


@pytest.mark.parametrize("include_norm_add", [False, True])
@pytest.mark.parametrize("use_bias", [False, True])
def test_self_multihead_attn_matches_jax(include_norm_add, use_bias):
    rng = np.random.RandomState(2)
    S, B, H, nh = 16, 2, 32, 2
    x = rng.randn(S, B, H).astype(np.float32)
    pad = ~_lengths_mask([16, 11], S)  # True = PAD
    cot = rng.randn(S, B, H).astype(np.float32)
    jm = jmha.SelfMultiheadAttn(H, nh, use_bias=use_bias, include_norm_add=include_norm_add)
    params = _flax_params(jm, jnp.asarray(x), jnp.asarray(pad))
    tm = tmha.SelfMultiheadAttn(H, nh, use_bias=use_bias, include_norm_add=include_norm_add,
                                device="cpu").params_from_numpy(params)
    names = sorted(params)

    def jf(x, p):
        return jm.apply({"params": p}, x, jnp.asarray(pad), train=False)

    jout, pull = jax.vjp(jax.jit(jf), jnp.asarray(x), params)
    jdx, jdp = pull(jnp.asarray(cot))
    tx = _t(x, grad=True)
    tout = tm(tx, torch.tensor(pad), train=False)
    grads = torch.autograd.grad(tout, [tx] + [dict(tm.named_parameters())[n] for n in names],
                                _t(cot))
    check(tout, jout, name="out")
    check(grads[0], jdx, name="dx")
    for n, g in zip(names, grads[1:]):
        check(g, jdp[n], name=n)


@pytest.mark.parametrize("include_norm_add", [False, True])
@pytest.mark.parametrize("use_bias", [False, True])
def test_encdec_multihead_attn_matches_jax(include_norm_add, use_bias):
    """Sq 16 against Sk 24 keys, non-causal, under a key mask."""
    rng = np.random.RandomState(3)
    Sq, Sk, B, H, nh = 16, 24, 2, 32, 4
    q = rng.randn(Sq, B, H).astype(np.float32)
    k = rng.randn(Sk, B, H).astype(np.float32)
    pad = ~_lengths_mask([24, 13], Sk)
    cot = rng.randn(Sq, B, H).astype(np.float32)
    jm = jmha.EncdecMultiheadAttn(H, nh, use_bias=use_bias, include_norm_add=include_norm_add)
    params = _flax_params(jm, jnp.asarray(q), jnp.asarray(k), jnp.asarray(pad))
    tm = tmha.EncdecMultiheadAttn(H, nh, use_bias=use_bias, include_norm_add=include_norm_add,
                                  device="cpu").params_from_numpy(params)
    names = sorted(params)

    def jf(q, k, p):
        return jm.apply({"params": p}, q, k, jnp.asarray(pad), train=False)

    jout, pull = jax.vjp(jax.jit(jf), jnp.asarray(q), jnp.asarray(k), params)
    jdq, jdk, jdp = pull(jnp.asarray(cot))
    tq, tk = _t(q, grad=True), _t(k, grad=True)
    tout = tm(tq, tk, torch.tensor(pad), train=False)
    grads = torch.autograd.grad(
        tout, [tq, tk] + [dict(tm.named_parameters())[n] for n in names], _t(cot))
    check(tout, jout, name="out")
    check(grads[0], jdq, name="dq")
    check(grads[1], jdk, name="dk")
    for n, g in zip(names, grads[2:]):
        check(g, jdp[n], name=n)


def test_multihead_attn_dropout():
    """Training dropout needs a generator (flax needs its ``dropout``
    rng); with one, a generator's draws repeat and the output is finite;
    ``train=False`` (or ``eval()``) drops nothing."""
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.randn(8, 2, 16).astype(np.float32))
    m = tmha.SelfMultiheadAttn(16, 2, dropout=0.5, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        m(x)
    a = m(x, generator=torch.Generator().manual_seed(5))
    b = m(x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert torch.equal(m(x, train=False), m.eval()(x))
    with pytest.raises(ValueError, match="expected params"):
        m.params_from_numpy({"input_weights": np.zeros((48, 16))})


@pytest.mark.parametrize("additive", [False, True])
def test_mask_softmax_dropout_matches_jax(additive):
    rng = np.random.RandomState(5)
    B, nh, Sq, Sk = 2, 2, 8, 12
    scores = rng.randn(B * nh, Sq, Sk).astype(np.float32)
    lens = [12, 7]
    if additive:
        mask = np.where(_lengths_mask(lens, Sk), 0.0, -10000.0).astype(np.float32)
    else:
        mask = (~_lengths_mask(lens, Sk)).astype(np.uint8)  # nonzero = PAD
    want = jmsd.fast_mask_softmax_dropout_func(False, nh, jnp.asarray(scores),
                                               jnp.asarray(mask), additive, 0.0)
    got = tmsd.fast_mask_softmax_dropout_func(False, nh, torch.tensor(scores),
                                              torch.tensor(mask), additive, 0.0)
    check(got, want, SOFTMAX_TOL)
    # an additive mask broadcastable to the scores, and no mask at all
    full = rng.randn(B * nh, Sq, Sk).astype(np.float32)
    check(tmsd.fast_mask_softmax_dropout_func(False, nh, torch.tensor(scores),
                                              torch.tensor(full), True, 0.0),
          jmsd.fast_mask_softmax_dropout_func(False, nh, jnp.asarray(scores),
                                              jnp.asarray(full), True, 0.0), SOFTMAX_TOL)
    check(tmsd.fast_mask_softmax_dropout_func(True, nh, torch.tensor(scores), None, False, 0.0),
          jmsd.fast_mask_softmax_dropout_func(True, nh, jnp.asarray(scores), None, False, 0.0),
          SOFTMAX_TOL)
    # dropout: every entry 0 or the probability over the keep rate
    p = 0.25
    with pytest.raises(ValueError, match="generator"):
        tmsd.fast_mask_softmax_dropout_func(True, nh, torch.tensor(scores), None, False, p)
    dropped = tmsd.fast_mask_softmax_dropout_func(
        True, nh, torch.tensor(scores), torch.tensor(mask), additive, p,
        generator=torch.Generator().manual_seed(0))
    kept = _np(dropped) != 0
    np.testing.assert_allclose(_np(dropped)[kept], _np(got)[kept] / (1 - p), rtol=1e-6)
    assert 0.5 < kept[_np(got) > 0].mean() < 0.95


# ----------------------------------------------------------- openfold_triton

@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_core_matches_jax(with_bias):
    """MSA-row-like shapes: (batch 2, rows 3, heads 2, S 16, D 16), a
    per-key residue mask (…, 1, 1, Sk) and a pair bias (1, 1, H, Sq, Sk)
    broadcast over rows, whose gradient is summed back."""
    rng = np.random.RandomState(6)
    lead, H, S, D = (2, 3), 2, 16, 16
    q, k, v = (rng.randn(*lead, H, S, D).astype(np.float32) for _ in range(3))
    mask = (rng.rand(*lead, 1, 1, S) > 0.3).astype(np.float32)
    bias = rng.randn(1, 1, H, S, S).astype(np.float32)
    cot = rng.randn(*lead, H, S, D).astype(np.float32)
    args = [q, k, v, mask, bias] if with_bias else [q, k, v, mask]
    diff = [0, 1, 2, 4] if with_bias else [0, 1, 2]

    def jf(q, k, v, m, b=None):
        return jof.attention_core(q, k, v, mask=m, bias=b)

    def tf(q, k, v, m, b=None):
        return tof.attention_core(q, k, v, mask=m, bias=b)

    jout, jg, tout, tg = vjp_both(jf, tf, args, cot, diff)
    check(tout, jout, name="out")
    for n, a, b in zip("qkvb", tg, jg):
        check(a, b, name=f"d{n}")
    check(tof.AttnTri(*[_t(a) for a in args]), jout, name="AttnTri")


@pytest.mark.parametrize("with_bias", [False, True])
def test_attn_bias_jit_matches_jax(with_bias):
    rng = np.random.RandomState(7)
    B, H, S, D = 2, 2, 16, 16
    q, k, v = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(3))
    mask = (rng.rand(B, 1, 1, S) > 0.3).astype(np.float32)
    bias = rng.randn(1, H, S, S).astype(np.float32)
    cot = rng.randn(B, H, S, D).astype(np.float32)
    if with_bias:
        jf, tf = (lambda *a: jof.AttnBiasJIT(*a, 1e9)), (lambda *a: tof.AttnBiasJIT(*a, 1e9))
        args, diff = [q, k, v, mask, bias], [0, 1, 2, 4]
    else:
        jf, tf = (lambda *a: jof.AttnNoBiasJIT(*a, 1e9)), (lambda *a: tof.AttnNoBiasJIT(*a, 1e9))
        args, diff = [q, k, v, mask], [0, 1, 2]
    jout, jg, tout, tg = vjp_both(jf, tf, args, cot, diff)
    check(tout, jout, name="out")
    for n, a, b in zip("qkvb", tg, jg):
        check(a, b, name=f"d{n}")


def test_openfold_switches_and_exports():
    from apex_tpu_torch.contrib import openfold_triton as of
    from apex_tpu_torch.normalization import FusedLayerNorm

    assert of.LayerNormSmallShapeOptImpl is FusedLayerNorm
    assert of.sync_triton_auto_tune_cache_across_gpus() is None
    try:
        of.disable()
        assert not of.is_enabled() and not of.CanSchTriMHA((1, 2, 3))
    finally:
        of.enable()
    assert of.is_enabled() and of.CanSchTriMHA((1, 2, 3))
    assert tswa.FusedAdamSWA.supports_update_scaled is False


@pytest.mark.parametrize("decay", [None, 0.9])
@pytest.mark.parametrize("inplace", [False, True])
def test_fused_adam_swa_matches_jax(decay, inplace):
    """Five steps, the third skipped (``grads_finite`` false): params,
    moments and SWA copies within 1e-7, ``n_averaged`` exact, the SWA
    copies never aliasing a param."""
    rng = np.random.RandomState(8)
    shapes = {"a": (7, 5), "b": (33,), "c": (3, 4, 2)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    finite = [True, True, False, True, True]
    kw = dict(lr=1e-2, weight_decay=0.01, swa_decay_rate=decay)
    jo = jswa.FusedAdamSWA(**kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jo.init(jp)
    to = tswa.FusedAdamSWA(**kw)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    ts = to.init(tp)
    assert all(s.data_ptr() != p.data_ptr() for s, p in zip(ts.swa_params.values(),
                                                            tp.values()))
    jupdate = jax.jit(jo.update)
    for g, f in zip(grads, finite):
        jp, js = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                           grads_finite=jnp.asarray(f))
        new_p, new_s = to.update({k: torch.tensor(v) for k, v in g.items()}, ts, tp,
                                 grads_finite=torch.tensor(f), inplace=inplace)
        if inplace:
            assert new_p is tp and new_s is ts
        tp, ts = new_p, new_s
    assert int(ts.n_averaged) == int(js.n_averaged) == 4
    for k in shapes:
        check(tp[k], jp[k], SWA_TOL, f"param {k}")
        check(ts.swa_params[k], js.swa_params[k], SWA_TOL, f"swa {k}")
        check(ts.adam.exp_avg[k], js.adam.exp_avg[k], SWA_TOL, f"m {k}")
        check(ts.adam.exp_avg_sq[k], js.adam.exp_avg_sq[k], SWA_TOL, f"v {k}")


# ----------------------------------------------------------- xentropy, focal

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_xentropy_matches_jax(smoothing, dtype):
    """fp32 within 1e-5; bf16 logits: the loss (fp32 from the same bf16
    values) within 1e-5 and the bf16 gradient within one bf16 step of
    its largest entry (the one rounding of the same fp32 value)."""
    rng = np.random.RandomState(9)
    N, C = 12, 40
    logits = (rng.randn(N, C) * 3).astype(np.float32)
    labels = rng.randint(0, C, size=N)
    g = rng.randn(N).astype(np.float32)
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    jloss, pull = jax.vjp(lambda x: jxent.softmax_xentropy(x, jnp.asarray(labels), smoothing),
                          jl)
    (jg,) = pull(jnp.asarray(g))
    tl = torch.tensor(np.asarray(jl.astype(jnp.float32))).to(getattr(torch, dtype))
    tl.requires_grad_(True)
    tloss = txent.SoftmaxCrossEntropyLoss.apply(tl, torch.tensor(labels), smoothing, 0)
    (tg,) = torch.autograd.grad(tloss, [tl], torch.tensor(g))
    assert tloss.dtype == torch.float32 and tg.dtype == getattr(torch, dtype)
    check(tloss, jloss, name="loss")
    gtol = TOL if dtype == "float32" else 2.0 ** -8
    check(tg.float(), np.asarray(jg.astype(jnp.float32)), gtol, "grad")


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_focal_loss_matches_jax(smoothing):
    """Ids -1 (ignore) and 0 (background) give zero one-hot rows, as
    ``jax.nn.one_hot(t - 1)`` does."""
    rng = np.random.RandomState(10)
    A, C = 64, 6
    x = (rng.randn(2, A, C) * 2).astype(np.float32)
    t = rng.randint(-1, C + 1, size=(2, A))
    t[0, :3] = [-1, 0, C]
    nps = np.float32(max((t > 0).sum(), 1))
    cot = np.float32(1.7)
    jout, (jg,), tout, (tg,) = vjp_both(
        lambda x: jfocal.focal_loss(x, jnp.asarray(t), jnp.asarray(nps), C,
                                    label_smoothing=smoothing),
        lambda x: tfocal.focal_loss(x, torch.tensor(t), torch.tensor(nps), C,
                                    label_smoothing=smoothing),
        [x], cot, [0])
    check(tout, jout, name="loss")
    check(tg, jg, name="grad")


# ------------------------------------------------- group_norm, index_mul_2d

@pytest.mark.parametrize("act", ["", "silu"])
@pytest.mark.parametrize("affine", [False, True])
def test_group_norm_nhwc_matches_jax(act, affine):
    rng = np.random.RandomState(11)
    N, H, W, C, G = 2, 5, 6, 16, 4
    x = (rng.randn(N, H, W, C) * 2 + 1).astype(np.float32)
    w = rng.randn(C).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    cot = rng.randn(N, H, W, C).astype(np.float32)
    if affine:
        jf = lambda x, w, b: jgn.group_norm_nhwc(x, G, w, b, act=act)  # noqa: E731
        tf = lambda x, w, b: tgn.cuda_group_norm_nhwc_forward(x, G, w, b, act=act)  # noqa: E731
        args, diff = [x, w, b], [0, 1, 2]
    else:
        jf = lambda x: jgn.group_norm_nhwc(x, G, act=act)  # noqa: E731
        tf = lambda x: tgn.group_norm_nhwc(x, G, act=act)  # noqa: E731
        args, diff = [x], [0]
    jout, jg, tout, tg = vjp_both(jf, tf, args, cot, diff)
    check(tout, jout, name="out")
    for a, b_ in zip(tg, jg):
        check(a, b_, name="grad")


def test_group_norm_module_matches_flax():
    rng = np.random.RandomState(12)
    x = rng.randn(2, 4, 4, 8).astype(np.float32)
    jm = jgn.GroupNorm(num_groups=2, num_channels=8, act="silu")
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = tgn.GroupNorm(2, 8, act="silu", device="cpu")
    check(tm(torch.tensor(x)), jm.apply(v, jnp.asarray(x)))
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(v["params"])
    assert tgn.GroupNorm(2, 8, affine=False, device="cpu").weight is None


def test_index_mul_2d_matches_jax():
    """Repeated indices: in1's gradient adds the rows they pick."""
    rng = np.random.RandomState(13)
    N, K, D = 10, 24, 8
    in1 = rng.randn(N, D).astype(np.float32)
    in2 = rng.randn(K, D).astype(np.float32)
    idx = rng.randint(0, N, size=K)
    idx[:4] = 3
    cot = rng.randn(K, D).astype(np.float32)
    jout, jg, tout, tg = vjp_both(lambda a, b, i: jimul.index_mul_2d(a, b, i),
                                  lambda a, b, i: timul.index_mul_2d(a, b, i),
                                  [in1, in2, idx], cot, [0, 1])
    check(tout, jout, name="out")
    check(tg[0], jg[0], name="din1")
    check(tg[1], jg[1], name="din2")


# ------------------------------------------------------------ transducer

def rnnt_oracle_full(logp, targets, T, U):
    """Brute-force alpha recursion in float64 (``tests/test_contrib_tail.py``'s
    oracle; blank 0, labels are raw vocab ids)."""
    alpha = np.full((T, U), -np.inf)
    alpha[0, 0] = 0.0
    for t in range(T):
        for u in range(U):
            if t == 0 and u == 0:
                continue
            cands = []
            if t > 0:
                cands.append(alpha[t - 1, u] + logp[t - 1, u, 0])
            if u > 0:
                cands.append(alpha[t, u - 1] + logp[t, u - 1, targets[u - 1]])
            alpha[t, u] = np.logaddexp.reduce(cands)
    return -(alpha[T - 1, U - 1] + logp[T - 1, U - 1, 0])


@pytest.mark.parametrize("shape", [(2, 6, 4, 7), (3, 3, 8, 5), (1, 1, 1, 3)])
def test_transducer_loss_matches_jax(shape):
    """Full lengths, and (for the first shape) shorter ``f_len`` /
    ``y_len``: the loss and its gradient against JAX's scan, and each
    sample against the brute-force recursion."""
    B, T, U, V = shape
    rng = np.random.RandomState(14)
    logits = rng.randn(B, T, U, V).astype(np.float32)
    targets = rng.randint(1, V, size=(B, U - 1))
    f_len = np.full(B, T)
    y_len = np.full(B, U - 1)
    if B == 2:
        f_len[1], y_len[1] = T - 2, U - 3
    cot = rng.rand(B).astype(np.float32)
    jout, (jg,), tout, (tg,) = vjp_both(
        lambda x: jtr.transducer_loss(x, jnp.asarray(targets), jnp.asarray(f_len),
                                      jnp.asarray(y_len)),
        lambda x: ttr.TransducerLoss()(x, torch.tensor(targets), torch.tensor(f_len),
                                       torch.tensor(y_len)),
        [logits], cot, [0])
    check(tout, jout, name="loss")
    check(tg, jg, name="grad")
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits, jnp.float64)
                                         if jax.config.jax_enable_x64 else
                                         jnp.asarray(logits), axis=-1), np.float64)
    for b in range(B):
        want = rnnt_oracle_full(logp[b], targets[b], int(f_len[b]), int(y_len[b]) + 1)
        np.testing.assert_allclose(float(tout[b].detach()), want, rtol=1e-5)


def test_transducer_joint_matches_jax():
    rng = np.random.RandomState(15)
    B, T, U, H = 2, 5, 4, 8
    f = rng.randn(B, T, H).astype(np.float32)
    g = rng.randn(B, U, H).astype(np.float32)
    f_len, g_len = np.array([5, 3]), np.array([2, 4])
    for kw in ({}, {"relu": True}, {"relu": True, "pack_output": True}):
        want = jtr.TransducerJoint(**kw)(jnp.asarray(f), jnp.asarray(g),
                                         jnp.asarray(f_len), jnp.asarray(g_len))
        got = ttr.TransducerJoint(**kw)(torch.tensor(f), torch.tensor(g),
                                        torch.tensor(f_len), torch.tensor(g_len))
        check(got, want, name=str(kw))
    joint = ttr.TransducerJoint(dropout=True, dropout_prob=0.5)
    with pytest.raises(ValueError, match="generator"):
        joint(torch.tensor(f), torch.tensor(g))
    full = _np(ttr.TransducerJoint()(torch.tensor(f), torch.tensor(g)))
    out = _np(joint(torch.tensor(f), torch.tensor(g), generator=torch.Generator().manual_seed(0)))
    kept = out != 0
    np.testing.assert_allclose(out[kept], full[kept] * 2, rtol=1e-6)


# ---------------------------------------------------------- conv_bias_relu

@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"), (1, "VALID"),
                                            (2, "VALID")])
def test_conv_bias_relu_matches_jax(stride, padding):
    """All four forms, forward and gradients; the frozen form gives
    scale and bias no gradient."""
    rng = np.random.RandomState(16)
    x = rng.randn(2, 9, 8, 3).astype(np.float32)
    w = rng.randn(3, 3, 3, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    s = rng.rand(5).astype(np.float32) + 0.5
    mask = (rng.rand(*jcbr.ConvBias(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride,
                                    padding).shape) > 0.5).astype(np.float32)
    cot = rng.randn(*mask.shape).astype(np.float32)
    cases = (("ConvBias", [x, w, b], [0, 1, 2]), ("ConvBiasReLU", [x, w, b], [0, 1, 2]),
             ("ConvBiasMaskReLU", [x, w, b, mask], [0, 1, 2]),
             ("ConvFrozenScaleBiasReLU", [x, w, s, b], [0, 1]))
    for name, args, diff in cases:
        jout, jg, tout, tg = vjp_both(
            lambda *a, n=name: getattr(jcbr, n)(*a, stride=stride, padding=padding),
            lambda *a, n=name: getattr(tcbr, n)(*a, stride=stride, padding=padding),
            args, cot, diff)
        check(tout, jout, name=name)
        for a, b_ in zip(tg, jg):
            check(a, b_, name=f"{name} grad")
    ts, tb = _t(s, grad=True), _t(b, grad=True)
    out = tcbr.ConvFrozenScaleBiasReLU(_t(x), _t(w), ts, tb, stride=stride, padding=padding)
    assert not out.requires_grad


def test_contrib_lists_its_subpackages_lazily():
    assert set(tcontrib._SUBS) == {"optimizers", "xentropy", "clip_grad", "focal_loss",
                                   "group_norm", "layer_norm", "index_mul_2d", "fmha",
                                   "multihead_attn", "transducer", "conv_bias_relu",
                                   "openfold_triton"}
    assert tcontrib.fmha.fmha is tfmha.fmha
    with pytest.raises(AttributeError):
        tcontrib.groupbn  # noqa: B018 (not ported yet)
