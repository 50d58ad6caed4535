"""The port's fused LM-head CE (apex_tpu_torch.ops.fused_ce_kernels and
ops.fused_ce, plain PyTorch versions on the CPU) against the JAX
package: the Pallas kernels in interpret mode
(``fused_ce_fwd_pallas`` / ``fused_ce_bwd_pallas`` with
``interpret=True``), dense jnp, and ``jax.vjp`` of
``apex_tpu.ops.fused_ce.fused_lm_head_ce``.

Bands: fp32 dots, lse/tgt within 1e-5 abs and grads within 1e-5 of the
output's largest magnitude (sums in other orders).  bf16 dots: lse/tgt
within 1e-5 abs (bf16 products are exact in fp32, only the order of the
sums differs); dx/dembed within 2**-8 of the output's largest magnitude
(d rounds to bf16 before the second product, and an fp32 difference in
the last place of p can move that rounding by one bf16 step).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.fused_ce import fused_lm_head_ce as jax_fused_ce
from apex_tpu.ops.fused_ce_pallas import fused_ce_bwd_pallas, fused_ce_fwd_pallas

from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.ops import fused_ce_kernels as K
from apex_tpu_torch.ops.fused_ce import fused_lm_head_ce

# (N, H, V, block_n, block_v): the shapes of tests/test_fused_ce_pallas.py
SHAPES = [(64, 32, 96, 16, 32), (90, 32, 393, 64, 128), (24, 8, 100, 64, 128)]
_DOT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _data(N, H, V, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H).astype(np.float32)
    e = (0.5 * rng.randn(V, H)).astype(np.float32)
    t = rng.randint(0, V, size=N).astype(np.int32)
    g = (rng.randn(N) / N).astype(np.float32)
    return x, e, t, g


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def _scale(a):
    return float(np.abs(np.asarray(a, np.float32)).max())


@pytest.mark.parametrize("dot", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,H,V,bn,bv", SHAPES)
def test_plain_kernels_match_pallas_interpret(N, H, V, bn, bv, dot):
    tdot, jdot = _DOT[dot]
    x, e, t, g = _data(N, H, V)
    xt, et, tt, gt = (torch.from_numpy(a) for a in (x, e, t, g))
    m, l, tgt = K.ce_fwd_plain(xt, et, tt, dot_dtype=tdot, chunk_rows=16)
    jm, jl, jtgt = fused_ce_fwd_pallas(jnp.asarray(x), jnp.asarray(e), jnp.asarray(t),
                                       dot_dtype=jdot, block_n=bn, block_v=bv,
                                       interpret=True)
    lse = m + torch.log(l)
    _close(lse, np.asarray(jm + jnp.log(jl)), 1e-5)
    _close(m, jm, 1e-5)
    _close(tgt, jtgt, 1e-5)
    dx = K.ce_dx_plain(xt, et, tt, lse, gt, dot_dtype=tdot, chunk_rows=16)
    de = K.ce_dembed_plain(xt, et, tt, lse, gt, dot_dtype=tdot, chunk_rows=16)
    jdx, jde = fused_ce_bwd_pallas(jnp.asarray(x), jnp.asarray(e), jnp.asarray(t),
                                   jnp.asarray(lse.numpy()), jnp.asarray(g), dot_dtype=jdot,
                                   block_n=bn, block_v=bv, interpret=True)
    band = 1e-5 if dot == "float32" else 2.0 ** -8
    assert dx.dtype == torch.float32 and de.dtype == torch.float32
    _close(dx, jdx, band * _scale(jdx))
    _close(de, jde, band * _scale(jde))


@pytest.mark.parametrize("N,H,V,bn,bv", SHAPES)
def test_plain_fp32_matches_dense_jnp(N, H, V, bn, bv):
    """The CPU path (the wrappers on CPU tensors, fp32 dots) against the
    dense head and its autodiff in jnp."""
    x, e, t, g = _data(N, H, V, seed=1)
    xt, et, tt, gt = (torch.from_numpy(a) for a in (x, e, t, g))
    m, l, tgt = K.ce_fwd(xt, et, tt)
    lse = m + torch.log(l)
    logits = jnp.asarray(x) @ jnp.asarray(e).T
    _close(lse, jax.scipy.special.logsumexp(logits, -1), 1e-5)
    _close(tgt, jnp.take_along_axis(logits, jnp.asarray(t)[:, None], -1)[:, 0], 1e-5)

    def loss(x_, e_):
        lg = x_ @ e_.T
        return jnp.sum(jnp.asarray(g) * (jax.scipy.special.logsumexp(lg, -1)
                                         - jnp.take_along_axis(lg, jnp.asarray(t)[:, None],
                                                               -1)[:, 0]))

    rdx, rde = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(e))
    _close(K.ce_dx(xt, et, tt, lse, gt), rdx, 1e-5 * _scale(rdx))
    _close(K.ce_dembed(xt, et, tt, lse, gt), rde, 1e-5 * _scale(rde))


def test_bf16_x_gives_bf16_dx():
    x, e, t, g = _data(24, 16, 40, seed=2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    et, tt, gt = (torch.from_numpy(a) for a in (e, t, g))
    m, l, _ = K.ce_fwd_plain(xb, et, tt, dot_dtype=torch.bfloat16)
    lse = m + torch.log(l)
    dx = K.ce_dx_plain(xb, et, tt, lse, gt, dot_dtype=torch.bfloat16)
    assert dx.dtype == torch.bfloat16
    assert K.ce_dembed_plain(xb, et, tt, lse, gt, dot_dtype=torch.bfloat16).dtype == torch.float32


def _ce_inputs(S=16, B=2, H=32, V=48, seed=3, out_of_range=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(S, B, H).astype(np.float32)
    e = (0.5 * rng.randn(V, H)).astype(np.float32)
    t = rng.randint(0, V, size=(S, B)).astype(np.int32)
    if out_of_range:
        t[0, 0], t[1, 1] = -3, V + 5
    return x, e, t


@pytest.mark.parametrize("chunk", [8, 16])
def test_fused_lm_head_ce_grads_match_jax_vjp(chunk):
    """Loss, dx and dembed of the port's fused_lm_head_ce (the plain
    kernels) against jax.vjp of the JAX package's at impl="off" (its
    fp32 chunked scan), targets out of range included."""
    x, e, t = _ce_inputs()
    S, B = t.shape
    ct = np.random.RandomState(4).randn(S, B).astype(np.float32)
    jloss, vjp = jax.vjp(lambda a, b: jax_fused_ce(a, b, jnp.asarray(t), chunk, None, "off"),
                         jnp.asarray(x), jnp.asarray(e))
    rdx, rde = vjp(jnp.asarray(ct))
    xt, et = (torch.from_numpy(a).requires_grad_() for a in (x, e))
    loss = fused_lm_head_ce(xt, et, torch.from_numpy(t).long(), chunk)
    assert loss.shape == (S, B)
    _close(loss, jloss, 1e-5)
    loss.backward(torch.from_numpy(ct))
    _close(xt.grad, rdx, 1e-5 * _scale(rdx))
    _close(et.grad, rde, 1e-5 * _scale(rde))


def test_out_of_range_targets_clamp_like_the_dense_head():
    """Ids outside [0, V) clamp to the nearest end on the fused and the
    dense head alike (test_fused_ce_pallas.py's check)."""
    x, e, t = _ce_inputs(seed=5)
    cfg = tgpt.GPTConfig(vocab_size=48, hidden_size=32, num_layers=1, num_attention_heads=4,
                         compute_dtype=torch.float32)
    xt, et, tt = torch.from_numpy(x), torch.from_numpy(e), torch.from_numpy(t).long()
    fused = fused_lm_head_ce(xt, et, tt, 8)
    dense = tgpt.lm_head_loss(xt, et, tt, cfg)
    clamped = fused_lm_head_ce(xt, et, tt.clamp(0, 47), 8)
    torch.testing.assert_close(fused, clamped, rtol=0, atol=0)
    torch.testing.assert_close(fused, dense, rtol=1e-6, atol=1e-5)


def test_refusals():
    x, e, t = (torch.from_numpy(a) for a in _ce_inputs(out_of_range=False))
    for impl in ("interpret", "on", "off"):
        with pytest.raises(ValueError, match="one implementation"):
            fused_lm_head_ce(x, e, t, 8, impl=impl)
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        fused_lm_head_ce(x, e, t, 8, axis_name="tp")
    with pytest.raises(ValueError, match="divisible"):
        fused_lm_head_ce(x, e, t, 5)


def test_plain_version_is_the_cpu_path_and_other_devices_raise():
    x, e, t, g = (torch.from_numpy(a) for a in _data(20, 16, 30, seed=6))
    for got, want in zip(K.ce_fwd(x, e, t), K.ce_fwd_plain(x, e, t)):
        assert torch.equal(got, want)
    lse = torch.logsumexp(x @ e.T, -1)
    assert torch.equal(K.ce_dx(x, e, t, lse, g), K.ce_dx_plain(x, e, t, lse, g))
    assert torch.equal(K.ce_dembed(x, e, t, lse, g), K.ce_dembed_plain(x, e, t, lse, g))
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta") for a in (x, e, t, lse, g)]
    with pytest.raises(ValueError, match="not supported"):
        K.ce_fwd(*meta[:3])
    with pytest.raises(ValueError, match="not supported"):
        K.ce_dx(*meta)
    with pytest.raises(ValueError, match="not supported"):
        K.ce_dembed(*meta)
