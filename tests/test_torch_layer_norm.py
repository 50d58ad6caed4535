"""The port's LayerNorm (apex_tpu_torch.ops.layer_norm, plain PyTorch
versions on the CPU) against the JAX package: the jnp specification
(``fused_layer_norm_affine`` and its ``jax.vjp``) and the Pallas kernels
in interpret mode (``layer_norm_fwd_pallas`` / ``layer_norm_bwd_pallas``
with ``interpret=True``).

The RMS and non-affine modes, the ``memory_efficient`` backward and the
``FusedLayerNorm``/``FusedRMSNorm`` modules (flax params carried over)
are held against ``apex_tpu.normalization`` the same way.

Bands: fp32 atol 1e-5 (summation order differs between the two
frameworks' row means); bf16 outputs within 1 bf16 ulp (the fp32 values
before the final rounding differ by ulps, which can move a rounding
boundary by one step).  Backward: dx as the forward; dw/db (fp32 sums
over the rows) within 1e-5 relative to the largest |dw|, |db|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.normalization import fused_layer_norm_affine as jax_ln
from apex_tpu.ops.layer_norm_pallas import layer_norm_bwd_pallas, layer_norm_fwd_pallas

from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.ops.layer_norm import (
    layer_norm_bwd, layer_norm_bwd_plain, layer_norm_fwd, layer_norm_fwd_plain,
)

EPS = 1e-5


def _inputs(R, H, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(R, H) * 2.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(H)).astype(np.float32)
    b = (0.1 * rng.randn(H)).astype(np.float32)
    return x, w, b


def _bf16_ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 steps between two bf16 tensors."""
    def key(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((key(a) - key(b)).abs().max())


def _to_bf16_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("R,H", [(8, 768), (64, 256), (5, 96)])
def test_fp32_matches_jax_spec_and_pallas(R, H):
    x, w, b = _inputs(R, H)
    y, mean, rstd = layer_norm_fwd(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), EPS)
    ref = np.asarray(jax_ln(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), (H,), EPS))
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=1e-5)
    py, pmean, prstd = layer_norm_fwd_pallas(jnp.asarray(x), jnp.asarray(w),
                                             jnp.asarray(b), EPS, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), rtol=0, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(pmean)[:, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(prstd)[:, 0], rtol=1e-5, atol=0)


@pytest.mark.parametrize("R,H", [(8, 768), (64, 256)])
def test_bf16_within_one_ulp_of_jax(R, H):
    x, w, b = _inputs(R, H, seed=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    y, _, _ = layer_norm_fwd(_to_bf16_torch(np.asarray(xb, np.float32)),
                             torch.from_numpy(w), torch.from_numpy(b), EPS)
    assert y.dtype == torch.bfloat16
    ref = jax_ln(xb, jnp.asarray(w), jnp.asarray(b), (H,), EPS)
    assert _bf16_ulp_diff(y, _to_bf16_torch(np.asarray(ref, np.float32))) <= 1
    py, _, _ = layer_norm_fwd_pallas(xb, jnp.asarray(w), jnp.asarray(b), EPS,
                                     interpret=True)
    assert _bf16_ulp_diff(y, _to_bf16_torch(np.asarray(py, np.float32))) <= 1


def test_fused_layer_norm_affine_3d_matches_jax():
    """(S, B, H) activations normalize over the trailing dim, as the
    GPT blocks call it."""
    rng = np.random.RandomState(2)
    x = rng.randn(6, 3, 128).astype(np.float32)
    w = rng.rand(128).astype(np.float32)
    b = rng.randn(128).astype(np.float32)
    got = fused_layer_norm_affine(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(b), (128,), EPS)
    ref = jax_ln(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), (128,), EPS)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_plain_version_is_the_cpu_path():
    x, w, b = _inputs(4, 64)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), EPS)
    for got, want in zip(layer_norm_fwd(*args), layer_norm_fwd_plain(*args)):
        assert torch.equal(got, want)


def test_other_devices_raise_instead_of_falling_back():
    """Only CPU tensors take the plain version; anything else that is
    not a CUDA tensor is refused, never silently computed elsewhere."""
    x = torch.empty(8, 64, device="meta")
    w = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        layer_norm_fwd(x, w, w, EPS)


def _bwd_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    H = shape[-1]
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(H)).astype(np.float32)
    b = (0.1 * rng.randn(H)).astype(np.float32)
    return x, dy, w, b


def _assert_sums_close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


def _assert_dx_close(dx, want, dtype):
    if dtype == torch.bfloat16:
        assert _bf16_ulp_diff(dx, _to_bf16_torch(np.asarray(want, np.float32))) <= 1
    else:
        np.testing.assert_allclose(dx.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(6, 3, 128), (4, 2, 768), (5, 1, 96)])
def test_plain_bwd_matches_jax_vjp(shape, dtype):
    """dx, dw, db of the plain backward against jax.vjp of the JAX
    package's fused_layer_norm_affine on (S, B, H) activations."""
    x, dy, w, b = _bwd_inputs(shape, seed=3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj, dyj = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    H = shape[-1]
    _, vjp = jax.vjp(lambda a, ww, bb: jax_ln(a, ww, bb, (H,), EPS), xj, jnp.asarray(w),
                     jnp.asarray(b))
    rdx, rdw, rdb = vjp(dyj)
    xt = torch.from_numpy(np.array(xj, np.float32)).to(dtype).reshape(-1, H)
    dyt = torch.from_numpy(np.array(dyj, np.float32)).to(dtype).reshape(-1, H)
    wt = torch.from_numpy(w)
    _, mean, rstd = layer_norm_fwd_plain(xt, wt, torch.from_numpy(b), EPS)
    dx, dw, db = layer_norm_bwd_plain(xt, wt, dyt, mean, rstd)
    assert dx.dtype == dtype and dw.dtype == db.dtype == torch.float32
    _assert_dx_close(dx, np.asarray(rdx, np.float32).reshape(-1, H), dtype)
    _assert_sums_close(dw, rdw)
    _assert_sums_close(db, rdb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,H", [(64, 256), (16, 768)])
def test_plain_bwd_matches_pallas_interpret(R, H, dtype):
    """The Pallas backward kernel in interpret mode, fed the same x, dy,
    mean and rstd, against the plain backward."""
    x, dy, w, b = _bwd_inputs((R, H), seed=4)
    xt, dyt = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    wt = torch.from_numpy(w)
    _, mean, rstd = layer_norm_fwd_plain(xt, wt, torch.from_numpy(b), EPS)
    dx, dw, db = layer_norm_bwd(xt, wt, dyt, mean, rstd)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rdx, rdw, rdb = layer_norm_bwd_pallas(
        jnp.asarray(xt.float().numpy(), jdt), jnp.asarray(w), jnp.asarray(dyt.float().numpy(), jdt),
        jnp.asarray(mean.numpy()[:, None]), jnp.asarray(rstd.numpy()[:, None]), interpret=True)
    _assert_dx_close(dx, np.asarray(rdx, np.float32), dtype)
    _assert_sums_close(dw, np.asarray(rdw).sum(0))
    _assert_sums_close(db, np.asarray(rdb).sum(0))


def test_grads_through_fused_layer_norm_affine():
    """Autograd through the port's fused_layer_norm_affine runs the
    _LayerNormCUDA Function (saved x, mean, rstd; the plain backward on
    the CPU) and matches jax.vjp in input, weight and bias."""
    x, dy, w, b = _bwd_inputs((6, 3, 128), seed=5)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = fused_layer_norm_affine(xt, wt, bt, (128,), EPS)
    assert "_LayerNormCUDA" in type(y.grad_fn.next_functions[0][0]).__name__
    y.backward(torch.from_numpy(dy))
    _, vjp = jax.vjp(lambda a, ww, bb: jax_ln(a, ww, bb, (128,), EPS),
                     *(jnp.asarray(a) for a in (x, w, b)))
    rdx, rdw, rdb = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(rdx), rtol=0, atol=1e-5)
    _assert_sums_close(wt.grad, rdw)
    _assert_sums_close(bt.grad, rdb)
    # memory_efficient: the output is saved in place of x and xhat
    # recovered from it, as the JAX package's backward does
    xm, wm, bm = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    fused_layer_norm_affine(xm, wm, bm, (128,), EPS, memory_efficient=True).backward(
        torch.from_numpy(dy))
    _, vjp = jax.vjp(lambda a, ww, bb: jax_ln(a, ww, bb, (128,), EPS, True),
                     *(jnp.asarray(a) for a in (x, w, b)))
    rdx, rdw, rdb = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(xm.grad.numpy(), np.asarray(rdx), rtol=0, atol=1e-5)
    _assert_sums_close(wm.grad, rdw)
    _assert_sums_close(bm.grad, rdb)


def test_bwd_plain_version_is_the_cpu_path_and_other_devices_raise():
    x, dy, w, b = _bwd_inputs((8, 64), seed=6)
    args = [torch.from_numpy(a) for a in (x, w, dy)]
    _, mean, rstd = layer_norm_fwd_plain(args[0], args[1], torch.from_numpy(b), EPS)
    for got, want in zip(layer_norm_bwd(*args, mean, rstd),
                         layer_norm_bwd_plain(*args, mean, rstd)):
        assert torch.equal(got, want)
    meta = torch.empty(8, 64, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        layer_norm_bwd(meta, torch.empty(64, device="meta"), meta,
                       torch.empty(8, device="meta"), torch.empty(8, device="meta"))


# ------------------------------------------------ RMS and non-affine modes
import apex_tpu.normalization as jnorm  # noqa: E402

import apex_tpu_torch.normalization as tnorm  # noqa: E402

# the shapes of tests/test_fused_layer_norm.py: (x shape, normalized shape)
NORM_SHAPES = [((4, 16), (16,)), ((2, 3, 32), (32,)), ((5, 4, 6), (4, 6))]
# mode -> (function name, has weight, has bias, rms)
MODES = {"ln": ("fused_layer_norm", False, False, False),
         "ln_affine": ("fused_layer_norm_affine", True, True, False),
         "rms": ("fused_rms_norm", False, False, True),
         "rms_affine": ("fused_rms_norm_affine", True, False, True)}


def _mode_inputs(xshape, nshape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*xshape) * 2.0 + 0.5).astype(np.float32)
    w = (rng.rand(*nshape) + 0.5).astype(np.float32)
    b = rng.randn(*nshape).astype(np.float32)
    dy = rng.randn(*xshape).astype(np.float32)
    return x, w, b, dy


def _assert_out_close(got, want, dtype):
    if dtype == torch.bfloat16:
        assert got.dtype == torch.bfloat16
        assert _bf16_ulp_diff(got, _to_bf16_torch(np.asarray(want, np.float32))) <= 1
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("xshape,nshape", NORM_SHAPES)
def test_plain_modes_match_pallas_interpret(xshape, nshape, mode, dtype):
    """The plain forward and backward in each mode against the Pallas
    kernels in interpret mode on the (R, H) view, fed the same inputs
    (and the same mean and rstd for the backward)."""
    _, affine, with_bias, rms = MODES[mode]
    x, w, b, dy = _mode_inputs(xshape, nshape, seed=7)
    H = int(np.prod(nshape))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj, dyj = jnp.asarray(x.reshape(-1, H), jdt), jnp.asarray(dy.reshape(-1, H), jdt)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(dtype)
    dyt = torch.from_numpy(np.asarray(dyj, np.float32)).to(dtype)
    wt = torch.from_numpy(w.reshape(H)) if affine else None
    bt = torch.from_numpy(b.reshape(H)) if with_bias else None
    y, mean, rstd = layer_norm_fwd(xt, wt, bt, EPS, rms=rms)
    ry, rmean, rrstd = layer_norm_fwd_pallas(
        xj, None if wt is None else jnp.asarray(w.reshape(H)),
        None if bt is None else jnp.asarray(b.reshape(H)), EPS, rms=rms, interpret=True)
    _assert_out_close(y, ry, dtype)
    np.testing.assert_allclose(mean.numpy(), np.asarray(rmean)[:, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rrstd)[:, 0], rtol=1e-5, atol=0)
    dx, dw, db = layer_norm_bwd(xt, wt, dyt, mean, rstd, rms=rms, with_bias=with_bias)
    rdx, rdw, rdb = layer_norm_bwd_pallas(
        xj, None if wt is None else jnp.asarray(w.reshape(H)), dyj,
        jnp.asarray(mean.numpy()[:, None]), jnp.asarray(rstd.numpy()[:, None]), rms=rms,
        with_bias=with_bias, interpret=True)
    _assert_dx_close(dx, np.asarray(rdx, np.float32), dtype)
    assert (dw is None) == (rdw is None) and (db is None) == (rdb is None)
    if dw is not None:
        _assert_sums_close(dw, np.asarray(rdw).sum(0))
    if db is not None:
        _assert_sums_close(db, np.asarray(rdb).sum(0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("memory_efficient", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("xshape,nshape", NORM_SHAPES)
def test_norm_functions_match_jax_vjp(xshape, nshape, mode, memory_efficient, dtype):
    """Each public function, forward and gradients (input and params),
    against jax.vjp of the JAX package's function of the same name, with
    the memory-efficient backward on and off."""
    name, affine, with_bias, _ = MODES[mode]
    x, w, b, dy = _mode_inputs(xshape, nshape, seed=8)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj, dyj = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    params = [w] if affine else []
    params += [b] if with_bias else []

    def jfn(xx, *ps):
        return getattr(jnorm, name)(xx, *ps, nshape, 1e-5, memory_efficient)

    ry, vjp = jax.vjp(jfn, xj, *(jnp.asarray(p) for p in params))
    rgrads = vjp(dyj)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(dtype).requires_grad_()
    pt = [torch.from_numpy(p).requires_grad_() for p in params]
    y = getattr(tnorm, name)(xt, *pt, nshape, 1e-5, memory_efficient)
    _assert_out_close(y, ry, dtype)
    y.backward(torch.from_numpy(np.asarray(dyj, np.float32)).to(dtype))
    H = int(np.prod(nshape))
    _assert_dx_close(xt.grad.reshape(-1, H), np.asarray(rgrads[0], np.float32).reshape(-1, H),
                     dtype)
    if dtype == torch.bfloat16 and memory_efficient:
        # xhat is recovered from the bf16 output, where the two packages
        # may round one element a bf16 step apart (the forward's band):
        # (y - b) / w then moves by up to 2**-8 |y| / |w| in that row
        yf = np.abs(np.asarray(ry, np.float32)).reshape(-1, H)
        step = 2.0 ** -8 * yf.max() / (np.abs(w).min() if affine else 1.0)
        band = step * np.abs(np.asarray(dyj, np.float32)).reshape(-1, H).sum(0).max()
        for p, r in zip(pt, rgrads[1:]):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-5 * max(1.0, _scale_of(r)) + band)
        return
    for p, r in zip(pt, rgrads[1:]):
        _assert_sums_close(p.grad, r)


def _scale_of(a):
    return float(np.abs(np.asarray(a, np.float32)).max())


def test_manual_rms_norm_and_mixed_aliases_match_jax():
    x, w, _, _ = _mode_inputs((3, 5, 32), (32,), seed=9)
    got = tnorm.manual_rms_norm(torch.from_numpy(x), (32,), torch.from_numpy(w), 1e-5)
    want = jnorm.manual_rms_norm(jnp.asarray(x), (32,), jnp.asarray(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w)
    assert torch.equal(tnorm.mixed_dtype_fused_rms_norm_affine(xb, wt, (32,)),
                       tnorm.fused_rms_norm_affine(xb, wt, (32,)))
    bt = torch.zeros(32)
    assert torch.equal(tnorm.mixed_dtype_fused_layer_norm_affine(xb, wt, bt, (32,)),
                       tnorm.fused_layer_norm_affine(xb, wt, bt, (32,)))
    assert tnorm.MixedFusedLayerNorm is tnorm.FusedLayerNorm
    assert tnorm.MixedFusedRMSNorm is tnorm.FusedRMSNorm


@pytest.mark.parametrize("memory_efficient", [False, True])
@pytest.mark.parametrize("rms,affine", [(False, True), (False, False), (True, True),
                                        (True, False)])
def test_modules_with_flax_params_match_jax(rms, affine, memory_efficient):
    """FusedLayerNorm / FusedRMSNorm with the flax module's params
    (perturbed from their ones/zeros init) carried over: output and the
    gradients of input and params."""
    x, w, b, dy = _mode_inputs((4, 3, 32), (32,), seed=10)
    jcls = jnorm.FusedRMSNorm if rms else jnorm.FusedLayerNorm
    jm = jcls(normalized_shape=(32,), elementwise_affine=affine,
              memory_efficient=memory_efficient)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    if affine:
        params["params"]["weight"] = w
        if not rms:
            params["params"]["bias"] = b
    tcls = tnorm.FusedRMSNorm if rms else tnorm.FusedLayerNorm
    tm = tcls((32,), elementwise_affine=affine, memory_efficient=memory_efficient,
              device="cpu").load_flax_params(params)
    assert all(p.dtype == torch.float32 for p in tm.parameters())

    def jloss(p, xx):
        return jnp.sum(jm.apply(p, xx) * jnp.asarray(dy))

    ry = jm.apply(params, jnp.asarray(x))
    rgp, rgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = tm(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry), rtol=0, atol=1e-5)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(rgx), rtol=0, atol=1e-5)
    for name, p in tm.named_parameters():
        _assert_sums_close(p.grad, rgp["params"][name])


def test_modules_default_to_cuda_and_refuse_wrong_params():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnorm.FusedLayerNorm(32)
    m = tnorm.FusedRMSNorm(32, device="cpu")
    with pytest.raises(ValueError, match="expected params"):
        m.load_flax_params({"weight": np.ones(32), "bias": np.zeros(32)})
    with pytest.raises(ValueError, match="shape"):
        m.load_flax_params({"params": {"weight": np.ones(16)}})
