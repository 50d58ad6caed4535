"""The port's LayerNorm forward (apex_tpu_torch.ops.layer_norm, plain
PyTorch version on the CPU) against the JAX package: the jnp
specification (``fused_layer_norm_affine``) and the Pallas kernel in
interpret mode (``layer_norm_fwd_pallas(interpret=True)``).

Bands: fp32 atol 1e-5 (summation order differs between the two
frameworks' row means); bf16 outputs within 1 bf16 ulp (the fp32 values
before the final rounding differ by ulps, which can move a rounding
boundary by one step).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.normalization import fused_layer_norm_affine as jax_ln
from apex_tpu.ops.layer_norm_pallas import layer_norm_fwd_pallas

from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.ops.layer_norm import layer_norm_fwd, layer_norm_fwd_plain

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
