"""The port's fused sampling head (apex_tpu_torch.ops.decode_sampling,
plain PyTorch version on the CPU) against the JAX package's
``decode_sampling_pallas``: the counter hash bitwise, the Gumbel noise
within 1 fp32 ulp of max(|g|, 1) (``log`` differs by at most an ulp
between the two frameworks' CPU math libraries), and the sampled tokens of
``fused_sample_xla`` bitwise in fp32, ties included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.ops.decode_sampling_pallas import (
    _hash_u32, fused_sample_xla, gumbel_from_seed as jax_gumbel,
)

from apex_tpu_torch.ops.decode_sampling import (
    fused_sample, fused_sample_plain, gumbel_from_seed, hash_u32,
)


def _seeds(rng, n):
    """uint32 seeds, half of them with the high bit set."""
    lo = rng.randint(0, 2 ** 31, size=n).astype(np.uint64)
    hi = lo | np.uint64(1 << 31)
    return np.where(np.arange(n) % 2 == 0, lo, hi).astype(np.uint32)


def test_hash_is_bitwise_jax():
    rng = np.random.RandomState(0)
    seeds = np.concatenate([_seeds(rng, 4096),
                            np.asarray([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint32)])
    got = hash_u32(torch.from_numpy(seeds.astype(np.int64)))
    want = np.asarray(_hash_u32(jnp.asarray(seeds)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_gumbel_within_one_ulp_of_jax():
    rng = np.random.RandomState(1)
    seeds = _seeds(rng, 256)
    cols = np.arange(513, dtype=np.int32)
    got = gumbel_from_seed(torch.from_numpy(seeds.astype(np.int64))[:, None],
                           torch.from_numpy(cols)[None, :])
    want = np.asarray(jax_gumbel(jnp.asarray(seeds)[:, None], jnp.asarray(cols)[None, :]))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    # 1 ulp at the noise's scale: where g crosses 0, a 1-ulp difference
    # in the inner log is many ulps of the tiny g itself
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
    assert np.all(np.abs(got.numpy() - want) <= ulp)


def _case(rng, N=5, H=32, V=307):
    x2 = rng.randn(N, H).astype(np.float32)
    emb = rng.randn(V, H).astype(np.float32)
    return x2, emb, _seeds(rng, N)


def _with_ties(x2, emb, k):
    """Copy each row's k-th largest column into three other columns and
    row 0's argmax column into one more, so both the greedy argmax and
    the top-k threshold see exact ties."""
    emb = emb.copy()
    logits = x2 @ emb.T
    V = emb.shape[0]
    for n in range(x2.shape[0]):
        order = np.argsort(-logits[n], kind="stable")
        kth = order[k - 1]
        for j in range(3):
            emb[(kth + 37 * (j + 1) + 11 * n) % V] = emb[kth]
    top = int(np.argmax(logits[0]))
    emb[(top + 101) % V] = emb[top]
    return emb


@pytest.mark.parametrize("temperature,top_k", [
    (0.0, 0), (0.8, 0), (0.0, 6), (0.8, 6), (0.8, 1), (0.8, 400)])
@pytest.mark.parametrize("ties", [False, True])
def test_tokens_bitwise_jax_fp32(temperature, top_k, ties):
    rng = np.random.RandomState(2)
    x2, emb, seeds = _case(rng)
    if ties:
        emb = _with_ties(x2, emb, 6)
    got = fused_sample(torch.from_numpy(x2), torch.from_numpy(emb),
                       torch.from_numpy(seeds.astype(np.int64)), temperature, top_k)
    want = fused_sample_xla(jnp.asarray(x2), jnp.asarray(emb), jnp.asarray(seeds),
                            temperature, top_k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_k_restricts_support():
    rng = np.random.RandomState(3)
    x2, emb, _ = _case(rng, N=1)
    k = 7
    topset = set(np.argsort(-(x2 @ emb.T)[0])[:k].tolist())
    xs = torch.from_numpy(np.repeat(x2, 256, axis=0))
    toks = fused_sample_plain(xs, torch.from_numpy(emb), torch.arange(256), 0.8, k)
    assert set(toks.tolist()) <= topset and len(set(toks.tolist())) > 1


def test_bf16_hidden_is_widened():
    """bf16 hidden states are scored against the fp32 embed in fp32,
    exactly as their fp32 widening."""
    rng = np.random.RandomState(4)
    x2, emb, seeds = _case(rng)
    xb = torch.from_numpy(x2).to(torch.bfloat16)
    s = torch.from_numpy(seeds.astype(np.int64))
    e = torch.from_numpy(emb)
    assert torch.equal(fused_sample(xb, e, s, 0.8, 0), fused_sample(xb.float(), e, s, 0.8, 0))


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty(2, 32, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        fused_sample(x, torch.empty(50, 32, device="meta"),
                     torch.empty(2, dtype=torch.int64, device="meta"))
