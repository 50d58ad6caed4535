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


# ------------------------------------------------------------ the plan
import re  # noqa: E402
from pathlib import Path  # noqa: E402

from apex_tpu_torch import sample_tiles as ST  # noqa: E402
from apex_tpu_torch.flash_bwd_tiles import variant_source  # noqa: E402
from apex_tpu_torch.ops import decode_sampling as S  # noqa: E402

_SRC = Path(S.__file__).parents[1] / "csrc" / "decode_sampling.cu"


@pytest.mark.parametrize("H", [1600, 2048])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_tokens_bitwise_jax_fp32_wide(H, temperature):
    """At the widths the kernel now takes past the old 1504 limit, the
    plain version's tokens are ``fused_sample_xla``'s in fp32."""
    rng = np.random.RandomState(5)
    x2, emb, seeds = _case(rng, N=6, H=H, V=311)
    got = fused_sample(torch.from_numpy(x2), torch.from_numpy(emb),
                       torch.from_numpy(seeds.astype(np.int64)), temperature, 0)
    want = fused_sample_xla(jnp.asarray(x2), jnp.asarray(emb), jnp.asarray(seeds),
                            temperature, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("H", [768, 1600, 2048, S.MAX_HIDDEN])
def test_problem_admits_the_wide_widths(H):
    """The kernel's checks take any H % 4 == 0 up to ``MAX_HIDDEN``
    (1600 and 2048 raised before) and refuse the rest."""
    def shapes(h, dtype=torch.bfloat16):
        return (torch.empty(3, h, dtype=dtype, device="meta"),
                torch.empty(50, h, device="meta"),
                torch.empty(3, dtype=torch.int64, device="meta"))
    assert S._shape_problem(*shapes(H)) is None
    assert S._shape_problem(*shapes(H, torch.float32)) is None
    assert "multiple of 4" in S._shape_problem(*shapes(H + 2))
    assert "multiple of 4" in S._shape_problem(*shapes(S.MAX_HIDDEN + 4))


def test_sample_plan_fits_the_card():
    """At N from 1 to 256 and H from 4 to 8192 in steps of 4 (V = 50304,
    132 SMs), a block fits shared memory at the opt-in limit; the first
    pass's n-tiles of 8 hold all its rows; a warp serves each 16 vocab
    rows of a tile; the passes cover N; the blocks are at most one a
    vocab tile and ``blocks_per_sm`` an SM.  The plan does not depend on
    H."""
    t = S.SAMPLE_TILES
    V, sms = 50304, 132
    ntiles = -(-V // t["vocab_tile"])
    for N in range(1, 257):
        plan = S.sample_plan(N, 4, V, sms)
        n = min(N, t["row_cap"])
        assert plan.passes * plan.row_cap >= N > (plan.passes - 1) * plan.row_cap
        assert 8 * plan.n_tiles >= n > 8 * (plan.n_tiles - 1)
        assert plan.warps * 16 == plan.vocab_tile and plan.warps <= 8
        assert plan.blocks == min(ntiles, t["blocks_per_sm"] * sms)
        assert 0 < plan.smem_bytes <= 232448 and plan.smem_bytes % 16 == 0
        for H in range(4, 8193, 4):
            assert S.sample_plan(N, H, V, sms) == plan
    with pytest.raises(ValueError):
        S.sample_plan(8, 770, V, sms)


def test_sample_plan_is_the_kernel_source_plan():
    """``SAMPLE_TILES`` holds the constants of csrc/decode_sampling.cu's
    SampleTiles, and the plan gives the shared memory its header reckons:
    two stages of 128 vocab rows and the pass's x rows rounded up to 8,
    32 columns (row stride 36 fp32), and a bf16 landing area; then the 8
    warps' best (value, index) of 64 rows."""
    body = re.search(r"struct SampleTiles \{(.*?)\n\};", _SRC.read_text(), re.S).group(1)
    consts = {k: int(v) for k, v in re.findall(r"static constexpr int (\w+) = (\d+);", body)}
    assert {ST.CONSTANTS[k]: v for k, v in consts.items()} == S.SAMPLE_TILES
    plan = S.sample_plan(40, 768, 50304, 132)
    assert (plan.n_tiles, plan.warps, plan.blocks) == (5, 8, 393)
    assert plan.smem_bytes == 2 * ((128 + 40) * 36 + 40 * 16) * 4 + 8 * 64 * 8
    assert S.sample_plan(1, 768, 50304, 132).smem_bytes == (
        2 * ((128 + 8) * 36 + 8 * 16) * 4 + 8 * 64 * 8)


@pytest.mark.parametrize("variant", sorted(ST.VARIANTS))
def test_sample_tile_variants_apply_to_the_kernel_source(variant):
    """``sample_tiles`` builds each variant by giving SampleTiles'
    constants new values: every other line stays, and the new tiles are
    ones the kernel takes."""
    src = _SRC.read_text()
    out = variant_source(src, ST.VARIANTS[variant])
    changed = [(a, b) for a, b in zip(src.splitlines(), out.splitlines()) if a != b]
    assert len(src.splitlines()) == len(out.splitlines())
    assert changed and {b.split("=")[0].split()[-1] for _, b in changed} <= set(ST.CONSTANTS)
    tiles = ST.tiles_of({c: int(v) for (_, c), v in ST.VARIANTS[variant].items()})
    assert tiles != S.SAMPLE_TILES and ST.valid_sample_tiles(tiles)


@pytest.mark.parametrize("ablation", sorted(ST.ABLATIONS) + sorted(ST.REWRITES))
def test_sample_ablations_apply_to_the_kernel_source(ablation):
    """Each ablation and rewrite ``sample_tiles`` times changes its part
    of the score kernel: every text it replaces is in the source once,
    and nothing else changes."""
    pairs = {**ST.ABLATIONS, **ST.REWRITES}[ablation]
    src = _SRC.read_text()
    out = ST.ablated_source(src, pairs)
    assert out != src
    assert len(src) - len(out) == sum(len(a) - len(b) for a, b in pairs)
