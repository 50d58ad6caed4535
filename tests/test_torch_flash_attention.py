"""The port's flash attention (apex_tpu_torch.ops.flash_attention and
ops.attention, plain PyTorch versions on the CPU) against the JAX
package: the scan specification (``_attend_fwd_scan``,
``flash_bwd_from_lse``, ``jax.vjp`` of ``flash_attention(impl="scan")``)
and the Pallas kernels in interpret mode (``flash_fwd_pallas``,
``flash_bwd_pallas``).

Cases: causal and not, GQA (kv heads 2 and 1), q/k offsets, a key
padding mask, and offsets that leave rows with no visible key (their
output must be exactly 0 and their gradients finite).  The flash
causal mask is top-left aligned, so it is compared with
``mha_reference`` (bottom-right aligned) only at Sq == Sk.

Bands: fp32 atol 1e-5 (the same fp32 arithmetic summed in another order
by two frameworks; values are O(1)); bf16 outputs one bf16 step apart at
most (both fp32 inside, one final rounding each).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops import attention as jatt
from apex_tpu.ops.flash_attention_pallas import flash_bwd_pallas, flash_fwd_pallas

from apex_tpu_torch.flash_bwd_tiles import VARIANTS, variant_source
from apex_tpu_torch.ops import attention as tatt
from apex_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5

#: name -> (causal, H, H_kv, Sq, Sk, q_offset, k_offset, masked)
CASES = {
    "causal": (True, 4, 4, 64, 64, 0, 0, False),
    "non_causal": (False, 4, 4, 64, 64, 0, 0, False),
    "gqa2": (True, 4, 2, 64, 64, 0, 0, False),
    "mqa": (True, 4, 1, 64, 64, 0, 0, False),
    "offsets": (True, 2, 2, 32, 64, 64, 32, False),
    "kv_mask": (False, 2, 1, 48, 48, 0, 0, True),
    "masked_rows": (True, 2, 2, 32, 32, 0, 16, False),
}
B, D = 2, 32


def _inputs(case, seed=0, d=D):
    causal, H, Hkv, Sq, Sk, qo, ko, masked = CASES[case]
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Sq, d).astype(np.float32)
    k = rng.randn(B, Hkv, Sk, d).astype(np.float32)
    v = rng.randn(B, Hkv, Sk, d).astype(np.float32)
    do = rng.randn(B, H, Sq, d).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, Sk), bool)
        mask[1, Sk - 20:] = False
    return dict(causal=causal, H=H, Hkv=Hkv, qo=qo, ko=ko, q=q, k=k, v=v, do=do, mask=mask)


def _flat(x):
    return x.reshape(-1, x.shape[2], x.shape[3])


def _torch_bias(mask):
    return None if mask is None else tatt.padding_bias(torch.from_numpy(mask))[:, None, :]


def _jax_bias(mask):
    return None if mask is None else jatt.padding_bias(jnp.asarray(mask))


def _repeat(k, H):
    return np.repeat(k, H // k.shape[1], axis=1)


def _fwd_plain(c):
    return tfa.flash_fwd_plain(
        torch.from_numpy(_flat(c["q"])), torch.from_numpy(_flat(c["k"])),
        torch.from_numpy(_flat(c["v"])), 1 / np.sqrt(c["q"].shape[-1]), c["causal"],
        c["qo"], c["ko"], kv_bias=_torch_bias(c["mask"]), heads=c["H"], kv_heads=c["Hkv"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_fwd_matches_jax_scan(case):
    c = _inputs(case)
    out, lse = _fwd_plain(c)
    ref, ref_lse = jatt._attend_fwd_scan(
        jnp.asarray(c["q"]), jnp.asarray(_repeat(c["k"], c["H"])),
        jnp.asarray(_repeat(c["v"], c["H"])), 1 / np.sqrt(D), c["causal"], c["qo"],
        c["ko"], 256, kv_bias=_jax_bias(c["mask"]))
    np.testing.assert_allclose(out.numpy(), _flat(np.asarray(ref)), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse.numpy()[..., 0], np.asarray(ref_lse).reshape(lse.shape[:2]),
                               rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("case", ["causal", "gqa2", "offsets", "kv_mask"])
def test_plain_fwd_and_bwd_match_jax_scan_at_head_dims(case, d):
    """The other head widths the bf16 kernels are built for (16, 64 and
    128 beside the module's 32): the plain forward against
    ``_attend_fwd_scan`` and the plain backward against
    ``flash_bwd_from_lse``, at the same band."""
    c = _inputs(case, seed=d, d=d)
    H, Hkv, scale = c["H"], c["Hkv"], 1 / np.sqrt(d)
    out, lse = _fwd_plain(c)
    k4, v4 = (jnp.asarray(_repeat(c[n], H)) for n in ("k", "v"))
    ref, ref_lse = jatt._attend_fwd_scan(
        jnp.asarray(c["q"]), k4, v4, scale, c["causal"], c["qo"], c["ko"], 256,
        kv_bias=_jax_bias(c["mask"]))
    np.testing.assert_allclose(out.numpy(), _flat(np.asarray(ref)), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse.numpy()[..., 0], np.asarray(ref_lse).reshape(lse.shape[:2]),
                               rtol=1e-6, atol=ATOL)
    do = torch.from_numpy(_flat(c["do"]))
    delta = (do * out).sum(-1, keepdim=True)
    args = (torch.from_numpy(_flat(c["q"])), torch.from_numpy(_flat(c["k"])),
            torch.from_numpy(_flat(c["v"])), do, lse, delta, scale, c["causal"], c["qo"],
            c["ko"])
    kw = dict(kv_bias=_torch_bias(c["mask"]), heads=H, kv_heads=Hkv)
    dq, (dk, dv) = tfa.flash_dq_plain(*args, **kw), tfa.flash_dkv_plain(*args, **kw)
    rq = jatt.flash_bwd_from_lse(
        jnp.asarray(c["q"]), k4, v4, jnp.asarray(c["do"]),
        jnp.asarray(lse.numpy().reshape(c["do"].shape[:3])),
        jnp.asarray(delta.numpy().reshape(c["do"].shape[:3])), scale, c["causal"], c["qo"],
        c["ko"], 256, kv_bias=_jax_bias(c["mask"]))
    g = H // Hkv
    rdq, rdk, rdv = (np.asarray(r) for r in rq[:3])
    rdk = rdk.reshape(B, Hkv, g, *rdk.shape[2:]).sum(2)
    rdv = rdv.reshape(B, Hkv, g, *rdv.shape[2:]).sum(2)
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        np.testing.assert_allclose(got.numpy(), _flat(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["causal", "gqa2", "offsets", "kv_mask", "masked_rows"])
def test_plain_fwd_matches_pallas_interpret(case):
    c = _inputs(case)
    out, lse = _fwd_plain(c)
    bias = _jax_bias(c["mask"])
    ref, ref_lse = flash_fwd_pallas(
        jnp.asarray(_flat(c["q"])), jnp.asarray(_flat(c["k"])), jnp.asarray(_flat(c["v"])),
        1 / np.sqrt(D), c["causal"], c["qo"], c["ko"], block_q=32, block_k=32,
        interpret=True, kv_bias=None if bias is None else bias[:, None, :],
        heads=c["H"], kv_heads=c["Hkv"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=1e-6, atol=ATOL)


def _bwd_plain(c, out, lse):
    do = torch.from_numpy(_flat(c["do"]))
    delta = (do * out).sum(-1, keepdim=True)
    args = (torch.from_numpy(_flat(c["q"])), torch.from_numpy(_flat(c["k"])),
            torch.from_numpy(_flat(c["v"])), do, lse, delta, 1 / np.sqrt(D), c["causal"],
            c["qo"], c["ko"])
    kw = dict(kv_bias=_torch_bias(c["mask"]), heads=c["H"], kv_heads=c["Hkv"])
    return tfa.flash_dq_plain(*args, **kw), *tfa.flash_dkv_plain(*args, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_bwd_matches_flash_bwd_from_lse(case):
    c = _inputs(case)
    out, lse = _fwd_plain(c)
    dq, dk, dv = _bwd_plain(c, out, lse)
    H, Hkv = c["H"], c["Hkv"]
    do = c["do"]
    delta = (do * out.numpy().reshape(do.shape)).sum(-1)
    ref = jatt.flash_bwd_from_lse(
        jnp.asarray(c["q"]), jnp.asarray(_repeat(c["k"], H)), jnp.asarray(_repeat(c["v"], H)),
        jnp.asarray(do), jnp.asarray(lse.numpy().reshape(do.shape[:3])), jnp.asarray(delta),
        1 / np.sqrt(D), c["causal"], c["qo"], c["ko"], 256, kv_bias=_jax_bias(c["mask"]))
    rdq, rdk, rdv = (np.asarray(r) for r in ref[:3])
    g = H // Hkv
    rdk = rdk.reshape(B, Hkv, g, *rdk.shape[2:]).sum(2)
    rdv = rdv.reshape(B, Hkv, g, *rdv.shape[2:]).sum(2)
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        np.testing.assert_allclose(got.numpy(), _flat(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_matches_jax_grad_of_scan(case):
    """The port's flash_attention (the autograd Function, plain versions
    on the CPU) against jax.vjp of flash_attention(impl="scan")."""
    c = _inputs(case)
    tq, tk, tv = (torch.from_numpy(c[n]).requires_grad_() for n in ("q", "k", "v"))
    mask = None if c["mask"] is None else torch.from_numpy(c["mask"])
    out = tatt.flash_attention(tq, tk, tv, causal=c["causal"], q_offset=c["qo"],
                               k_offset=c["ko"], kv_mask=mask)
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(c["do"]))

    def f(q, k, v):
        return jatt.flash_attention(q, k, v, causal=c["causal"], q_offset=c["qo"],
                                    k_offset=c["ko"], impl="scan",
                                    kv_mask=None if c["mask"] is None else jnp.asarray(c["mask"]))

    ref, vjp = jax.vjp(f, *(jnp.asarray(c[n]) for n in ("q", "k", "v")))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(c["do"]))):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_fully_masked_rows_are_zero_not_nan():
    c = _inputs("masked_rows")  # q positions 0..31, keys at 16..47: rows 0..15 see nothing
    out, lse = _fwd_plain(c)
    dead = out.reshape(B, c["H"], 32, D)[:, :, :16]
    assert torch.equal(dead, torch.zeros_like(dead))
    assert bool((lse.reshape(B, c["H"], 32)[:, :, :16] < -1e29).all())
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    dq, dk, dv = _bwd_plain(c, out, lse)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert torch.equal(dq.reshape(B, c["H"], 32, D)[:, :, :16],
                       torch.zeros_like(dead))


def test_pallas_interpret_backward_matches_plain():
    """The Pallas dq/dkv kernels in interpret mode (tiny shape, explicit
    32-row blocks) against the port's plain backward, GQA and causal."""
    c = _inputs("gqa2")
    out, lse = _fwd_plain(c)
    dq, dk, dv = _bwd_plain(c, out, lse)
    rdq, rdk, rdv = flash_bwd_pallas(
        jnp.asarray(_flat(c["q"])), jnp.asarray(_flat(c["k"])), jnp.asarray(_flat(c["v"])),
        jnp.asarray(out.numpy()), jnp.asarray(lse.numpy()), jnp.asarray(_flat(c["do"])),
        1 / np.sqrt(D), True, 0, 0, block_q=32, block_k=32, interpret=True,
        heads=c["H"], kv_heads=c["Hkv"])
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_mha_reference_agrees_at_equal_lengths():
    c = _inputs("gqa2")
    args = [torch.from_numpy(c[n]) for n in ("q", "k", "v")]
    got = tatt.mha_reference(*args, causal=True)
    want = jatt.mha_reference(*(jnp.asarray(c[n]) for n in ("q", "k", "v")), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tatt.flash_attention(*args, causal=True).numpy(),
                               got.numpy(), rtol=0, atol=ATOL)


def test_bf16_forward_within_one_ulp_of_jax():
    c = _inputs("gqa2")
    qb, kb, vb = (jnp.asarray(c[n], jnp.bfloat16) for n in ("q", "k", "v"))
    want = jatt.flash_attention(qb, kb, vb, causal=True, impl="scan")
    got = tatt.flash_attention(*(torch.from_numpy(np.asarray(t, np.float32)).to(torch.bfloat16)
                                 for t in (qb, kb, vb)), causal=True)
    assert got.dtype == torch.bfloat16
    # one bf16 step apart at most: 2**-7 relative, or 1e-6 absolute where
    # the two fp32 values straddle zero and round to opposite signs
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2.0 ** -7, atol=1e-6)


def test_flash_attention_with_lse_and_refusals():
    c = _inputs("offsets")
    args = [torch.from_numpy(c[n]) for n in ("q", "k", "v")]
    k4, v4 = (torch.from_numpy(_repeat(c[n], c["H"])) for n in ("k", "v"))
    out, lse = tatt.flash_attention_with_lse(args[0], k4, v4, q_offset=64, k_offset=32)
    ref, ref_lse = jatt.flash_attention_with_lse(
        jnp.asarray(c["q"]), jnp.asarray(k4.numpy()), jnp.asarray(v4.numpy()),
        q_offset=64, k_offset=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=1e-6, atol=ATOL)
    # attn_bias is ported (the scan path): a zero bias changes nothing
    sk = args[1].shape[2]
    biased = tatt.flash_attention(*args, attn_bias=torch.zeros(sk))
    ref = jatt.flash_attention(*(jnp.asarray(c[n]) for n in ("q", "k", "v")),
                               attn_bias=jnp.zeros(sk), impl="scan")
    np.testing.assert_allclose(biased.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    meta = torch.empty(2, 64, 32, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        tfa.flash_fwd(meta, meta, meta, 0.1, True)


#: (Sq, Sk, causal, q_offset, k_offset) of the bf16 backward's schedule
#: tests: the training shape, ragged S, a ring-attention chunk (q rows
#: 512.. of 1024 keys), offsets that leave rows with no visible key, and
#: keys ahead of every q row
PLAN_SHAPES = {
    "gpt124": (1024, 1024, True, 0, 0),
    "non_causal": (1024, 1024, False, 0, 0),
    "ragged": (1000, 1000, True, 0, 0),
    "ragged_non_causal": (1000, 1000, False, 0, 0),
    "chunk": (512, 1024, True, 512, 0),
    "offsets": (1000, 1000, True, 0, 100),
    "keys_ahead": (200, 300, True, 0, 250),
    "short": (100, 50, True, 20, 0),
}


@pytest.mark.parametrize("which", [1, 2])
@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_bwd_launch_plan_visits_each_visible_tile_pair_once(shape, which):
    """dq (1) and dkv (2) blocks, walking the tiles the plan gives them,
    cover every visible (q row, key) entry exactly once, visit no tile
    pair wholly above the diagonal, and launch causal blocks heaviest
    first."""
    Sq, Sk, causal, qo, ko = PLAN_SHAPES[shape]
    plan = tfa.bwd_launch_plan(which, Sq, Sk, 64, causal, qo, ko)
    R, N = plan.rows_per_block, plan.tile_rows
    assert sorted(plan.order) == list(range(-(-(Sq if which == 1 else Sk) // R)))
    i, j = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    visible = (qo + i >= ko + j) if causal else np.ones((Sq, Sk), bool)
    cover = np.zeros((Sq, Sk), np.int32)
    work = []
    for blk in plan.order:
        work.append(plan.last[blk] - plan.first[blk] + 1)
        for tile in range(plan.first[blk], plan.last[blk] + 1):
            rb, cb = (blk * R, tile * N) if which == 1 else (tile * N, blk * R)
            rows = slice(rb, min(Sq, rb + (R if which == 1 else N)))
            cols = slice(cb, min(Sk, cb + (N if which == 1 else R)))
            assert visible[rows, cols].any(), (blk, tile)
            cover[rows, cols] += 1
    assert (cover[visible] == 1).all() and (cover[~visible] <= 1).all()
    if causal:
        assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("which", [1, 2])
@pytest.mark.parametrize("d", range(16, 129, 16))
def test_bwd_launch_plan_fits_the_card(d, which):
    plan = tfa.bwd_launch_plan(which, 1024, 1024, d, True)
    assert 0 < plan.smem_bytes <= tfa._SMEM_LIMIT
    assert plan.smem_bytes % 16 == 0


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tile_variants_apply_to_the_kernel_source(variant):
    """``flash_bwd_tiles`` builds each variant by giving constants of the
    kernels' Dq/Dkv structs new values: each constant is still in its
    struct, and the variant changes exactly those lines, to new values."""
    src = (Path(tfa.__file__).parents[1] / "csrc" / "flash_attention.cu").read_text()
    out = variant_source(src, VARIANTS[variant])
    changed = [(a, b) for a, b in zip(src.splitlines(), out.splitlines()) if a != b]
    assert len(src.splitlines()) == len(out.splitlines())
    assert sorted(b.split("=")[0].split()[-1] for _, b in changed) == sorted(
        name for _, name in VARIANTS[variant])
