"""The port's paged decode attention (apex_tpu_torch.ops.decode_attention,
plain PyTorch version on the CPU) against the JAX package's
``decode_attention_xla`` (the numerics specification) and the Pallas
kernel in interpret mode (``paged_decode_attention_pallas``), on the
shapes of tests/test_inference.py: GQA, partial and inactive rows,
clamped page ids, and bf16 pools widened at the read.

Bands: fp32 atol 1e-5 (reduction order differs between frameworks,
and the Pallas kernel's online softmax against the full softmax);
bf16 outputs within 2 bf16 ulps of the JAX reference (the
probabilities round to bf16 before P.V in both, and a ulp-level
difference in a probability can move the output's rounding by a step).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.ops.decode_attention_pallas import (
    decode_attention_xla, paged_decode_attention_pallas,
)

from apex_tpu_torch.ops.decode_attention import (
    decode_attention_plain, paged_decode_attention,
)


def _case(rng, B=3, H=4, KVH=2, D=16, num_pages=9, page=8, P=4):
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(num_pages, page, KVH, D).astype(np.float32)
    vp = rng.randn(num_pages, page, KVH, D).astype(np.float32)
    pt = rng.randint(1, num_pages, size=(B, P)).astype(np.int32)
    return q, kp, vp, pt


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _bf16_ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    def key(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((key(a) - key(b)).abs().max())


@pytest.mark.parametrize("H,KVH", [(4, 2), (4, 4), (4, 1)])
def test_fp32_matches_jax_gqa_partial_inactive(H, KVH):
    rng = np.random.RandomState(0)
    q, kp, vp, pt = _case(rng, H=H, KVH=KVH)
    lengths = np.asarray([0, 5, 25], np.int32)  # inactive / tail / full
    out = paged_decode_attention(*_torch(q, kp, vp, pt, lengths))
    args = [jnp.asarray(a) for a in (q, kp, vp, pt, lengths)]
    np.testing.assert_allclose(out.numpy(), np.asarray(decode_attention_xla(*args)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(paged_decode_attention_pallas(*args, interpret=True)),
        rtol=0, atol=1e-5)
    assert float(out[0].abs().max()) == 0.0, "a length-0 row must attend to nothing"


def test_bf16_pools_widen_at_read():
    rng = np.random.RandomState(1)
    q, kp, vp, pt = _case(rng)
    lengths = np.asarray([8, 16, 32], np.int32)
    kb, vb = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
    tq, tpt, tlen = _torch(q, pt, lengths)
    tk = torch.from_numpy(np.asarray(kb, np.float32)).to(torch.bfloat16)
    tv = torch.from_numpy(np.asarray(vb, np.float32)).to(torch.bfloat16)
    out = paged_decode_attention(tq, tk, tv, tpt, tlen)
    assert out.dtype == torch.bfloat16
    ref = decode_attention_xla(jnp.asarray(q), kb, vb, jnp.asarray(pt), jnp.asarray(lengths))
    ref_t = torch.from_numpy(np.asarray(ref, np.float32)).to(torch.bfloat16)
    assert _bf16_ulp_diff(out, ref_t) <= 2


def test_out_of_range_page_ids_clamp_not_wrap():
    """A corrupt table (negative or past-the-pool ids) reads exactly
    what its clamped self reads, and what the JAX reference reads."""
    rng = np.random.RandomState(2)
    q, kp, vp, _ = _case(rng, B=2, P=3)
    pt_bad = np.asarray([[-3, 2, 99], [1, -1, 1000]], np.int32)
    pt_ok = np.clip(pt_bad, 0, kp.shape[0] - 1)
    lengths = np.asarray([20, 24], np.int32)
    bad = paged_decode_attention(*_torch(q, kp, vp, pt_bad, lengths))
    ok = paged_decode_attention(*_torch(q, kp, vp, pt_ok, lengths))
    assert torch.equal(bad, ok)
    ref = decode_attention_xla(*[jnp.asarray(a) for a in (q, kp, vp, pt_bad, lengths)])
    np.testing.assert_allclose(bad.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_serve_shape_page_boundary_lengths():
    """The serve layout (page 16, head dim 64) with lengths on and next
    to page boundaries."""
    rng = np.random.RandomState(3)
    q, kp, vp, pt = _case(rng, B=5, H=6, KVH=3, D=64, num_pages=20, page=16, P=4)
    lengths = np.asarray([1, 15, 16, 17, 64], np.int32)
    out = paged_decode_attention(*_torch(q, kp, vp, pt, lengths))
    ref = decode_attention_xla(*[jnp.asarray(a) for a in (q, kp, vp, pt, lengths)])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_width_above_one_is_not_ported():
    rng = np.random.RandomState(4)
    q, kp, vp, pt = _torch(*_case(rng))
    lengths = torch.tensor([1, 2, 3], dtype=torch.int32)
    for fn in (paged_decode_attention, decode_attention_plain):
        with pytest.raises(NotImplementedError, match="width"):
            fn(q, kp, vp, pt, lengths, width=2)


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty(2, 4, 16, device="meta")
    pool = torch.empty(3, 8, 2, 16, device="meta")
    pt = torch.empty(2, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        paged_decode_attention(q, pool, pool, pt, pt[:, 0])
