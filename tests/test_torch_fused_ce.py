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

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.fused_ce import fused_lm_head_ce as jax_fused_ce
from apex_tpu.ops.fused_ce_pallas import fused_ce_bwd_pallas, fused_ce_fwd_pallas

from apex_tpu_torch.ce_bwd_tiles import (
    ABLATIONS, STRUCTS, VARIANTS, ablated_source, valid_plan,
)
from apex_tpu_torch.flash_bwd_tiles import variant_source
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
    # the vocab-parallel combine runs: over a one-rank group it is the
    # single-device head (world 2 and 4 in tests/test_torch_tensor_parallel.py)
    from apex_tpu_torch.transformer.parallel_state import AxisGroup

    one = AxisGroup("tp", None, 1, 0, (0,))
    torch.testing.assert_close(fused_lm_head_ce(x, e, t, 8, axis_name=one),
                               fused_lm_head_ce(x, e, t, 8), rtol=0, atol=0)
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


_DTYPE_PAIRS = [(xd, ed) for xd in (torch.float32, torch.bfloat16)
                for ed in (torch.float32, torch.bfloat16)]
_CSRC = Path(K.__file__).parents[1] / "csrc" / "fused_ce.cu"


@pytest.mark.parametrize("x_dtype,e_dtype", _DTYPE_PAIRS)
@pytest.mark.parametrize("which", [1, 2])
def test_ce_bwd_plan_fits_the_card(which, x_dtype, e_dtype):
    """At every H the kernels take, the backward's plan fits a block's
    shared memory, and it converts the streamed operand (the embed for
    dx, x for dembed) into a bf16 scratch exactly when that is fp32."""
    N, V = 8192, 50304
    streamed, rows = (e_dtype, V) if which == 1 else (x_dtype, N)
    for H in range(16, 1025, 16):
        plan = K.ce_bwd_plan(which, N, H, V, x_dtype, e_dtype)
        assert 0 < plan.smem_bytes <= K.SMEM_LIMIT and plan.smem_bytes % 16 == 0, H
        assert plan.own_rows == (64 if H <= 768 else 32) and plan.stages == 2
        assert plan.scratch_bytes == (rows * H * 2 if streamed == torch.float32 else 0)


def test_ce_bwd_plan_is_the_kernel_source_plan():
    """``BWD_TILES`` holds the constants of csrc/fused_ce.cu's tile
    structs, and the plan gives the shared memory the header reckons."""
    src = _CSRC.read_text()
    for H, struct in STRUCTS.items():
        body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S).group(1)
        consts = dict(re.findall(r"static constexpr int (\w+) = (\d+);", body))
        assert tuple(int(consts[c]) for c in ("kRows", "kStream", "kGroups", "kWarps")) == \
            K.BWD_TILES[H]
    rows, sr, kg, _ = K.BWD_TILES[768]
    plan = K.ce_bwd_plan(1, 8192, 768, 50304, torch.bfloat16, torch.float32)
    assert plan.smem_bytes == (rows * 776 + 2 * sr * 776 + rows * (sr + 8)) * 2 \
        + 3 * rows * 4 + (kg - 1) * rows * sr * 4
    assert plan.scratch_bytes == 50304 * 768 * 2
    with pytest.raises(ValueError, match="which"):
        K.ce_bwd_plan(0, 8, 16, 8, torch.float32, torch.float32)


@pytest.mark.parametrize("N,H,V,bn,bv", SHAPES)
def test_bf16_copy_of_the_streamed_operand_changes_no_bit(N, H, V, bn, bv):
    """The backward streams a bf16 copy of an fp32 operand: with bf16
    dots, dx from the embed rounded to bf16 first is bitwise dx from the
    fp32 embed, and dembed from x rounded first bitwise dembed from the
    fp32 x."""
    x, e, t, g = (torch.from_numpy(a) for a in _data(N, H, V, seed=7))
    bf = torch.bfloat16
    m, l, _ = K.ce_fwd_plain(x, e, t, dot_dtype=bf)
    lse = m + torch.log(l)
    assert torch.equal(K.ce_dx_plain(x, e.to(bf), t, lse, g, dot_dtype=bf),
                       K.ce_dx_plain(x, e, t, lse, g, dot_dtype=bf))
    assert torch.equal(K.ce_dembed_plain(x.to(bf), e, t, lse, g, dot_dtype=bf),
                       K.ce_dembed_plain(x, e, t, lse, g, dot_dtype=bf))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ce_tile_variants_apply_to_the_kernel_source(variant):
    """``ce_bwd_tiles`` builds each variant by giving the K groups,
    streamed rows and warps of one width's tile struct new values: the
    struct's own rows, the other width's struct and every other line stay
    as they are, and the new plan is one the kernel takes."""
    src = _CSRC.read_text()
    out = variant_source(src, VARIANTS[variant])
    assert len(src.splitlines()) == len(out.splitlines())
    changed = [(a, b) for a, b in zip(src.splitlines(), out.splitlines()) if a != b]
    names = {b.split("=")[0].split()[-1] for _, b in changed}
    assert changed and names <= {"kGroups", "kStream", "kWarps"}
    (struct,) = {s for s, _ in VARIANTS[variant]}
    H = next(h for h, s in STRUCTS.items() if s == struct)
    rows, sr, kg, warps = K.BWD_TILES[H]
    new = {c: int(v) for (_, c), v in VARIANTS[variant].items()}
    assert (new["kGroups"], new["kStream"], new["kWarps"]) != (kg, sr, warps)
    assert valid_plan(H, rows, new["kStream"], new["kGroups"], new["kWarps"])


def test_valid_plans_are_the_kernels():
    """The tool's test of a plan is the kernel's: the landed plans pass it,
    pieces smaller than a fragment tile or K groups that do not divide
    the warps fail it, and so do partials past shared memory."""
    for H in STRUCTS:
        assert valid_plan(H, *K.BWD_TILES[H])
    assert not valid_plan(1024, 32, 16, 1, 8)   # 8 warps of 64 elements
    assert not valid_plan(768, 64, 32, 4, 12)   # 3 warps a group
    assert not valid_plan(768, 64, 32, 6, 12)   # five 8 KB partials: 245 KB


@pytest.mark.parametrize("ablation", sorted(ABLATIONS))
def test_ce_ablations_apply_to_the_kernel_source(ablation):
    """Each ablation ``ce_bwd_tiles`` times takes its part out of the
    backward's tile loop: every text it replaces is in the source once,
    and nothing else changes."""
    src = _CSRC.read_text()
    out = ablated_source(src, ABLATIONS[ablation])
    assert out != src
    assert len(src) - len(out) == sum(len(a) - len(b) for a, b in ABLATIONS[ablation])


# ------------------------------------------------------------------ forward
from apex_tpu_torch import ce_fwd_tiles as FT  # noqa: E402

_LOG2E = 1.4426950408889634


#: the kernel's kLog2e, a float
_K32 = float(np.float32(_LOG2E))


def _fmaf(a, b, c):
    """The card's ``fmaf(a, b, c)``: ``a * b + c`` rounded once (float64
    holds the product of two floats exactly)."""
    return (a.double() * b + c.double()).float()


def _fwd_model(x, e, t, guard=True):
    """The forward kernel's arithmetic in plain torch, at the landed
    plan: vocab splits of whole tiles; in each tile a lane (warp wn,
    quad t) owns 16 columns of every row, masked to -2e30 past V, and
    keeps its own running (m, l, tgt) in base 2; the 4 x kWarpsN lanes of
    a row are merged in lane order, then the splits in split order."""
    f = K.FWD_TILES
    BM, BN, lanes = f["rows"], f["cols"], 4 * f["warps_n"]
    NW = BN // f["warps_n"]
    (N, H), V = x.shape, e.shape[0]
    plan = K.ce_fwd_plan(N, H, V, x.dtype, e.dtype)
    assert plan.rows == BM
    nv = -(-V // BN)
    tps = -(-nv // plan.splits)
    s = torch.full((N, nv * BN), -2e30)
    s[:, :V] = x.to(torch.bfloat16).float() @ e.to(torch.bfloat16).float().T
    c = torch.arange(BN)
    order = torch.argsort((c // NW) * 4 + (c % 8) // 2, stable=True)  # columns by lane
    rows = torch.arange(N)
    parts = []
    for y in range(plan.splits):
        m = torch.full((N, lanes), -1e30)
        l = torch.zeros(N, lanes)
        g = torch.zeros(N, lanes)
        for vt in range(y * tps, min(nv, (y + 1) * tps)):
            tile = s[:, vt * BN:(vt + 1) * BN][:, order].reshape(N, lanes, BN // lanes)
            mx = torch.maximum(m, tile.max(-1).values)
            ms = mx * _K32
            rescaled = l * torch.exp2(_fmaf(m, _K32, -ms))
            if guard:  # a lane with no valid column yet keeps l = 0
                rescaled = torch.where(l == 0, torch.zeros_like(l), rescaled)
            l = rescaled + torch.exp2(_fmaf(tile, _K32, -ms[..., None])).sum(-1)
            m = mx
            rel = t.long() - vt * BN
            hit = (rel >= 0) & (rel < BN)
            lane = (rel.clamp(0, BN - 1) // NW) * 4 + (rel.clamp(0, BN - 1) % 8) // 2
            g[rows[hit], lane[hit]] += s[rows[hit], t.long()[hit]]
        M = m.max(-1).values
        L = torch.zeros(N)
        for k in range(lanes):
            L = L + l[:, k] * torch.exp2((m[:, k] - M) * _LOG2E)
        parts.append((M, L, g.sum(-1)))
    M = torch.stack([p[0] for p in parts]).max(0).values
    L, G = torch.zeros(N), torch.zeros(N)
    for pm, pl, pg in parts:
        L, G = L + pl * torch.exp(pm - M), G + pg
    return M, L, G


@pytest.mark.parametrize("N,H,V", [(300, 48, 700), (64, 32, 259), (1000, 80, 2049),
                                   (130, 16, 256)])
def test_forward_kernel_arithmetic_matches_the_plain_version(N, H, V):
    """The kernel's lane-wise online softmax (columns past V masked below
    every running max, a lane with none of a tile's valid columns, splits
    of one partial tile) gives the plain version's m and tgt exactly and
    its lse within 1e-5."""
    x, e, t, _ = _data(N, H, V, seed=8)
    xt, et, tt = (torch.from_numpy(a) for a in (x, e, t))
    m, l, tgt = _fwd_model(xt.to(torch.bfloat16), et, tt)
    pm, pl, ptgt = K.ce_fwd_plain(xt.to(torch.bfloat16), et, tt, dot_dtype=torch.bfloat16)
    assert torch.equal(m, pm) and torch.equal(tgt, ptgt)
    _close(m + torch.log(l), (pm + torch.log(pl)).numpy(), 1e-5)


def test_a_lane_with_no_valid_column_keeps_its_sum_at_zero():
    """The tp 2 x pp 2 NaN of ROADMAP.md section 3: at GPT-345M's vocab
    shard under tp 2 (V 25152: a last tile of 64 valid columns of 256) and
    1024 rows, the last vocab split holds that tile alone, so three warps'
    lanes see no valid column; their running max stays at the initial
    -1e30 and ``fmaf(m, log2 e, -m log2 e)`` leaves the product's rounding,
    +6.4e21: exp2 gives inf and ``0 * inf`` NaN.  The kernel keeps such an
    l at 0 (``csrc/fused_ce.cu``); without that, the kernel's arithmetic
    (``_fwd_model``) turns NaN at a small shape with the same split."""
    plan = K.ce_fwd_plan(1024, 1024, 25152, torch.bfloat16, torch.float32)
    nv = -(-25152 // K.FWD_TILES["cols"])
    tps = -(-nv // plan.splits)
    assert (plan.splits - 1) * tps == nv - 1 and 25152 % K.FWD_TILES["cols"] == 64
    m = np.float32(-1e30)
    assert np.float64(m) * np.float32(_LOG2E) - np.float64(np.float32(m * np.float32(_LOG2E))) > 0
    x, e, t, _ = _data(64, 32, 259, seed=8)
    xt, et, tt = (torch.from_numpy(a) for a in (x, e, t))
    assert torch.isnan(_fwd_model(xt.to(torch.bfloat16), et, tt, guard=False)[1]).any()
    assert torch.isfinite(_fwd_model(xt.to(torch.bfloat16), et, tt)[1]).all()


#: the shapes the forward's plan is held at: the CE_GRID cases of
#: chip_smoke.py, the ragged one, GPT-124M and every H the kernels take
_FWD_SHAPES = sorted({(1000, 768, 8191), (1000, 1024, 8191), (1000, 80, 8191), (1000, 784, 8191),
                      (1000, 768, 50257), (2048, 768, 50304)}
                     | {(8192, H, 50304) for H in range(16, 1025, 16)})


@pytest.mark.parametrize("x_dtype,e_dtype", _DTYPE_PAIRS)
def test_ce_fwd_plan_fits_the_card(x_dtype, e_dtype):
    """At every shape the forward's plan fits a block's shared memory,
    its splits leave none empty and bring the blocks to at most the
    card's SMs (more than 96 of them at N = 8192), and its scratch is
    the splits' partials and a bf16 copy of exactly the fp32 operands,
    each from a 256-byte boundary."""
    f = K.FWD_TILES
    for N, H, V in _FWD_SHAPES:
        plan = K.ce_fwd_plan(N, H, V, x_dtype, e_dtype)
        assert 0 < plan.smem_bytes <= K.SMEM_LIMIT
        assert (plan.rows, plan.vocab_rows, plan.warps) == (
            f["rows"], f["cols"], f["warps_m"] * f["warps_n"])
        nv, rb = -(-V // plan.vocab_rows), -(-N // plan.rows)
        tps = -(-nv // plan.splits)
        assert 1 <= plan.splits <= nv and (plan.splits - 1) * tps < nv
        assert rb * plan.splits <= max(K.SMS, rb)
        if N == 8192:
            assert rb * plan.splits > 96
        r = lambda b: -(-b // 256) * 256  # noqa: E731
        assert plan.scratch_bytes == (r(3 * plan.splits * N * 4)
                                      + (r(N * H * 2) if x_dtype == torch.float32 else 0)
                                      + (r(V * H * 2) if e_dtype == torch.float32 else 0))


def test_ce_fwd_plan_is_the_kernel_source_plan():
    """``FWD_TILES`` holds the constants of csrc/fused_ce.cu's FwdTiles,
    and the plan gives the shared memory the header reckons: two
    stages of 128 x rows and 256 vocab rows, 64 columns (row stride 72),
    and the rows' target ids."""
    body = re.search(r"struct FwdTiles \{(.*?)\n\};", _CSRC.read_text(), re.S).group(1)
    consts = {k: int(v) for k, v in re.findall(r"static constexpr int (\w+) = (\d+);", body)}
    assert {FT.CONSTANTS[k]: v for k, v in consts.items()} == K.FWD_TILES
    plan = K.ce_fwd_plan(8192, 768, 50304, torch.bfloat16, torch.float32)
    assert plan.smem_bytes == 2 * (128 + 256) * 72 * 2 + 128 * 4
    assert plan.splits == 2 and plan.scratch_bytes == 3 * 2 * 8192 * 4 + 50304 * 768 * 2


@pytest.mark.parametrize("N,H,V,bn,bv", SHAPES)
def test_bf16_copy_of_the_forward_operands_changes_no_bit(N, H, V, bn, bv):
    """The forward streams bf16 copies of fp32 x and embed: with bf16
    dots, m, l and tgt from operands rounded to bf16 first are bitwise
    those from the fp32 operands."""
    x, e, t, _ = (torch.from_numpy(a) for a in _data(N, H, V, seed=9))
    bf = torch.bfloat16
    for got, want in zip(K.ce_fwd_plain(x.to(bf), e.to(bf), t, dot_dtype=bf),
                         K.ce_fwd_plain(x, e, t, dot_dtype=bf)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("variant", sorted(FT.VARIANTS))
def test_ce_fwd_tile_variants_apply_to_the_kernel_source(variant):
    """``ce_fwd_tiles`` builds each variant by giving FwdTiles' constants
    new values: every other line stays as it is, and the new tiles are
    ones the kernel takes."""
    src = _CSRC.read_text()
    out = variant_source(src, FT.VARIANTS[variant])
    assert len(src.splitlines()) == len(out.splitlines())
    changed = [(a, b) for a, b in zip(src.splitlines(), out.splitlines()) if a != b]
    assert changed and {b.split("=")[0].split()[-1] for _, b in changed} <= set(FT.CONSTANTS)
    tiles = FT.tiles_of({c: int(v) for (_, c), v in FT.VARIANTS[variant].items()})
    assert tiles != K.FWD_TILES and FT.valid_fwd_tiles(tiles)


def test_valid_fwd_tiles_are_the_kernels():
    """The tool's test of tiles is the kernel's: the landed tiles pass,
    pieces of s that are not whole 16 x 16 tiles, stages that do not
    split over the threads and rings past shared memory fail."""
    assert FT.valid_fwd_tiles(K.FWD_TILES)
    assert not FT.valid_fwd_tiles(FT.tiles_of({"kCols": 96}))     # 24 columns a warp
    assert not FT.valid_fwd_tiles(FT.tiles_of({"kChunk": 24}))    # not 16 deep
    assert not FT.valid_fwd_tiles(FT.tiles_of({"kStages": 5}))    # 276 KB
    assert not FT.valid_fwd_tiles(FT.tiles_of({"kBlocksPerSm": 3}))  # three 111 KB blocks


@pytest.mark.parametrize("ablation", sorted(FT.ABLATIONS) + sorted(FT.REWRITES))
def test_ce_fwd_ablations_apply_to_the_kernel_source(ablation):
    """Each ablation and rewrite ``ce_fwd_tiles`` times changes its part
    of the forward: every text it replaces is in the source once, and
    nothing else changes."""
    pairs = {**FT.ABLATIONS, **FT.REWRITES}[ablation]
    src = _CSRC.read_text()
    out = ablated_source(src, pairs)
    assert out != src
    assert len(src) - len(out) == sum(len(a) - len(b) for a, b in pairs)
