#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (apex_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. card: PyTorch version, the card, ``nvidia-smi`` name and power
   limit; TF32 is switched off for matmuls and cuDNN.
2. build: the CUDA kernels are compiled from ``apex_tpu_torch/csrc``.
3. kernels: each kernel against its plain PyTorch version at the
   serve and train paths' shapes (LN forward at 8 and 64 rows for
   serving and 8192 for training), with its error and tolerance, its
   device time beside the plain version's, one PyTorch library call's
   where one computes the same function, and the bound (the larger of
   bytes at 3.35 TB/s and flops at the peak rate of their type: 989
   TFLOP/s bf16 tensor cores, 67 TFLOP/s fp32).
4. serve: ``apex_tpu_torch.serve_gpt`` at its defaults — GPT-124M
   width, bf16, 8 slots, 32 requests — with every kernel's launch
   count from that run, checked exactly against the steps taken.
5. parity: full width in fp32, greedy, 4 requests of 8 tokens: every
   served token must be the argmax of the full-sequence forward.
6. profile: device busy share and kernel time by name over decode
   steps of the bf16 engine.
7. train: ``apex_tpu_torch.train_gpt`` at its defaults — bench.py's
   GPT-124M step, seq 1024, batch 8, bf16, flash attention, full remat,
   FusedAdam — one warm-up step and 5 timed steps: losses finite and
   falling, launch counts exactly 49 / 25 / 24 / 12 / 12 a step (LN
   fwd, LN bwd, flash fwd, dq, dkv), and two backward passes of one
   flash layer bitwise equal.
8. flash_grad_parity: one bf16 flash layer in the model's layout (B=8,
   H=12, S=1024; and GQA H_kv=4): the output and the gradients through
   ``flash_attention`` on the card (the bf16 kernels the train step
   runs) against the CPU (plain versions) on the same bf16 inputs.
9. train_parity: the loss and every gradient leaf of one step at full
   width (2 layers, seq 256, batch 2, fp32) on the card (the fp32
   kernels) against the CPU (plain versions), from the same numpy
   params.
10. train_profile: device busy share and kernel time by name over one
    training step.

Then a line with every phase's seconds (the build's included), the
kernels summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code
is nonzero and the last line is not printed.  Without a CUDA device,
or without the package beside this file, it exits nonzero at once.
"""

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet, dense): device memory bytes/s,
#: fp32 flops/s outside the tensor cores, bf16 tensor-core flops/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12

ITERS = 20

NEG_INF_HALF = -0.5e30

#: bands of the flash kernels against their plain versions, by output:
#: relative to the plain output's max for out/dq/dk/dv, absolute for lse
FLASH_TOL_BF16 = {"out": 2.0 ** -6, "dq": 2.0 ** -6, "dk": 2.0 ** -6, "dv": 2.0 ** -6,
                  "lse": 1e-4}
FLASH_TOL_FP32 = {"out": 1e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4, "lse": 1e-4}
#: train parity bands (relative): the loss, and every gradient leaf
TRAIN_PARITY_TOL = {"loss": 1e-5, "grads": 1e-3}


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(nbytes, flops, peak=PEAK_FP32):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def device_ms(fn, iters=ITERS):
    """Device time of one ``fn()`` call: for each CUDA activity name
    (kernels, copies), its launches in one call times its mean duration.
    A profiler trace can drop records, so the launches come from a
    profiled single call (raised to what a profiled run of ``iters``
    calls saw) and the mean from that run (from the single call for a
    name the run lost); neither depends on how many records were kept.
    CUDA events around the calls when the profiler records nothing."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    one = _cuda_durations(fn, 1)
    many = _cuda_durations(fn, iters)
    if not one and not many:
        return call_ms(fn, iters), "cuda_events"
    us = 0.0
    for name in set(one) | set(many):
        d = many.get(name) or one[name]
        launches = max(len(one.get(name, ())), math.ceil(len(many.get(name, ())) / iters))
        us += launches * sum(d) / len(d)
    return us / 1e3, "profiler"


def _cuda_durations(fn, iters):
    """{name: [us, ...]} of the CUDA activity over ``iters`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return out


def call_ms(fn, iters=ITERS):
    """Time per call between CUDA events around ``iters`` back-to-back
    calls: the device time, or the host's when the host is slower."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timings(kernel, plain, library=None):
    ms, timer = device_ms(kernel)
    out = {"kernel_ms": ms, "timer": timer, "call_ms": call_ms(kernel),
           "plain_ms": device_ms(plain)[0], "library_ms": None}
    if library is not None:
        out["library_ms"] = device_ms(library)[0]
    return out


def bf16_ulps(a, b):
    def key(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((key(a) - key(b)).abs().max())


# ------------------------------------------------------------------ kernels
def check_layer_norm(dev, R, dtype):
    from apex_tpu_torch.ops.layer_norm import layer_norm_fwd, layer_norm_fwd_plain

    H, eps = 768, 1e-5
    rng = np.random.default_rng(R)
    x = torch.from_numpy(rng.standard_normal((R, H), dtype=np.float32) * 2 + 0.5)
    x = x.to(dev, dtype)
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(H, dtype=np.float32)).to(dev)
    b = torch.from_numpy(0.1 * rng.standard_normal(H, dtype=np.float32)).to(dev)
    y, mean, rstd = layer_norm_fwd(x, w, b, eps)
    py, pmean, prstd = layer_norm_fwd_plain(x, w, b, eps)
    torch.cuda.synchronize()
    err = float((y.float() - py.float()).abs().max())
    stat_err = max(float((mean - pmean).abs().max()),
                   float(((rstd - prstd) / prstd).abs().max()))
    excess = None
    if dtype == torch.bfloat16:
        # y against the plain fp32 value: the final rounding (half a bf16
        # ulp, 2**-8 relative) plus the fp32 band, 1e-5 abs (row stats in
        # another order).  An ulp count is no measure: where w * xhat
        # cancels b, y is near 0 and a 1e-7 change moves it many ulps.
        ulps = bf16_ulps(y, py)
        y32 = layer_norm_fwd_plain(x.float(), w, b, eps)[0]
        excess = float(((y.float() - y32).abs() - 2.0 ** -8 * y32.abs()).max())
        ok = excess <= 1e-5
        tol = ("y within 2**-8 |y| + 1e-5 of the plain fp32 y (rounding to bf16, "
               "then fp32 row stats in another order)")
    else:
        ulps = None
        ok, tol = err <= 1e-5, "1e-5 abs (fp32 row stats summed in another order)"
    if not ok or stat_err > 1e-5:
        raise AssertionError(f"layer_norm R={R} {dtype}: err {err}, ulps {ulps}, "
                             f"band excess {excess}, stats {stat_err}")
    xb = x.element_size()
    nbytes = 2 * R * H * xb + 2 * H * 4 + 2 * R * 4
    bms, by = bound(nbytes, 8 * R * H)
    wl, bl = w.to(dtype), b.to(dtype)
    t = timings(lambda: layer_norm_fwd(x, w, b, eps),
                lambda: layer_norm_fwd_plain(x, w, b, eps),
                lambda: torch.nn.functional.layer_norm(x, (H,), wl, bl, eps))
    return {"R": R, "H": H, "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "bf16_ulps": ulps, "band_excess": excess,
            "stats_err": stat_err,
            "tolerance": tol, "bound_ms": bms, "bound_by": by, **t}


def check_decode_attention(dev, h_kv, dtype):
    from apex_tpu_torch.ops.decode_attention import (
        decode_attention_plain, paged_decode_attention,
    )

    B, H, D, PS, P, num_pages = 8, 12, 64, 16, 6, 49
    rng = np.random.default_rng(h_kv)
    q = torch.from_numpy(rng.standard_normal((B, H, D), dtype=np.float32)).to(dev, dtype)
    kp = torch.from_numpy(rng.standard_normal((num_pages, PS, h_kv, D), dtype=np.float32)).to(dev, dtype)
    vp = torch.from_numpy(rng.standard_normal((num_pages, PS, h_kv, D), dtype=np.float32)).to(dev, dtype)
    pt_np = rng.integers(1, num_pages, size=(B, P)).astype(np.int32)
    pt_np[4, 1] = -5      # out of range, inside the read range (len 17)
    pt_np[6, 2] = 1000    # out of range, inside the read range (len 95)
    lens_np = np.asarray([0, 1, 15, 16, 17, 50, 95, 96], np.int32)
    pt = torch.from_numpy(pt_np).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    out = paged_decode_attention(q, kp, vp, pt, lens)
    ref = decode_attention_plain(q, kp, vp, pt, lens)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    if dtype == torch.bfloat16:
        tol = 2 * 2.0 ** -8 * scale
        why = "2 bf16 ulps at the output's scale (probabilities round to bf16 before and after normalizing)"
    else:
        tol = 1e-5 * scale
        why = "1e-5 abs (online against full softmax, other summation order)"
    if err > tol or float(out[0].float().abs().max()) != 0.0:
        raise AssertionError(f"decode_attention h_kv={h_kv} {dtype}: err {err} > {tol}")
    eb = kp.element_size()
    n_pos = int(lens_np.sum())
    nbytes = (2 * n_pos * h_kv * D * eb + B * H * D * (q.element_size() + eb)
              + B * P * 4 + B * 4)
    bms, by = bound(nbytes, 4 * n_pos * H * D)
    # library yardstick: SDPA over K/V gathered (and GQA-repeated) beforehand
    ptc = pt.long().clamp(0, num_pages - 1)
    kg = kp[ptc].reshape(B, P * PS, h_kv, D).transpose(1, 2).repeat_interleave(H // h_kv, 1)
    vg = vp[ptc].reshape(B, P * PS, h_kv, D).transpose(1, 2).repeat_interleave(H // h_kv, 1)
    kg, vg, q4 = kg.to(dtype).contiguous(), vg.to(dtype).contiguous(), q[:, :, None, :]
    mask = (torch.arange(P * PS, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    t = timings(lambda: paged_decode_attention(q, kp, vp, pt, lens),
                lambda: decode_attention_plain(q, kp, vp, pt, lens),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, kg, vg, attn_mask=mask))
    return {"B": B, "H": H, "H_kv": h_kv, "D": D, "page": PS,
            "lengths": lens_np.tolist(), "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "tolerance": tol, "tolerance_why": why,
            "bound_ms": bms, "bound_by": by, **t}


def check_sampling(dev, temperature, top_k):
    from apex_tpu_torch.ops.decode_sampling import (
        fused_sample, fused_sample_plain, gumbel_from_seed,
    )

    N, V, H = 8, 50304, 768
    rng = np.random.default_rng(7)
    embed = torch.from_numpy(rng.standard_normal((V, H), dtype=np.float32) * 0.02).to(dev)
    ties = 0
    worst = 0.0
    for rep in range(8):
        x = torch.from_numpy(rng.standard_normal((N, H), dtype=np.float32)).to(dev, torch.bfloat16)
        seeds = torch.from_numpy(
            rng.integers(0, 2 ** 32, size=N, dtype=np.uint64).astype(np.int64)).to(dev)
        got = fused_sample(x, embed, seeds, temperature, top_k).long()
        want = fused_sample_plain(x, embed, seeds, temperature, top_k).long()
        torch.cuda.synchronize()
        logits = torch.matmul(x.float(), embed.T)
        cand = logits
        if temperature > 0:
            cand = logits / temperature + gumbel_from_seed(
                seeds[:, None], torch.arange(V, device=dev)[None, :])
            if top_k:
                kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
                cand = torch.where(logits >= kth - 1e-4, cand, torch.full_like(cand, -1e30))
        gap = cand.gather(1, want[:, None]) - cand.gather(1, got[:, None])
        worst = max(worst, float(gap.abs().max()))
        diff = got != want
        if bool(diff.any()):
            if float(gap[diff].max()) > 1e-4:
                raise AssertionError(
                    f"sampling T={temperature} top_k={top_k}: kernel {got.tolist()} vs "
                    f"plain {want.tolist()}, score gaps {gap[:, 0].tolist()}")
            ties += int(diff.sum())
    nbytes = V * H * 4 + N * H * 2 + N * 8 + N * 4
    bms, by = bound(nbytes, 2 * N * V * H)
    t = timings(lambda: fused_sample(x, embed, seeds, temperature, top_k),
                lambda: fused_sample_plain(x, embed, seeds, temperature, top_k))
    return {"N": N, "V": V, "H": H, "temperature": temperature, "top_k": top_k,
            "draws": 8 * N, "near_ties": ties, "max_abs_err": worst,
            "tolerance": "tokens equal, or the plain score at the kernel's token "
                         "within 1e-4 of the plain max (summation order, logf)",
            "bound_ms": bms, "bound_by": by, **t}


def rel_err(got, want):
    """max |got - want| / max(|want|), in fp32."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)


def check_layer_norm_bwd(dev, dtype, R=8192, H=768):
    from apex_tpu_torch.ops.layer_norm import (
        layer_norm_bwd, layer_norm_bwd_plain, layer_norm_fwd_plain,
    )

    eps = 1e-5
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((R, H), dtype=np.float32) * 2 + 0.5)
    x = x.to(dev, dtype)
    dy = torch.from_numpy(rng.standard_normal((R, H), dtype=np.float32)).to(dev, dtype)
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(H, dtype=np.float32)).to(dev)
    b = torch.from_numpy(0.1 * rng.standard_normal(H, dtype=np.float32)).to(dev)
    _, mean, rstd = layer_norm_fwd_plain(x, w, b, eps)
    dx, dw, db = layer_norm_bwd(x, w, dy, mean, rstd)
    pdx, pdw, pdb = layer_norm_bwd_plain(x, w, dy, mean, rstd)
    dx32 = layer_norm_bwd_plain(x.float(), w, dy.float(), mean, rstd)[0]
    torch.cuda.synchronize()
    dx_err = float((dx.float() - pdx.float()).abs().max())
    # dx against the plain fp32 value: the final rounding (half a bf16
    # ulp, 2**-8 relative) plus the fp32 band, 1e-5 abs (the row sums in
    # another order; dx = (gw - m1 - xhat * m2) * rstd cancels, so an
    # ulp count of the rounded values is no measure)
    dx_excess = float(((dx.float() - dx32).abs() - 2.0 ** -8 * dx32.abs()).max())
    # fp32 column sums over R rows in another order: bounded by a few
    # ulps of the sum of the terms' magnitudes
    xhat = (x.float() - mean[:, None]) * rstd[:, None]
    w_scale = (dy.float() * xhat).abs().sum(0)
    b_scale = dy.float().abs().sum(0)
    sum_err = max(float(((dw - pdw).abs() / w_scale).max()),
                  float(((db - pdb).abs() / b_scale).max()))
    ulps = bf16_ulps(dx, pdx) if dtype == torch.bfloat16 else None
    tol = ("dx within 2**-8 |dx| + 1e-5 of the plain fp32 dx (rounding to x's dtype, "
           "then fp32 row sums in another order); dw, db within 1e-5 of the sum "
           "of |terms| (fp32 column sums in another order)")
    if dx_excess > 1e-5 or sum_err > 1e-5:
        raise AssertionError(f"layer_norm_bwd {dtype}: dx err {dx_err} ulps {ulps}, "
                             f"dw/db rel {sum_err}")
    xb = x.element_size()
    nbytes = 3 * R * H * xb + 2 * R * 4 + 3 * H * 4
    bms, by = bound(nbytes, 12 * R * H)
    xl = x.detach().requires_grad_()
    wl = w.to(dtype).requires_grad_()
    bl = b.to(dtype).requires_grad_()
    yl = torch.nn.functional.layer_norm(xl, (H,), wl, bl, eps)
    t = timings(lambda: layer_norm_bwd(x, w, dy, mean, rstd),
                lambda: layer_norm_bwd_plain(x, w, dy, mean, rstd),
                lambda: torch.autograd.grad(yl, (xl, wl, bl), dy, retain_graph=True))
    return {"R": R, "H": H, "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": dx_err, "bf16_ulps": ulps, "dx_band_excess": dx_excess,
            "dw_db_rel_err": sum_err,
            "tolerance": tol, "bound_ms": bms, "bound_by": by, **t}


def causal_pairs(Sq, Sk, causal, q_offset, k_offset):
    """(q, k) pairs a head's attention needs: all of them, or those on
    or below the causal diagonal (q_offset + i >= k_offset + j)."""
    if not causal:
        return Sq * Sk
    i = np.arange(Sq)
    return int(np.clip(q_offset + i - k_offset + 1, 0, Sk).sum())


def check_flash(dev, dtype, case, B=8, H=12, Hkv=12, S=1024, D=64, causal=True,
                q_offset=0, k_offset=0, masked=False, library=False):
    """flash_fwd, flash_dq and flash_dkv against their plain versions on
    one input; the backward kernels and plain versions get the kernel's
    lse and delta, so each kernel is held on its own."""
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops.attention import padding_bias

    rng = np.random.default_rng(S + Hkv)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)

    q, do = randn(B * H, S, D), randn(B * H, S, D)
    k, v = randn(B * Hkv, S, D), randn(B * Hkv, S, D)
    bias = None
    if masked:  # batch row b keeps its first S - 100 * b keys
        valid = torch.arange(S, device=dev)[None, :] < (S - 100 * torch.arange(B, device=dev))[:, None]
        bias = padding_bias(valid)[:, None, :].contiguous()
    scale = 1.0 / math.sqrt(D)
    kw = dict(kv_bias=bias, heads=H, kv_heads=Hkv)
    fwd_args = (q, k, v, scale, causal, q_offset, k_offset)
    out, lse = fa.flash_fwd(*fwd_args, **kw)
    pout, plse = fa.flash_fwd_plain(*fwd_args, **kw)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    bwd_args = (q, k, v, do, lse, delta, scale, causal, q_offset, k_offset)
    dq = fa.flash_dq(*bwd_args, **kw)
    pdq = fa.flash_dq_plain(*bwd_args, **kw)
    dk, dv = fa.flash_dkv(*bwd_args, **kw)
    pdk, pdv = fa.flash_dkv_plain(*bwd_args, **kw)
    torch.cuda.synchronize()
    live = plse > NEG_INF_HALF
    dead_rows = int((~live).sum())
    if dead_rows and (float(out.float()[~live[..., 0]].abs().max()) != 0.0
                      or not bool((lse[~live] < NEG_INF_HALF).all())):
        raise AssertionError(f"flash {case}: fully masked rows are not zero")
    pairs_out = {"out": (out, pout), "dq": (dq, pdq), "dk": (dk, pdk), "dv": (dv, pdv)}
    errs = {n: rel_err(a, b) for n, (a, b) in pairs_out.items()}
    errs["lse"] = float((lse - plse)[live].abs().max())
    abs_errs = {n: float((a.float() - b.float()).abs().max()) for n, (a, b) in pairs_out.items()}
    finite = all(bool(torch.isfinite(t).all()) for t in (out, lse, dq, dk, dv))
    if dtype == torch.bfloat16:
        tol = FLASH_TOL_BF16
        why = ("max |kernel - plain| / max |plain| for out, dq, dk, dv: the kernel "
               "rounds p and ds to bf16 before its dots (as the Pallas kernels do), "
               "the plain version is fp32 throughout; lse abs (fp32 in both)")
    else:
        tol = FLASH_TOL_FP32
        why = ("max |kernel - plain| / max |plain|: fp32 throughout, sums in "
               "another order; lse abs")
    bad = {n: e for n, e in errs.items() if not e <= tol[n]}
    if bad or not finite:
        raise AssertionError(f"flash {case} {dtype}: errors {errs} over {tol} "
                             f"(finite={finite})")
    e, pairs = q.element_size(), causal_pairs(S, S, causal, q_offset, k_offset)
    BH, BKV = B * H, B * Hkv
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    qb, kb, rb = BH * S * D * e, BKV * S * D * e, BH * S * 4
    biasb = 0 if bias is None else B * S * 4
    bounds = {"fwd": bound(2 * qb + 2 * kb + rb + biasb, 4 * D * pairs * BH, peak),
              "dq": bound(3 * qb + 2 * kb + 2 * rb + biasb, 6 * D * pairs * BH, peak),
              "dkv": bound(2 * qb + 4 * kb + 2 * rb + biasb, 8 * D * pairs * BH, peak)}
    lib = {"fwd": None, "bwd": None}
    if library:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        q4, k4, v4 = (t.view(B, -1, S, D).detach().requires_grad_() for t in (q, k, v))
        o4 = sdpa(q4, k4, v4, is_causal=causal)
        do4 = do.view(B, H, S, D)
        lib = {"fwd": lambda: sdpa(q4, k4, v4, is_causal=causal),
               "bwd": lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)}
    t = {"fwd": timings(lambda: fa.flash_fwd(*fwd_args, **kw),
                        lambda: fa.flash_fwd_plain(*fwd_args, **kw), lib["fwd"]),
         "dq": timings(lambda: fa.flash_dq(*bwd_args, **kw),
                       lambda: fa.flash_dq_plain(*bwd_args, **kw), lib["bwd"]),
         "dkv": timings(lambda: fa.flash_dkv(*bwd_args, **kw),
                        lambda: fa.flash_dkv_plain(*bwd_args, **kw), lib["bwd"])}
    base = {"case": case, "B": B, "H": H, "H_kv": Hkv, "S": S, "D": D, "causal": causal,
            "q_offset": q_offset, "k_offset": k_offset, "kv_bias": masked,
            "dtype": str(dtype).replace("torch.", ""), "fully_masked_rows": dead_rows,
            "rel_errors": errs, "abs_errors": abs_errs, "tolerance": tol,
            "tolerance_why": why}
    outputs = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}
    return {name: {**base, "kernel": f"flash_{name}",
                   "max_abs_err": max(abs_errs[n] for n in outputs[name]),
                   "bound_ms": bounds[name][0], "bound_by": bounds[name][1], **t[name]}
            for name in outputs}


# -------------------------------------------------------------------- serve
def launch_counts():
    from apex_tpu_torch.ops import decode_attention, decode_sampling, flash_attention, layer_norm

    return {"layer_norm_fwd": layer_norm.LAUNCHES,
            "paged_decode_attention": decode_attention.LAUNCHES,
            "fused_sample": decode_sampling.LAUNCHES,
            "layer_norm_bwd": layer_norm.BWD_LAUNCHES,
            "flash_fwd": flash_attention.FWD_LAUNCHES,
            "flash_dq": flash_attention.DQ_LAUNCHES,
            "flash_dkv": flash_attention.DKV_LAUNCHES}


def reset_counts():
    from apex_tpu_torch.ops import decode_attention, decode_sampling, flash_attention, layer_norm

    layer_norm.LAUNCHES = decode_attention.LAUNCHES = decode_sampling.LAUNCHES = 0
    layer_norm.BWD_LAUNCHES = 0
    flash_attention.FWD_LAUNCHES = flash_attention.DQ_LAUNCHES = 0
    flash_attention.DKV_LAUNCHES = 0


def serve_phase():
    from apex_tpu_torch import serve_gpt

    args = serve_gpt.build_args().parse_args([])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, sched, params, config = serve_gpt.run(args)
    counts = launch_counts()
    st = sched.stats
    steps, prefills = st["decode_steps"], st["prefills"]
    expect = {"layer_norm_fwd": (2 * config.num_layers + 1) * (steps + prefills),
              "paged_decode_attention": config.num_layers * steps,
              "fused_sample": steps + prefills,
              "layer_norm_bwd": 0, "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    if out["requests"] != args.requests or any(
            len(c.tokens) != args.max_new for c in sched.completed):
        raise AssertionError(f"served {out['requests']}/{args.requests} requests")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != expected {expect}")
    emit({"phase": "serve", **out, "launches": counts,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return counts, sched, params, config


def parity_phase():
    from apex_tpu_torch import serve_gpt

    args = serve_gpt.build_args().parse_args(
        ["--compute-dtype", "float32", "--kv-dtype", "float32", "--temperature", "0",
         "--requests", "4", "--max-new", "8"])
    out, sched, params, config = serve_gpt.run(args)
    serve_gpt.check_greedy_parity(params, config, sched.completed, max_check=4)
    emit({"phase": "parity", "requests": out["requests"],
          "tokens_checked": sum(len(c.tokens) for c in sched.completed),
          "compute_dtype": "float32", "ok": True})
    del params, sched


def profile_phase(params, config, steps=10):
    """Busy share and kernel time by name over ``steps`` decode steps of
    the bf16 engine with all 8 slots active."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch import serve_gpt
    from apex_tpu_torch.inference import ContinuousBatchingScheduler, Request

    args = serve_gpt.build_args().parse_args([])
    _, _, dcfg = serve_gpt.setup(args)
    sched = ContinuousBatchingScheduler(params, config, dcfg)
    rng = np.random.RandomState(1)
    for rid in range(args.streams):
        plen = min(32, args.prompt_len)
        sched.submit(Request(rid=rid, prompt=rng.randint(0, args.vocab, plen).tolist(),
                             max_new_tokens=args.max_new))
    for _ in range(3):
        sched.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "profile", "decode_steps": steps, "active": sched.num_active,
          "step_ms": 1e3 * wall / steps, "device_busy_ms_per_step": busy_ms / steps,
          "idle_share": 1 - busy_ms / (1e3 * wall),
          "top_kernels_us_per_step": [[n[:90], us / steps] for n, us in top]})


# -------------------------------------------------------------------- train
def train_phase():
    """bench.py's GPT-124M step through ``train_gpt.run`` at its defaults."""
    from apex_tpu_torch import train_gpt

    args = train_gpt.build_args().parse_args([])
    reset_counts()
    t0 = time.monotonic()
    report, params, state = train_gpt.run(args)
    counts = launch_counts()
    n, L = args.warmup + args.steps, args.layers
    per_step = {"layer_norm_fwd": 4 * L + 1, "layer_norm_bwd": 2 * L + 1,
                "flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L}
    expect = {**{k: v * n for k, v in per_step.items()},
              "paged_decode_attention": 0, "fused_sample": 0}
    losses = report["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: {losses}")
    if counts != expect:
        raise AssertionError(f"train launch counts {counts} != expected {expect}")
    emit({"phase": "train", **report, "steps_counted": n,
          "launches_per_step": per_step, "launches": counts,
          "seconds": time.monotonic() - t0})
    return args, counts, report["step_ms_median"]


def flash_reproducible(dev, B=8, H=12, S=1024, D=64):
    """Two backward passes of one flash layer (bf16, causal) must give
    bitwise equal dq, dk, dv: no atomics in the kernels."""
    from apex_tpu_torch.ops.attention import flash_attention

    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, S, D), dtype=np.float32))
                   .to(dev, torch.bfloat16) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = flash_attention(q, k, v, causal=True)
    first = torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    second = torch.autograd.grad(out, (q, k, v), do)
    same = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
    if not all(same):
        raise AssertionError(f"flash backward not bitwise reproducible: {same}")
    emit({"phase": "train_reproducible", "B": B, "H": H, "S": S, "D": D,
          "dtype": "bfloat16", "dq_dk_dv_bitwise_equal": same})


def flash_grad_parity_phase(dev, S=1024, D=64):
    """One flash layer in bf16 as ``models.gpt._attention`` feeds it: q,
    k, v are (S, B, heads * D) projections viewed as (B, heads, S, D),
    and the output goes back to (S, B, heads * D).  The output and the
    gradients of the three projections through ``flash_attention`` on
    the card (the bf16 mma kernels, with the Function's saved lse, its
    delta and the layout and GQA reshapes) against the same bf16 inputs
    on the CPU (the plain versions through the same Function)."""
    from apex_tpu_torch.ops.attention import flash_attention

    t0 = time.monotonic()
    for case, B, H, Hkv in (("gpt124", 8, 12, 12), ("gqa", 2, 12, 4)):
        rng = np.random.default_rng(B * H + Hkv)

        def randn(n):
            return torch.from_numpy(rng.standard_normal((S, B, n * D), dtype=np.float32)
                                    ).to(torch.bfloat16)

        xq, xk, xv, g = randn(H), randn(Hkv), randn(Hkv), randn(H)
        got = {}
        for device in (dev, torch.device("cpu")):
            leaves = [t.to(device).requires_grad_() for t in (xq, xk, xv)]
            q, k, v = (t.view(S, B, n, D).permute(1, 2, 0, 3)
                       for t, n in zip(leaves, (H, Hkv, Hkv)))
            out = flash_attention(q, k, v, causal=True).permute(2, 0, 1, 3).reshape(S, B, H * D)
            grads = torch.autograd.grad(out, leaves, g.to(device))
            got[device.type] = [t.detach().cpu() for t in (out, *grads)]
        names = ("out", "dq", "dk", "dv")
        errs = {n: rel_err(a, b) for n, a, b in zip(names, got["cuda"], got["cpu"])}
        finite = all(bool(torch.isfinite(t.float()).all()) for t in got["cuda"])
        bad = {n: e for n, e in errs.items() if not e <= FLASH_TOL_BF16[n]}
        if bad or not finite:
            raise AssertionError(f"flash grad parity {case}: errors {errs} over "
                                 f"{FLASH_TOL_BF16} (finite={finite})")
        emit({"phase": "flash_grad_parity", "case": case, "B": B, "H": H, "H_kv": Hkv,
              "S": S, "D": D, "dtype": "bfloat16", "rel_errors": errs,
              "tolerance": {n: FLASH_TOL_BF16[n] for n in names},
              "tolerance_why": "max |cuda - cpu| / max |cpu| per output: the kernels "
                               "round p and ds to bf16 before their dots, the plain "
                               "versions are fp32 throughout; both round the "
                               "outputs to bf16",
              "seconds": time.monotonic() - t0})


def train_parity_phase():
    """One step's loss and gradients at full width, fp32: the card (the
    kernels) against the CPU (the plain versions), same numpy params."""
    from apex_tpu_torch import train_gpt
    from apex_tpu_torch.optimizers.base import tree_leaves

    t0 = time.monotonic()
    base = ["--layers", "2", "--seq", "256", "--batch", "2", "--compute-dtype", "float32"]
    out = {}
    for device in ("cuda", "cpu"):
        args = train_gpt.build_args().parse_args(base + ["--device", device])
        config, params, tokens, targets = train_gpt.setup(args)
        loss, grads = train_gpt.loss_and_grads(params, tokens, targets, config)
        out[device] = (float(loss), [g.detach().cpu() for g in tree_leaves(grads)])
    names = tree_leaves(_leaf_names(params))
    loss_err = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    # each leaf's max |cuda - cpu| over its own max |cpu|, floored at
    # 1e-4 of the largest gradient: bk's gradient is 0 in exact
    # arithmetic (a per-key constant cancels in the softmax), so both
    # sides hold rounding noise there and a ratio of noise means nothing
    floor = 1e-4 * max(float(c.abs().max()) for c in out["cpu"][1])
    grad_errs = {n: float((g - c).abs().max()) / max(float(c.abs().max()), floor)
                 for n, g, c in zip(names, out["cuda"][1], out["cpu"][1])}
    worst = max(grad_errs, key=grad_errs.get)
    if loss_err > TRAIN_PARITY_TOL["loss"] or grad_errs[worst] > TRAIN_PARITY_TOL["grads"]:
        raise AssertionError(f"train parity: loss rel {loss_err}, grad rel {grad_errs}")
    emit({"phase": "train_parity", "layers": 2, "hidden": 768, "heads": 12,
          "vocab": 50304, "seq": 256, "batch": 2, "compute_dtype": "float32",
          "loss_cuda": out["cuda"][0], "loss_cpu": out["cpu"][0],
          "loss_rel_err": loss_err, "grad_leaves": len(grad_errs),
          "grad_rel_err_max": grad_errs[worst], "grad_rel_err_worst_leaf": worst,
          "grad_rel_err": grad_errs, "tolerance": TRAIN_PARITY_TOL,
          "tolerance_why": "fp32 on both sides, TF32 off; cuBLAS, MKL and the "
                           "kernels sum in other orders; grads as max |cuda - cpu| "
                           "/ max(max |cpu|, 1e-4 max |grad|) per leaf",
          "seconds": time.monotonic() - t0})


def _leaf_names(tree, prefix=""):
    """A tree of ``tree``'s structure whose leaves are their paths."""
    if isinstance(tree, dict):
        return {k: _leaf_names(v, f"{prefix}{k}.") for k, v in tree.items()}
    return prefix[:-1]


def _kernel_kind(name):
    """A device kernel's group in the train profile: the port's kernels,
    the fp32 GEMMs (the dense LM head), the other GEMMs, the rest."""
    if "flash_" in name:
        return "flash"
    if "ln_fwd" in name or "ln_bwd" in name:
        return "layer_norm"
    if "sgemm" in name or "f32f32" in name:
        return "gemm_fp32"
    if any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "gemm_other"
    return "other"


def train_profile_phase(args, step_ms):
    """Busy share and kernel time by name over one training step.  The
    profiler slows the host side of the step, so the idle share is also
    given against ``step_ms``, the train phase's unprofiled median."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch import train_gpt
    from apex_tpu_torch.optimizers import FusedAdam

    config, params, tokens, targets = train_gpt.setup(args)
    opt = FusedAdam(lr=args.lr, weight_decay=train_gpt.WEIGHT_DECAY)
    state = opt.init(params)
    params, state, _ = train_gpt.train_step(params, state, opt, tokens, targets, config)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        train_gpt.train_step(params, state, opt, tokens, targets, config)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
    by_kind = {}
    for name, us in by_name.items():
        kind = _kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
    # the step launches 24 flash fwd, 12 dq, 12 dkv: fewer records here
    # mean the trace dropped some, and the busy time undercounts
    flash_seen = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "flash_" in e.name:
            kernel = re.search(r"flash_\w+", e.name).group(0)
            flash_seen[kernel] = flash_seen.get(kernel, 0) + 1
    emit({"phase": "train_profile", "step_ms": 1e3 * wall, "device_busy_ms": busy_ms,
          "device_ms_by_kind": by_kind, "flash_launches_seen": flash_seen,
          "idle_share": 1 - busy_ms / (1e3 * wall),
          "idle_share_of_unprofiled_step": 1 - busy_ms / step_ms,
          "top_kernels_ms": [[n[:90], us / 1e3] for n, us in top]})


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this "
                         "script runs only on a CUDA device")
    sys.path.insert(0, str(ROOT))
    try:
        from apex_tpu_torch.ops import _build
    except ImportError as exc:
        raise SystemExit(f"chip_smoke: the apex_tpu_torch package is not beside "
                         f"this script ({exc})")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    emit({"phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "tf32": "off (matmul and cudnn)"})

    secs = _build.build(force=True)
    _build.load()
    ptxas = [ln.strip() for ln in _build.LOG_PATH.read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs,
          "library": str(_build.LIB_PATH.relative_to(ROOT)),
          "sources": [str(s.relative_to(ROOT)) for s in _build.sources()],
          "ptxas": ptxas})

    seconds = {"build": secs}
    clock = time.monotonic()

    def lap(name):
        nonlocal clock
        now = time.monotonic()
        seconds[name] = now - clock
        clock = now

    results = {}
    for R in (8, 64, 8192):  # serve (decode, prefill) and train (B * S) rows
        for dtype in (torch.bfloat16, torch.float32):
            r = check_layer_norm(dev, R, dtype)
            results[("ln", R, dtype)] = r
            emit({"phase": "kernel", "kernel": "layer_norm_fwd", **r})
    for h_kv in (12, 4):
        for dtype in (torch.bfloat16, torch.float32):
            r = check_decode_attention(dev, h_kv, dtype)
            results[("attn", h_kv, dtype)] = r
            emit({"phase": "kernel", "kernel": "paged_decode_attention", **r})
    for temperature, top_k in ((0.0, 0), (1.0, 0), (1.0, 50)):
        r = check_sampling(dev, temperature, top_k)
        results[("sample", temperature, top_k)] = r
        emit({"phase": "kernel", "kernel": "fused_sample", **r})

    for dtype in (torch.bfloat16, torch.float32):
        r = check_layer_norm_bwd(dev, dtype)
        results[("ln_bwd", dtype)] = r
        emit({"phase": "kernel", "kernel": "layer_norm_bwd", **r})
    flash_cases = (
        ("gpt124", torch.bfloat16, {"library": True}),
        ("gpt124", torch.float32, {}),
        ("gqa", torch.bfloat16, {"Hkv": 4}),
        ("non_causal", torch.bfloat16, {"causal": False}),
        ("kv_bias", torch.bfloat16, {"masked": True}),
        ("offsets", torch.bfloat16, {"S": 1000, "q_offset": 0, "k_offset": 100}),
    )
    for case, dtype, kw in flash_cases:
        r = check_flash(dev, dtype, case, **kw)
        results[("flash", case, dtype)] = r
        for name in ("fwd", "dq", "dkv"):
            emit({"phase": "kernel", **r[name]})
    lap("kernels")

    counts, _, params, config = serve_phase()
    lap("serve")
    parity_phase()
    lap("parity")
    profile_phase(params, config)
    lap("profile")
    del params
    train_args, train_counts, step_ms = train_phase()
    lap("train")
    flash_reproducible(dev)
    lap("train_reproducible")
    flash_grad_parity_phase(dev)
    lap("flash_grad_parity")
    train_parity_phase()
    lap("train_parity")
    train_profile_phase(train_args, step_ms)
    lap("train_profile")
    emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})

    main_path = (
        ("layer_norm_fwd", "apex_tpu_torch/csrc/layer_norm.cu",
         "apex_tpu/ops/layer_norm_pallas.py:39", results[("ln", 8, torch.bfloat16)]),
        ("paged_decode_attention", "apex_tpu_torch/csrc/decode_attention.cu",
         "apex_tpu/ops/decode_attention_pallas.py:130",
         results[("attn", 12, torch.bfloat16)]),
        ("fused_sample", "apex_tpu_torch/csrc/decode_sampling.cu",
         "apex_tpu/ops/decode_sampling_pallas.py:126", results[("sample", 1.0, 0)]),
        ("layer_norm_bwd", "apex_tpu_torch/csrc/layer_norm.cu",
         "apex_tpu/ops/layer_norm_pallas.py:108", results[("ln_bwd", torch.bfloat16)]),
        ("flash_fwd", "apex_tpu_torch/csrc/flash_attention.cu",
         "apex_tpu/ops/flash_attention_pallas.py:145",
         results[("flash", "gpt124", torch.bfloat16)]["fwd"]),
        ("flash_dq", "apex_tpu_torch/csrc/flash_attention.cu",
         "apex_tpu/ops/flash_attention_pallas.py:339",
         results[("flash", "gpt124", torch.bfloat16)]["dq"]),
        ("flash_dkv", "apex_tpu_torch/csrc/flash_attention.cu",
         "apex_tpu/ops/flash_attention_pallas.py:394",
         results[("flash", "gpt124", torch.bfloat16)]["dkv"]),
    )
    # launches: the serve phase's for the serving kernels, the train
    # phase's for the training kernels (LayerNorm forward runs in both;
    # its line keeps the serve phase's count)
    launches = {**train_counts, **{k: counts[k] for k in
                                   ("layer_norm_fwd", "paged_decode_attention",
                                    "fused_sample")}}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": r["max_abs_err"],
         "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, src, rep, r in main_path]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
