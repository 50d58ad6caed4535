#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (apex_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. card: PyTorch version, the card, ``nvidia-smi`` name and power
   limit; TF32 is switched off for matmuls and cuDNN.
2. build: the CUDA kernels are compiled from ``apex_tpu_torch/csrc``.
3. kernels: each kernel against its plain PyTorch version at the
   serve and train paths' shapes (LN forward at 8, 40 and 64 rows for
   serving and 8192 for training; at 8192 rows, forward and backward in
   bf16 and fp32: the RMS-affine, RMS and non-affine modes, H = 1024 and
   4096 on the fast path, every mode at H = 770 and a misaligned view on
   the general path; the LN plan as ``ln_plan`` states it against the C
   entry's at 624 shapes; the fused-CE forward, dx and
   dembed at N = 8192, H = 768, V = 50304 with bf16 dots, a ragged
   N = 1000, V = 50257 case, every (x, embed) dtype pair at H = 768 and
   1024, H = 80 and 784 (widths that the backward's K groups split
   unevenly), and a control -- the backward fed lse + log 2 -- that must
   fail the same band; the backward's tile plan as ``ce_bwd_plan``
   states it against the C entry's), with its error and tolerance, its device
   time beside the plain version's, one PyTorch library call's where
   one computes the same function (for the CE kernels the dense bf16
   head, two calls), and the bound (the larger of bytes at 3.35 TB/s
   and flops at the peak rate of their type: 989 TFLOP/s bf16 tensor
   cores, 67 TFLOP/s fp32).  Paged decode attention runs in both
   layouts: width 1 (8 sequences) and width > 1 at the verify shape (8
   sequences x 5 rows) and the chunk shape (one sequence x 64 rows),
   MHA and GQA, bf16 and fp32, each width-W launch also bitwise equal to
   W width-1 launches of the same rows, and at the model's full context
   (8 sequences x up to 1024 positions, W = 1 and W = 5, lengths on the
   kernel's 64-position stage edges and one past them).  Flash attention
   at GPT-124M's shape (B*H = 96, S = 1024, causal) in bf16 at D = 32,
   64 and 128 (each with SDPA's time), fp32, GQA, non-causal, a key
   bias, offsets, a ring-attention chunk (512 q rows after 512 of 1024
   keys), and bf16 at D = 16, 48, 80, 96 and 112 (B = 2); the bf16
   backward's shared memory as ``bwd_launch_plan`` states it against
   the C entry's at every head dim.
4. serve: ``apex_tpu_torch.serve_gpt`` at its defaults — GPT-124M
   width, bf16, 8 slots, 32 requests — with every kernel's launch
   count from that run, checked exactly against the steps taken.
5. parity: full width in fp32, greedy, 4 requests of 8 tokens: every
   served token must be the argmax of the full-sequence forward.
6. profile: device busy share and kernel time by name over decode
   steps of the bf16 engine.
6a. serve_v2: ``serve_gpt`` at the serving-v2 command of
   ``examples/gpt/serve_gpt.py`` (``--draft-len 4 --prefix-sharing
   --system-prompt-len 128 --prefill-chunk 64 --best-effort-frac 0.5``),
   the rest at the serve defaults: 32/32 requests of 32 tokens, and
   exact launch counts from the scheduler's stats (N = verify + chunk
   steps: LN forward 25 N, width > 1 attention 12 N, width-1 attention
   0, sampling verify steps + prefills).
6b. serve_v2_profile: device busy share and kernel time by name over
   one verify step and one 64-position prefill chunk.
6c. serve_v2_parity: fp32, repetitive prompts after a shared system
   prompt: the speculative stream equals the plain one (T=0 and T=1),
   chunked prefill the one-shot, prefix-shared the unshared; greedy
   tokens are the full forward's argmax; some draft is accepted.
7. train: ``apex_tpu_torch.train_gpt`` at its defaults — bench.py's
   GPT-124M step, seq 1024, batch 8, bf16, flash attention, full remat,
   the dense head, FusedAdam — one warm-up step and 5 timed steps:
   losses finite and falling, launch counts exactly 49 / 25 / 24 / 12 /
   12 / 0 / 0 / 0 a step (LN fwd, LN bwd, flash fwd, dq, dkv, ce_fwd,
   ce_dx, ce_dembed).
8. train_fce: the same with ``--fused-ce`` (bench.py's
   ``gpt124_s1024_fce``): launch counts 49 / 25 / 24 / 12 / 12 / 1 / 1 /
   1 a step, the warm-up loss within 1e-5 (relative) of the dense
   step's, and the two steps' times side by side.
9. train_reproducible: two backward passes of one flash layer bitwise
   equal, two calls each of the CE dx and dembed kernels at GPT-124M
   bitwise equal, and two LN backward calls at 8192 x 768 (bf16, affine
   with bias) with bitwise equal dx, dw and db.
10. flash_grad_parity: one bf16 flash layer in the model's layout (B=8,
    H=12, S=1024; and GQA H_kv=4): the output and the gradients through
    ``flash_attention`` on the card (the bf16 kernels the train step
    runs) against the CPU (plain versions) on the same bf16 inputs.
11. fused_ce_grad_parity: ``fused_lm_head_ce`` in ``gpt_loss``'s layout
    (S=256, B=8, full vocab): loss, dx and dembed on the card against
    the CPU's plain versions with bf16 dots, and two backward passes on
    the card bitwise equal.
12. norm_modules: ``FusedLayerNorm`` and ``FusedRMSNorm``, affine and
    not, memory_efficient off and on, bf16 (1024, 8, 768), card against
    CPU, with exact launch counts.
13. train_parity: the loss and every gradient leaf of one step at full
    width (2 layers, seq 256, batch 2, fp32, dense head) on the card
    (the fp32 kernels) against the CPU (plain versions), from the same
    numpy params.
14. train_profile: device busy share and kernel time by name over one
    training step with the dense head and one with the fused CE.

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


def device_us_by_name(prof):
    """{name: total device µs} of the CUDA activity a profiler recorded."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
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
#: LayerNorm kernel modes: (rms, has weight, has bias)
LN_MODES = {"ln_affine": (False, True, True), "ln": (False, False, False),
            "rms_affine": (True, True, False), "rms": (True, False, False)}


def _ln_params(rng, dev, H, mode):
    _, affine, with_bias = LN_MODES[mode]
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(H, dtype=np.float32)).to(dev)
    b = torch.from_numpy(0.1 * rng.standard_normal(H, dtype=np.float32)).to(dev)
    return (w if affine else None), (b if with_bias else None)


def _ln_library(x, w, b, eps, rms):
    """The PyTorch call computing the same norm: F.rms_norm or
    F.layer_norm, params in x's dtype."""
    F = torch.nn.functional
    H = x.shape[-1]
    if rms:
        return F.rms_norm(x, (H,), w, eps)
    return F.layer_norm(x, (H,), w, b, eps)


def _ln_rows(rng, dev, R, H, dtype, misaligned, scale=1.0, shift=0.0):
    """An (R, H) ``dtype`` tensor of normal values on the card; with
    ``misaligned`` a contiguous view one element into a larger buffer,
    so that its data does not start on 16 bytes."""
    x = torch.from_numpy(rng.standard_normal((R, H), dtype=np.float32) * scale + shift)
    x = x.to(dev, dtype)
    if not misaligned:
        return x
    buf = torch.empty(R * H + 1, dtype=dtype, device=dev)
    view = buf[1:].view(R, H)
    view.copy_(x)
    return view


def _ln_path(R, H, dtype, tensors, want):
    """The path ``ln_plan`` gives these tensors, which must be ``want``
    (the case is there to run that path)."""
    from apex_tpu_torch.ops.layer_norm import _aligned, ln_plan

    path = "fast" if ln_plan(R, H, dtype, _aligned(*tensors)).fast else "general"
    if path != want:
        raise AssertionError(f"layer_norm R={R} H={H} {dtype}: plan takes the {path} "
                             f"path, the case is for the {want} path")
    return path


def check_layer_norm(dev, R, dtype, mode="ln_affine", H=768, path="fast", misaligned=False):
    from apex_tpu_torch.ops.layer_norm import layer_norm_fwd, layer_norm_fwd_plain

    eps = 1e-5
    rms = LN_MODES[mode][0]
    rng = np.random.default_rng(R)
    x = _ln_rows(rng, dev, R, H, dtype, misaligned, scale=2.0, shift=0.5)
    w, b = _ln_params(rng, dev, H, mode)
    _ln_path(R, H, dtype, (x, w, b), path)
    y, mean, rstd = layer_norm_fwd(x, w, b, eps, rms)
    py, pmean, prstd = layer_norm_fwd_plain(x, w, b, eps, rms)
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
        y32 = layer_norm_fwd_plain(x.float(), w, b, eps, rms)[0]
        excess = float(((y.float() - y32).abs() - 2.0 ** -8 * y32.abs()).max())
        ok = excess <= 1e-5
        tol = ("y within 2**-8 |y| + 1e-5 of the plain fp32 y (rounding to bf16, "
               "then fp32 row stats in another order)")
    else:
        ulps = None
        ok, tol = err <= 1e-5, "1e-5 abs (fp32 row stats summed in another order)"
    if not ok or stat_err > 1e-5:
        raise AssertionError(f"layer_norm {mode} R={R} {dtype}: err {err}, ulps {ulps}, "
                             f"band excess {excess}, stats {stat_err}")
    xb = x.element_size()
    nparams = sum(t is not None for t in (w, b))
    nbytes = 2 * R * H * xb + nparams * H * 4 + 2 * R * 4
    bms, by = bound(nbytes, 8 * R * H)
    wl, bl = (None if t is None else t.to(dtype) for t in (w, b))
    t = timings(lambda: layer_norm_fwd(x, w, b, eps, rms),
                lambda: layer_norm_fwd_plain(x, w, b, eps, rms),
                lambda: _ln_library(x, wl, bl, eps, rms))
    return {"mode": mode, "R": R, "H": H, "dtype": str(dtype).replace("torch.", ""),
            "path": path, "misaligned": misaligned,
            "max_abs_err": err, "bf16_ulps": ulps, "band_excess": excess,
            "stats_err": stat_err,
            "tolerance": tol, "bound_ms": bms, "bound_by": by, **t}


def layer_norm_kernels(dev, results, lib):
    """The LayerNorm part of the kernels phase: each case's line, its
    result kept in ``results``."""
    # serve (decode, verify 8 x 5, prefill and chunk) and train (B * S) rows
    for R in (8, 40, 64, 8192):
        for dtype in (torch.bfloat16, torch.float32):
            r = check_layer_norm(dev, R, dtype)
            results[("ln", R, dtype)] = r
            emit({"phase": "kernel", "kernel": "layer_norm_fwd", **r})
    for dtype in (torch.bfloat16, torch.float32):
        r = check_layer_norm_bwd(dev, dtype)
        results[("ln_bwd", dtype)] = r
        emit({"phase": "kernel", "kernel": "layer_norm_bwd", **r})
    # at the train path's rows: the RMS and non-affine modes, the widths of
    # gpt345 (1024) and bench.py's fused_ln (4096); a width the fast path
    # does not take (770) and a misaligned view, each on the general path
    ln_cases = [(mode, 768, "fast", False) for mode in ("rms_affine", "rms", "ln")]
    ln_cases += [("ln_affine", H, "fast", False) for H in (1024, 4096)]
    ln_cases += [(mode, 770, "general", False) for mode in LN_MODES]
    ln_cases += [("ln_affine", 768, "general", True)]
    for mode, H, path, misaligned in ln_cases:
        for dtype in (torch.bfloat16, torch.float32):
            kw = {"H": H, "path": path, "misaligned": misaligned}
            r = check_layer_norm(dev, 8192, dtype, mode, **kw)
            results[("ln", 8192, dtype, mode, H, misaligned)] = r
            emit({"phase": "kernel", "kernel": "layer_norm_fwd", **r})
            r = check_layer_norm_bwd(dev, dtype, mode, **kw)
            results[("ln_bwd", dtype, mode, H, misaligned)] = r
            emit({"phase": "kernel", "kernel": "layer_norm_bwd", **r})
    emit({"phase": "kernel", "kernel": "layer_norm_plan", **check_ln_plan(lib)})


def check_decode_attention(dev, h_kv, dtype, H=12, D=64):
    from apex_tpu_torch.ops.decode_attention import (
        decode_attention_plain, paged_decode_attention,
    )

    B, PS, P, num_pages = 8, 16, 6, 49
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
        raise AssertionError(f"decode_attention D={D} h_kv={h_kv} {dtype}: err {err} > {tol}")
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


#: the width > 1 cases of paged decode attention, at the serving-v2
#: path's shapes: the verify step (8 sequences x W = 5, draft_len 4) and
#: a prefill chunk (one sequence x W = 64), with P = 15 pages of 16; and
#: the long cases at the model's full context (P = 64 pages of 16 = 1024
#: positions, a pool of 513 pages), at W = 1 and W = 5
WIDE_CASES = {
    # per sequence, the length of its first row (each next row one more):
    # inactive, 1, rows ending on a page edge (16) and one past it (17),
    # and a sequence reaching the table's end (240 = 15 x 16)
    "verify": {"B": 8, "W": 5, "first": [0, 1, 12, 13, 30, 60, 100, 236]},
    # one sequence's chunk at positions 128..191: lengths 129..184, and 8
    # pad rows (the final chunk's) of length 0
    "chunk": {"B": 1, "W": 64, "first": [129], "pad": 8},
    # lengths on the kernel's 64-position stage edges and one past them
    # (64, 65; 128, 129), mid-table, and the table's end (1024)
    "long_w1": {"B": 8, "W": 1, "first": [0, 1, 64, 65, 128, 129, 700, 1024],
                "P": 64, "num_pages": 513},
    # rows 60..64 end on a stage edge, 64..68 and 128..132 start on one
    # and run past it, 1020..1024 reach the table's end
    "long": {"B": 8, "W": 5, "first": [0, 1, 60, 64, 124, 128, 1019, 1020],
             "P": 64, "num_pages": 513},
}


def check_decode_attention_wide(dev, case, h_kv, dtype, H=12, D=64):
    """The ``width > 1`` layout against its plain version, with the
    width = 1 bands; each width-W launch also against W width-1 launches
    of the same rows, which must be bitwise equal."""
    from apex_tpu_torch.ops.decode_attention import (
        decode_attention_plain, paged_decode_attention,
    )

    spec = WIDE_CASES[case]
    B, W = spec["B"], spec["W"]
    PS = 16
    P, num_pages = spec.get("P", 15), spec.get("num_pages", 121)
    rng = np.random.default_rng(W * 100 + h_kv)
    q = torch.from_numpy(rng.standard_normal((B * W, H, D), dtype=np.float32)).to(dev, dtype)
    kp = torch.from_numpy(rng.standard_normal((num_pages, PS, h_kv, D), dtype=np.float32)).to(dev, dtype)
    vp = torch.from_numpy(rng.standard_normal((num_pages, PS, h_kv, D), dtype=np.float32)).to(dev, dtype)
    pt_np = rng.integers(1, num_pages, size=(B, P)).astype(np.int32)
    pt_np[B - 1, 1] = -5      # out of range, inside the read range
    pt_np[B - 1, 9] = 1000
    first = np.asarray(spec["first"], np.int32)
    lens_np = (first[:, None] + np.arange(W, dtype=np.int32)[None, :])
    lens_np = np.where(first[:, None] > 0, lens_np, 0)
    if spec.get("pad"):
        lens_np[:, W - spec["pad"]:] = 0
    lens_np = lens_np.reshape(B * W).astype(np.int32)
    pt = torch.from_numpy(pt_np).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    out = paged_decode_attention(q, kp, vp, pt, lens, width=W)
    ref = decode_attention_plain(q, kp, vp, pt, lens, width=W)
    # the same rows, one width-1 launch per column w
    q4, l2 = q.view(B, W, H, D), lens.view(B, W)
    alone = [paged_decode_attention(q4[:, w].contiguous(), kp, vp, pt, l2[:, w].contiguous())
             for w in range(W)]
    torch.cuda.synchronize()
    bitwise = all(bool(torch.equal(out.view(B, W, H, D)[:, w], a)) for w, a in enumerate(alone))
    err = float((out.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    if dtype == torch.bfloat16:
        tol = 2 * 2.0 ** -8 * scale
        why = "2 bf16 ulps at the output's scale (probabilities round to bf16 before and after normalizing)"
    else:
        tol = 1e-5 * scale
        why = "1e-5 abs (online against full softmax, other summation order)"
    zero_rows = torch.from_numpy(lens_np == 0).to(dev)
    if (err > tol or not bitwise
            or float(out[zero_rows].float().abs().max()) != 0.0):
        raise AssertionError(f"decode_attention width={W} {case} D={D} h_kv={h_kv} {dtype}: "
                             f"err {err} > {tol}, bitwise vs width 1: {bitwise}")
    eb, qb = kp.element_size(), q.element_size()
    seq_len = lens_np.reshape(B, W).max(1)  # each sequence's longest row
    nbytes = (2 * int(seq_len.sum()) * h_kv * D * eb + B * W * H * D * (qb + eb)
              + B * P * 4 + B * W * 4)
    bms, by = bound(nbytes, 4 * int(lens_np.sum()) * H * D,
                    PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32)
    # library yardstick: SDPA over K/V gathered (and GQA-repeated)
    # beforehand, each query row masked at its own length
    ptc = pt.long().clamp(0, num_pages - 1)
    kg = kp[ptc].reshape(B, P * PS, h_kv, D).transpose(1, 2).repeat_interleave(H // h_kv, 1)
    vg = vp[ptc].reshape(B, P * PS, h_kv, D).transpose(1, 2).repeat_interleave(H // h_kv, 1)
    kg, vg = kg.to(dtype).contiguous(), vg.to(dtype).contiguous()
    qs = q4.transpose(1, 2).contiguous()  # (B, H, W, D)
    mask = (torch.arange(P * PS, device=dev)[None, None, :] < l2[:, :, None])[:, None]
    t = timings(lambda: paged_decode_attention(q, kp, vp, pt, lens, width=W),
                lambda: decode_attention_plain(q, kp, vp, pt, lens, width=W),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qs, kg, vg, attn_mask=mask))
    return {"case": case, "B": B, "W": W, "H": H, "H_kv": h_kv, "D": D, "page": PS,
            "pages_per_seq": P, "first_row_lengths": spec["first"],
            "pad_rows": spec.get("pad", 0), "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "tolerance": tol, "tolerance_why": why,
            "bitwise_equal_to_width_1": bitwise, "bound_ms": bms, "bound_by": by, **t}


def check_decode_plan(lib):
    """``launch_plan`` (the Python statement the CPU tests check)
    against the plan the C entry launches with, at every width, GQA
    group, head dim and dtype pair: equal, field for field."""
    import ctypes

    from apex_tpu_torch.ops.decode_attention import launch_plan

    got = (ctypes.c_int * 3)()
    n = 0
    for width in (1, 2, 5, 16, 17, 64, 65):
        for group in (1, 3, 4, 12):
            for D in range(16, 129, 16):
                for qd, kd in ((1, 1), (0, 0), (0, 1), (1, 0)):
                    rc = lib.apex_paged_decode_attention_plan(width, group, D, qd, kd,
                                                              ctypes.addressof(got))
                    want = tuple(launch_plan(width, group, D, 4 - 2 * qd, 4 - 2 * kd))
                    if rc or tuple(got) != want:
                        raise AssertionError(
                            f"decode launch plan W={width} group={group} D={D} dtypes "
                            f"{qd},{kd}: C {tuple(got)} (rc {rc}), Python {want}")
                    n += 1
    return {"plans_checked": n}


def check_flash_plan(lib):
    """The bf16 backward's shared memory as ``bwd_launch_plan`` states it
    (the Python plan the CPU tests check) against ``apex_flash_smem``,
    which the launches use, at every head dim: equal."""
    from apex_tpu_torch.ops.flash_attention import bwd_launch_plan

    n = 0
    for which in (1, 2):
        for D in range(16, 129, 16):
            got = lib.apex_flash_smem(which, D, 1)
            want = bwd_launch_plan(which, 1024, 1024, D, True).smem_bytes
            if got != want:
                raise AssertionError(f"flash backward plan which={which} D={D}: C {got} B, "
                                     f"Python {want} B")
            n += 1
    return {"plans_checked": n}


def check_ce_plan(lib):
    """The fused-CE backward's plan as ``ce_bwd_plan`` states it (the
    Python plan the CPU tests check) against ``apex_ce_bwd_plan``, what
    the launches use, for dx and dembed at every dtype pair, at GPT-124M,
    every ``CE_GRID`` shape and every H the kernels take: equal, field
    for field."""
    import ctypes

    from apex_tpu_torch.ops.fused_ce_kernels import ce_bwd_plan

    shapes = {(8192, 768, 50304)} | {(kw["N"], kw["H"], kw["V"]) for _, kw in CE_GRID}
    shapes |= {(8192, H, 50304) for H in range(16, 1025, 16)}
    got = (ctypes.c_int64 * 7)()
    n = 0
    for N, H, V in sorted(shapes):
        for which in (1, 2):
            for xd in (torch.float32, torch.bfloat16):
                for ed in (torch.float32, torch.bfloat16):
                    rc = lib.apex_ce_bwd_plan(which, N, H, V, int(xd == torch.bfloat16),
                                              int(ed == torch.bfloat16), ctypes.addressof(got))
                    want = tuple(ce_bwd_plan(which, N, H, V, xd, ed))
                    if rc or tuple(got) != want:
                        raise AssertionError(
                            f"CE backward plan which={which} N={N} H={H} V={V} dtypes "
                            f"{xd},{ed}: C {tuple(got)} (rc {rc}), Python {want}")
                    n += 1
    return {"plans_checked": n}


#: the widths the LayerNorm plan check runs: every path and warps a row,
#: ragged widths beside them, past the fast path and up to MAX_HIDDEN
LN_PLAN_WIDTHS = (8, 12, 16, 24, 96, 100, 256, 512, 764, 768, 770, 1000, 1024, 1028, 1536,
                  2048, 2052, 3072, 4096, 4100, 5120, 6144, 8192, 8200, 10240, 12032)


def check_ln_plan(lib):
    """``ln_plan`` (the Python statement the CPU tests check) against
    ``apex_layer_norm_plan``, what the launches use, at R in {1, 7, 8,
    40, 64, 8192}, every width of ``LN_PLAN_WIDTHS``, both dtypes,
    aligned or not: equal, field for field."""
    import ctypes

    from apex_tpu_torch.ops.layer_norm import LnPlan, ln_plan

    got = (ctypes.c_int64 * len(LnPlan._fields))()
    n = 0
    for R in (1, 7, 8, 40, 64, 8192):
        for H in LN_PLAN_WIDTHS:
            for dtype in (torch.float32, torch.bfloat16):
                for aligned in (True, False):
                    rc = lib.apex_layer_norm_plan(R, H, int(dtype == torch.bfloat16),
                                                  int(aligned), ctypes.addressof(got))
                    want = tuple(ln_plan(R, H, dtype, aligned))
                    if rc or tuple(got) != want:
                        raise AssertionError(
                            f"LayerNorm plan R={R} H={H} {dtype} aligned={aligned}: C "
                            f"{tuple(got)} (rc {rc}), Python {want}")
                    n += 1
    return {"plans_checked": n}


def check_sampling(dev, temperature, top_k, N):
    from apex_tpu_torch.ops.decode_sampling import (
        fused_sample, fused_sample_plain, gumbel_from_seed,
    )

    V, H = 50304, 768
    rng = np.random.default_rng(7 + N)
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
                    f"sampling N={N} T={temperature} top_k={top_k}: kernel {got.tolist()} vs "
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


def check_layer_norm_bwd(dev, dtype, mode="ln_affine", R=8192, H=768, path="fast",
                         misaligned=False):
    from apex_tpu_torch.ops.layer_norm import (
        layer_norm_bwd, layer_norm_bwd_plain, layer_norm_fwd_plain,
    )

    eps = 1e-5
    rms, _, with_bias = LN_MODES[mode]
    rng = np.random.default_rng(11)
    x = _ln_rows(rng, dev, R, H, dtype, misaligned, scale=2.0, shift=0.5)
    dy = _ln_rows(rng, dev, R, H, dtype, misaligned)
    w, b = _ln_params(rng, dev, H, mode)
    _ln_path(R, H, dtype, (x, dy, w), path)
    _, mean, rstd = layer_norm_fwd_plain(x, w, b, eps, rms)
    args = (x, w, dy, mean, rstd, rms, with_bias)
    dx, dw, db = layer_norm_bwd(*args)
    pdx, pdw, pdb = layer_norm_bwd_plain(*args)
    dx32 = layer_norm_bwd_plain(x.float(), w, dy.float(), mean, rstd, rms, with_bias)[0]
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
    sum_err = 0.0
    for got, want, scale in ((dw, pdw, w_scale), (db, pdb, b_scale)):
        if (got is None) != (want is None):
            raise AssertionError(f"layer_norm_bwd {mode}: dw/db presence differs")
        if got is not None:
            sum_err = max(sum_err, float(((got - want).abs() / scale).max()))
    ulps = bf16_ulps(dx, pdx) if dtype == torch.bfloat16 else None
    tol = ("dx within 2**-8 |dx| + 1e-5 of the plain fp32 dx (rounding to x's dtype, "
           "then fp32 row sums in another order); dw, db within 1e-5 of the sum "
           "of |terms| (fp32 column sums in another order)")
    if dx_excess > 1e-5 or sum_err > 1e-5:
        raise AssertionError(f"layer_norm_bwd {mode} {dtype}: dx err {dx_err} ulps {ulps}, "
                             f"dw/db rel {sum_err}")
    xb = x.element_size()
    nparams = sum(t is not None for t in (dw, db))
    nbytes = 3 * R * H * xb + 2 * R * 4 + (int(w is not None) + nparams) * H * 4
    bms, by = bound(nbytes, 12 * R * H)
    xl = x.detach().requires_grad_()
    wl, bl = (None if t is None else t.to(dtype).requires_grad_() for t in (w, b))
    yl = _ln_library(xl, wl, bl, eps, rms)
    leaves = [t for t in (xl, wl, bl) if t is not None]
    t = timings(lambda: layer_norm_bwd(*args),
                lambda: layer_norm_bwd_plain(*args),
                lambda: torch.autograd.grad(yl, leaves, dy, retain_graph=True))
    return {"mode": mode, "R": R, "H": H, "dtype": str(dtype).replace("torch.", ""),
            "path": path, "misaligned": misaligned,
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
                q_offset=0, k_offset=0, masked=False, library=False, Sk=None):
    """flash_fwd, flash_dq and flash_dkv against their plain versions on
    one input (S q rows, Sk keys, Sk = S by default); the backward
    kernels and plain versions get the kernel's lse and delta, so each
    kernel is held on its own."""
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops.attention import padding_bias

    rng = np.random.default_rng(S + Hkv)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)

    Sk = Sk or S
    q, do = randn(B * H, S, D), randn(B * H, S, D)
    k, v = randn(B * Hkv, Sk, D), randn(B * Hkv, Sk, D)
    bias = None
    if masked:  # batch row b keeps its first Sk - 100 * b keys
        valid = (torch.arange(Sk, device=dev)[None, :]
                 < (Sk - 100 * torch.arange(B, device=dev))[:, None])
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
    e, pairs = q.element_size(), causal_pairs(S, Sk, causal, q_offset, k_offset)
    BH, BKV = B * H, B * Hkv
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    qb, kb, rb = BH * S * D * e, BKV * Sk * D * e, BH * S * 4
    biasb = 0 if bias is None else B * Sk * 4
    bounds = {"fwd": bound(2 * qb + 2 * kb + rb + biasb, 4 * D * pairs * BH, peak),
              "dq": bound(3 * qb + 2 * kb + 2 * rb + biasb, 6 * D * pairs * BH, peak),
              "dkv": bound(2 * qb + 4 * kb + 2 * rb + biasb, 8 * D * pairs * BH, peak)}
    lib = {"fwd": None, "bwd": None}
    if library:  # SDPA's causal mask is the kernels' only at Sq == Sk, no offsets
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
    base = {"case": case, "B": B, "H": H, "H_kv": Hkv, "S": S, "Sk": Sk, "D": D,
            "causal": causal,
            "q_offset": q_offset, "k_offset": k_offset, "kv_bias": masked,
            "dtype": str(dtype).replace("torch.", ""), "fully_masked_rows": dead_rows,
            "rel_errors": errs, "abs_errors": abs_errs, "tolerance": tol,
            "tolerance_why": why}
    outputs = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}
    return {name: {**base, "kernel": f"flash_{name}",
                   "max_abs_err": max(abs_errs[n] for n in outputs[name]),
                   "bound_ms": bounds[name][0], "bound_by": bounds[name][1], **t[name]}
            for name in outputs}


#: bands of the CE kernels against their plain versions with bf16 dots
#: (the kernels' arithmetic; the two sum in other orders):
#: - m, lse, tgt: abs, times max(1, the largest |logit|);
#: - dx and dembed, per element, from that element's own product terms:
#:   |kernel - plain| <= out |plain| + acc_step * K/16 * T + flip * M.
#:   ``out`` is one rounding of the stored value (2**-7 for a bf16 dx, 0
#:   for fp32); T the sum of the |terms| d * e (dx) or d * x (dembed)
#:   summed into it, K their count, and acc_step what each 16-term mma
#:   step may lose of the fp32 accumulator; M a bound on its largest
#:   term (its target term, or the other ids' largest |d| in its row or
#:   vocab column times the largest |e| or |x| in its column), and
#:   ``flip`` four bf16 steps of d (2**-7 of it each): d's rounding moves
#:   when p changes in its last place, and over millions of elements a
#:   few of one element's terms flip at once.  So each element is held
#:   at the scale of its own terms: where no id is a target (most of
#:   dembed's rows), at the softmax part's, not at the one-hot part's.
CE_TOL = {"fwd": 1e-5, "out_bf16": 2.0 ** -7, "acc_step": 2.0 ** -22, "flip": 2.0 ** -5}

#: the CE kernels' dtype and width cases beside the GPT-124M one: every
#: (x, embed) dtype pair at H = 768 and 1024 (each instantiation and
#: backward tile shape of csrc/fused_ce.cu), and H = 80 (64 own rows) and
#: 784 (32 own rows), whose 16-column steps the backward's K groups split
#: unevenly; N and V ragged, embed std 0.1 for a peaked softmax
_CE_PAIRS = tuple((xd, ed) for xd in (torch.bfloat16, torch.float32)
                  for ed in (torch.float32, torch.bfloat16))
CE_GRID = tuple((f"x_{xd}_e_{ed}_h{H}".replace("torch.", ""),
                 {"N": 1000, "V": 8191, "H": H, "x_dtype": xd, "e_dtype": ed,
                  "e_std": 0.1, "library": False})
                for H, pairs in ((768, _CE_PAIRS), (1024, _CE_PAIRS),
                                 (80, ((torch.float32, torch.float32),)),
                                 (784, ((torch.bfloat16, torch.float32),)))
                for xd, ed in pairs)


def ce_term_scales(x2, e, t, lse, g, rows=1024):
    """The band's allowance for each element of dx and of dembed (plain
    arithmetic on x2's device): acc_step * K/16 * T + flip * M, with T
    the sum of its |terms| (|d| . |e|, |d|^T . |x| on the bf16-rounded
    operands) and M a bound on its largest term: the larger of its
    target terms (d at the target id times e or x) and the largest other
    |d| of its row (dx) or vocab column (dembed) times the largest |e| or
    |x| of its column."""
    bf = torch.bfloat16
    xb, eb = x2.to(bf).float(), e.to(bf).float()
    (N, H), V = x2.shape, e.shape[0]
    tl, ea = t.long(), eb.abs()
    cols = torch.arange(V, device=x2.device)
    t_dx, hit_dx, other_row = [], [], []
    t_de, hit_de = (torch.zeros(V, H, device=x2.device) for _ in range(2))
    other_col = torch.zeros(V, device=x2.device)
    for i in range(0, N, rows):
        xc, tc = xb[i:i + rows], tl[i:i + rows]
        p = torch.exp(xc @ eb.T - lse[i:i + rows, None])
        hit = (cols[None, :] == tc[:, None]).float()
        d = ((p - hit) * g[i:i + rows, None]).to(bf).float().abs()
        t_dx.append(d @ ea)
        t_de += d.T @ xc.abs()
        d_t = d.gather(1, tc[:, None])  # the target's |d|, (rows, 1)
        hit_dx.append(d_t * ea[tc])
        hit_de.index_add_(0, tc, d_t * xc.abs())
        other = d * (1 - hit)
        other_row.append(other.max(1).values)
        other_col = torch.maximum(other_col, other.max(0).values)
    m_dx = torch.maximum(torch.cat(hit_dx), torch.cat(other_row)[:, None] * ea.max(0).values)
    m_de = torch.maximum(hit_de, other_col[:, None] * xb.abs().max(0).values)
    acc = {"dx": CE_TOL["acc_step"] * math.ceil(V / 16),
           "dembed": CE_TOL["acc_step"] * math.ceil(N / 16)}
    return {"dx": acc["dx"] * torch.cat(t_dx) + CE_TOL["flip"] * m_dx,
            "dembed": acc["dembed"] * t_de + CE_TOL["flip"] * m_de}


def ce_band(got, want, allowance):
    """max over elements of (|got - want| - out |want|) / allowance: the
    band holds while it is <= 1 (an element with no allowance must be
    exact)."""
    out = CE_TOL["out_bf16"] if got.dtype == torch.bfloat16 else 0.0
    past = (got.float() - want.float()).abs() - out * want.float().abs()
    return float(torch.where(past > 0, past / allowance, 0.0).max())


def check_fused_ce(dev, case, N=8192, H=768, V=50304, x_dtype=torch.bfloat16,
                   e_dtype=torch.float32, e_std=0.02, library=True):
    """ce_fwd, ce_dx and ce_dembed against their plain versions with bf16
    dots on one input (by default x bf16 and embed fp32 as in training,
    embed std 0.02 as at init; g = 1/N as the mean loss gives it).  The
    backward kernels and plain versions get the kernel's lse, so each
    kernel is held on its own.  A control must fail the same band: the
    backward kernels fed lse + log 2, every p halved.  The error against
    the fp32-dot plain version is reported unbanded: the size of the bf16
    rounding."""
    from apex_tpu_torch.ops import fused_ce_kernels as K

    bf = torch.bfloat16
    rng = np.random.default_rng(N + V + H)
    x = torch.from_numpy(rng.standard_normal((N, H), dtype=np.float32)).to(dev, x_dtype)
    e = torch.from_numpy(e_std * rng.standard_normal((V, H), dtype=np.float32)).to(dev, e_dtype)
    t_np = rng.integers(0, V, size=N)
    t_np[:4] = (-3, V + 5, V - 1, 0)  # out of range ids, clamped as the caller does
    t = torch.from_numpy(np.clip(t_np, 0, V - 1).astype(np.int32)).to(dev)
    g = torch.full((N,), 1.0 / N, device=dev)
    m, l, tgt = K.ce_fwd(x, e, t)
    lse = m + torch.log(l)
    dx = K.ce_dx(x, e, t, lse, g)
    de = K.ce_dembed(x, e, t, lse, g)
    lse_c = lse + math.log(2.0)
    control = {"dx": K.ce_dx(x, e, t, lse_c, g), "dembed": K.ce_dembed(x, e, t, lse_c, g)}
    pm, pl, ptgt = K.ce_fwd_plain(x, e, t, dot_dtype=bf)
    plse = pm + torch.log(pl)
    plain = {"dx": K.ce_dx_plain(x, e, t, lse, g, dot_dtype=bf),
             "dembed": K.ce_dembed_plain(x, e, t, lse, g, dot_dtype=bf)}
    allowance = ce_term_scales(x, e, t, lse, g)
    fm, fl, ftgt = K.ce_fwd_plain(x, e, t)
    fdx = K.ce_dx_plain(x, e, t, lse, g)
    fde = K.ce_dembed_plain(x, e, t, lse, g)
    torch.cuda.synchronize()
    logit_scale = max(1.0, float(pm.abs().max()))
    fwd_errs = {"m": float((m - pm).abs().max()), "lse": float((lse - plse).abs().max()),
                "tgt": float((tgt - ptgt).abs().max())}
    band, control_band = {}, {}
    for n, got in (("dx", dx), ("dembed", de)):
        band[n] = ce_band(got, plain[n], allowance[n])
        control_band[n] = ce_band(control[n], plain[n], allowance[n])
    abs_errs = {**fwd_errs, "dx": float((dx.float() - plain["dx"].float()).abs().max()),
                "dembed": float((de - plain["dembed"]).abs().max())}
    fp32_errs = {"lse": float((lse - (fm + torch.log(fl))).abs().max()),
                 "tgt": float((tgt - ftgt).abs().max()),
                 "dx": rel_err(dx, fdx), "dembed": rel_err(de, fde)}
    finite = all(bool(torch.isfinite(a.float()).all()) for a in (m, l, tgt, dx, de))
    problems = [f"{n} err {v} > {CE_TOL['fwd'] * logit_scale}" for n, v in fwd_errs.items()
                if not v <= CE_TOL["fwd"] * logit_scale]
    problems += [f"{n} uses {v} of its band" for n, v in band.items() if not v <= 1.0]
    problems += [f"{n} control (lse + log 2) passed: it uses {v} of the band"
                 for n, v in control_band.items() if not v > 1.0]
    summary = {"abs_errors": abs_errs, "band_used": band, "control_band_used": control_band,
               "logit_scale": logit_scale}
    if problems or not finite:
        raise AssertionError(f"fused_ce {case}: {problems} (finite={finite}) "
                             f"{json.dumps(summary)}")
    xb, eb, row = x.element_size(), e.element_size(), N * 4
    flops = 2.0 * N * V * H
    bounds = {"fwd": bound(N * H * xb + V * H * eb + row + 3 * row, flops, PEAK_BF16),
              "dx": bound(2 * N * H * xb + V * H * eb + 3 * row, 2 * flops, PEAK_BF16),
              "dembed": bound(N * H * xb + V * H * eb + V * H * 4 + 3 * row, 2 * flops,
                              PEAK_BF16)}
    timed = {"fwd": None, "dx": None, "dembed": None}
    if library:
        # yardstick (no single PyTorch call computes the fused CE): the
        # dense bf16 head, two calls -- torch.matmul, then F.cross_entropy
        # on the fp32 logits -- and its autograd backward, one yardstick
        # for dx and dembed together
        F = torch.nn.functional
        tl = t.long()
        xl = x.to(bf).detach().requires_grad_()
        el = e.to(bf).requires_grad_()
        loss = F.cross_entropy(torch.matmul(xl, el.T).float(), tl)
        lib_fwd = lambda: F.cross_entropy(torch.matmul(xl.detach(), el.detach().T).float(), tl)  # noqa: E731
        lib_bwd = lambda: torch.autograd.grad(loss, (xl, el), retain_graph=True)  # noqa: E731
        timed = {
            "fwd": timings(lambda: K.ce_fwd(x, e, t),
                           lambda: K.ce_fwd_plain(x, e, t, dot_dtype=bf), lib_fwd),
            "dx": timings(lambda: K.ce_dx(x, e, t, lse, g),
                          lambda: K.ce_dx_plain(x, e, t, lse, g, dot_dtype=bf), lib_bwd),
            "dembed": timings(lambda: K.ce_dembed(x, e, t, lse, g),
                              lambda: K.ce_dembed_plain(x, e, t, lse, g, dot_dtype=bf),
                              lib_bwd)}
        del loss
    base = {"case": case, "N": N, "H": H, "V": V,
            "x_dtype": str(x_dtype).replace("torch.", ""),
            "embed_dtype": str(e_dtype).replace("torch.", ""), "embed_std": e_std,
            **summary, "tolerance": CE_TOL,
            "tolerance_why": "against the plain version with bf16 dots (the kernels' "
                             "arithmetic): m, lse, tgt abs, times max(1, max |logit|) "
                             "(fp32 sums in another order); dx, dembed per element "
                             "|kernel - plain| <= out |plain| + acc_step K/16 T + flip M "
                             "(T: the sum of its |terms|, M: a bound on its largest; out: "
                             "one bf16 rounding of a bf16 dx), so each element is held at "
                             "its own terms' scale; band_used is the largest share of it "
                             "taken, and the control (lse + log 2) must exceed it",
            "fp32_dot_errors_unbanded": fp32_errs,
            "library": "dense bf16 head: torch.matmul + F.cross_entropy on fp32 logits "
                       "(forward, 2 calls); its autograd backward (dx and dembed "
                       "together)"}
    outputs = {"fwd": ("m", "lse", "tgt"), "dx": ("dx",), "dembed": ("dembed",)}
    return {name: {**base, "kernel": f"ce_{name}",
                   "max_abs_err": max(abs_errs[n] for n in outputs[name]),
                   "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                   **(timed[name] or {})}
            for name in outputs}


# -------------------------------------------------------------------- serve
def launch_counts():
    from apex_tpu_torch.ops import (
        decode_attention, decode_sampling, flash_attention, fused_ce_kernels, layer_norm,
    )

    return {"layer_norm_fwd": layer_norm.LAUNCHES,
            "paged_decode_attention": decode_attention.LAUNCHES,
            "paged_decode_attention_wide": decode_attention.WIDE_LAUNCHES,
            "fused_sample": decode_sampling.LAUNCHES,
            "layer_norm_bwd": layer_norm.BWD_LAUNCHES,
            "flash_fwd": flash_attention.FWD_LAUNCHES,
            "flash_dq": flash_attention.DQ_LAUNCHES,
            "flash_dkv": flash_attention.DKV_LAUNCHES,
            "ce_fwd": fused_ce_kernels.FWD_LAUNCHES,
            "ce_dx": fused_ce_kernels.DX_LAUNCHES,
            "ce_dembed": fused_ce_kernels.DEMBED_LAUNCHES}


def reset_counts():
    from apex_tpu_torch.ops import (
        decode_attention, decode_sampling, flash_attention, fused_ce_kernels, layer_norm,
    )

    layer_norm.LAUNCHES = decode_attention.LAUNCHES = decode_sampling.LAUNCHES = 0
    decode_attention.WIDE_LAUNCHES = 0
    layer_norm.BWD_LAUNCHES = 0
    flash_attention.FWD_LAUNCHES = flash_attention.DQ_LAUNCHES = 0
    flash_attention.DKV_LAUNCHES = 0
    fused_ce_kernels.FWD_LAUNCHES = fused_ce_kernels.DX_LAUNCHES = 0
    fused_ce_kernels.DEMBED_LAUNCHES = 0


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
              "paged_decode_attention_wide": 0, "fused_sample": steps + prefills,
              "layer_norm_bwd": 0, "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
              "ce_fwd": 0, "ce_dx": 0, "ce_dembed": 0}
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
    by_name = device_us_by_name(prof)
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "profile", "decode_steps": steps, "active": sched.num_active,
          "step_ms": 1e3 * wall / steps, "device_busy_ms_per_step": busy_ms / steps,
          "idle_share": 1 - busy_ms / (1e3 * wall),
          "top_kernels_us_per_step": [[n[:90], us / steps] for n, us in top]})


# ----------------------------------------------------------------- serve v2
#: the serving-v2 command of examples/gpt/serve_gpt.py:13-16
SERVE_V2_ARGS = ["--draft-len", "4", "--prefix-sharing", "--system-prompt-len", "128",
                 "--prefill-chunk", "64", "--best-effort-frac", "0.5"]


def serve_v2_phase():
    """``serve_gpt.run`` at the serving-v2 command, the rest at the serve
    defaults: every request served in full, and exact launch counts from
    the scheduler's stats (N = verify + chunk steps, each one
    ``forward_decode`` at width 5 or 64)."""
    from apex_tpu_torch import serve_gpt

    args = serve_gpt.build_args().parse_args(SERVE_V2_ARGS)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, sched, params, config = serve_gpt.run(args)
    counts = launch_counts()
    st = sched.stats
    n = st["spec_steps"] + st["chunk_steps"]
    L = config.num_layers
    expect = {"layer_norm_fwd": (2 * L + 1) * n, "paged_decode_attention": 0,
              "paged_decode_attention_wide": L * n,
              "fused_sample": st["spec_steps"] + st["prefills"],
              "layer_norm_bwd": 0, "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
              "ce_fwd": 0, "ce_dx": 0, "ce_dembed": 0}
    if out["requests"] != args.requests or any(
            len(c.tokens) != args.max_new for c in sched.completed):
        raise AssertionError(f"serve_v2 served {out['requests']}/{args.requests} requests")
    if st["decode_steps"] != st["spec_steps"]:
        raise AssertionError(f"serve_v2 took other steps than verify and chunk steps: {st}")
    if counts != expect:
        raise AssertionError(f"serve_v2 launch counts {counts} != expected {expect}")
    emit({"phase": "serve_v2", "argv": SERVE_V2_ARGS, **out, "launches": counts,
          "launches_expected": "LN fwd 25 N, wide attention 12 N, width-1 attention 0, "
                               "sampling spec_steps + prefills; N = spec_steps + "
                               "chunk_steps",
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return counts, params, config


def serve_v2_parity_phase():
    """fp32 on the card, repetitive prompts (as tests/test_serving_v2.py
    draws them) after a shared 128-token system prompt, 8 requests of 16
    tokens in 8 slots: the speculative stream equals the plain stream
    (T=0 and T=1), the chunked prefill the one-shot, the prefix-shared
    the unshared, and every greedy token is the full forward's argmax.
    Some verify step must accept a draft: more tokens emitted by verify
    steps than (slot, verify step) pairs.  Then the serving-v2 engine's
    copy-on-write (one prompt twice) and preemption (best-effort
    residents of a full pool yield to an interactive request) paths,
    each against the plain engine."""
    import dataclasses

    from apex_tpu_torch import serve_gpt
    from apex_tpu_torch.inference import ContinuousBatchingScheduler, Request

    t0 = time.monotonic()
    args = serve_gpt.build_args().parse_args(
        ["--compute-dtype", "float32", "--kv-dtype", "float32", "--temperature", "0"]
        + SERVE_V2_ARGS)
    config, params, dcfg = serve_gpt.setup(args)
    rng = np.random.RandomState(3)
    sysp = rng.randint(0, args.vocab, size=args.system_prompt_len).tolist()
    prompts = []
    for _ in range(args.streams):
        pat = rng.randint(0, args.vocab, size=4).tolist()
        prompts.append(sysp + (pat * 4)[:14])
    max_new = 16

    # every run starts from the plain engine and turns on what it names
    plain = dict(draft_len=0, prefill_chunk=None, prefix_sharing=False)

    def serve(**kw):
        sched = ContinuousBatchingScheduler(params, config,
                                            dataclasses.replace(dcfg, **{**plain, **kw}))
        slot_steps = [0]
        if sched._verify is not None:
            inner = sched._verify

            def counted(prm, pools, tokens, positions, active, *rest):
                slot_steps[0] += int(active.sum())
                return inner(prm, pools, tokens, positions, active, *rest)

            sched._verify = counted
        for rid, prompt in enumerate(prompts):
            sched.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=max_new))
        done = sched.run_until_drained()
        if len(done) != len(prompts) or any(len(c.tokens) != max_new for c in done):
            raise AssertionError(f"serve_v2_parity {kw}: not every request served")
        return {c.rid: c.tokens for c in done}, sched, slot_steps[0]

    checks = {}
    for T in (0.0, 1.0):
        spec, sched, slot_steps = serve(draft_len=4, temperature=T)
        checks[f"spec_equals_plain_T{T:g}"] = spec == serve(temperature=T)[0]
        checks[f"drafts_accepted_T{T:g}"] = sched.stats["spec_emitted"] - slot_steps
        if T == 0.0:
            greedy, greedy_sched = spec, sched
    oneshot = serve()[0]
    checks["chunked_equals_oneshot"] = serve(prefill_chunk=64)[0] == oneshot
    shared, shared_sched, _ = serve(prefix_sharing=True)
    checks["shared_equals_unshared"] = shared == oneshot
    checks["shared_full_pages"] = shared_sched.stats["shared_full_pages"]

    # copy-on-write: one whole prompt served twice, one after the other;
    # the second shares the first's full pages and its tail page, and
    # copies the tail before its first write (the whole serving-v2
    # engine against the plain one)
    v2 = dict(draft_len=4, prefill_chunk=64, prefix_sharing=True)

    def twice(**kw):
        sched = ContinuousBatchingScheduler(params, config,
                                            dataclasses.replace(dcfg, **{**plain, **kw}))
        for rid in range(2):
            sched.submit(Request(rid=rid, prompt=list(prompts[0]), max_new_tokens=max_new))
            sched.run_until_drained()
        return {c.rid: c.tokens for c in sched.completed}, sched

    cow, cow_sched = twice(**v2)
    checks["cow_equals_unshared"] = cow == twice()[0]
    checks["cow_copies"] = cow_sched.stats["cow_copies"]
    checks["shared_tail_pages"] = cow_sched.stats["shared_tail_pages"]

    # preemption: a pool that holds two of these requests and no more;
    # two best-effort requests decode when an interactive one arrives,
    # the younger yields and its continuation (prompt and tokens so far)
    # is prefilled again in chunks.  Greedy, so every stream must equal
    # the unpreempted run's; sampled, the run must repeat itself (draw
    # counters carry across re-admission)
    own = [(rng.randint(0, args.vocab, size=4).tolist() * 36)[:len(prompts[0])]
           for _ in range(3)]
    need = -(-(len(own[0]) + max_new + 4) // args.page_size)
    small = dataclasses.replace(dcfg.cache, num_pages=1 + 2 * need)

    def preempted(T):
        sched = ContinuousBatchingScheduler(params, config, dataclasses.replace(
            dcfg, **v2, cache=small, max_batch=3, temperature=T))
        for rid in (0, 1):
            sched.submit(Request(rid=rid, prompt=list(own[rid]), max_new_tokens=max_new,
                                 lane="best_effort"))
        for _ in range(32):  # until both decode with a few tokens each
            sched.step()
            live = [s for s in sched._slots if s is not None]
            if len(live) == 2 and all(s.chunk_next is None and len(s.generated) >= 3
                                      for s in live):
                break
        else:
            raise AssertionError("serve_v2_parity: best-effort requests never decoded")
        sched.submit(Request(rid=2, prompt=list(own[2]), max_new_tokens=max_new))
        done = sched.run_until_drained()
        if len(done) != 3 or any(len(c.tokens) != max_new for c in done):
            raise AssertionError("serve_v2_parity: preemption run did not serve every request")
        return {c.rid: c.tokens for c in done}, sched

    pre, pre_sched = preempted(0.0)
    ref = ContinuousBatchingScheduler(params, config,
                                      dataclasses.replace(dcfg, **plain, temperature=0.0))
    for rid in range(3):
        ref.submit(Request(rid=rid, prompt=list(own[rid]), max_new_tokens=max_new))
    checks["preempted_equals_unpreempted"] = pre == {
        c.rid: c.tokens for c in ref.run_until_drained()}
    checks["preemptions"] = pre_sched.stats["preemptions"]
    checks["completion_preemptions"] = sum(c.preemptions for c in pre_sched.completed)
    checks["preempted_T1_repeats"] = preempted(1.0)[0] == preempted(1.0)[0]

    serve_gpt.check_greedy_parity(params, config, greedy_sched.completed, max_check=8)
    serve_gpt.check_greedy_parity(params, config, pre_sched.completed)
    bad = [k for k, v in checks.items() if v is False]
    if (bad or checks["drafts_accepted_T0"] <= 0 or checks["shared_full_pages"] <= 0
            or checks["cow_copies"] <= 0 or checks["shared_tail_pages"] <= 0
            or checks["preemptions"] <= 0 or checks["completion_preemptions"] <= 0):
        raise AssertionError(f"serve_v2_parity: {checks}")
    emit({"phase": "serve_v2_parity", "compute_dtype": "float32", "requests": len(prompts),
          "max_new": max_new, **checks,
          "greedy_tokens_checked_against_full_forward": sum(len(t) for t in greedy.values()),
          "spec_stats_T0": {k: greedy_sched.stats[k] for k in ("spec_steps", "spec_emitted")},
          "seconds": time.monotonic() - t0})


def serve_v2_profile_phase(params, config):
    """Busy share and kernel time by name over one verify step (8 slots
    decoding, W = 5) and one prefill chunk (64 positions at 128..191) of
    the bf16 serving-v2 engine."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch import serve_gpt
    from apex_tpu_torch.inference import ContinuousBatchingScheduler, Request

    args = serve_gpt.build_args().parse_args(SERVE_V2_ARGS)
    _, _, dcfg = serve_gpt.setup(args)
    sched = ContinuousBatchingScheduler(params, config, dcfg)
    rng = np.random.RandomState(1)
    sysp = rng.randint(0, args.vocab, size=args.system_prompt_len).tolist()
    for rid in range(args.streams):
        sched.submit(Request(rid=rid, prompt=sysp + rng.randint(0, args.vocab, 32).tolist(),
                             max_new_tokens=args.max_new))
    for _ in range(16):  # until every slot decodes: its chunks are done
        sched.step()
        if all(s is not None and s.chunk_next is None for s in sched._slots):
            break
    else:
        raise AssertionError("serve_v2_profile: prompts still chunk-prefilling")
    sched.step()
    dev = sched.device
    B, W, C = dcfg.max_batch, dcfg.draft_len + 1, dcfg.prefill_chunk
    tokmat = torch.from_numpy(np.repeat(sched._tokens[:, None], W, 1)).to(dev, torch.long)
    pos = torch.from_numpy(sched._positions).to(dev, torch.long)
    act = torch.from_numpy(sched._active).to(dev)
    tables = torch.from_numpy(sched._page_tables).to(dev)
    seeds = torch.zeros((B, W), dtype=torch.long, device=dev)
    chunk_tok = torch.from_numpy(rng.randint(0, args.vocab, C)).to(dev, torch.long)
    steps = {
        "verify": lambda: sched._verify(sched.params, sched.pools, tokmat, pos, act,
                                        tables, seeds),
        # slot 0's pages, positions 128..191, writing (its own cache is
        # overwritten: this scheduler is thrown away)
        "chunk": lambda: sched._chunk(sched.params, sched.pools, chunk_tok, 128, C, 0,
                                      tables[0]),
    }
    for name, fn in steps.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            fn()
            host = time.monotonic() - t0
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        by_name = device_us_by_name(prof)
        busy_ms = sum(by_name.values()) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        emit({"phase": "serve_v2_profile", "step": name,
              "rows": B * W if name == "verify" else C,
              "step_ms": 1e3 * wall, "host_dispatch_ms": 1e3 * host,
              "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / (1e3 * wall),
              "top_kernels_us": [[n[:90], us] for n, us in top]})


# -------------------------------------------------------------------- train
#: the fused-CE step's warm-up loss against the dense step's (same
#: params and batch): the bf16-dot rounding of the head, relative
FCE_LOSS_TOL = 1e-5


def train_phase(fused=False, dense_report=None):
    """bench.py's GPT-124M step through ``train_gpt.run`` at its defaults:
    the dense head (``gpt124_s1024``) or, with ``fused``, ``--fused-ce``
    (``gpt124_s1024_fce``), whose warm-up loss is held against the dense
    step's ``dense_report``."""
    from apex_tpu_torch import train_gpt

    args = train_gpt.build_args().parse_args(["--fused-ce"] if fused else [])
    reset_counts()
    t0 = time.monotonic()
    report, params, state = train_gpt.run(args)
    counts = launch_counts()
    n, L = args.warmup + args.steps, args.layers
    per_step = {"layer_norm_fwd": 4 * L + 1, "layer_norm_bwd": 2 * L + 1,
                "flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
                "ce_fwd": int(fused), "ce_dx": int(fused), "ce_dembed": int(fused)}
    expect = {**{k: v * n for k, v in per_step.items()},
              "paged_decode_attention": 0, "paged_decode_attention_wide": 0,
              "fused_sample": 0}
    losses = report["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: {losses}")
    if counts != expect:
        raise AssertionError(f"train launch counts {counts} != expected {expect}")
    extra = {}
    if fused:
        dense = dense_report["losses"][0]
        rel = abs(losses[0] - dense) / abs(dense)
        if not rel <= FCE_LOSS_TOL:
            raise AssertionError(f"fused-CE warm-up loss {losses[0]} vs dense {dense}: "
                                 f"rel {rel} > {FCE_LOSS_TOL}")
        # bench.py's A/B on this card: the dense step (the train phase)
        # beside this one
        extra = {"warmup_loss_dense": dense, "warmup_loss_rel_err": rel,
                 "tolerance": FCE_LOSS_TOL,
                 "tolerance_why": "same params and batch; the fused head rounds embed and "
                                  "x to bf16 before its dots, the dense head is fp32: that "
                                  "moves each row's loss by about 1e-3 at random, the mean "
                                  "over 8192 rows by about 1e-5 (1e-6 relative)",
                 "ab_step_ms_median": {"dense": dense_report["step_ms_median"],
                                       "fused_ce": report["step_ms_median"]},
                 "ab_tokens_per_sec": {"dense": dense_report["tokens_per_sec"],
                                       "fused_ce": report["tokens_per_sec"]},
                 "ab_peak_memory_gb": {"dense": dense_report["peak_memory_gb"],
                                       "fused_ce": report["peak_memory_gb"]}}
    emit({"phase": "train_fce" if fused else "train", **report, "steps_counted": n,
          "launches_per_step": per_step, "launches": counts, **extra,
          "seconds": time.monotonic() - t0})
    return args, counts, report


def train_reproducible_phase(dev, B=8, H=12, S=1024, D=64):
    """Two backward passes of one flash layer (bf16, causal) must give
    bitwise equal dq, dk, dv; two calls each of the CE dx and dembed
    kernels at GPT-124M (bf16 x, fp32 embed) bitwise equal dx and
    dembed; and two LayerNorm backward calls at the train step's rows
    (8192 x 768 bf16, affine with bias) bitwise equal dx, dw and db: no
    atomics in the kernels, sums in a fixed order."""
    from apex_tpu_torch.ops import fused_ce_kernels as K
    from apex_tpu_torch.ops.attention import flash_attention
    from apex_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd_plain

    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, S, D), dtype=np.float32))
                   .to(dev, torch.bfloat16) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = flash_attention(q, k, v, causal=True)
    first = torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    second = torch.autograd.grad(out, (q, k, v), do)
    same = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
    N, Hd, V = 8192, 768, 50304
    x = torch.from_numpy(rng.standard_normal((N, Hd), dtype=np.float32)).to(dev, torch.bfloat16)
    e = torch.from_numpy(0.02 * rng.standard_normal((V, Hd), dtype=np.float32)).to(dev)
    t = torch.from_numpy(rng.integers(0, V, size=N).astype(np.int32)).to(dev)
    g = torch.full((N,), 1.0 / N, device=dev)
    m, l, _ = K.ce_fwd(x, e, t)
    lse = m + torch.log(l)
    ce_same = {"dx": bool(torch.equal(K.ce_dx(x, e, t, lse, g), K.ce_dx(x, e, t, lse, g))),
               "dembed": bool(torch.equal(K.ce_dembed(x, e, t, lse, g),
                                          K.ce_dembed(x, e, t, lse, g)))}
    xl = _ln_rows(rng, dev, N, Hd, torch.bfloat16, False, scale=2.0, shift=0.5)
    dyl = _ln_rows(rng, dev, N, Hd, torch.bfloat16, False)
    wl, bl = _ln_params(rng, dev, Hd, "ln_affine")
    _, mean, rstd = layer_norm_fwd_plain(xl, wl, bl, 1e-5)
    first_ln = layer_norm_bwd(xl, wl, dyl, mean, rstd)
    second_ln = layer_norm_bwd(xl, wl, dyl, mean, rstd)
    ln_same = {k: bool(torch.equal(a, b)) for k, a, b in zip(("dx", "dw", "db"), first_ln,
                                                            second_ln)}
    if not all(same) or not all(ce_same.values()) or not all(ln_same.values()):
        raise AssertionError(f"backward not bitwise reproducible: flash {same}, CE {ce_same}, "
                             f"LayerNorm {ln_same}")
    emit({"phase": "train_reproducible", "B": B, "H": H, "S": S, "D": D,
          "dtype": "bfloat16", "dq_dk_dv_bitwise_equal": same,
          "ce": {"N": N, "H": Hd, "V": V, "x_dtype": "bfloat16", "embed_dtype": "float32",
                 "bitwise_equal": ce_same},
          "layer_norm_bwd": {"R": N, "H": Hd, "dtype": "bfloat16", "mode": "ln_affine",
                             "bitwise_equal": ln_same}})


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


def fused_ce_grad_parity_phase(dev, S=256, B=8, H=768, V=50304):
    """``fused_lm_head_ce`` in the layout ``gpt_loss`` gives it -- x (S,
    B, H) bf16 as a leaf, embed fp32, the mean loss -- on the card (the
    CE kernels through the autograd Function) against the CPU's plain
    versions with bf16 dots on the same inputs; then two backward passes
    on the card must be bitwise equal (no atomics)."""
    from apex_tpu_torch.ops import fused_ce_kernels as K
    from apex_tpu_torch.ops.fused_ce import fused_lm_head_ce

    t0 = time.monotonic()
    rng = np.random.default_rng(S * B)
    x = torch.from_numpy(rng.standard_normal((S, B, H), dtype=np.float32)).to(torch.bfloat16)
    e = torch.from_numpy(0.02 * rng.standard_normal((V, H), dtype=np.float32))
    t = torch.from_numpy(rng.integers(0, V, size=(S, B)))
    xc, ec = x.to(dev).requires_grad_(), e.to(dev).requires_grad_()
    loss = fused_lm_head_ce(xc, ec, t.to(dev), 128)
    first = torch.autograd.grad(loss.mean(), (xc, ec), retain_graph=True)
    second = torch.autograd.grad(loss.mean(), (xc, ec))
    same = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
    # the CPU: the plain versions with the kernels' bf16 dots
    N, bf = S * B, torch.bfloat16
    x2, t2 = x.reshape(N, H), t.reshape(N).to(torch.int32)
    m, l, tgt = K.ce_fwd_plain(x2, e, t2, dot_dtype=bf)
    lse = m + torch.log(l)
    g = torch.full((N,), 1.0 / N)
    want = {"loss": (lse - tgt).reshape(S, B),
            "dx": K.ce_dx_plain(x2, e, t2, lse, g, dot_dtype=bf),
            "dembed": K.ce_dembed_plain(x2, e, t2, lse, g, dot_dtype=bf)}
    got = {"loss": loss.detach().cpu(), "dx": first[0].reshape(N, H).cpu(),
           "dembed": first[1].cpu()}
    allowance = ce_term_scales(*(a.to(dev) for a in (x2, e, t2, lse, g)))
    errs = {"loss": float((got["loss"] - want["loss"]).abs().max())}
    for n in ("dx", "dembed"):
        errs[n] = ce_band(got[n], want[n], allowance[n].cpu())
    tol = {"loss": CE_TOL["fwd"] * max(1.0, float(m.abs().max())), "dx": 1.0, "dembed": 1.0}
    finite = all(bool(torch.isfinite(a.float()).all()) for a in got.values())
    bad = {n: v for n, v in errs.items() if not v <= tol[n]}
    if bad or not finite or not all(same):
        raise AssertionError(f"fused CE grad parity: errors {errs} over {tol} "
                             f"(finite={finite}, bitwise={same})")
    emit({"phase": "fused_ce_grad_parity", "S": S, "B": B, "H": H, "V": V,
          "x_dtype": "bfloat16", "embed_dtype": "float32", "errors": errs,
          "tolerance": tol, "dx_dembed_bitwise_equal_across_passes": same,
          "tolerance_why": "card (kernels) against CPU (plain versions, bf16 dots): loss "
                           "abs, times max(1, max |logit|); dx, dembed: the share of the "
                           "kernels phase's per-element band used",
          "seconds": time.monotonic() - t0})


def norm_modules_phase(dev, shape=(1024, 8, 768)):
    """FusedLayerNorm and FusedRMSNorm, affine and not, memory_efficient
    off and on: forward and backward in bf16 on the card against the
    same module on the CPU, with exact launch counts (one forward kernel;
    one backward kernel, none with memory_efficient)."""
    from apex_tpu_torch.normalization import FusedLayerNorm, FusedRMSNorm

    t0 = time.monotonic()
    H = shape[-1]
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 2 + 0.5)
    x = x.to(torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)
    params = {"weight": 1 + 0.1 * rng.standard_normal(H, dtype=np.float32),
              "bias": 0.1 * rng.standard_normal(H, dtype=np.float32)}
    cases = []
    for cls in (FusedLayerNorm, FusedRMSNorm):
        for affine in (True, False):
            for mem in (False, True):
                got, counts = {}, None
                for device in (dev, torch.device("cpu")):
                    mod = cls((H,), elementwise_affine=affine, memory_efficient=mem,
                              device=device)
                    names = [n for n, _ in mod.named_parameters()]
                    mod.load_flax_params({n: params[n] for n in names})
                    xl = x.to(device).detach().requires_grad_()
                    reset_counts()
                    y = mod(xl)
                    y.backward(dy.to(device))
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                        counts = launch_counts()
                    got[device.type] = [y.detach().cpu(), xl.grad.cpu()] + [
                        p.grad.cpu() for p in mod.parameters()]
                expect = {"layer_norm_fwd": 1, "layer_norm_bwd": 0 if mem else 1}
                seen = {k: counts[k] for k in expect}
                errs = [rel_err(a, b) for a, b in zip(got["cuda"], got["cpu"])]
                case = {"module": cls.__name__, "affine": affine, "memory_efficient": mem,
                        "launches": seen, "rel_errors": errs}
                if seen != expect or max(errs) > 2.0 ** -6:
                    raise AssertionError(f"norm module {case}: expected launches {expect}, "
                                         f"band 2**-6")
                cases.append(case)
    emit({"phase": "norm_modules", "shape": list(shape), "dtype": "bfloat16",
          "cases": cases, "tolerance": 2.0 ** -6,
          "tolerance_why": "max |cuda - cpu| / max |cpu| of y, dx, dw, db: bf16 outputs "
                           "one rounding apart; memory_efficient recovers xhat from the "
                           "bf16 output",
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
    if any(k in name for k in ("ce_fwd_kernel", "ce_fwd_combine", "ce_bwd_kernel", "ce_to_bf16")):
        return "fused_ce"
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
        host = time.monotonic() - t0  # the host's dispatch of the step
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    by_name = device_us_by_name(prof)
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
    emit({"phase": "train_profile", "head": "fused_ce" if args.fused_ce else "dense",
          "step_ms": 1e3 * wall, "host_dispatch_ms": 1e3 * host, "device_busy_ms": busy_ms,
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
    layer_norm_kernels(dev, results, _build.load())
    for h_kv in (12, 4):
        for dtype in (torch.bfloat16, torch.float32):
            r = check_decode_attention(dev, h_kv, dtype)
            results[("attn", h_kv, dtype)] = r
            emit({"phase": "kernel", "kernel": "paged_decode_attention", **r})
    for case in ("verify", "chunk", "long_w1", "long"):
        for h_kv in (12, 4):
            for dtype in (torch.bfloat16, torch.float32):
                r = check_decode_attention_wide(dev, case, h_kv, dtype)
                results[("attn_wide", case, h_kv, dtype)] = r
                name = "paged_decode_attention" + ("_wide" if r["W"] > 1 else "")
                emit({"phase": "kernel", "kernel": name, **r})
    # the other head widths serve_gpt --heads gives at hidden 768: 6
    # heads of 128 and 24 of 32, MHA and GQA (group 3), width 1 and verify
    for H, D in ((6, 128), (24, 32)):
        for h_kv in (H, H // 3):
            for dtype in (torch.bfloat16, torch.float32):
                r = check_decode_attention(dev, h_kv, dtype, H=H, D=D)
                results[("attn", h_kv, dtype, D)] = r
                emit({"phase": "kernel", "kernel": "paged_decode_attention", **r})
                r = check_decode_attention_wide(dev, "verify", h_kv, dtype, H=H, D=D)
                results[("attn_wide", "verify", h_kv, dtype, D)] = r
                emit({"phase": "kernel", "kernel": "paged_decode_attention_wide", **r})
    emit({"phase": "kernel", "kernel": "paged_decode_attention_plan",
          **check_decode_plan(_build.load())})
    # rows: the decode step (8), the verify step (8 x 5) and the chunked
    # prefill's sampling head (1)
    for N in (8, 40, 1):
        for temperature, top_k in ((0.0, 0), (1.0, 0), (1.0, 50)):
            r = check_sampling(dev, temperature, top_k, N)
            results[("sample", temperature, top_k, N)] = r
            emit({"phase": "kernel", "kernel": "fused_sample", **r})

    for case, kw in (("gpt124", {}),
                     ("ragged", {"N": 1000, "V": 50257, "library": False}), *CE_GRID):
        r = check_fused_ce(dev, case, **kw)
        results[("ce", case)] = r
        for name in ("fwd", "dx", "dembed"):
            emit({"phase": "kernel", **r[name]})
    flash_cases = (
        ("gpt124", torch.bfloat16, {"library": True}),
        ("gpt124", torch.float32, {}),
        ("gqa", torch.bfloat16, {"Hkv": 4}),
        ("non_causal", torch.bfloat16, {"causal": False}),
        ("kv_bias", torch.bfloat16, {"masked": True}),
        ("offsets", torch.bfloat16, {"S": 1000, "q_offset": 0, "k_offset": 100}),
        # the other head widths of the bf16 kernels, at the gpt124 shape
        ("gpt124_d32", torch.bfloat16, {"D": 32, "library": True}),
        ("gpt124_d128", torch.bfloat16, {"D": 128, "library": True}),
        # a ring-attention chunk: q rows 512.. of 1024 keys
        ("chunk", torch.bfloat16, {"S": 512, "Sk": 1024, "q_offset": 512}),
        # the other instantiations of the bf16 kernels
        *((f"d{D}", torch.bfloat16, {"B": 2, "D": D}) for D in (16, 48, 80, 96, 112)),
    )
    emit({"phase": "kernel", "kernel": "flash_bwd_plan", **check_flash_plan(_build.load())})
    emit({"phase": "kernel", "kernel": "ce_bwd_plan", **check_ce_plan(_build.load())})
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
    v2_counts, params, config = serve_v2_phase()
    lap("serve_v2")
    serve_v2_profile_phase(params, config)
    lap("serve_v2_profile")
    del params
    serve_v2_parity_phase()
    lap("serve_v2_parity")
    train_args, train_counts, dense = train_phase()
    lap("train")
    fce_args, fce_counts, fused = train_phase(fused=True, dense_report=dense)
    lap("train_fce")
    train_reproducible_phase(dev)
    lap("train_reproducible")
    flash_grad_parity_phase(dev)
    lap("flash_grad_parity")
    fused_ce_grad_parity_phase(dev)
    lap("fused_ce_grad_parity")
    norm_modules_phase(dev)
    lap("norm_modules")
    train_parity_phase()
    lap("train_parity")
    train_profile_phase(train_args, dense["step_ms_median"])
    train_profile_phase(fce_args, fused["step_ms_median"])
    lap("train_profile")
    emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})

    main_path = (
        ("layer_norm_fwd", "apex_tpu_torch/csrc/layer_norm.cu",
         "apex_tpu/ops/layer_norm_pallas.py:39", results[("ln", 8, torch.bfloat16)]),
        ("paged_decode_attention", "apex_tpu_torch/csrc/decode_attention.cu",
         "apex_tpu/ops/decode_attention_pallas.py:130",
         results[("attn", 12, torch.bfloat16)]),
        ("paged_decode_attention_wide", "apex_tpu_torch/csrc/decode_attention.cu",
         "apex_tpu/ops/decode_attention_pallas.py:130",
         results[("attn_wide", "verify", 12, torch.bfloat16)]),
        ("fused_sample", "apex_tpu_torch/csrc/decode_sampling.cu",
         "apex_tpu/ops/decode_sampling_pallas.py:126", results[("sample", 1.0, 0, 8)]),
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
        ("ce_fwd", "apex_tpu_torch/csrc/fused_ce.cu",
         "apex_tpu/ops/fused_ce_pallas.py:104", results[("ce", "gpt124")]["fwd"]),
        ("ce_dx", "apex_tpu_torch/csrc/fused_ce.cu",
         "apex_tpu/ops/fused_ce_pallas.py:185", results[("ce", "gpt124")]["dx"]),
        ("ce_dembed", "apex_tpu_torch/csrc/fused_ce.cu",
         "apex_tpu/ops/fused_ce_pallas.py:210", results[("ce", "gpt124")]["dembed"]),
    )
    # launches: the serve phase's for the serving kernels, the serve_v2
    # phase's for the width > 1 layout, the train phase's for the
    # training kernels, the train_fce phase's for the CE kernels
    # (LayerNorm forward and sampling run in several; their lines keep
    # the serve phase's counts)
    launches = {**train_counts, **{k: counts[k] for k in
                                   ("layer_norm_fwd", "paged_decode_attention",
                                    "fused_sample")},
                "paged_decode_attention_wide": v2_counts["paged_decode_attention_wide"],
                **{k: fce_counts[k] for k in ("ce_fwd", "ce_dx", "ce_dembed")}}
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
