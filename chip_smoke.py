#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (apex_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. card: PyTorch version, the card, ``nvidia-smi`` name and power
   limit; TF32 is switched off for matmuls and cuDNN.
2. build: the CUDA kernels are compiled from ``apex_tpu_torch/csrc``.
3. kernels: each kernel against its plain PyTorch version at the
   serve path's shapes, with its error and tolerance, its device time
   beside the plain version's, one PyTorch library call's where one
   computes the same function, and the bound (the larger of bytes at
   3.35 TB/s and flops at the peak rate of their type).
4. serve: ``apex_tpu_torch.serve_gpt`` at its defaults — GPT-124M
   width, bf16, 8 slots, 32 requests — with every kernel's launch
   count from that run, checked exactly against the steps taken.
5. parity: full width in fp32, greedy, 4 requests of 8 tokens: every
   served token must be the argmax of the full-sequence forward.
6. profile: device busy share and kernel time by name over decode
   steps of the bf16 engine.

Then the kernels summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code
is nonzero and the last line is not printed.  Without a CUDA device,
or without the package beside this file, it exits nonzero at once.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet, dense): device memory bytes/s,
#: fp32 flops/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12

ITERS = 20


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def device_ms(fn, iters=ITERS):
    """Device time of one ``fn()`` call: the CUDA activity the profiler
    records over ``iters`` calls (kernels, copies) summed and divided;
    CUDA events around the calls when the profiler records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us > 0:
        return us / 1e3 / iters, "profiler"
    return call_ms(fn, iters), "cuda_events"


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
    if dtype == torch.bfloat16:
        ulps = bf16_ulps(y, py)
        ok, tol = ulps <= 1, "1 bf16 ulp (fp32 stats in another summation order can move a rounding by a step)"
    else:
        ulps = None
        ok, tol = err <= 1e-5, "1e-5 abs (fp32 row stats summed in another order)"
    if not ok or stat_err > 1e-5:
        raise AssertionError(f"layer_norm R={R} {dtype}: err {err}, ulps {ulps}, "
                             f"stats {stat_err}")
    xb = x.element_size()
    nbytes = 2 * R * H * xb + 2 * H * 4 + 2 * R * 4
    bms, by = bound(nbytes, 8 * R * H)
    wl, bl = w.to(dtype), b.to(dtype)
    t = timings(lambda: layer_norm_fwd(x, w, b, eps),
                lambda: layer_norm_fwd_plain(x, w, b, eps),
                lambda: torch.nn.functional.layer_norm(x, (H,), wl, bl, eps))
    return {"R": R, "H": H, "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "bf16_ulps": ulps, "stats_err": stat_err,
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


# -------------------------------------------------------------------- serve
def launch_counts():
    from apex_tpu_torch.ops import decode_attention, decode_sampling, layer_norm

    return {"layer_norm_fwd": layer_norm.LAUNCHES,
            "paged_decode_attention": decode_attention.LAUNCHES,
            "fused_sample": decode_sampling.LAUNCHES}


def reset_counts():
    from apex_tpu_torch.ops import decode_attention, decode_sampling, layer_norm

    layer_norm.LAUNCHES = decode_attention.LAUNCHES = decode_sampling.LAUNCHES = 0


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
              "fused_sample": steps + prefills}
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

    results = {}
    for R in (8, 64):
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

    counts, _, params, config = serve_phase()
    parity_phase()
    profile_phase(params, config)

    main_path = (
        ("layer_norm_fwd", "apex_tpu_torch/csrc/layer_norm.cu",
         "apex_tpu/ops/layer_norm_pallas.py:39", results[("ln", 8, torch.bfloat16)]),
        ("paged_decode_attention", "apex_tpu_torch/csrc/decode_attention.cu",
         "apex_tpu/ops/decode_attention_pallas.py:130",
         results[("attn", 12, torch.bfloat16)]),
        ("fused_sample", "apex_tpu_torch/csrc/decode_sampling.cu",
         "apex_tpu/ops/decode_sampling_pallas.py:126", results[("sample", 1.0, 0)]),
    )
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, src, rep, r in main_path]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
