#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (apex_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Every step of the serve and train paths runs compiled, as the
reference's ``jax.jit`` with donated buffers: captured as a CUDA graph
over static buffers at its first call, after an eager warm-up, and
replayed after (``apex_tpu_torch.graphs``).  The serve, serve_v2, train
and train_fce phases then run once more with ``--eager`` in the same
call and print a ``graphs_ab`` line: graphed beside eager, streams equal
token for token, train losses bitwise equal (or within 1e-5, and which
held).  The launch counts are counted by replay and stay exact.

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
   entry's at 936 shapes (3 dtypes); the fused-CE forward, dx and
   dembed at N = 8192, H = 768, V = 50304 with bf16 dots, a ragged
   N = 1000, V = 50257 case, every (x, embed) dtype pair at H = 768 and
   1024, H = 80 and 784 (widths that the backward's K groups split
   unevenly), and a control -- the backward fed lse + log 2 -- that must
   fail the same band; the forward's and the backward's plans as
   ``ce_fwd_plan`` and ``ce_bwd_plan`` state them against the C entries';
   the sampling head at 8, 40, 1 and 64 rows and H = 768, 1600 and 2048,
   greedy, T = 1 and top-k, and its plan as ``sample_plan`` states it
   against ``apex_sample_plan`` at N 1..256 and H 4..8192), with its
   error and tolerance, its device
   time beside the plain version's, one PyTorch library call's where
   one computes the same function (for the CE kernels the dense bf16
   head, two calls; for the greedy sampling head argmax of a fp32
   matmul, two calls), and the bound (the larger of bytes at 3.35 TB/s
   and flops at the peak rate of their type: 989 TFLOP/s bf16 and 495
   tf32 tensor cores, 67 TFLOP/s fp32).  Paged decode attention runs in both
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
   the C entry's at every head dim.  The float16 instantiations (the
   amp train step's): LN forward at 8 and 8192 rows, the backward at
   8192, the RMS and non-affine modes, H = 770 and a misaligned view,
   each with ``F.layer_norm``'s fp16 time; flash at GPT-124M's shape at
   D = 64, 32 and 128 with SDPA's fp16 time, GQA, and B = 2 at D = 16,
   48, 80, 96, 112, against their plain versions (the reference's fp16
   path: the jnp LayerNorm, the fp32 scan) in bands of fp16's rounding;
   the plans in fp16 against the C entries'.  The optimizer engine's kernels
   (XLA fusions in the JAX package): ``mt_adam`` bitwise against its
   plain version (AdamW at GPT-124M's 20 leaves, timed beside
   ``torch.optim.AdamW`` fused and foreach; L2 mode, bf16 params with
   and without a master, resident bucket slices, param groups with a
   tensor lr, a clip coefficient, a false predicate that keeps every
   value), ``mt_scale`` bitwise with its flag (an injected inf, an
   overflow), ``mt_l2norm`` within 1e-5 of float64 sums and bitwise over
   two calls, and ``mt_plan`` against ``apex_mt_plan``.
3a. optimizers: bench.py's headline section (``bench_fused_adam``) on
   the port: FusedAdam over bench.py's 99-tensor set, timed graphed and
   eager on the engine (resident and transparent), on the per-leaf
   path, as bench.py's op-by-op eager Adam and as ``torch.optim.AdamW``
   (fused, foreach); ``speedup_vs_eager``; 5 steps of every engine
   variant bitwise equal to the per-leaf path; ``update_scaled`` with
   exact mt_adam / mt_scale / mt_l2norm launches; FusedSGD (momentum,
   nesterov), FusedLAMB, FusedMixedPrecisionLamb, FusedAdagrad and
   FusedNovoGrad card against CPU.
4. serve: ``apex_tpu_torch.serve_gpt`` at its defaults — GPT-124M
   width, bf16, 8 slots, 32 requests — with every kernel's launch
   count from that run, checked exactly against the steps taken;
   graphed, then eager (``serve_eager``), then ``graphs_ab``.
5. parity: full width in fp32, greedy, 4 requests of 8 tokens: every
   served token must be the argmax of the full-sequence forward.
6. profile: device busy share and kernel time by name over decode
   steps of the bf16 engine, graphed and eager.
6a. serve_v2: ``serve_gpt`` at the serving-v2 command of
   ``examples/gpt/serve_gpt.py`` (``--draft-len 4 --prefix-sharing
   --system-prompt-len 128 --prefill-chunk 64 --best-effort-frac 0.5``),
   the rest at the serve defaults: 32/32 requests of 32 tokens, and
   exact launch counts from the scheduler's stats (N = verify + chunk
   steps: LN forward 25 N, width > 1 attention 12 N, width-1 attention
   0, sampling verify steps + prefills); graphed, then eager.
6b. serve_v2_profile: device busy share, host dispatch and kernel time
   by name over one verify step and one 64-position prefill chunk,
   graphed and eager.
6c. serve_streams: the serve and serving-v2 commands in bf16 and fp32,
   T = 0 and T = 1, graphed and eager: equal streams, exact counts.
6d. graph_replay: each serving step (decode, prefill at the serve
   shapes; verify, chunk, head at the serving-v2 shapes) compiled beside
   the same step eager on three sets of random inputs in turn: outputs
   and pools bitwise equal, launch counts equal, call by call.
6e. serve_v2_parity: fp32, repetitive prompts after a shared system
   prompt: the speculative stream equals the plain one (T=0 and T=1),
   chunked prefill the one-shot, prefix-shared the unshared; greedy
   tokens are the full forward's argmax; some draft is accepted.
7. train: ``apex_tpu_torch.train_gpt`` at its defaults — bench.py's
   GPT-124M step, seq 1024, batch 8, bf16, flash attention, full remat,
   the dense head, FusedAdam — one warm-up step and 5 timed steps:
   losses finite and falling, launch counts exactly 49 / 25 / 24 / 12 /
   12 / 0 / 0 / 0 a step (LN fwd, LN bwd, flash fwd, dq, dkv, ce_fwd,
   ce_dx, ce_dembed) and ``mt_plan``'s mt_adam launches (one); each
   timed step a graph replay; then ``--eager`` and ``graphs_ab``
   (losses, step median with its spread, tokens/s, peak memory side by
   side); then FusedAdam on its per-leaf path and ``optimizer_ab``
   (losses bitwise equal to the engine's, medians side by side).
8. train_fce: the same with ``--fused-ce`` (bench.py's
   ``gpt124_s1024_fce``): launch counts 49 / 25 / 24 / 12 / 12 / 1 / 1 /
   1 a step, the warm-up loss within 1e-5 (relative) of the dense
   step's, and the two steps' times side by side; graphed, then eager.
8a. train_fp16: ``train_gpt --fp16`` (``examples/gpt/pretrain_gpt.py
   --fp16`` on one device: fp16 compute, ``DynamicLossScaler(2**12)``,
   the scaled step with ``update_scaled``), graphed and eager: losses
   finite and falling, every scale 4096, 0 skipped steps, launch counts
   exactly 49 / 25 / 24 / 12 / 12 fp16 kernels, one ``mt_adam`` and
   ``mt_plan``'s ``mt_scale`` a step; graphed = eager (losses and
   scales); step ms, tokens/s and peak GB beside the bf16 train phase's.
8b. amp_overflow: the same step at GPT-124M with ``--step-guard 3`` and
   the scaler at 2**127 (one backoff to 2**12): the first step skipped
   with every param and the whole optimizer state bitwise unchanged, the
   next two finite graph replays; the guard 1 -> 0 bad, 1 skipped.
9. train_reproducible: two backward passes of one flash layer bitwise
   equal, two calls each of the CE forward, dx and dembed kernels at
   GPT-124M bitwise equal, two LN backward calls at 8192 x 768 (bf16,
   affine with bias) with bitwise equal dx, dw and db, and two calls of
   the sampling head at 40 rows (T = 1) with equal tokens, and two
   ``mt_adam`` and ``mt_l2norm`` calls at GPT-124M's leaves; the same
   calls captured as CUDA graphs, two replays bitwise equal to them.
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
    numpy params; the card's from a graph replay of ``loss_and_grads``
    on this batch after a warm-up on another, held against an eager call.
    train_parity_fp16: ``train_gpt --fp16`` at 2 layers, hidden 256, seq
    128, on the card (compiled) and the CPU: losses in stated bands,
    scales and skipped steps equal.
14. train_profile: device busy share and kernel time by name over one
    training step with the dense head and one with the fused CE, each
    a graph replay and eager, and the dense step with FusedAdam
    per-leaf; ``optimizer_profile``: the update alone on the step's
    grads, device ms by kernel name under both paths.
15. pretrain: ``apex_tpu_torch.pretrain_gpt`` (the trainer's host
    runtime) at GPT-124M width, seq 1024, global batch 8, bf16,
    ``--fused-ce``, graphed, on a uint16 token file of 2**20 tokens from
    the seed: in this process the full run (8 steps, checkpoints at 4
    and 8, telemetry every 4, metrics and trace dirs) and the same
    without telemetry and tracing, bitwise equal; in child processes
    (``python -m``) a run resumed from ``step_00000004.ckpt``, bitwise
    equal at steps 5-8, and the SIGTERM runs below; the full run's
    files (2 metrics windows, each ``loss_mean`` within 1e-6 of its
    steps' mean; ``metrics.prom``; goodput fractions summing to 1 within
    1e-6; the trace's spans, ``train.step.dispatch`` 8 times;
    checkpoints that validate); an ``--auto-resume`` run sent SIGTERM
    after its ``step 2`` line (saves every 2), which must print
    ``preempted``, exit 0 with a checkpoint at the step it reached and a
    flight-recorder dump, and the same command again, resuming there:
    both bitwise equal to the full run, at most 3 checkpoints kept.  Then
    7 steps in this process under the profiler: bitwise equal again,
    launch counts exactly the train_fce step's plus three ``mt_l2norm``
    calls a step (the grad, param and update norms), and the idle share
    over the last 4 steps.  Printed beside ``nvidia-smi``: the step
    median with telemetry on and off, each save's blocking host time,
    the writer thread's seconds and bytes, the step after a save.
16. zero: ``pretrain_gpt --zero`` (DistributedFusedAdam over a one-rank
    NCCL group on this card) at the pretrain cell, in this process:
    graphed (8 steps, elastic saves at 4 and 8) and ``--eager``, losses
    bitwise equal to the pretrain phase's FusedAdam run at every step;
    exact launch counts (train_fce's and one ``mt_adam`` a step); a
    resume from the step-4 directory bitwise; ``--grad-sync-dtype int8``,
    ``float8_e4m3fn`` and ``float8_e5m2`` on one repeated batch finite,
    falling and within 1e-2 of the wide wire's losses; the quantized wire's
    residual identity bitwise on the card; bench.py's ``zero2_vs_fused``
    and ``zero_gpt124`` at dp 1 (step ms, live MB, wire bytes; the
    remainder mode's ``mt_adam_remainder`` launches counted); a profile
    of 7 graphed steps, wide and int8 (the collectives' and quantize
    ops' device ms, the idle share).  With two or more cards, torchrun at
    world min(4, count) against world 1; with one, a line says world > 1
    did not run on a card.  The kernels phase holds ``mt_adam_remainder``
    bitwise against its plain version (with a clip and a false
    predicate) and times it beside ``torch.optim.AdamW(fused=True)``.
17. tp: ``pretrain_gpt --tp 1`` at GPT-345M (24 layers, hidden 1024, 16
    heads, vocab 50304, seq 1024, global batch 8, bf16, full remat,
    FusedAdam) in this process over a one-rank NCCL group registered at
    tp 1: the fused CE head and the dense head, graphed (6 steps) and
    ``--eager`` (4): exact launch counts (97 / 49 / 48 / 24 / 24 a step,
    1 / 1 / 1 CE with the fused head, one ``mt_adam``), graphed = eager,
    losses bitwise equal to the same step with no tp group
    (``train_gpt.make_train_step`` alone), step ms (CUDA events), peak
    memory, a profile of 7 graphed fused steps (idle share, kernel ms by
    name); then the CE forward, dx and dembed on the halves and quarters
    of a 50304 x 1024 bf16 embed with shard-local targets (ids on every
    shard's edges and in its tail tile), combined as ``fused_lm_head_ce``
    combines them, held against the full-vocab call and their plain
    versions, and timed at V 50304, 25152 and 12576 with their bounds and
    the dense bf16 head's time.  With two or more cards,
    ``tp_multi_card``: ``torchrun --tp 2`` (and 4) against tp 1 (losses
    within 1e-3), GPT-345M timed at each tp with and without
    ``--sequence-parallel``, and a profile at the largest.
18. pp: ``models.gpt.make_pp_train_step`` at GPT-345M over one-rank NCCL
    pipeline, tp and dp groups (the 1F1B schedule at pp 1: every
    microbatch's forward and backward in turn), 4 microbatches of 2 rows:
    the fused CE head and the dense head, graphed (6 steps) and eager
    (4): exact launch counts (4 x 97 / 49 / 48 / 24 / 24 a step, 4 x 1 CE
    with the fused head, one ``mt_adam``), graphed = eager, the losses
    against the tp phase's ``make_train_step`` on the same batches (the
    first step's within 1e-5 relative, every step's within 1e-3: each
    microbatch's bf16 weight grads round before their fp32 sum; with one
    microbatch, eager, both heads, every step within 1e-5), step ms
    (CUDA events), peak memory.  With two or more
    cards, ``pp_multi_card``: GPT-345M timed at pp 1, pp 4 (8
    microbatches, and profiled: every stage's idle share, NCCL ms and
    peak memory), pp 2 (8) and pp 4 at 2 (the reference's default),
    each within 1e-3 of pp 1's losses (tp x pp and the interleaved
    schedule are refused over NCCL, ROADMAP.md section 3).
    ``python3 chip_smoke.py pp_multi_card`` runs that check alone.
19. supervised: a ``Supervisor`` runs ``pretrain_gpt --zero
    --auto-resume --save-every 1 --steps 3`` at the pretrain phase's
    GPT-124M shape as its child, a fault script killing attempt 0 at
    step 1 (exit 137): rc 0, one restart, the resumed losses bitwise an
    unkilled run's (in this process, exact launch counts); the backoffs
    and the wall seconds.
20. serve_resilience: ``serve_gpt`` at its defaults with
    ``--metrics-dir`` and ``--trace-dir`` off and on (exact launch
    counts, streams equal token for token, the hooks' cost in tokens/s);
    then ``serve_gpt --watchdog-secs 5 --supervise`` as a child whose
    attempt 0 wedges after 20 decode steps: exit 75 with a manifest of
    all 32 requests (8 in flight), one restart, every request served.
21. fleet: two ``LocalReplica`` s of GPT-124M (fp32, T = 0) behind a
    ``FleetFrontend`` on this card, r0 killed at its step 3: no request
    dropped or duplicated, every stream bitwise the single-replica run,
    exact LN, decode attention and sampling launches of every scheduler
    built.  ``python3 chip_smoke.py resilience`` runs 19-21 alone.

Then a line with every phase's seconds (the build's included), the
kernels summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code
is nonzero and the last line is not printed.  A run whose one-card
phases pass ``STALL_SECONDS``, or a multi-card check that passes its own
limit, exits nonzero with every thread's stack.  Without a CUDA device,
or without the package beside this file, it exits nonzero at once.
"""

import contextlib
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
#: a run still going after this many seconds of its one-card phases has
#: stalled: it exits nonzero
STALL_SECONDS = 1140
#: the same for each multi-card check (``*_multi_card``), which runs only
#: with two or more cards and outside the one-card wall
MULTI_CARD_STALL_SECONDS = 1800

#: H100 SXM peaks (NVIDIA data sheet, dense): device memory bytes/s,
#: fp32 flops/s outside the tensor cores, bf16 and tf32 tensor-core flops/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12

ITERS = 20

NEG_INF_HALF = -0.5e30

#: bands of the flash kernels against their plain versions, by output:
#: relative to the plain output's max for out/dq/dk/dv, absolute for lse
FLASH_TOL_BF16 = {"out": 2.0 ** -6, "dq": 2.0 ** -6, "dk": 2.0 ** -6, "dv": 2.0 ** -6,
                  "lse": 1e-4}
FLASH_TOL_FP32 = {"out": 1e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4, "lse": 1e-4}
#: fp16: the bf16 bands scaled by fp16's unit roundoff (2**-11 against
#: bf16's 2**-8), the same 4x margin over one rounding of p and ds
FLASH_TOL_FP16 = {"out": 2.0 ** -9, "dq": 2.0 ** -9, "dk": 2.0 ** -9, "dv": 2.0 ** -9,
                  "lse": 1e-4}
#: half an ulp, relative: what rounding an fp32 value to the type moves it
HALF_ULP = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
#: train parity bands (relative): the loss, and every gradient leaf
TRAIN_PARITY_TOL = {"loss": 1e-5, "grads": 1e-3}


def emit(obj):
    print(json.dumps(obj), flush=True)


class _StallGuard:
    """``faulthandler``'s deadline: every thread's stack on stderr and a
    nonzero exit once the one-card phases have run ``STALL_SECONDS``.  A
    multi-card check runs under :meth:`multi_card`, with a limit of its
    own, and its time does not count against the one-card wall."""

    def __init__(self):
        self.left, self.since = None, None

    def _arm(self, seconds):
        import faulthandler

        faulthandler.dump_traceback_later(max(1.0, seconds), exit=True)

    def start(self, seconds=STALL_SECONDS):
        self.left, self.since = seconds, time.monotonic()
        self._arm(seconds)

    @contextlib.contextmanager
    def multi_card(self, seconds=MULTI_CARD_STALL_SECONDS):
        if self.left is None:  # not armed: a child mode or a lone check
            yield
            return
        self.left -= time.monotonic() - self.since
        self._arm(seconds)
        try:
            yield
        finally:
            self.since = time.monotonic()
            self._arm(self.left)


STALL = _StallGuard()


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


def ulps16(a, b):
    """Largest distance in steps of their type between two bf16 or two
    fp16 tensors (both sign-magnitude 16-bit codes)."""
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
    if dtype != torch.float32:
        # y against the plain fp32 value: the final rounding (half an
        # ulp: 2**-8 relative for bf16, 2**-11 for fp16) plus the fp32
        # band, 1e-5 abs (row stats in another order).  An ulp count is no
        # measure: where w * xhat cancels b, y is near 0 and a 1e-7 change
        # moves it many ulps.
        ulps = ulps16(y, py)
        y32 = layer_norm_fwd_plain(x.float(), w, b, eps, rms)[0]
        excess = float(((y.float() - y32).abs() - HALF_ULP[dtype] * y32.abs()).max())
        ok = excess <= 1e-5
        tol = (f"y within {HALF_ULP[dtype]} |y| + 1e-5 of the plain fp32 y (rounding to "
               f"{dtype}, then fp32 row stats in another order)")
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
            "max_abs_err": err, "ulps": ulps, "band_excess": excess,
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


#: the fp16 flash cases (the amp train step's kernels): GPT-124M's shape
#: with SDPA's fp16 time, its other head widths, a GQA case, and the
#: other instantiations at B = 2
FLASH_FP16_CASES = (
    ("gpt124", torch.float16, {"library": True}),
    ("gpt124_d32", torch.float16, {"D": 32, "library": True}),
    ("gpt124_d128", torch.float16, {"D": 128, "library": True}),
    ("gqa", torch.float16, {"Hkv": 4}),
    *((f"d{D}", torch.float16, {"B": 2, "D": D}) for D in (16, 48, 80, 96, 112)),
)


def fp16_kernels(dev, results):
    """The float16 instantiations of the LayerNorm and flash kernels (the
    amp train step's): LN forward at the decode (8) and train (8192)
    rows, the backward at 8192, the RMS and non-affine modes and the
    general path (H = 770, a misaligned view); flash per
    :data:`FLASH_FP16_CASES`.  Each against its plain version."""
    fp16 = torch.float16
    for R in (8, 8192):
        r = check_layer_norm(dev, R, fp16)
        results[("ln", R, fp16)] = r
        emit({"phase": "kernel", "kernel": "layer_norm_fwd", **r})
    r = check_layer_norm_bwd(dev, fp16)
    results[("ln_bwd", fp16)] = r
    emit({"phase": "kernel", "kernel": "layer_norm_bwd", **r})
    ln_cases = [(mode, 768, "fast", False) for mode in ("rms_affine", "rms", "ln")]
    ln_cases += [("ln_affine", 770, "general", False), ("ln_affine", 768, "general", True)]
    for mode, H, path, misaligned in ln_cases:
        kw = {"H": H, "path": path, "misaligned": misaligned}
        r = check_layer_norm(dev, 8192, fp16, mode, **kw)
        results[("ln", 8192, fp16, mode, H, misaligned)] = r
        emit({"phase": "kernel", "kernel": "layer_norm_fwd", **r})
        r = check_layer_norm_bwd(dev, fp16, mode, **kw)
        results[("ln_bwd", fp16, mode, H, misaligned)] = r
        emit({"phase": "kernel", "kernel": "layer_norm_bwd", **r})
    for case, dtype, kw in FLASH_FP16_CASES:
        r = check_flash(dev, dtype, case, **kw)
        results[("flash", case, dtype)] = r
        for name in ("fwd", "dq", "dkv"):
            emit({"phase": "kernel", **r[name]})


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
    """The bf16 and fp16 backward's shared memory as ``bwd_launch_plan``
    states it (the Python plan the CPU tests check) against
    ``apex_flash_smem``, which the launches use, at every head dim:
    equal."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops.flash_attention import bwd_launch_plan

    n = 0
    for which in (1, 2):
        for D in range(16, 129, 16):
            for dtype in (torch.bfloat16, torch.float16):
                got = lib.apex_flash_smem(which, D, _build.DTYPE_CODES[dtype])
                want = bwd_launch_plan(which, 1024, 1024, D, True).smem_bytes
                if got != want:
                    raise AssertionError(f"flash backward plan which={which} D={D} {dtype}: "
                                         f"C {got} B, Python {want} B")
                n += 1
    return {"plans_checked": n}


def check_ce_plan(lib):
    """The fused-CE plans as ``ce_bwd_plan`` and ``ce_fwd_plan`` state
    them (the Python plans the CPU tests check) against
    ``apex_ce_bwd_plan`` and ``apex_ce_fwd_plan``, what the launches use:
    dx and dembed, and the forward, at every dtype pair, at GPT-124M,
    every ``CE_GRID`` shape and every H the kernels take: equal, field
    for field."""
    import ctypes

    from apex_tpu_torch.ops.fused_ce_kernels import ce_bwd_plan, ce_fwd_plan

    shapes = {(8192, 768, 50304)} | {(kw["N"], kw["H"], kw["V"]) for _, kw in CE_GRID}
    shapes |= {(8192, H, 50304) for H in range(16, 1025, 16)}
    got = (ctypes.c_int64 * 7)()
    got_fwd = (ctypes.c_int64 * 8)()
    n = n_fwd = 0
    for N, H, V in sorted(shapes):
        for xd in (torch.float32, torch.bfloat16):
            for ed in (torch.float32, torch.bfloat16):
                codes = (int(xd == torch.bfloat16), int(ed == torch.bfloat16))
                for which in (1, 2):
                    rc = lib.apex_ce_bwd_plan(which, N, H, V, *codes, ctypes.addressof(got))
                    want = tuple(ce_bwd_plan(which, N, H, V, xd, ed))
                    if rc or tuple(got) != want:
                        raise AssertionError(
                            f"CE backward plan which={which} N={N} H={H} V={V} dtypes "
                            f"{xd},{ed}: C {tuple(got)} (rc {rc}), Python {want}")
                    n += 1
                rc = lib.apex_ce_fwd_plan(N, H, V, *codes, ctypes.addressof(got_fwd))
                want = tuple(ce_fwd_plan(N, H, V, xd, ed))
                if rc or tuple(got_fwd) != want:
                    raise AssertionError(
                        f"CE forward plan N={N} H={H} V={V} dtypes {xd},{ed}: C "
                        f"{tuple(got_fwd)} (rc {rc}), Python {want}")
                n_fwd += 1
    return {"plans_checked": n, "fwd_plans_checked": n_fwd}


def check_sample_plan(lib, sm_counts=(132,)):
    """``sample_plan`` (the Python statement the CPU tests check) against
    ``apex_sample_plan``, what the launches use, at N from 1 to 256, H
    from 4 to 8192 in steps of 4, V = 50304 and 8191, on 132 SMs and the
    card's own count: equal, field for field."""
    import ctypes

    from apex_tpu_torch.ops.decode_sampling import SamplePlan, sample_plan

    got = (ctypes.c_int64 * len(SamplePlan._fields))()
    n = 0
    for sms in sm_counts:
        for V in (50304, 8191):
            for N in range(1, 257):
                for H in range(4, 8193, 4):
                    rc = lib.apex_sample_plan(N, H, V, sms, ctypes.addressof(got))
                    want = tuple(sample_plan(N, H, V, sms))
                    if rc or tuple(got) != want:
                        raise AssertionError(
                            f"sampling plan N={N} H={H} V={V} SMs={sms}: C {tuple(got)} "
                            f"(rc {rc}), Python {want}")
                    n += 1
    return {"plans_checked": n, "sm_counts": list(sm_counts)}


#: the widths the LayerNorm plan check runs: every path and warps a row,
#: ragged widths beside them, past the fast path and up to MAX_HIDDEN
LN_PLAN_WIDTHS = (8, 12, 16, 24, 96, 100, 256, 512, 764, 768, 770, 1000, 1024, 1028, 1536,
                  2048, 2052, 3072, 4096, 4100, 5120, 6144, 8192, 8200, 10240, 12032)


def check_ln_plan(lib):
    """``ln_plan`` (the Python statement the CPU tests check) against
    ``apex_layer_norm_plan``, what the launches use, at R in {1, 7, 8,
    40, 64, 8192}, every width of ``LN_PLAN_WIDTHS``, the three dtypes,
    aligned or not: equal, field for field."""
    import ctypes

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops.layer_norm import LnPlan, ln_plan

    got = (ctypes.c_int64 * len(LnPlan._fields))()
    n = 0
    for R in (1, 7, 8, 40, 64, 8192):
        for H in LN_PLAN_WIDTHS:
            for dtype in _build.DTYPE_CODES:
                for aligned in (True, False):
                    rc = lib.apex_layer_norm_plan(R, H, _build.DTYPE_CODES[dtype],
                                                  int(aligned), ctypes.addressof(got))
                    want = tuple(ln_plan(R, H, dtype, aligned))
                    if rc or tuple(got) != want:
                        raise AssertionError(
                            f"LayerNorm plan R={R} H={H} {dtype} aligned={aligned}: C "
                            f"{tuple(got)} (rc {rc}), Python {want}")
                    n += 1
    return {"plans_checked": n}


_SAMPLE_EMBEDS = {}


def sample_embed(dev, H, V=50304):
    """The fp32 (V, H) embed of the sampling cases at width H (std 0.02,
    from seed 7 + H), made once."""
    if H not in _SAMPLE_EMBEDS:
        rng = np.random.default_rng(7 + H)
        _SAMPLE_EMBEDS[H] = torch.from_numpy(
            rng.standard_normal((V, H), dtype=np.float32) * 0.02).to(dev)
    return _SAMPLE_EMBEDS[H]


def check_sampling(dev, temperature, top_k, N, H=768, timed=True):
    """The sampling head against its plain version on 8 draws of N bf16
    rows of width H: the same tokens, or the plain score at the kernel's
    token within 1e-4 of the plain max.  ``timed``: the kernel's, the
    plain version's and, at T = 0, the library's time (argmax of a fp32
    torch.matmul, two calls) beside the bound."""
    from apex_tpu_torch.ops.decode_sampling import (
        fused_sample, fused_sample_plain, gumbel_from_seed,
    )

    V = 50304
    embed = sample_embed(dev, H, V)
    rng = np.random.default_rng(7 + N)
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
    # the kernel's operations: two tf32 products (the embed's hi and lo
    # halves against the bf16 rows, exact in tf32) on the tensor cores
    bms, by = bound(nbytes, 2 * 2 * N * V * H, PEAK_TF32)
    t = {}
    if timed:
        # yardstick at T = 0 (no single PyTorch call samples): the greedy
        # head as two calls, a fp32 torch.matmul and torch.argmax
        library = None if temperature > 0 else (
            lambda: torch.argmax(torch.matmul(x.float(), embed.T), dim=-1))
        t = timings(lambda: fused_sample(x, embed, seeds, temperature, top_k),
                    lambda: fused_sample_plain(x, embed, seeds, temperature, top_k), library)
    return {"N": N, "V": V, "H": H, "temperature": temperature, "top_k": top_k,
            "draws": 8 * N, "near_ties": ties, "max_abs_err": worst,
            "tolerance": "tokens equal, or the plain score at the kernel's token "
                         "within 1e-4 of the plain max (summation order, logf)",
            "library": None if temperature > 0 else "torch.argmax(torch.matmul(x.float(), "
                                                    "embed.T)): 2 calls",
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
    # dx against the plain fp32 value: the final rounding (half an ulp:
    # 2**-8 relative for bf16, 2**-11 for fp16, 0 for fp32) plus the fp32
    # band, 1e-5 abs (the row sums in another order; dx = (gw - m1 - xhat
    # * m2) * rstd cancels, so an ulp count of the rounded values is no
    # measure)
    half_ulp = HALF_ULP.get(dtype, 2.0 ** -8)
    dx_excess = float(((dx.float() - dx32).abs() - half_ulp * dx32.abs()).max())
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
    ulps = ulps16(dx, pdx) if dtype != torch.float32 else None
    tol = (f"dx within {half_ulp} |dx| + 1e-5 of the plain fp32 dx (rounding to x's "
           "dtype, then fp32 row sums in another order); dw, db within 1e-5 of the sum "
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
            "max_abs_err": dx_err, "ulps": ulps, "dx_band_excess": dx_excess,
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
    elif dtype == torch.float16:
        tol = FLASH_TOL_FP16
        why = ("max |kernel - plain| / max |plain| for out, dq, dk, dv: the kernel "
               "rounds p and ds to fp16 before its dots, the plain version (the "
               "reference's fp16 path, the fp32 scan) is fp32 throughout; the bf16 "
               "band times 2**-3; lse abs (fp32 in both)")
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
    peak = PEAK_FP32 if dtype == torch.float32 else PEAK_BF16  # fp16: the same peak
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
    arithmetic on x2's device; ``t`` may hold ids outside ``[0, V)``, a
    vocab shard's misses): acc_step * K/16 * T + flip * M, with T
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
        # the target's |d|, (rows, 1); 0 for an id outside [0, V) (a
        # vocab shard's miss), which hits nothing
        tc_in = tc.clamp(0, V - 1)
        d_t = d.gather(1, tc_in[:, None]) * ((tc >= 0) & (tc < V)).float()[:, None]
        hit_dx.append(d_t * ea[tc_in])
        hit_de.index_add_(0, tc_in, d_t * xc.abs())
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


# --------------------------------------------------------------- optimizers
def bench_param_shapes():
    """bench.py's ``make_params`` shapes (bench.py:72-90) in its order:
    ResNet-50's convolutions, batch-norm vectors and classifier, 99
    tensors and 22,761,768 params."""
    shapes = [("conv1", (64, 3, 7, 7))]
    widths = ((64, 256, 3), (128, 512, 4), (256, 1024, 6), (512, 2048, 3))
    for si, (w, wout, blocks) in enumerate(widths):
        for b in range(blocks):
            shapes += [(f"s{si}b{b}c1", (w, wout if b else wout // 2, 1, 1)),
                       (f"s{si}b{b}c2", (w, w, 3, 3)), (f"s{si}b{b}c3", (wout, w, 1, 1)),
                       (f"s{si}b{b}bn1", (w,)), (f"s{si}b{b}bn2", (w,)),
                       (f"s{si}b{b}bn3", (wout,))]
    return shapes + [("fc", (1000, 2048)), ("fc_b", (1000,))]


def gpt_param_shapes(L=12, H=768, V=50304, S=1024):
    """GPT-124M's param leaves as ``models.gpt.init_params`` lays them out
    (the layers stacked), ``{name: shape}``."""
    layer = {"ln1_scale": (L, H), "ln1_bias": (L, H), "wq": (L, H, H), "wk": (L, H, H),
             "wv": (L, H, H), "bq": (L, H), "bk": (L, H), "bv": (L, H), "wo": (L, H, H),
             "bo": (L, H), "ln2_scale": (L, H), "ln2_bias": (L, H), "fc1": (L, 4 * H, H),
             "fc1_b": (L, 4 * H), "fc2": (L, H, 4 * H), "fc2_b": (L, H)}
    return {"embed": (V, H), "final_ln_scale": (H,), "final_ln_bias": (H,),
            "pos_embed": (S, H), "layers": layer}


#: shapes whose sizes are not multiples of 4: the kernels' scalar path,
#: and bucket slices that start off 16 bytes
ODD_SHAPES = ((7,), (33,), (9, 17), (1,), (1001,), (3, 5, 7), (65537,), (16385,), (256, 3))


def _leaf_shapes(tree):
    """The shapes of a ``{name: shape}`` tree in leaf order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _leaf_shapes(tree[k])]
    return [tree]


def _randn(gen, shape, dev, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def _adam_operands(dev, shapes, seed, p_dtype=torch.float32, g_dtype=torch.float32,
                   master=False, resident=False):
    """Inputs and two sets of outputs of one ``mt_adam`` call; with
    ``resident`` m, v (and the master) are slices of bucket buffers, as
    ``init(bucketed=True)`` holds them."""
    from apex_tpu_torch.optimizers import bucketing

    gen = torch.Generator(device=dev).manual_seed(seed)
    n = [int(np.prod(s)) for s in shapes]
    g = [_randn(gen, s, dev, 0.1, g_dtype) for s in shapes]
    p = [_randn(gen, s, dev, 1.0, p_dtype) for s in shapes]
    m = [_randn(gen, s, dev, 0.01) for s in shapes]
    v = [_randn(gen, s, dev, 0.01).abs() for s in shapes]
    src = [x.float() for x in p] if master else p
    if resident:
        plan = bucketing.plan_of([torch.empty(s, device="meta") for s in shapes])

        def views(leaves):
            return bucketing.Buckets(plan, bucketing.pack(plan, leaves)).leaf_views()

        m, v = views(m), views(v)
        if master:
            src = views(src)

    def outs():
        def bucket_views():
            return bucketing.Buckets(plan, [torch.zeros(b.total, device=dev)
                                            for b in plan.buckets]).leaf_views()
        po = [torch.empty(k, dtype=p_dtype, device=dev) for k in n]
        if resident:
            return po, bucket_views(), bucket_views(), bucket_views() if master else None
        return (po, [torch.empty(k, device=dev) for k in n], [torch.empty(k, device=dev)
                                                               for k in n],
                [torch.empty(k, device=dev) for k in n] if master else None)

    return g, src, m, v, outs(), outs()


#: the mt_adam cases: (shapes, operands, options)
ADAM_CASES = {
    "adamw": ("gpt124", {}, {}),
    "l2": ("bench", {}, {"adam_w_mode": False}),
    "bf16_master": ("bench", {"p_dtype": torch.bfloat16, "g_dtype": torch.bfloat16,
                              "master": True}, {}),
    "bf16_params": ("odd", {"p_dtype": torch.bfloat16}, {}),
    "resident": ("odd", {"resident": True}, {}),
    "resident_master": ("odd", {"resident": True, "master": True,
                                "p_dtype": torch.bfloat16}, {}),
    "groups": ("odd", {}, {"groups": True}),
    "clip": ("bench", {}, {"coef": 0.37}),
    "nonfinite": ("odd", {"resident": True}, {"pred": False}),
}


def _case_shapes(name):
    if name == "gpt124":
        return _leaf_shapes(gpt_param_shapes())
    if name == "bench":
        return [s for _, s in sorted(bench_param_shapes())]
    return list(ODD_SHAPES)


def check_mt_adam(dev, case):
    """``mt_adam`` against its plain version on the same card tensors,
    bitwise: params, moments and master; the AdamW case at GPT-124M's
    20 leaves (the train step's call) is timed beside the plain version
    and ``torch.optim.AdamW`` (``fused=True``, the library call; and
    ``foreach=True``)."""
    from apex_tpu_torch.ops import multi_tensor as mt

    shapes_name, okw, ckw = ADAM_CASES[case]
    shapes = _case_shapes(shapes_name)
    g, src, m, v, out_k, out_p = _adam_operands(dev, shapes, len(case), **okw)
    T = len(shapes)
    kw = dict(lr=1e-3, wd=[0.01] * T, bc1=torch.tensor(0.19, device=dev),
              bc2=torch.tensor(0.0029970, device=dev), beta1=0.9, beta2=0.999, eps=1e-8,
              adam_w_mode=ckw.get("adam_w_mode", True))
    if ckw.get("groups"):
        kw.update(lr=torch.tensor(3e-3, device=dev),
                  wd=[0.1 if len(s) > 1 else 0.0 for s in shapes],
                  lr_abs=[1e-4 if k % 3 == 0 else None for k in range(T)],
                  lr_scale=[0.5 if k % 2 else 1.0 for k in range(T)])
    if "coef" in ckw:
        kw["coef"] = torch.tensor(ckw["coef"], device=dev)
    if "pred" in ckw:
        kw["pred"] = torch.tensor(ckw["pred"], device=dev)
    mt.mt_adam(g, src, m, v, *out_k, **kw)
    mt.mt_adam_plain(g, src, m, v, *out_p, **kw)
    torch.cuda.synchronize()
    got = [t for ts in out_k if ts is not None for t in ts]
    want = [t for ts in out_p if ts is not None for t in ts]
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    kept = None
    if ckw.get("pred") is False:
        old = list(src) + list(m) + list(v)
        new = list(out_k[0] if out_k[3] is None else out_k[3]) + list(out_k[1]) + list(out_k[2])
        kept = all(torch.equal(a.float().reshape(-1), b.float().reshape(-1))
                   for a, b in zip(new, old, strict=True))
    if not bitwise or kept is False:
        raise AssertionError(f"mt_adam {case}: kernel != plain version (max abs {err}), "
                             f"old values kept: {kept}")
    N = sum(int(np.prod(s)) for s in shapes)
    pb = src[0].element_size()
    nbytes = N * (g[0].element_size() + pb + 8 + out_k[0][0].element_size() + 8
                  + (4 if out_k[3] is not None else 0))
    bms, by = bound(nbytes, 20 * N)
    plan = mt.mt_plan("adam", [int(np.prod(s)) for s in shapes])
    r = {"kernel": "mt_adam", "case": case, "tensors": T, "elements": N,
         "launches_per_call": plan.launches, "max_abs_err": err, "bitwise_equal": bitwise,
         "old_values_kept": kept, "tolerance": "bitwise (the same fp32 operations, "
         "no FMA contraction, in the same association)", "bound_ms": bms, "bound_by": by}
    if case != "adamw":
        return r
    t = timings(lambda: mt.mt_adam(g, src, m, v, *out_k, **kw),
                lambda: mt.mt_adam_plain(g, src, m, v, *out_p, **kw))
    for k in ("fused", "foreach"):
        lp = [x.clone().requires_grad_() for x in src]
        for a, b in zip(lp, g):
            a.grad = b.clone()
        lib_opt = torch.optim.AdamW(lp, lr=1e-3, weight_decay=0.01, **{k: True})
        lib_opt.step()
        t[f"adamw_{k}_ms"] = device_ms(lib_opt.step)[0]
        del lib_opt, lp
    t["library_ms"] = t["adamw_fused_ms"]
    return {**r, **t, "library": "torch.optim.AdamW(fused=True).step (foreach: adamw_foreach_ms); "
            "its decay associates differently, a yardstick of time only"}


def check_mt_scale(dev, case):
    """``mt_scale`` against its plain version, bitwise, with the found
    flag equal and as expected: the train grads' 1/1024 unscale into
    fp32 (timed; the library: ``torch._foreach_mul`` and an
    ``isfinite().all()`` vote), bf16 in and out, an inf injected, and a
    multiply that overflows."""
    from apex_tpu_torch.ops import multi_tensor as mt

    gen = torch.Generator(device=dev).manual_seed(11)
    src_dtype, out_dtype, shapes, mult, want_found = {
        "unscale": (torch.float32, torch.float32, "gpt124", 1.0 / 1024, False),
        "bf16_in": (torch.bfloat16, torch.float32, "bench", 0.5, False),
        "bf16_out": (torch.float32, torch.bfloat16, "odd", 3.0, False),
        "inf": (torch.float32, torch.float32, "odd", 1.0 / 1024, True),
        "overflow": (torch.float32, torch.float32, "odd", 3e38, True),
        "tensor_mult": (torch.float16, torch.float32, "odd", "tensor", False),
    }[case]
    shapes = _case_shapes(shapes)
    src = [_randn(gen, s, dev, 1.0, src_dtype) for s in shapes]
    if case == "inf":
        src[len(src) // 2].view(-1)[-1] = math.inf
    if mult == "tensor":
        mult = torch.tensor(1.0 / 64, device=dev)
    out_k = [torch.empty(s, dtype=out_dtype, device=dev) for s in shapes]
    out_p = [torch.empty(s, dtype=out_dtype, device=dev) for s in shapes]
    fk = mt.mt_scale(src, out_k, mult)
    fp = mt.mt_scale_plain(src, out_p, mult)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(out_k, out_p)) or case in ("inf",
                                                                          "overflow")
    if case in ("inf", "overflow"):  # inf and nan compare unequal: compare the bits
        bitwise = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                      for a, b in zip(out_k, out_p))
    err = max(float((a.float() - b.float()).abs().nan_to_num(0.0, 0.0, 0.0).max())
              for a, b in zip(out_k, out_p))
    if not bitwise or bool(fk) != bool(fp) or bool(fk) != want_found:
        raise AssertionError(f"mt_scale {case}: bitwise {bitwise}, found {bool(fk)} / "
                             f"plain {bool(fp)}, expected {want_found}")
    N = sum(int(np.prod(s)) for s in shapes)
    bms, by = bound(N * (src[0].element_size() + out_k[0].element_size()), N)
    r = {"kernel": "mt_scale", "case": case, "tensors": len(src), "elements": N,
         "launches_per_call": mt.mt_plan("scale", [x.numel() for x in src]).launches,
         "max_abs_err": err, "bitwise_equal": bitwise, "found_non_finite": bool(fk),
         "tolerance": "bitwise, and the flag equal", "bound_ms": bms, "bound_by": by}
    if case != "unscale":
        return r

    def library():
        outs = torch._foreach_mul(src, mult)
        return torch.stack([torch.isfinite(o).all() for o in outs]).all()

    t = timings(lambda: mt.mt_scale(src, out_k, mult), lambda: mt.mt_scale_plain(src, out_p, mult),
                library)
    return {**r, **t, "library": "torch._foreach_mul + stack(isfinite(x).all())"}


def check_mt_l2norm(dev, case):
    """``mt_l2norm`` within 1e-5 relative of a float64 sum per leaf and
    in total (its order differs from the plain version's), and bitwise
    equal over two calls; at the train grads' shapes timed beside the
    plain version and ``torch.linalg.vector_norm`` a leaf."""
    from apex_tpu_torch.ops import multi_tensor as mt

    gen = torch.Generator(device=dev).manual_seed(13)
    dtype, shapes = {"gpt124": (torch.float32, "gpt124"), "bench": (torch.float32, "bench"),
                     "odd_bf16": (torch.bfloat16, "odd"), "odd": (torch.float32, "odd")}[case]
    shapes = _case_shapes(shapes)
    x = [_randn(gen, s, dev, 1.0, dtype) for s in shapes]
    total, per = mt.mt_l2norm(x)
    total2, per2 = mt.mt_l2norm(x)
    torch.cuda.synchronize()
    ref = torch.stack([t.double().square().sum() for t in x])
    rel_leaf = float(((per.double() - ref).abs() / ref).max())
    rel_total = abs(float(total) - float(ref.sum())) / float(ref.sum())
    same = bool(torch.equal(total, total2)) and bool(torch.equal(per, per2))
    if max(rel_leaf, rel_total) > 1e-5 or not same:
        raise AssertionError(f"mt_l2norm {case}: rel {rel_leaf} / {rel_total}, "
                             f"reproducible {same}")
    N = sum(t.numel() for t in x)
    bms, by = bound(N * x[0].element_size(), 2 * N)
    r = {"kernel": "mt_l2norm", "case": case, "tensors": len(x), "elements": N,
         "launches_per_call": mt.mt_plan("l2norm", [t.numel() for t in x]).launches,
         "max_abs_err": float((per.double() - ref).abs().max()),
         "max_rel_err_leaf": rel_leaf, "rel_err_total": rel_total,
         "bitwise_equal_over_two_calls": same,
         "tolerance": "1e-5 relative of the float64 sums (fp32 partials in a fixed order)",
         "bound_ms": bms, "bound_by": by}
    if case != "gpt124":
        return r
    t = timings(lambda: mt.mt_l2norm(x), lambda: mt.mt_l2norm_plain(x),
                lambda: [torch.linalg.vector_norm(t) for t in x])
    return {**r, **t, "library": "torch.linalg.vector_norm, one call a leaf"}


def check_mt_plan(lib):
    """``mt_plan`` against ``apex_mt_plan`` field for field, for each
    kernel at the bench set, GPT-124M, the odd shapes and random lists
    of up to 600 tensors (empty ones among them)."""
    import ctypes

    from apex_tpu_torch.ops import _build, multi_tensor as mt

    rng = np.random.default_rng(17)
    lists = [[int(np.prod(s)) for s in _case_shapes(n)] for n in ("bench", "gpt124", "odd")]
    lists += [list(rng.integers(0, 3 * mt.CHUNK, size=int(rng.integers(0, 600))))
              for _ in range(40)]
    lists += [[0] * 200, [mt.CHUNK] * 500, []]
    out = (ctypes.c_longlong * 6)()
    checked = 0
    for kind, code in mt.KINDS.items():
        for sizes in lists:
            n = np.array(sizes, dtype=np.int64)
            _build.check(lib.apex_mt_plan(code, n.ctypes.data, len(sizes), out), "apex_mt_plan")
            want = tuple(mt.mt_plan(kind, sizes))
            if tuple(out) != want:
                raise AssertionError(f"mt_plan {kind} over {len(sizes)} tensors: {want} != "
                                     f"C {tuple(out)}")
            checked += 1
    return {"plans_checked": checked, "capacity": mt.CAPACITY, "table_bytes": mt.TABLE_SIZES,
            "chunk": mt.CHUNK, "threads": mt.THREADS}


def mt_kernels(dev, results, lib):
    """The optimizer kernels' part of the kernels phase."""
    emit({"phase": "kernel", "kernel": "mt_plan", **check_mt_plan(lib)})
    for case in ADAM_CASES:
        results[("mt_adam", case)] = r = check_mt_adam(dev, case)
        emit({"phase": "kernel", **r})
    for case in ("unscale", "bf16_in", "bf16_out", "inf", "overflow", "tensor_mult"):
        results[("mt_scale", case)] = r = check_mt_scale(dev, case)
        emit({"phase": "kernel", **r})
    for case in ("gpt124", "bench", "odd_bf16", "odd"):
        results[("mt_l2norm", case)] = r = check_mt_l2norm(dev, case)
        emit({"phase": "kernel", **r})
    results[("mt_adam_remainder",)] = r = check_mt_adam_remainder(dev)
    emit({"phase": "kernel", **r})


def bench_params(dev, seed=0):
    """bench.py's params (``randn * 0.01`` from numpy's ``seed``) and
    grads (``p * 0.001 + 0.0001``, ``bench_fused_adam``) on ``dev``."""
    rng = np.random.RandomState(seed)
    params = {n: torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.01).to(dev)
              for n, s in bench_param_shapes()}
    return params, {n: p * 0.001 + 0.0001 for n, p in params.items()}


def eager_adam_step(params, m, v, grads, step, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.01):
    """bench.py's ``eager_adam_step``: op-by-op Adam, one launch a line a
    tensor."""
    new_p, new_m, new_v = {}, {}, {}
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    for k in params:
        g = grads[k]
        m_k = b1 * m[k] + (1 - b1) * g
        v_k = b2 * v[k] + (1 - b2) * (g * g)
        update = (m_k / bc1) / (torch.sqrt(v_k / bc2) + eps) + wd * params[k]
        new_p[k] = params[k] - lr * update
        new_m[k] = m_k
        new_v[k] = v_k
    return new_p, new_m, new_v


def _chain_ms(step, carry, K, reps=3):
    """Device-clock ms a step of ``K`` chained eager steps (CUDA events,
    best of ``reps``): the host's time where the host is slower."""
    best = None
    for _ in range(reps):
        c = carry
        c = step(c)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(K):
            c = step(c)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / K
        best = ms if best is None else min(best, ms)
    return best


def _graphed_chain(step, carry, K):
    """``K`` chained steps captured as one CUDA graph (bench.py's jitted
    chain): ``(graph, output after K steps)``; each replay recomputes
    them from ``carry``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(carry)  # warm-up: kernels built, allocator primed
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = carry
        for _ in range(K):
            c = step(c)
    return graph, c


def _replay_ms(graph, K, reps=5):
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * K)


def _state_tensors(state):
    from apex_tpu_torch.optimizers import bucketing
    from apex_tpu_torch.optimizers.tree import tree_leaves

    out = []
    for field in state:
        if isinstance(field, bucketing.Buckets):
            out += tree_leaves(field.unpack(dtype=torch.float32))
        elif field is not None:
            out += tree_leaves(field)
    return out


#: the other optimizers' card-against-CPU runs: (class, kwargs, bf16 params)
OTHER_OPTS = {
    "sgd_momentum": ("FusedSGD", {"lr": 1e-2, "momentum": 0.9, "weight_decay": 0.01}, False),
    "sgd_nesterov": ("FusedSGD", {"lr": 1e-2, "momentum": 0.9, "nesterov": True}, False),
    "lamb": ("FusedLAMB", {"lr": 1e-2, "weight_decay": 0.01}, False),
    "mixed_precision_lamb": ("FusedMixedPrecisionLamb", {"lr": 1e-2, "weight_decay": 0.01},
                             True),
    "adagrad": ("FusedAdagrad", {"lr": 1e-2, "weight_decay": 0.01}, False),
    "novograd": ("FusedNovoGrad", {"lr": 1e-2, "weight_decay": 0.01}, False),
}
#: fp32 params and state; bf16 params (the mixed-precision LAMB's) within
#: one bf16 ulp: their fp32 master may differ by an ulp, and its rounding
#: to bf16 by one bf16 ulp where it lies next to a rounding midpoint
OTHER_OPTS_TOL = {"rtol": 1e-5, "atol": 1e-6}


def other_optimizers(dev, steps=5):
    """Each other optimizer 5 steps on the engine on the card and on the
    CPU from the same numpy params and grads (the bench set's first 40
    tensors and the odd shapes): bitwise where it holds, else fp32
    within rtol 1e-5 / atol 1e-6 and bf16 params within one bf16 ulp
    (LAMB's and NovoGrad's norms sum in another order on the card, and
    their bias corrections' powers may round apart)."""
    from apex_tpu_torch import optimizers as O
    from apex_tpu_torch.optimizers.tree import tree_leaves

    rng = np.random.RandomState(3)
    shapes = [s for _, s in bench_param_shapes()[:40]] + list(ODD_SHAPES)
    p_np = {f"t{i:03d}": rng.randn(*s).astype(np.float32) * 0.1 for i, s in enumerate(shapes)}
    g_np = [{k: rng.randn(*a.shape).astype(np.float32) * 0.01 for k, a in p_np.items()}
            for _ in range(steps)]
    out = {}
    for name, (cls, kw, bf16) in OTHER_OPTS.items():
        res = {}
        for where in ("cpu", dev):
            dt = torch.bfloat16 if bf16 else torch.float32
            p = {k: torch.from_numpy(a).to(where, dt) for k, a in p_np.items()}
            opt = getattr(O, cls)(**kw)
            s = opt.init(p)
            for g in g_np:
                p, s = opt.update({k: torch.from_numpy(a).to(where, dt) for k, a in g.items()},
                                  s, p)
            res[str(where)] = [t.cpu() for t in tree_leaves(p) + _state_tensors(s)]
        cpu, card = res["cpu"], res[str(dev)]
        bitwise = all(torch.equal(a, b) for a, b in zip(card, cpu, strict=True))
        f32 = [(a, b) for a, b in zip(card, cpu) if a.dtype == torch.float32]
        half = [(a, b) for a, b in zip(card, cpu) if a.dtype == torch.bfloat16]
        err = max(float((a - b).abs().max()) for a, b in f32)
        ulps = max((ulps16(a, b) for a, b in half), default=0)
        ok = all(torch.allclose(a, b, **OTHER_OPTS_TOL) for a, b in f32) and ulps <= 1
        out[name] = {"bitwise_equal": bitwise, "max_abs_err_fp32": err,
                     "max_bf16_ulps": ulps if half else None, "within_band": ok}
        if not ok:
            raise AssertionError(f"{name}: card against CPU outside the band: fp32 {err}, "
                                 f"bf16 ulps {ulps}")
    return out


def optimizers_phase(dev, K=10):
    """bench.py's headline section (``bench_fused_adam``) on the card:
    FusedAdam(lr=1e-3, weight_decay=0.01) over bench.py's 99-tensor set
    with grads ``p * 0.001 + 0.0001``.  Times per step (CUDA events over
    chained steps): the engine with resident state graphed (``K`` steps
    a graph: the twin of the jitted chain) and eager, the engine in
    transparent mode, the per-leaf path (graphed and eager), bench.py's
    op-by-op eager Adam, and ``torch.optim.AdamW`` fused and foreach.
    After 5 steps every engine variant's params and moments equal the
    per-leaf path's bitwise.  Then ``update_scaled`` (scale 1024, clip
    1.0) for two steps with exact mt_adam / mt_scale / mt_l2norm launch
    counts, and the other five optimizers card against CPU."""
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.tree import tree_leaves

    t0 = time.monotonic()
    params, grads = bench_params(dev)
    sizes = [p.numel() for p in tree_leaves(params)]
    N = sum(sizes)
    plan = mt.mt_plan("adam", sizes)
    bms, by = bound(28 * N, 20 * N)
    engine = FusedAdam(lr=1e-3, weight_decay=0.01)
    leaf = FusedAdam(lr=1e-3, weight_decay=0.01, use_buckets=False)

    def stepper(opt):
        def step(c):
            return opt.update(grads, c[1], c[0])
        return step

    # 5 steps each: every engine variant bitwise equal to the per-leaf path
    runs = {}
    for name, opt, bucketed in (("resident", engine, True), ("transparent", engine, False),
                                ("per_leaf", leaf, False)):
        reset_counts()
        c = (params, opt.init(params, bucketed=bucketed))
        for _ in range(5):
            c = stepper(opt)(c)
        torch.cuda.synchronize()
        runs[name] = (tree_leaves(c[0]) + _state_tensors(c[1]), launch_counts())
    graph5, out5 = _graphed_chain(stepper(engine), (params, engine.init(params, bucketed=True)),
                                  5)
    graph5.replay()
    torch.cuda.synchronize()
    runs["resident_graphed"] = (tree_leaves(out5[0]) + _state_tensors(out5[1]), None)
    del graph5, out5
    ref = runs["per_leaf"][0]
    equal = {k: all(torch.equal(a, b) for a, b in zip(v[0], ref, strict=True))
             for k, v in runs.items() if k != "per_leaf"}
    launches = {k: runs[k][1]["mt_adam"] for k in ("resident", "transparent", "per_leaf")}
    want_launches = {"resident": 5 * plan.launches, "transparent": 5 * plan.launches,
                     "per_leaf": 0}
    del runs, ref

    # times
    ms = {}
    for name, opt, bucketed in (("engine_resident_graphed", engine, True),
                                ("per_leaf_graphed", leaf, False)):
        graph, _ = _graphed_chain(stepper(opt), (params, opt.init(params, bucketed=bucketed)), K)
        ms[name] = _replay_ms(graph, K)
        del graph
    ms["engine_resident_eager"] = _chain_ms(stepper(engine),
                                            (params, engine.init(params, bucketed=True)), K)
    ms["engine_transparent_eager"] = _chain_ms(stepper(engine), (params, engine.init(params)), K)
    ms["per_leaf_eager"] = _chain_ms(stepper(leaf), (params, leaf.init(params)), 3)
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    eager = {"i": 1}

    def eager_step(c):
        eager["i"] += 1
        p, m_, v_ = eager_adam_step(c[0], c[1], c[2], grads, eager["i"])
        return p, m_, v_

    ms["op_by_op_eager"] = _chain_ms(eager_step, (params, zeros, dict(zeros)), 3)
    for k in ("fused", "foreach"):
        lp = [p.clone().requires_grad_() for p in tree_leaves(params)]
        for a, g in zip(lp, tree_leaves(grads)):
            a.grad = g.clone()
        lib_opt = torch.optim.AdamW(lp, lr=1e-3, weight_decay=0.01, **{k: True})
        ms[f"torch_adamw_{k}"] = _chain_ms(lambda c, o=lib_opt: o.step(), None, K)
        del lib_opt, lp

    # the amp step: unscale, clip, vote and Adam, two steps, counted
    reset_counts()
    c = (params, engine.init(params, bucketed=True))
    scaled = {n: g * 1024.0 for n, g in grads.items()}
    for _ in range(2):
        p, s, fin = engine.update_scaled(scaled, c[1], c[0], scale=1024.0, clip_norm=1.0)
        c = (p, s)
    finite = bool(fin)
    amp_counts = launch_counts()
    amp_want = {"mt_adam": 2 * plan.launches,
                "mt_scale": 2 * mt.mt_plan("scale", sizes).launches,
                "mt_l2norm": 2 * mt.mt_plan("l2norm", sizes).launches}
    amp_seen = {k: amp_counts[k] for k in amp_want}
    others = other_optimizers(dev)
    fused_ms = ms["engine_resident_graphed"]
    report = {
        "phase": "optimizers", "set": "bench.py make_params (bench.py:72-90)",
        "tensors": len(sizes), "params": N, "tensors_under_64k": sum(n < 65536 for n in sizes),
        "ms": ms, "graph_steps": K,
        "speedup_vs_eager": ms["op_by_op_eager"] / fused_ms,
        "speedup_vs_per_leaf": ms["per_leaf_graphed"] / fused_ms,
        "speedup_vs_per_leaf_eager": ms["per_leaf_eager"] / fused_ms,
        "speedup_vs_torch_adamw_fused": ms["torch_adamw_fused"] / fused_ms,
        "bound_ms": bms, "bound_by": by, "fraction_of_bound": bms / fused_ms,
        "five_steps_bitwise_equal_per_leaf": equal,
        "mt_adam_launches": launches, "mt_adam_launches_expected": want_launches,
        "mt_adam_launches_per_step": plan.launches,
        "amp_step": {"finite": finite, "launches": amp_seen, "expected": amp_want},
        "other_optimizers_card_vs_cpu": others,
        "band": {**OTHER_OPTS_TOL, "bf16_params_ulps": 1},
        "nvidia_smi": _smi(), "seconds": time.monotonic() - t0}
    emit(report)
    if not all(equal.values()) or launches != want_launches or amp_seen != amp_want \
            or not finite:
        raise AssertionError(f"optimizers: bitwise {equal}, launches {launches} vs "
                             f"{want_launches}, amp {amp_seen} vs {amp_want}, finite {finite}")
    return amp_seen


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


# -------------------------------------------------------------------- serve
#: the kernels' launch counters (``apex_tpu_torch.ops.COUNTERS``) by the
#: names of this script's lines
COUNTER_NAMES = {
    "layer_norm_fwd": "layer_norm.LAUNCHES",
    "paged_decode_attention": "decode_attention.LAUNCHES",
    "paged_decode_attention_wide": "decode_attention.WIDE_LAUNCHES",
    "fused_sample": "decode_sampling.LAUNCHES",
    "layer_norm_bwd": "layer_norm.BWD_LAUNCHES",
    "flash_fwd": "flash_attention.FWD_LAUNCHES",
    "flash_dq": "flash_attention.DQ_LAUNCHES",
    "flash_dkv": "flash_attention.DKV_LAUNCHES",
    "ce_fwd": "fused_ce_kernels.FWD_LAUNCHES",
    "ce_dx": "fused_ce_kernels.DX_LAUNCHES",
    "ce_dembed": "fused_ce_kernels.DEMBED_LAUNCHES",
    "mt_adam": "multi_tensor.ADAM_LAUNCHES",
    "mt_scale": "multi_tensor.SCALE_LAUNCHES",
    "mt_l2norm": "multi_tensor.L2NORM_LAUNCHES",
}


def launch_counts():
    from apex_tpu_torch import ops

    counts = ops.launch_counts()
    return {name: counts[key] for name, key in COUNTER_NAMES.items()}


def reset_counts():
    from apex_tpu_torch import ops

    ops.restore_counts(dict.fromkeys(ops.launch_counts(), 0))


def serve_expect(stats, L, chunked):
    """The launch counts a serve run must show, from its scheduler's
    stats: LN forward 2L + 1 a forward (decode, verify and chunk steps,
    one-shot prefills), width-1 attention L a plain decode step, width >
    1 attention L a verify or chunk step, sampling one a decode or verify
    step and one a prefill (the one-shot prefill's, or the sampling head
    after a chunked prefill)."""
    oneshot = 0 if chunked else stats["prefills"]
    return {"layer_norm_fwd": (2 * L + 1) * (stats["decode_steps"] + stats["chunk_steps"]
                                             + oneshot),
            "paged_decode_attention": L * (stats["decode_steps"] - stats["spec_steps"]),
            "paged_decode_attention_wide": L * (stats["spec_steps"] + stats["chunk_steps"]),
            "fused_sample": stats["decode_steps"] + stats["prefills"],
            "layer_norm_bwd": 0, "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
            "ce_fwd": 0, "ce_dx": 0, "ce_dembed": 0, "mt_adam": 0, "mt_scale": 0,
            "mt_l2norm": 0}


def serve_run(argv, eager=False):
    """``serve_gpt.run`` on ``argv``, compiled (every step a CUDA graph)
    or with ``eager`` its ``--eager`` twin: every request served in full,
    the launch counts exactly :func:`serve_expect`'s, ``graphs`` as
    asked.  Returns ``(report, scheduler, params, config)``."""
    from apex_tpu_torch import serve_gpt

    args = serve_gpt.build_args().parse_args(argv + (["--eager"] if eager else []))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, sched, params, config = serve_gpt.run(args)
    counts = launch_counts()
    expect = serve_expect(sched.stats, config.num_layers, args.prefill_chunk is not None)
    if out["requests"] != args.requests or any(
            len(c.tokens) != args.max_new for c in sched.completed):
        raise AssertionError(f"{argv}: served {out['requests']}/{args.requests} requests")
    if counts != expect:
        raise AssertionError(f"{argv} eager={eager}: launch counts {counts} != "
                             f"expected {expect}")
    if out["graphs"] is eager:
        raise AssertionError(f"{argv} eager={eager}: the report says graphs={out['graphs']}")
    out.update(launches=counts, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out, sched, params, config


def streams(sched):
    return {c.rid: c.tokens for c in sched.completed}


#: the numbers of a serve cell printed graphed beside eager
SERVE_AB_KEYS = ("tokens_per_sec", "ttft_p50_ms", "ttft_p99_ms", "per_token_p50_ms",
                 "per_token_p99_ms", "wall_secs", "capture_ms", "peak_memory_gb", "lanes",
                 "accepted_tokens_per_step")


def serve_ab(phase, argv):
    """A serve cell compiled, then eager in the same call: each run's
    line, then both side by side; the two streams must be equal token for
    token (the same seeds)."""
    g = serve_run(argv)
    e = serve_run(argv, eager=True)
    emit({"phase": phase, "argv": argv, **g[0]})
    emit({"phase": f"{phase}_eager", "argv": argv, **e[0]})
    same = streams(g[1]) == streams(e[1])
    emit({"phase": "graphs_ab", "cell": phase, "argv": argv, "streams_equal": same,
          "graphed": {k: g[0][k] for k in SERVE_AB_KEYS if k in g[0]},
          "eager": {k: e[0][k] for k in SERVE_AB_KEYS if k in e[0]}})
    if not same:
        raise AssertionError(f"{phase}: the graphed and eager streams differ")
    return g


def serve_phase():
    """``serve_gpt`` at its defaults, graphed and eager (``--eager``):
    every request served, exact launch counts, equal streams."""
    out, sched, params, config = serve_ab("serve", [])
    return out["launches"], sched, params, config


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


def profile_phase(params, config, steps=10, eager=False):
    """Busy share and kernel time by name over ``steps`` decode steps of
    the bf16 engine with all 8 slots active, graphed or ``eager``; the
    host dispatch is the time in the scheduler's step calls (uploads or
    copies into the graph's buffers, then the launches or the replay),
    the rest of a step is the scheduler's own host work and the
    readback."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch import serve_gpt
    from apex_tpu_torch.inference import ContinuousBatchingScheduler, Request

    args = serve_gpt.build_args().parse_args([])
    _, _, dcfg = serve_gpt.setup(args)
    sched = ContinuousBatchingScheduler(params, config, dcfg,
                                        graphs=False if eager else None)
    rng = np.random.RandomState(1)
    for rid in range(args.streams):
        plen = min(32, args.prompt_len)
        sched.submit(Request(rid=rid, prompt=rng.randint(0, args.vocab, plen).tolist(),
                             max_new_tokens=args.max_new))
    for _ in range(3):
        sched.step()
    dispatch = [0.0]
    call = sched._call

    def timed(*args):
        t = time.monotonic()
        out = call(*args)
        dispatch[0] += time.monotonic() - t
        return out

    sched._call = timed
    # the same steps unprofiled first: the profiler slows the host
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        sched.step()
    torch.cuda.synchronize()
    plain_wall, plain_dispatch = time.monotonic() - t0, dispatch[0]
    dispatch[0] = 0.0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    by_name = device_us_by_name(prof)
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "profile", "graphs": not eager, "decode_steps": steps,
          "active": sched.num_active, "kernels_seen": len(by_name),
          "step_ms": 1e3 * wall / steps, "host_dispatch_ms": 1e3 * dispatch[0] / steps,
          "device_busy_ms_per_step": busy_ms / steps,
          "idle_share": 1 - busy_ms / (1e3 * wall),
          "unprofiled_step_ms": 1e3 * plain_wall / steps,
          "unprofiled_host_dispatch_ms": 1e3 * plain_dispatch / steps,
          "idle_share_unprofiled": 1 - busy_ms / (1e3 * plain_wall),
          "top_kernels_us_per_step": [[n[:90], us / steps] for n, us in top]})


# ----------------------------------------------------------------- serve v2
#: the serving-v2 command of examples/gpt/serve_gpt.py:13-16
SERVE_V2_ARGS = ["--draft-len", "4", "--prefix-sharing", "--system-prompt-len", "128",
                 "--prefill-chunk", "64", "--best-effort-frac", "0.5"]


def serve_v2_phase():
    """``serve_gpt.run`` at the serving-v2 command, the rest at the serve
    defaults, graphed and eager: every request served in full, only
    verify and chunk steps, exact launch counts (N = verify + chunk
    steps: LN forward 25 N, width > 1 attention 12 N, width-1 attention
    0, sampling verify steps + prefills), equal streams."""
    out, sched, params, config = serve_ab("serve_v2", SERVE_V2_ARGS)
    st = sched.stats
    if st["decode_steps"] != st["spec_steps"]:
        raise AssertionError(f"serve_v2 took other steps than verify and chunk steps: {st}")
    return out["launches"], params, config


def serve_streams_phase():
    """Graphed against eager, token for token, at the serve and the
    serving-v2 commands in bf16 and fp32 (compute and KV), T = 0 and
    T = 1, each with exact launch counts (bf16 at T = 1 are the serve
    and serve_v2 phases' own A/B)."""
    t0 = time.monotonic()
    cases = {}
    for cell, base in (("serve", []), ("serve_v2", SERVE_V2_ARGS)):
        for dtype in ("bfloat16", "float32"):
            for T in ("0", "1"):
                if (dtype, T) == ("bfloat16", "1"):
                    continue
                argv = base + ["--compute-dtype", dtype, "--kv-dtype", dtype,
                               "--temperature", T]
                g, e = serve_run(argv), serve_run(argv, eager=True)
                cases[f"{cell}_{dtype}_T{T}"] = {
                    "streams_equal": streams(g[1]) == streams(e[1]),
                    "tokens": g[0]["generated_tokens"],
                    "tokens_per_sec": {"graphed": g[0]["tokens_per_sec"],
                                       "eager": e[0]["tokens_per_sec"]}}
                del g, e
    emit({"phase": "serve_streams", "cases": cases, "seconds": time.monotonic() - t0})
    bad = [k for k, v in cases.items() if not v["streams_equal"]]
    if bad:
        raise AssertionError(f"serve_streams: graphed and eager streams differ in {bad}")


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


def serve_v2_profile_phase(params, config, eager=False):
    """Busy share and kernel time by name over one verify step (8 slots
    decoding, W = 5) and one prefill chunk (64 positions at 128..191) of
    the bf16 serving-v2 engine, graphed or ``eager``."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch import serve_gpt
    from apex_tpu_torch.inference import ContinuousBatchingScheduler, Request

    args = serve_gpt.build_args().parse_args(SERVE_V2_ARGS)
    _, _, dcfg = serve_gpt.setup(args)
    sched = ContinuousBatchingScheduler(params, config, dcfg,
                                        graphs=False if eager else None)
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
        walls, hosts = [], []
        for _ in range(10):  # unprofiled: the profiler slows the host
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fn()
            hosts.append(time.monotonic() - t0)
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            fn()
            host = time.monotonic() - t0
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        by_name = device_us_by_name(prof)
        busy_ms = sum(by_name.values()) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        emit({"phase": "serve_v2_profile", "graphs": not eager, "step": name,
              "rows": B * W if name == "verify" else C, "kernels_seen": len(by_name),
              "step_ms": 1e3 * wall, "host_dispatch_ms": 1e3 * host,
              "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / (1e3 * wall),
              "unprofiled_step_ms": 1e3 * float(np.median(walls)),
              "unprofiled_host_dispatch_ms": 1e3 * float(np.median(hosts)),
              "idle_share_unprofiled": 1 - busy_ms / (1e3 * float(np.median(walls))),
              "top_kernels_us": [[n[:90], us] for n, us in top]})


def _step_inputs(rng, kind, config, dcfg):
    """Random inputs of one serving step at ``dcfg``'s shapes, the
    arguments after its params and pools: numpy arrays and ints."""
    c = dcfg.cache
    B, cap, V = dcfg.max_batch, c.pages_per_seq * c.page_size, config.vocab_size
    tables = (rng.permutation(np.arange(1, c.num_pages))[:B * c.pages_per_seq]
              .reshape(B, c.pages_per_seq).astype(np.int32))

    def seeds(*shape):
        return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.int64)

    if kind == "decode":
        return [rng.randint(0, V, B), rng.randint(0, cap, B), rng.rand(B) < 0.9, tables,
                seeds(B)]
    if kind == "verify":
        W = dcfg.draft_len + 1
        return [rng.randint(0, V, (B, W)), rng.randint(0, cap - W + 1, B), rng.rand(B) < 0.9,
                tables, seeds(B, W)]
    if kind == "prefill":
        S = dcfg.max_prompt_len
        plen = int(rng.randint(1, S + 1))
        prompt = np.zeros((1, S), np.int64)
        prompt[0, :plen] = rng.randint(0, V, plen)
        return [prompt, plen, int(rng.randint(0, plen)), tables[0], seeds(1)]
    if kind == "chunk":
        C = dcfg.prefill_chunk
        start, valid = int(rng.randint(0, cap - C + 1)), int(rng.randint(1, C + 1))
        return [rng.randint(0, V, C), start, valid, start + int(rng.randint(0, valid)),
                tables[0]]
    return [rng.standard_normal(config.hidden_size).astype(np.float32), seeds(1)]  # head


def graph_replay_phase():
    """Each serving step compiled (an eager warm-up, then a CUDA graph)
    beside the same step eager, each on its own pools, over three sets
    of random inputs in turn at the serve (decode, prefill) and
    serving-v2 (verify, chunk, head) shapes, bf16: every output and the
    pools (the garbage page aside: its duplicate writes land in no fixed
    order) bitwise equal, and each call's launch counts equal.  A static
    buffer that the capture missed keeps the first inputs' result, and a
    replay that is not counted shows in the counts."""
    from apex_tpu_torch import serve_gpt
    from apex_tpu_torch.graphs import tensor_leaves
    from apex_tpu_torch.inference import (
        alloc_pools, make_decode_step, make_prefill, make_prefill_chunk, make_sample_head,
        make_verify_step,
    )

    builders = {"decode": make_decode_step, "prefill": make_prefill,
                "verify": make_verify_step, "chunk": make_prefill_chunk,
                "head": make_sample_head}
    t0 = time.monotonic()
    rng = np.random.RandomState(7)
    results = {}
    for argv, kinds in (([], ("decode", "prefill")),
                        (SERVE_V2_ARGS, ("verify", "chunk", "head"))):
        args = serve_gpt.build_args().parse_args(argv)
        config, params, dcfg = serve_gpt.setup(args)
        dev = params["embed"].device
        for kind in kinds:
            steps = (builders[kind](config, dcfg), builders[kind](config, dcfg, graphs=False))
            pools = [alloc_pools(config.num_layers, config.kv_heads, config.head_dim,
                                 dcfg.cache, device=dev) for _ in steps]
            equal, counts_equal = [], []
            for _ in range(3):
                inputs = _step_inputs(rng, kind, config, dcfg)
                outs, counts = [], []
                for step, pool, where in zip(steps, pools, ("pinned", dev)):
                    args_in = []
                    for a in inputs:
                        if isinstance(a, np.ndarray):
                            a = torch.from_numpy(a)
                            if a.is_floating_point():
                                a = a.to(config.compute_dtype)
                            a = a.pin_memory() if where == "pinned" else a.to(where)
                        args_in.append(a)
                    reset_counts()
                    res = (step(params, *args_in) if kind == "head"
                           else step(params, pool, *args_in)[1])
                    outs.append([t.clone() for t in tensor_leaves(res)])
                    counts.append(launch_counts())
                equal.append(all(torch.equal(a, b) for a, b in zip(*outs, strict=True))
                             and all(torch.equal(pools[0][n][:, 1:], pools[1][n][:, 1:])
                                     for n in ("k", "v")))
                counts_equal.append(counts[0] == counts[1])
            results[kind] = {"captured": steps[0].graph is not None, "calls": steps[0].calls,
                             "outputs_and_pools_bitwise_equal": equal,
                             "launch_counts_equal": counts_equal}
            del steps, pools
    emit({"phase": "graph_replay", "compute_dtype": "bfloat16", "steps": results,
          "seconds": time.monotonic() - t0})
    bad = [k for k, r in results.items() if not (
        r["captured"] and all(r["outputs_and_pools_bitwise_equal"])
        and all(r["launch_counts_equal"]))]
    if bad:
        raise AssertionError(f"graph_replay: a replay is not the eager step in {bad}")


# -------------------------------------------------------------------- train
#: the fused-CE step's warm-up loss against the dense step's (same
#: params and batch): the bf16-dot rounding of the head, relative
FCE_LOSS_TOL = 1e-5


#: graphed against eager train losses, relative, if they are not
#: bitwise equal: the fp32 band of the train parity's loss
TRAIN_AB_TOL = 1e-5


def train_phase(fused=False, dense_report=None, eager=False, per_leaf=False, fp16=False):
    """bench.py's GPT-124M step through ``train_gpt.run`` at its defaults:
    the dense head (``gpt124_s1024``) or, with ``fused``, ``--fused-ce``
    (``gpt124_s1024_fce``), whose warm-up loss is held against the dense
    step's ``dense_report``; compiled (one CUDA graph a step, replayed
    after the warm-up) or with ``eager`` its ``--eager`` twin.  FusedAdam
    runs on the engine (one ``mt_adam`` call a step, ``mt_plan``'s
    launches) or, with ``per_leaf``, on its per-leaf path
    (``use_buckets=False``: no ``mt_adam`` launch).  With ``fp16``,
    ``--fp16`` (``pretrain_gpt.py --fp16``'s single-device step: fp16
    compute, the fp16 LayerNorm and flash kernels, the 2**12 loss scale,
    ``update_scaled``'s ``mt_scale`` pass a step), its numbers beside the
    bf16 step's ``dense_report``: every step finite at the scale 2**12."""
    from apex_tpu_torch import train_gpt
    from apex_tpu_torch.ops.multi_tensor import mt_plan
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.tree import tree_leaves

    argv = ((["--fused-ce"] if fused else []) + (["--eager"] if eager else [])
            + (["--fp16"] if fp16 else []))
    args = train_gpt.build_args().parse_args(argv)
    opt = (FusedAdam(lr=args.lr, weight_decay=train_gpt.WEIGHT_DECAY, use_buckets=False)
           if per_leaf else None)
    reset_counts()
    t0 = time.monotonic()
    report, params, state = train_gpt.run(args, opt=opt)
    counts = launch_counts()
    sizes = [p.numel() for p in tree_leaves(params)]
    del params, state
    n, L = args.warmup + args.steps, args.layers
    per_step = {"layer_norm_fwd": 4 * L + 1, "layer_norm_bwd": 2 * L + 1,
                "flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
                "ce_fwd": int(fused), "ce_dx": int(fused), "ce_dembed": int(fused),
                "mt_adam": 0 if per_leaf else mt_plan("adam", sizes).launches,
                "mt_scale": mt_plan("scale", sizes).launches if fp16 else 0,
                "mt_l2norm": 0}
    expect = {**{k: v * n for k, v in per_step.items()},
              "paged_decode_attention": 0, "paged_decode_attention_wide": 0,
              "fused_sample": 0}
    losses = report["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: {losses}")
    if counts != expect:
        raise AssertionError(f"train launch counts {counts} != expected {expect}")
    if report["graphs"] is eager:
        raise AssertionError(f"train eager={eager}: the report says graphs={report['graphs']}")
    extra = {}
    if fp16:
        if report["loss_scale"] != [train_gpt.FP16_INIT_SCALE] * n or report["skipped_steps"]:
            raise AssertionError(f"train_fp16: scales {report['loss_scale']}, skipped "
                                 f"{report['skipped_steps']}: every step must be finite "
                                 f"at 2**12")
        extra = {k: {"bf16": dense_report[m], "fp16": report[m]} for k, m in (
            ("ab_step_ms_median", "step_ms_median"), ("ab_tokens_per_sec", "tokens_per_sec"),
            ("ab_peak_memory_gb", "peak_memory_gb"))}
    if fused:
        dense = dense_report["losses"][0]
        rel = abs(losses[0] - dense) / abs(dense)
        if not rel <= FCE_LOSS_TOL:
            raise AssertionError(f"fused-CE warm-up loss {losses[0]} vs dense {dense}: "
                                 f"rel {rel} > {FCE_LOSS_TOL}")
        # bench.py's A/B on this card: the dense step (the train phase)
        # beside this one, in the same mode
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
    emit({"phase": ("train_fce" if fused else "train") + ("_fp16" if fp16 else "")
          + ("_eager" if eager else "") + ("_per_leaf" if per_leaf else ""),
          **report, "steps_counted": n, "launches_per_step": per_step, "launches": counts,
          **extra, "seconds": time.monotonic() - t0})
    return args, counts, report


#: the amp_overflow phase's scaler: 2**127 overflows the first step's
#: fp16 backward, and one backoff to 2**12, the trainer's scale, makes the
#: next steps finite (2**127 times 2**-4, the flagship test's backoff,
#: would overflow the fp16 backward again for some 28 steps)
OVERFLOW_SCALER = {"init_scale": 2.0 ** 127, "backoff_factor": 2.0 ** -115}


def amp_overflow_phase():
    """``train_gpt --fp16 --step-guard 3`` at GPT-124M, the step compiled,
    with the scaler at 2**127: the first step (the eager warm-up that
    captures) overflows in the fp16 backward and must leave every param
    and the whole optimizer state bitwise as they were, the Adam counter
    included, and back the scale off; the next two (graph replays) are
    finite.  The guard goes consecutive_bad 1 -> 0, total_skipped 1, and
    its host-side check passes."""
    from apex_tpu_torch import train_gpt
    from apex_tpu_torch.amp import DynamicLossScaler
    from apex_tpu_torch.graphs import tensor_leaves
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.resilience import StepGuard

    t0 = time.monotonic()
    args = train_gpt.build_args().parse_args(["--fp16", "--step-guard", "3"])
    config, params, tokens, targets = train_gpt.setup(args)
    opt = FusedAdam(lr=args.lr, weight_decay=train_gpt.WEIGHT_DECAY)
    scaler, guard = DynamicLossScaler(**OVERFLOW_SCALER), StepGuard(args.step_guard)
    state, sstate, gstate = opt.init(params), scaler.init(), guard.init()
    for leaf in tensor_leaves(params):
        leaf.requires_grad_(True)
    step = train_gpt.make_train_step(opt, config, loss_scaler=scaler, step_guard=guard)
    # detached: a clone recorded by autograd would keep the leaves' grad
    # accumulators on this stream alive and break the capture
    before = [t.detach().clone() for t in tensor_leaves((params, state))]
    rows = []
    for i in range(3):
        loss = float(step(params, state, sstate, gstate, tokens, targets))
        torch.cuda.synchronize()
        rows.append({"loss": loss, "loss_scale": float(sstate.loss_scale),
                     "adam_step": int(state.step), **guard.state_dict(gstate)})
        if i == 0:
            unchanged = all(torch.equal(a, b) for a, b in zip(
                tensor_leaves((params, state)), before, strict=True))
    del before
    guard.check(gstate)
    want_scales = [2.0 ** 12] * 3
    ok = (unchanged and [r["loss_scale"] for r in rows] == want_scales
          and [r["adam_step"] for r in rows] == [0, 1, 2]
          and [r["consecutive_bad"] for r in rows] == [1, 0, 0]
          and rows[-1]["total_skipped"] == 1 and rows[-1]["step"] == 3
          and all(math.isfinite(r["loss"]) for r in rows[1:]) and step.graph is not None)
    emit({"phase": "amp_overflow", "scaler": OVERFLOW_SCALER, "guard_budget": 3,
          "skipped_step_params_and_state_bitwise_unchanged": unchanged, "steps": rows,
          "graphs": step.graph is not None, "seconds": time.monotonic() - t0})
    if not ok:
        raise AssertionError(f"amp_overflow: unchanged={unchanged}, steps {rows}")


#: fp16 train parity bands (relative): the warm-up loss (the forward and
#: the loss only: the kernels round p and the matmuls round their
#: outputs to fp16, 2**-11 each, where the CPU's plain versions keep
#: fp32) and the losses after Adam steps (which carry the gradients'
#: fp16 roundings, ds and p rounded in the kernels, into the params)
TRAIN_FP16_PARITY_TOL = {"warmup_loss": 2e-3, "losses": 1e-2}


def train_fp16_parity_phase():
    """``train_gpt --fp16`` at a small size (2 layers, hidden 256, 4
    heads, vocab 512, seq 128, batch 2; 1 warm-up and 3 steps) on the
    card (the fp16 kernels, compiled) against the CPU (the plain
    versions), from the same numpy params: losses in the bands of
    :data:`TRAIN_FP16_PARITY_TOL`, the scales and skipped steps equal."""
    from apex_tpu_torch import train_gpt

    t0 = time.monotonic()
    base = ["--fp16", "--layers", "2", "--hidden", "256", "--heads", "4", "--vocab", "512",
            "--seq", "128", "--batch", "2", "--steps", "3"]
    out = {dev: train_gpt.run(train_gpt.build_args().parse_args(base + ["--device", dev]))[0]
           for dev in ("cuda", "cpu")}
    card, cpu = out["cuda"], out["cpu"]
    rel = [abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"], strict=True)]
    emit({"phase": "train_parity_fp16", "argv": base, "losses_cuda": card["losses"],
          "losses_cpu": cpu["losses"], "loss_rel_err": rel,
          "loss_scale_cuda": card["loss_scale"], "loss_scale_cpu": cpu["loss_scale"],
          "skipped_steps": [card["skipped_steps"], cpu["skipped_steps"]],
          "graphs": card["graphs"], "tolerance": TRAIN_FP16_PARITY_TOL,
          "seconds": time.monotonic() - t0})
    if (rel[0] > TRAIN_FP16_PARITY_TOL["warmup_loss"]
            or max(rel) > TRAIN_FP16_PARITY_TOL["losses"]
            or card["loss_scale"] != cpu["loss_scale"]
            or card["skipped_steps"] != cpu["skipped_steps"] or not card["graphs"]):
        raise AssertionError(f"train_parity_fp16: losses {card['losses']} vs "
                             f"{cpu['losses']} (rel {rel}), scales {card['loss_scale']} "
                             f"vs {cpu['loss_scale']}")


def _train_summary(report):
    ms = report["step_ms"]
    return {"step_ms_median": report["step_ms_median"], "step_ms_min": min(ms),
            "step_ms_max": max(ms), "tokens_per_sec": report["tokens_per_sec"],
            "capture_ms": report["capture_ms"], "peak_memory_gb": report["peak_memory_gb"]}


def train_ab(cell, graphed, eager):
    """The graphed and eager runs of one train cell side by side: their
    losses bitwise equal, or failing that within ``TRAIN_AB_TOL``
    (cuBLAS may pick another algorithm under capture); which held is
    printed."""
    gl, el = graphed["losses"], eager["losses"]
    if graphed.get("loss_scale") != eager.get("loss_scale"):
        raise AssertionError(f"{cell}: graphed scales {graphed['loss_scale']} != eager "
                             f"{eager['loss_scale']}")
    bitwise = gl == el
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, el, strict=True))
    emit({"phase": "graphs_ab", "cell": cell, "losses_bitwise_equal": bitwise,
          "losses_max_rel_err": rel, "held": "bitwise" if bitwise else f"band {TRAIN_AB_TOL}",
          "graphed": _train_summary(graphed), "eager": _train_summary(eager)})
    if not bitwise and not rel <= TRAIN_AB_TOL:
        raise AssertionError(f"{cell}: graphed losses {gl} vs eager {el}: rel {rel}")


def optimizer_ab(cell, engine, per_leaf):
    """The train cell with FusedAdam on the engine beside the same cell on
    its per-leaf path, both graphed: the losses must be bitwise equal
    (the update is the same fp32 expression), the medians side by side."""
    bitwise = engine["losses"] == per_leaf["losses"]
    emit({"phase": "optimizer_ab", "cell": cell, "losses_bitwise_equal": bitwise,
          "engine": _train_summary(engine), "per_leaf": _train_summary(per_leaf),
          "step_ms_saved": per_leaf["step_ms_median"] - engine["step_ms_median"]})
    if not bitwise:
        raise AssertionError(f"{cell}: engine losses {engine['losses']} != per-leaf "
                             f"{per_leaf['losses']}")


def train_reproducible_phase(dev, B=8, H=12, S=1024, D=64):
    """Two backward passes of one flash layer (bf16, causal) must give
    bitwise equal dq, dk, dv; two calls each of the CE forward, dx and
    dembed kernels at GPT-124M (bf16 x, fp32 embed) bitwise equal m, l,
    tgt, dx and dembed; two LayerNorm backward calls at the train step's
    rows (8192 x 768 bf16, affine with bias) bitwise equal dx, dw and db;
    and two sampling-head calls at 40 rows (T = 1) equal tokens: no
    atomics in the kernels, sums and merges in a fixed order.  Then the
    same calls captured as CUDA graphs: two replays after the eager
    warm-up, each bitwise equal to the eager calls."""
    from apex_tpu_torch.graphs import CapturedStep
    from apex_tpu_torch.ops import fused_ce_kernels as K
    from apex_tpu_torch.ops.attention import flash_attention
    from apex_tpu_torch.ops.decode_sampling import fused_sample
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
    fwd = K.ce_fwd(x, e, t)
    m, l, _ = fwd
    lse = m + torch.log(l)
    dx, de = K.ce_dx(x, e, t, lse, g), K.ce_dembed(x, e, t, lse, g)
    ce_same = {**{k: bool(torch.equal(a, b)) for k, a, b in zip(("m", "l", "tgt"), fwd,
                                                               K.ce_fwd(x, e, t))},
               "dx": bool(torch.equal(dx, K.ce_dx(x, e, t, lse, g))),
               "dembed": bool(torch.equal(de, K.ce_dembed(x, e, t, lse, g)))}
    # the sampling head at the verify step's 40 rows, T = 1, on the same embed
    xs = torch.from_numpy(rng.standard_normal((40, Hd), dtype=np.float32)).to(dev, torch.bfloat16)
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, size=40, dtype=np.uint64)
                             .astype(np.int64)).to(dev)
    tokens = fused_sample(xs, e, seeds, 1.0, 0)
    sample_same = bool(torch.equal(tokens, fused_sample(xs, e, seeds, 1.0, 0)))
    xl = _ln_rows(rng, dev, N, Hd, torch.bfloat16, False, scale=2.0, shift=0.5)
    dyl = _ln_rows(rng, dev, N, Hd, torch.bfloat16, False)
    wl, bl = _ln_params(rng, dev, Hd, "ln_affine")
    _, mean, rstd = layer_norm_fwd_plain(xl, wl, bl, 1e-5)
    first_ln = layer_norm_bwd(xl, wl, dyl, mean, rstd)
    second_ln = layer_norm_bwd(xl, wl, dyl, mean, rstd)
    ln_same = {k: bool(torch.equal(a, b)) for k, a, b in zip(("dx", "dw", "db"), first_ln,
                                                            second_ln)}
    # the optimizer kernels at the train step's 20 GPT-124M leaves
    from apex_tpu_torch.ops import multi_tensor as mt

    ga, pa, ma, va, out1, out2 = _adam_operands(dev, _case_shapes("gpt124"), 7)
    akw = dict(lr=3e-4, wd=[0.1] * len(ga), bc1=torch.tensor(0.19, device=dev),
               bc2=torch.tensor(0.002997, device=dev), beta1=0.9, beta2=0.999, eps=1e-8,
               adam_w_mode=True)
    mt.mt_adam(ga, pa, ma, va, *out1, **akw)
    mt.mt_adam(ga, pa, ma, va, *out2, **akw)
    n1, q1 = mt.mt_l2norm(ga)
    n2, q2 = mt.mt_l2norm(ga)
    mt_same = {"mt_adam": all(torch.equal(a, b) for x, y in zip(out1[:3], out2[:3])
                              for a, b in zip(x, y)),
               "mt_l2norm": bool(torch.equal(n1, n2)) and bool(torch.equal(q1, q2))}
    del ga, pa, ma, va, out1, out2

    def flash_grads(q, k, v, do):
        q, k, v = (a.detach().requires_grad_() for a in (q, k, v))
        return torch.autograd.grad(flash_attention(q, k, v, causal=True), (q, k, v), do)

    def kernels(x, e, t, lse, g, xs, seeds, xl, wl, dyl, mean, rstd):
        return (*K.ce_fwd(x, e, t), K.ce_dx(x, e, t, lse, g), K.ce_dembed(x, e, t, lse, g),
                fused_sample(xs, e, seeds, 1.0, 0), *layer_norm_bwd(xl, wl, dyl, mean, rstd))

    graphed = {}
    for name, fn, inputs, eager in (
            ("flash", flash_grads, (q, k, v, do), first),
            ("ce_sampling_ln", kernels, (x, e, t, lse, g, xs, seeds, xl, wl, dyl, mean, rstd),
             (*fwd, dx, de, tokens, *first_ln))):
        step = CapturedStep(fn)
        step(*inputs)  # eager on a side stream, then the capture
        replays = [[o.clone() for o in step(*inputs)] for _ in range(2)]
        graphed[name] = step.graph is not None and all(
            torch.equal(a, b) for r in replays for a, b in zip(r, eager, strict=True))
    if (not all(same) or not all(ce_same.values()) or not all(ln_same.values())
            or not sample_same or not all(graphed.values()) or not all(mt_same.values())):
        raise AssertionError(f"not bitwise reproducible: flash {same}, CE {ce_same}, "
                             f"LayerNorm {ln_same}, sampling {sample_same}, "
                             f"graph replays {graphed}, optimizer kernels {mt_same}")
    emit({"phase": "train_reproducible", "B": B, "H": H, "S": S, "D": D,
          "dtype": "bfloat16", "dq_dk_dv_bitwise_equal": same,
          "ce": {"N": N, "H": Hd, "V": V, "x_dtype": "bfloat16", "embed_dtype": "float32",
                 "bitwise_equal": ce_same},
          "layer_norm_bwd": {"R": N, "H": Hd, "dtype": "bfloat16", "mode": "ln_affine",
                             "bitwise_equal": ln_same},
          "fused_sample": {"N": 40, "H": Hd, "V": V, "temperature": 1.0,
                           "x_dtype": "bfloat16", "bitwise_equal": sample_same},
          "optimizer_kernels": {"leaves": "GPT-124M's 20", "bitwise_equal": mt_same},
          "graph_replays_bitwise_equal_eager": graphed})


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
    kernels) against the CPU (the plain versions), same numpy params.
    On the card they come from a CUDA graph of ``loss_and_grads``
    replayed on this batch after its eager warm-up on another one, and
    must also equal an eager call on this batch: bitwise, or failing
    that within the same bands (which held is printed)."""
    from apex_tpu_torch import train_gpt
    from apex_tpu_torch.graphs import CapturedStep
    from apex_tpu_torch.optimizers.base import tree_leaves

    t0 = time.monotonic()
    base = ["--layers", "2", "--seq", "256", "--batch", "2", "--compute-dtype", "float32"]
    out = {}
    for device in ("cuda", "cpu"):
        args = train_gpt.build_args().parse_args(base + ["--device", device])
        config, params, tokens, targets = train_gpt.setup(args)
        if device == "cuda":
            step = CapturedStep(
                lambda p, x, y: train_gpt.loss_and_grads(p, x, y, config), donate=(0,))
            step(params, torch.roll(tokens, 1, 1), torch.roll(targets, 1, 1))
            loss, grads = step(params, tokens, targets)
            graphed = (float(loss), [g.clone() for g in tree_leaves(grads)])
            loss, grads = train_gpt.loss_and_grads(params, tokens, targets, config)
            eager = (float(loss), tree_leaves(grads))
            replay_bitwise = graphed[0] == eager[0] and all(
                torch.equal(a, b) for a, b in zip(graphed[1], eager[1], strict=True))
            floor = 1e-4 * max(float(b.abs().max()) for b in eager[1])
            replay_err = {"loss": abs(graphed[0] - eager[0]) / abs(eager[0]),
                          "grads": max(float((a - b).abs().max())
                                       / max(float(b.abs().max()), floor)
                                       for a, b in zip(graphed[1], eager[1]))}
            loss, grads = graphed
        else:
            loss, grads = train_gpt.loss_and_grads(params, tokens, targets, config)
            loss, grads = float(loss), tree_leaves(grads)
        out[device] = (loss, [g.detach().cpu() for g in grads])
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
    if not replay_bitwise and any(replay_err[k] > TRAIN_PARITY_TOL[k] for k in replay_err):
        raise AssertionError(f"train parity: the graph replay is {replay_err} from eager")
    emit({"phase": "train_parity", "layers": 2, "hidden": 768, "heads": 12,
          "vocab": 50304, "seq": 256, "batch": 2, "compute_dtype": "float32",
          "graph_replay_bitwise_equal_eager": replay_bitwise,
          "graph_replay_rel_err_to_eager": replay_err,
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
    if "mt_adam" in name or "mt_scale" in name or "mt_l2norm" in name:
        return "optimizer_kernels"
    if "sgemm" in name or "f32f32" in name:
        return "gemm_fp32"
    if any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "gemm_other"
    return "other"


def optimizer_profile_phase(args):
    """FusedAdam's update alone on the train step's real grads, each path
    eager: its device ms a call (``device_ms``) and the device ms by
    kernel name over 5 profiled calls, for the engine (``mt_adam``) and
    the per-leaf path (its elementwise ops)."""
    from apex_tpu_torch import train_gpt
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.tree import tree_leaves

    config, params, tokens, targets = train_gpt.setup(args)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    _, grads = train_gpt.loss_and_grads(params, tokens, targets, config)
    out = {}
    for name, use_buckets in (("engine", True), ("per_leaf", False)):
        opt = FusedAdam(lr=args.lr, weight_decay=train_gpt.WEIGHT_DECAY,
                        use_buckets=use_buckets)
        state = opt.init(params)

        def update():
            opt.update(grads, state, params)

        ms, timer = device_ms(update, iters=5)
        by_name = {k: sum(v) / 5 for k, v in _cuda_durations(update, 5).items()}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[name] = {"device_ms": ms, "timer": timer, "kernels_seen": len(by_name),
                     "top_kernels_ms": [[n[:90], us / 1e3] for n, us in top]}
        del opt, state
    emit({"phase": "optimizer_profile", "head": "fused_ce" if args.fused_ce else "dense",
          "leaves": len(tree_leaves(params)),
          "params": sum(p.numel() for p in tree_leaves(params)), **out,
          "per_leaf_over_engine": out["per_leaf"]["device_ms"] / out["engine"]["device_ms"]})


def train_profile_phase(args, step_ms, eager=False, per_leaf=False):
    """Busy share and kernel time by name over one training step, a
    graph replay or with ``eager`` an eager step; with ``per_leaf``
    FusedAdam on its per-leaf path.  The profiler slows the host side of
    the step, so the idle share is also given against ``step_ms``, the
    train phase's unprofiled median in the same mode."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch import train_gpt
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.base import tree_leaves

    config, params, tokens, targets = train_gpt.setup(args)
    opt = FusedAdam(lr=args.lr, weight_decay=train_gpt.WEIGHT_DECAY, use_buckets=not per_leaf)
    state = opt.init(params)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    step = train_gpt.make_train_step(opt, config, graphs=False if eager else None)
    step(params, state, tokens, targets)  # the warm-up (and the capture)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(params, state, tokens, targets)
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
          "optimizer": "per_leaf" if per_leaf else "engine", "graphs": not eager, "kernels_seen": len(by_name), "step_ms": 1e3 * wall,
          "host_dispatch_ms": 1e3 * host, "device_busy_ms": busy_ms,
          "device_ms_by_kind": by_kind, "flash_launches_seen": flash_seen,
          "idle_share": 1 - busy_ms / (1e3 * wall),
          "idle_share_of_unprofiled_step": 1 - busy_ms / step_ms,
          "top_kernels_ms": [[n[:90], us / 1e3] for n, us in top]})


# ----------------------------------------------------------------- pretrain
#: the pretrain phase's model: the train phase's GPT-124M width, seq
#: 1024, global batch 8, bf16, the fused CE head, graphed
PRETRAIN_ARGV = ["--layers", "12", "--hidden", "768", "--heads", "12", "--vocab", "50304",
                 "--seq", "1024", "--global-batch", "8", "--fused-ce"]
#: tokens of the phase's uint16 corpus (about 1M, from the seed)
PRETRAIN_TOKENS = 1 << 20


def _pretrain_proc(argv, sigterm_after=None, timeout=300):
    """``python -m apex_tpu_torch.pretrain_gpt`` in a child process on
    this card; with ``sigterm_after`` the child gets SIGTERM once it has
    printed that step's loss line.  Returns ``(returncode, stdout lines,
    the JSON report)``."""
    import signal

    import queue
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-m", "apex_tpu_torch.pretrain_gpt", *argv], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # a reader thread, so that a child that prints nothing still meets the
    # deadline
    got = queue.Queue()
    threading.Thread(target=lambda: ([got.put(ln) for ln in proc.stdout], got.put(None)),
                     daemon=True).start()
    lines, deadline = [], time.monotonic() + timeout
    try:
        while True:
            try:
                line = got.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"pretrain_gpt {argv} ran past {timeout} s:\n"
                                   + "\n".join(lines[-40:])) from None
            if line is None:
                break
            lines.append(line.rstrip("\n"))
            if sigterm_after is not None and line.startswith(f"step {sigterm_after}:"):
                proc.send_signal(signal.SIGTERM)
                sigterm_after = None
        rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    report = next((json.loads(ln)["pretrain_gpt"] for ln in lines
                   if ln.startswith('{"pretrain_gpt"')), None)
    if rc != 0 or report is None:
        raise AssertionError(f"pretrain_gpt {argv} exited {rc}:\n" + "\n".join(lines[-40:]))
    return rc, lines, report


def _pretrain_here(argv, profiler=None):
    """``pretrain_gpt.run`` in this process (its lines kept out of this
    script's output) in a metrics scope of its own; with ``profiler`` (a
    ``torch.profiler.profile``) under it.  Returns the JSON report."""
    import gc
    import io as stdio

    from apex_tpu_torch import pretrain_gpt
    from apex_tpu_torch.observability.metrics import MetricsScope

    args = pretrain_gpt.build_args().parse_args(argv)
    with contextlib.redirect_stdout(stdio.StringIO()), MetricsScope(), \
            (profiler if profiler is not None else contextlib.nullcontext()):
        report = pretrain_gpt.run(args)
    gc.collect()  # the run's graph, params and state, before the next run
    torch.cuda.empty_cache()
    return report


def _bitwise(name, got, want):
    """``got``'s losses by step equal to ``want``'s wherever both ran."""
    g, w = dict(zip(got["steps"], got["losses"])), dict(zip(want["steps"], want["losses"]))
    common = sorted(set(g) & set(w))
    bad = [(s, g[s], w[s]) for s in common if g[s] != w[s]]
    if not common or bad:
        raise AssertionError(f"pretrain {name}: losses not bitwise equal to the full run's "
                             f"at steps {common}: {bad}")
    return common


def _busy_share(prof, kernel="mt_adam_kernel", skip=3):
    """The device's busy share over the steps after the ``skip``-th: the
    window from the end of that step's ``mt_adam`` (one launch a step, the
    update's) to the end of the last one, the union of every CUDA
    activity's intervals inside it over its length; and each activity's
    device ms a step in that window, by name (the first 100 characters),
    largest first."""
    from torch.autograd import DeviceType

    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    ends = sorted(end for _, end, name in spans if kernel in name)
    if len(ends) <= skip:
        raise AssertionError(f"pretrain profile: {len(ends)} {kernel} records, want more "
                             f"than {skip}")
    lo, hi = ends[skip - 1], ends[-1]
    busy, cur_lo, cur_hi = 0.0, None, None
    for s, e, _ in sorted((max(s, lo), min(e, hi), n) for s, e, n in spans if e > lo and s < hi):
        if cur_hi is None or s > cur_hi:
            busy += 0.0 if cur_hi is None else cur_hi - cur_lo
            cur_lo, cur_hi = s, e
        else:
            cur_hi = max(cur_hi, e)
    busy += 0.0 if cur_hi is None else cur_hi - cur_lo
    by_name = {}
    for s, e, n in spans:
        if e > lo and s < hi:
            by_name[n[:100]] = by_name.get(n[:100], 0.0) + min(e, hi) - max(s, lo)
    n_steps = len(ends) - skip
    return {"window_steps": n_steps, "window_ms": (hi - lo) / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / (hi - lo),
            "kernel_ms_per_step": {n: us / 1e3 / n_steps for n, us in
                                   sorted(by_name.items(), key=lambda kv: -kv[1])}}


def pretrain_phase(smi):
    """``apex_tpu_torch.pretrain_gpt`` at GPT-124M width on a uint16 token
    file of about 1M tokens written from the seed.  In this process: the
    full run (8 steps, checkpoints at 4 and 8, telemetry every 4, metrics
    and trace dirs) and the same run with telemetry and tracing off,
    bitwise equal (their step times side by side).  In child processes
    (``python -m``): a run resumed from step 4, bitwise equal at steps
    5-8; an --auto-resume run sent SIGTERM after its step 2 line, which
    must save at the step it reached, dump the flight recorder and exit
    0, and the same command again, both bitwise equal to the full run.
    The full run's files: 2 metrics windows whose loss_mean is the mean
    of their steps' losses, metrics.prom, goodput fractions summing to 1,
    the trace's spans with 8 dispatches, checkpoints that validate, at
    most max(keep, 3) of them.  Then, in this process, 7 steps with
    telemetry under the profiler: exact launch counts (the train_fce
    step's, plus the telemetry's three mt_l2norm calls a step) and the
    idle share over its last 4 steps.  Child processes pay torch's
    import and first-use costs again (about 25 s each on the card's
    host), so only what needs a process of its own runs in one."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch import io
    from apex_tpu_torch.ops.multi_tensor import mt_plan

    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="pretrain_"))
    try:
        data = work / "tokens.u16"
        vocab = int(PRETRAIN_ARGV[PRETRAIN_ARGV.index("--vocab") + 1])
        np.random.RandomState(0).randint(0, vocab, size=PRETRAIN_TOKENS).astype(
            np.uint16).tofile(data)
        # the watchdog ends a child whose step hangs (exit 75) instead of
        # this script waiting on it
        base = PRETRAIN_ARGV + ["--data", str(data), "--steps", "8", "--save-every", "4",
                                "--telemetry-every", "4", "--watchdog-secs", "120"]
        ck, m, tr = work / "ck", work / "metrics", work / "trace"
        full = _pretrain_here(base + ["--checkpoint", str(ck), "--metrics-dir", str(m),
                                      "--trace-dir", str(tr)])
        if full["steps"] != list(range(8)) or not all(map(math.isfinite, full["losses"])):
            raise AssertionError(f"pretrain full run: steps {full['steps']}, losses "
                                 f"{full['losses']}")
        # the full run's files
        kept = sorted(p.name for p in ck.glob("step_*.ckpt"))
        for p in ck.glob("step_*.ckpt"):
            io.validate_checkpoint(p)
        if kept != ["step_00000004.ckpt", "step_00000008.ckpt"]:
            raise AssertionError(f"pretrain checkpoints {kept}")
        lines = [json.loads(x) for x in (m / "metrics.jsonl").read_text().splitlines()]
        windows = {x["window_end_step"]: x["value"] for x in lines
                   if x["metric"] == "apex_train_loss"}
        window_err = {}
        for end, mean in windows.items():
            want = float(np.sum(np.float32(full["losses"][end - 4:end]), dtype=np.float32)) / 4
            window_err[end] = abs(mean - want) / abs(want)
        if sorted(windows) != [4, 8] or max(window_err.values()) > 1e-6:
            raise AssertionError(f"pretrain metrics windows {windows} against the printed "
                                 f"losses: relative errors {window_err}")
        if not (m / "metrics.prom").read_text().startswith("# "):
            raise AssertionError("pretrain metrics.prom is empty")
        goodput = json.loads((m / "goodput_report.json").read_text())
        if abs(sum(goodput["fractions"].values()) - 1.0) > 1e-6:
            raise AssertionError(f"pretrain goodput fractions {goodput['fractions']}")
        trace = json.loads(next(tr.glob("trace_gpt_*.json")).read_text())
        names = [e["name"] for e in trace["traceEvents"]]
        spans = {n: names.count(n) for n in (
            "train.data_wait", "train.step.dispatch", "train.telemetry_fetch",
            "train.checkpoint_save")}
        if spans["train.step.dispatch"] != 8 or not all(spans.values()):
            raise AssertionError(f"pretrain trace spans {spans}")
        # the resumed process
        _, out2, resumed = _pretrain_proc(PRETRAIN_ARGV + [
            "--data", str(data), "--resume", str(ck / "step_00000004.ckpt"), "--steps", "8"])
        if "resumed at step 4" not in out2:
            raise AssertionError("pretrain resume did not resume at step 4")
        resumed_steps = _bitwise("resume", resumed, full)
        shutil.rmtree(ck)
        # telemetry and tracing off
        quiet = _pretrain_here(base + ["--checkpoint", str(work / "ck_quiet")])
        quiet_steps = _bitwise("telemetry off", quiet, full)
        shutil.rmtree(work / "ck_quiet")
        # SIGTERM after the step 2 line, then the same command again
        # saves every 2 steps: each blocks the host until its step is done,
        # so the loop cannot run ahead of the notice to its end
        pre_argv = base + ["--save-every", "2", "--checkpoint", str(work / "ck_pre"),
                           "--auto-resume", "--metrics-dir", str(work / "m_pre")]
        _, out4, first = _pretrain_proc(pre_argv, sigterm_after=2)
        said = [ln for ln in out4 if ln.startswith("preempted (")]
        reached = first["start_step"] + first["steps_done"]
        saved = sorted(p.name for p in (work / "ck_pre").glob("step_*.ckpt"))
        dumps = [p.name for p in (work / "m_pre" / "flightrec").glob("flightrec_dump_*.json")]
        if not said or not first["preempted"] or f"step_{reached:08d}.ckpt" not in saved \
                or not dumps:
            raise AssertionError(f"pretrain preemption: said {said}, reached {reached}, "
                                 f"checkpoints {saved}, dumps {dumps}")
        _, out5, again = _pretrain_proc(pre_argv)
        if f"resumed at step {reached}" not in out5 or again["steps_done"] != 8:
            raise AssertionError(f"pretrain rerun after preemption: {out5[-5:]}")
        pre_steps = _bitwise("preempted", first, full) + _bitwise("rerun", again, full)
        if pre_steps != list(range(8)):
            raise AssertionError(f"pretrain preempted + rerun cover steps {pre_steps}")
        kept_pre = sorted(p.name for p in (work / "ck_pre").glob("step_*.ckpt"))
        if len(kept_pre) > 3:
            raise AssertionError(f"pretrain --keep 3 left {kept_pre}")
        shutil.rmtree(work / "ck_pre")

        # in this process: exact launch counts and the profiled idle share
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        reset_counts()
        profiled = _pretrain_here(PRETRAIN_ARGV + [
            "--data", str(data), "--steps", "7", "--telemetry-every", "4",
            "--metrics-dir", str(work / "m_prof")], profiler=prof)
        counts = launch_counts()
        prof_steps = _bitwise("profiled", profiled, full)
        sizes = [math.prod(shape) for shape in _leaf_shapes(gpt_param_shapes())]
        L = 12
        per_step = {"layer_norm_fwd": 4 * L + 1, "layer_norm_bwd": 2 * L + 1,
                    "flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
                    "ce_fwd": 1, "ce_dx": 1, "ce_dembed": 1,
                    "mt_adam": mt_plan("adam", sizes).launches, "mt_scale": 0,
                    # the grad norm, the param norm and the update norm
                    "mt_l2norm": 3 * mt_plan("l2norm", sizes).launches}
        expect = {**{k: 7 * v for k, v in per_step.items()},
                  "paged_decode_attention": 0, "paged_decode_attention_wide": 0,
                  "fused_sample": 0}
        if counts != expect:
            raise AssertionError(f"pretrain launch counts {counts} != expected {expect}")
        idle = _busy_share(prof)
        del prof
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def steady(rep):
        # every step after the first (warm-up and capture), but the ones
        # right after a save (their time holds the save's snapshot)
        after_save = {s["step"] for s in rep["saves"]}
        return [ms for k, ms in enumerate(rep["step_ms"][1:], start=rep["start_step"] + 1)
                if k not in after_save]

    def median(xs):
        return float(np.median(xs)) if xs else None

    overlap = {s["step"]: full["step_ms"][s["step"] - full["start_step"]]
               for s in full["saves"] if s["step"] - full["start_step"] < len(full["step_ms"])}
    emit({"phase": "pretrain", "argv": PRETRAIN_ARGV, "nvidia_smi": smi,
          "corpus_tokens": PRETRAIN_TOKENS, "losses": full["losses"],
          "resume_bitwise_steps": resumed_steps, "telemetry_off_bitwise_steps": quiet_steps,
          "preempted_after": reached, "preempt_rerun_bitwise_steps": pre_steps,
          "profiled_bitwise_steps": prof_steps, "flight_dumps": len(dumps),
          "metrics_window_rel_err": window_err, "goodput": goodput["fractions"],
          "trace_spans": spans, "checkpoints_kept_after_rerun": kept_pre,
          "launches_per_step": per_step, "launches": counts,
          "step_ms_median_telemetry_on": median(steady(full)),
          "step_ms_median_telemetry_off": median(steady(quiet)),
          "step_ms_telemetry_on": full["step_ms"], "step_ms_telemetry_off": quiet["step_ms"],
          "first_step_ms": full["step_ms"][0] if full["step_ms"] else None,
          "save_block_ms": [s["block_ms"] for s in full["saves"]],
          "step_ms_after_save": overlap,
          "writes": [{"seconds": w["seconds"], "bytes": w["bytes"]} for w in full["writes"]],
          "tokens_per_sec_wall": full["tokens_per_sec"], "profile": idle,
          "seconds": time.monotonic() - t_phase})
    return full


# --------------------------------------------------------------------- zero
def _remainder_launches():
    from apex_tpu_torch import ops

    return ops.launch_counts()["multi_tensor.REMAINDER_LAUNCHES"]


def check_mt_adam_remainder(dev):
    """``mt_adam_remainder`` against its plain version on the same card
    tensors, bitwise (bf16 params, uint16 remainders, moments), at
    GPT-124M's bf16 params as ZeRO's world-1 shards (one tensor a
    bucket, ``bucket_cap_mb=100``); with a clip coefficient; and a false
    predicate that must keep every value.  Timed beside the plain
    version and ``torch.optim.AdamW(fused=True)`` over the fp32 master
    (the library yardstick)."""
    from apex_tpu_torch.contrib.optimizers import _quantized_sync as qs
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.optimizers import bucketing

    meta = {k: (torch.empty(s, device="meta", dtype=torch.bfloat16) if not isinstance(s, dict)
                else {n: torch.empty(t, device="meta", dtype=torch.bfloat16)
                      for n, t in s.items()})
            for k, s in gpt_param_shapes().items()}
    plan = bucketing.plan_of(meta, cap_bytes=100 * 2 ** 20, block=qs.QBLOCK)
    sizes = [b.total for b in plan.buckets]
    gen = torch.Generator(device=dev).manual_seed(5)
    g = [_randn(gen, (n,), dev, 0.1) for n in sizes]
    p = [_randn(gen, (n,), dev, 1.0, torch.bfloat16) for n in sizes]
    rem = [torch.randint(0, 1 << 16, (n,), generator=gen, device=dev, dtype=torch.int32)
           .to(torch.uint16) for n in sizes]
    m = [_randn(gen, (n,), dev, 0.01) for n in sizes]
    v = [_randn(gen, (n,), dev, 0.01).abs() for n in sizes]

    def outs():
        return ([torch.empty_like(x) for x in p], [torch.empty_like(x) for x in rem],
                [torch.empty_like(x) for x in m], [torch.empty_like(x) for x in v])

    kw = dict(lr=1e-3, wd=[0.01] * len(sizes), bc1=torch.tensor(0.19, device=dev),
              bc2=torch.tensor(0.0029970, device=dev), beta1=0.9, beta2=0.999, eps=1e-8,
              adam_w_mode=True)
    cases = {}
    for case, extra in (("adamw", {}), ("clip", {"coef": torch.tensor(0.37, device=dev)}),
                        ("nonfinite", {"pred": torch.tensor(False, device=dev)})):
        ok_, op_ = outs(), outs()
        mt.mt_adam_remainder(g, p, rem, m, v, *ok_, **kw, **extra)
        mt.mt_adam_remainder_plain(g, p, rem, m, v, *op_, **kw, **extra)
        torch.cuda.synchronize()
        got = [t.view(torch.int16) if t.dtype in (torch.bfloat16, torch.uint16) else t
               for ts in ok_ for t in ts]
        want = [t.view(torch.int16) if t.dtype in (torch.bfloat16, torch.uint16) else t
                for ts in op_ for t in ts]
        bitwise = all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
        kept = None
        if case == "nonfinite":
            kept = all(torch.equal(a.view(torch.int16) if a.dtype != torch.float32 else a,
                                   b.view(torch.int16) if b.dtype != torch.float32 else b)
                       for a, b in zip([t for ts in ok_ for t in ts], p + rem + m + v))
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(ok_[0] + ok_[2] + ok_[3], op_[0] + op_[2] + op_[3]))
        cases[case] = {"bitwise_equal": bitwise, "old_values_kept": kept, "max_abs_err": err}
        if not bitwise or kept is False:
            raise AssertionError(f"mt_adam_remainder {case}: kernel != plain version {cases}")
    # the master the kernel wrote back rebuilds bit-exactly
    ok_ = outs()
    mt.mt_adam_remainder(g, p, rem, m, v, *ok_, **kw)
    rebuilt = mt.master_from_remainder(ok_[0][0], ok_[1][0])
    hi, lo = mt.split_master(rebuilt)
    roundtrip = bool(torch.equal(hi.view(torch.int16), ok_[0][0].view(torch.int16))
                     and torch.equal(lo.view(torch.int16), ok_[1][0].view(torch.int16)))
    if not roundtrip:
        raise AssertionError("mt_adam_remainder: split(master(p, rem)) != (p, rem)")
    N = sum(sizes)
    bms, by = bound(28 * N, 20 * N)
    t = timings(lambda: mt.mt_adam_remainder(g, p, rem, m, v, *ok_, **kw),
                lambda: mt.mt_adam_remainder_plain(g, p, rem, m, v, *ok_, **kw))
    master = [mt.master_from_remainder(a, b).clone().requires_grad_() for a, b in zip(p, rem)]
    for a, b in zip(master, g):
        a.grad = b.clone()
    lib_opt = torch.optim.AdamW(master, lr=1e-3, weight_decay=0.01, fused=True)
    lib_opt.step()
    t["library_ms"] = device_ms(lib_opt.step)[0]
    del lib_opt, master
    return {"kernel": "mt_adam_remainder", "tensors": len(sizes), "elements": N,
            "launches_per_call": mt.mt_plan("adam_remainder", sizes).launches,
            "cases": cases, "max_abs_err": cases["adamw"]["max_abs_err"],
            "master_roundtrip": roundtrip, "bound_ms": bms, "bound_by": by,
            "tolerance": "bitwise (the same fp32 operations as mt_adam; truncation split)",
            "library": "torch.optim.AdamW(fused=True).step over the fp32 master (its decay "
                       "associates differently, a yardstick of time only)", **t}


def check_residual_identity(dev, n_blocks=122880):
    """The quantized wire's telescoping identity on the card at world 1,
    bitwise: two steps of ``quantized_reduce_scatter`` on a GPT-124M-sized
    bucket (``n_blocks`` x 1024 fp32) of crafted values (integers with
    each block's amax pinned at 2 qmax x 2^k, so every scale is a power
    of two, the scaled values half-integers that the wire rounds, and
    every add exact): ``transmitted_1 + transmitted_2 +
    residual_2 == g_1 + g_2``, for int8 and float8_e4m3fn."""
    from apex_tpu_torch.contrib.optimizers import _quantized_sync as qs
    from apex_tpu_torch.transformer import parallel_state as ps

    group = ps.get_data_parallel_group()
    N = n_blocks * qs.QBLOCK
    gen = torch.Generator(device=dev).manual_seed(3)

    out = {}
    for name in ("int8", "float8_e4m3fn"):
        spec = qs.qspec_of(name)

        def ints(scale):
            h = torch.randint(-100, 101, (N,), generator=gen, device=dev).to(
                torch.float32) * scale
            h.view(-1, qs.QBLOCK)[:, 0] = 2 * spec.qmax * scale
            return h

        g1 = ints(1.0)
        t1, res1 = qs.quantized_reduce_scatter(g1, group.group, spec, 0, 1)
        h2 = ints(2.0)
        g2 = h2 - res1
        t2, res2 = qs.quantized_reduce_scatter(h2, group.group, spec, 0, 1)
        lhs, rhs = t1 + t2 + res2, g1 + g2
        torch.cuda.synchronize()
        ok = bool(torch.equal(lhs, rhs))
        out[name] = {"bitwise": ok, "residual_max": float(res1.abs().max()),
                     "elements": N}
        if not ok or not float(res1.abs().max()) > 0:
            raise AssertionError(f"residual identity {name}: {out[name]}, max diff "
                                 f"{float((lhs - rhs).abs().max())}")
    return out


def gpt345_param_shapes():
    """GPT-345M (bench.py's ``gpt345_params``: 24 layers, hidden 1024,
    16 heads, vocab 50304, seq 1024) in the port's layout."""
    return gpt_param_shapes(L=24, H=1024, V=50304, S=1024)


def _shape_params(dev, shapes, seed=0, dtype=torch.float32):
    rng = np.random.RandomState(seed)

    def one(s):
        if isinstance(s, dict):
            return {k: one(s[k]) for k in sorted(s)}
        return (torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.02)
                .to(dev).to(dtype))

    return one(shapes)


def zero2_vs_fused(dev, K=5):
    """bench.py's ``zero2_vs_fused`` (``bench_zero2``, bench.py:726-808)
    at dp 1: ``DistributedFusedAdam`` against ``FusedAdam`` (lr 1e-3,
    weight decay 0.01, grads ``p * 0.001 + 0.0001``) over bench.py's
    99-tensor set and GPT-345M's params; a step's ms from CUDA events
    over ``K`` steps captured as one graph, and the optimizer state's
    bytes of each."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map

    out = {}
    for label, make in (("resnet50_25m", lambda: bench_params(dev)[0]),
                        ("gpt345", lambda: _shape_params(dev, gpt345_param_shapes()))):
        params = make()
        grads = tree_map(lambda p: p * 0.001 + 0.0001, params)
        n = sum(p.numel() for p in tree_leaves(params))
        rec = {"params_m": n / 1e6}
        for name, opt in (("fused", FusedAdam(lr=1e-3, weight_decay=0.01)),
                          ("zero2_dp1", DistributedFusedAdam(lr=1e-3, weight_decay=0.01,
                                                             axis_name="dp"))):
            state = opt.init(params)
            rec[f"{name}_state_mb"] = sum(t.numel() * t.element_size()
                                          for t in tree_leaves(state)
                                          if isinstance(t, torch.Tensor)) / 2 ** 20

            def step(c, opt=opt):
                return opt.update(grads, c[1], c[0])

            graph, _ = _graphed_chain(step, (params, state), K)
            rec[f"{name}_ms"] = _replay_ms(graph, K)
            del graph, state
            torch.cuda.empty_cache()
        rec["zero2_over_fused"] = rec["zero2_dp1_ms"] / rec["fused_ms"]
        out[label] = rec
        del params, grads
        torch.cuda.empty_cache()
    return out


#: zero_gpt124's modes (bench.py:923-935): label -> DistributedFusedAdam kwargs
ZERO_MODES = {"zero_fp32_master": {}, "zero_param_remainders": {"store_param_remainders": True},
              "zero_int8_sync": {"grad_sync_dtype": "int8"},
              "zero_fp8_e4m3_sync": {"grad_sync_dtype": "float8_e4m3fn"}}


def zero_gpt124(dev, iters=8):
    """bench.py's ``zero_gpt124`` (bench.py:810-935) at dp 1: GPT-124M
    with bf16 params everywhere, batch 1 a rank, seq 1024, bf16 compute,
    flash attention, full remat, through ``train_gpt.make_train_step``
    graphed: replicated ``FusedAdam(lr=3e-4, weight_decay=0.1,
    master_weights=True)`` and ``DistributedFusedAdam`` in its
    fp32-master, ``store_param_remainders``, int8 and float8_e4m3fn
    modes.  Each: tokens/s over ``iters`` replays (CUDA events), the
    live bytes of params and optimizer state on the device,
    ``wire_bytes_per_step``; the remainder mode's ``mt_adam_remainder``
    launches counted from zero."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.models.gpt import GPTConfig, init_params
    from apex_tpu_torch.optimizers import FusedAdam, bucketing
    from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map
    from apex_tpu_torch.train_gpt import make_train_step

    cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12, num_attention_heads=12,
                    max_seq_len=1024, compute_dtype=torch.bfloat16, use_flash_attention=True,
                    checkpoint_layers=True, remat_policy="full")
    rng = np.random.RandomState(0)
    tok = rng.randint(0, 50304, size=(1, 1024))
    tokens = torch.from_numpy(tok).to(dev)
    targets = torch.from_numpy(np.roll(tok, -1, axis=1)).to(dev)
    base = tree_map(lambda x: x.to(torch.bfloat16), init_params(cfg, 0, dev, keep_fp32=True))
    n_params = sum(p.numel() for p in tree_leaves(base))

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))

    out = {"dp": 1, "params_m": n_params / 1e6, "batch": 1, "seq": 1024}
    modes = {"fused_replicated": lambda: FusedAdam(lr=3e-4, weight_decay=0.1,
                                                   master_weights=True)}
    modes.update({k: (lambda kw=kw: DistributedFusedAdam(lr=3e-4, weight_decay=0.1,
                                                          axis_name="dp", **kw))
                  for k, kw in ZERO_MODES.items()})
    rem_launches = 0
    for label, make in modes.items():
        params = tree_map(lambda x: x.clone().requires_grad_(True), base)
        opt = make()
        state = opt.init(params)
        live = nbytes(params) + nbytes(state)
        step = make_train_step(opt, cfg)
        losses = torch.empty(iters + 1, device=dev)
        losses[0].copy_(step(params, state, tokens, targets))  # warm-up + capture
        torch.cuda.synchronize()
        before = _remainder_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            losses[i + 1].copy_(step(params, state, tokens, targets))
        end.record()
        torch.cuda.synchronize()
        losses = losses.tolist()
        dt = start.elapsed_time(end) / 1e3 / iters
        if label == "zero_param_remainders":
            rem_launches = _remainder_launches() - before
        rec = {"tokens_per_sec": 1024 / dt, "ms_per_step": 1e3 * dt,
               "live_bytes_per_device_mb": live / 2 ** 20, "losses": losses,
               "graphed": step.graph is not None}
        if label == "fused_replicated":
            rplan = bucketing.plan_of(params)
            rec["wire_bytes_per_step"] = sum(
                b.total * torch.empty((), dtype=bucketing.torch_dtype(b.dtype)).element_size()
                for b in rplan.buckets)
        else:
            wb = opt.wire_bytes_per_step()
            rec["wire_bytes_per_step"] = wb["grad_sync"]
            rec["wire_bytes_param_sync"] = wb["param_sync"]
            rec["state_bytes_vs_replicated"] = (
                rec["live_bytes_per_device_mb"]
                / out["fused_replicated"]["live_bytes_per_device_mb"])
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"zero_gpt124 {label}: losses {losses}")
        out[label] = rec
        del params, state, step, opt
        torch.cuda.empty_cache()
    default = out["zero_fp32_master"]["wire_bytes_per_step"]
    for label in ("zero_int8_sync", "zero_fp8_e4m3_sync"):
        out[label]["wire_cut_vs_default"] = default / out[label]["wire_bytes_per_step"]
    if rem_launches != iters:
        raise AssertionError(f"zero_gpt124: mt_adam_remainder launched {rem_launches} times "
                             f"in {iters} replays, want {iters}")
    out["mt_adam_remainder_launches"] = rem_launches
    return out


#: the quantized wires' losses against the wide wire's on the same run
#: (error feedback keeps the trajectory; the quantization error of 8
#: steps of int8 / e4m3 payloads at GPT-124M)
QUANT_BAND = 1e-2


def _kernel_ms_matching(idle, *needles):
    """Device ms a step of the profiled kernels whose name holds any of
    ``needles`` (case-insensitive), by name."""
    return {n: ms for n, ms in idle["kernel_ms_per_step"].items()
            if any(k in n.lower() for k in needles)}


def zero_phase(smi, full):
    """``pretrain_gpt --zero`` at the pretrain phase's GPT-124M cell (seq
    1024, global batch 8, bf16, --fused-ce, its token file from the same
    seed), at world 1 over NCCL on this card, in this process: graphed
    (8 steps, elastic checkpoints at 4 and 8) and ``--eager``, losses
    bitwise equal to the pretrain phase's FusedAdam run (``full``) at
    every step, exact launch counts (the train_fce step's and one
    ``mt_adam`` a step); resumed from the step-4 directory, bitwise equal
    at steps 4-7; ``--grad-sync-dtype int8``, ``float8_e4m3fn`` and
    ``float8_e5m2`` on a corpus of one global batch (so that a loss
    falls): finite, falling, within ``QUANT_BAND`` of the wide wire's; the residual identity on
    the card; bench.py's
    ``zero2_vs_fused`` and ``zero_gpt124`` sections; a profile of 7
    graphed --zero steps (wide and int8): device ms of the collectives
    and the quantize ops by kernel name and the idle share.  With two or
    more cards, ``torchrun`` at world min(4, count) against world 1 on
    the same global batch; with one, a line says that world > 1 did not
    run on a card here."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.ops.multi_tensor import mt_plan
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="zero_"))
    # one world-1 NCCL group for the whole phase: every run reuses it
    multiproc.initialize_distributed("cuda")
    ps.initialize_model_parallel()
    try:
        data = work / "tokens.u16"
        vocab = int(PRETRAIN_ARGV[PRETRAIN_ARGV.index("--vocab") + 1])
        np.random.RandomState(0).randint(0, vocab, size=PRETRAIN_TOKENS).astype(
            np.uint16).tofile(data)
        base = PRETRAIN_ARGV + ["--data", str(data), "--zero"]
        ck = work / "ck"
        reset_counts()
        graphed = _pretrain_here(base + ["--steps", "8", "--checkpoint", str(ck),
                                         "--save-every", "4"])
        counts = launch_counts()
        zsizes = _zero_shard_sizes()
        L = 12
        per_step = {"layer_norm_fwd": 4 * L + 1, "layer_norm_bwd": 2 * L + 1,
                    "flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
                    "ce_fwd": 1, "ce_dx": 1, "ce_dembed": 1,
                    "mt_adam": mt_plan("adam", zsizes).launches, "mt_scale": 0,
                    "mt_l2norm": 0}
        expect = {**{k: 8 * v for k, v in per_step.items()},
                  "paged_decode_attention": 0, "paged_decode_attention_wide": 0,
                  "fused_sample": 0}
        if counts != expect:
            raise AssertionError(f"zero launch counts {counts} != expected {expect}")
        dirs = sorted(p.name for p in ck.glob("step_*"))
        if dirs != ["step_00000004", "step_00000008"] or not graphed["graphs"]:
            raise AssertionError(f"zero checkpoints {dirs}, graphs {graphed['graphs']}")
        graphed_steps = _bitwise("zero graphed vs FusedAdam", graphed, full)
        eager = _pretrain_here(base + ["--steps", "8", "--eager"])
        eager_steps = _bitwise("zero eager vs FusedAdam", eager, full)
        shutil.rmtree(ck / "step_00000008")
        resumed = _pretrain_here(base + ["--resume", str(ck), "--steps", "4"])
        if resumed["start_step"] != 4:
            raise AssertionError(f"zero resume started at {resumed['start_step']}")
        resume_steps = _bitwise("zero resume", resumed, graphed)
        shutil.rmtree(ck)
        # the quantized wires on one global batch repeated (a corpus of
        # one batch), where a loss falls: finite, falling, and within
        # QUANT_BAND of the wide wire's at every step
        one = work / "one_batch.u16"
        np.random.RandomState(1).randint(0, vocab, size=8 * 1025).astype(np.uint16).tofile(one)
        qbase = PRETRAIN_ARGV + ["--data", str(one), "--zero", "--steps", "8"]
        wide = _pretrain_here(qbase)["losses"]
        quant = {"wide": {"losses": wide}}
        for wire in ("int8", "float8_e4m3fn", "float8_e5m2"):
            q = _pretrain_here(qbase + ["--grad-sync-dtype", wire])
            ls = q["losses"]
            rel = max(abs(a - b) / abs(b) for a, b in zip(ls, wide))
            if not all(map(math.isfinite, ls)) or not ls[-1] < ls[0] or rel > QUANT_BAND:
                raise AssertionError(f"zero {wire}: losses {ls} against the wide wire's {wide}")
            quant[wire] = {"losses": ls, "max_rel_vs_wide": rel, "step_ms": q["step_ms"]}
        identity = check_residual_identity(torch.device("cuda", 0))

        # profiles: 7 graphed steps, the wide wire and int8; at world 1
        # NCCL runs a collective as a device-to-device copy
        prof_out = {}
        for wire in (None, "int8"):
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            argv = base + ["--steps", "7"] + (["--grad-sync-dtype", wire] if wire else [])
            rep = _pretrain_here(argv, profiler=prof)
            idle = _busy_share(prof)
            del prof
            prof_out[wire or "wide"] = {
                "idle_share": idle["idle_share"], "busy_ms": idle["busy_ms"],
                "window_ms": idle["window_ms"], "window_steps": idle["window_steps"],
                "collectives_ms_per_step": _kernel_ms_matching(idle, "nccl", "memcpy dtod"),
                "kernel_ms_per_step": idle["kernel_ms_per_step"], "losses": rep["losses"]}
        # the quantized wire's own device time: what int8 adds, by name
        wide_k, int8_k = (prof_out[k].pop("kernel_ms_per_step") for k in ("wide", "int8"))
        extra = {n: ms - wide_k.get(n, 0.0) for n, ms in int8_k.items()
                 if ms - wide_k.get(n, 0.0) > 0.005}
        prof_out["int8"]["quantize_ms_per_step"] = sum(extra.values())
        prof_out["int8"]["quantize_by_kernel"] = dict(sorted(extra.items(), key=lambda kv: -kv[1]))
        prof_out["wide"]["top_kernels_ms_per_step"] = dict(list(wide_k.items())[:20])
        z2 = zero2_vs_fused(torch.device("cuda", 0))
        reset_counts()
        z124 = zero_gpt124(torch.device("cuda", 0))
    finally:
        multiproc.destroy_distributed()
        shutil.rmtree(work, ignore_errors=True)

    n_cards = torch.cuda.device_count()
    multi = {"ran": False, "cards": n_cards,
             "note": "world > 1 did not run on a card here: one card"}
    if n_cards >= 2:
        data = Path(tempfile.mkdtemp(prefix="zero_multi_")) / "tokens.u16"
        np.random.RandomState(0).randint(0, vocab, size=PRETRAIN_TOKENS).astype(
            np.uint16).tofile(data)
        try:
            with STALL.multi_card():
                multi = zero_multi_card(min(4, n_cards), data)
        finally:
            shutil.rmtree(data.parent, ignore_errors=True)

    def steady(rep):
        return [ms for k, ms in enumerate(rep["step_ms"][1:], start=rep["start_step"] + 1)
                if k not in {s["step"] for s in rep["saves"]}]

    med = lambda xs: float(np.median(xs)) if xs else None  # noqa: E731
    emit({"phase": "zero", "argv": PRETRAIN_ARGV + ["--zero"], "nvidia_smi": smi,
          "world": 1, "backend": "nccl", "losses": graphed["losses"],
          "bitwise_vs_fused_adam_graphed_steps": graphed_steps,
          "bitwise_vs_fused_adam_eager_steps": eager_steps,
          "resume_bitwise_steps": resume_steps, "launches_per_step": per_step,
          "launches": counts, "checkpoint_dirs": dirs,
          "step_ms_median_zero_graphed": med(steady(graphed)),
          "step_ms_median_zero_eager": med(steady(eager)),
          "step_ms_median_fused_adam": med([ms for k, ms in enumerate(full["step_ms"][1:], 1)
                                            if k not in {s["step"] for s in full["saves"]}]),
          "step_ms_zero_graphed": graphed["step_ms"],
          "save_block_ms": [s["block_ms"] for s in graphed["saves"]],
          "quantized": quant, "residual_identity": identity, "profile": prof_out,
          "zero2_vs_fused": z2, "zero_gpt124": z124, "world_gt_1": multi,
          "seconds": time.monotonic() - t_phase})
    return z124["mt_adam_remainder_launches"]


def _zero_shard_sizes():
    """The world-1 ZeRO shard sizes of GPT-124M's fp32 params (one
    tensor a bucket of ``bucket_cap_mb=100``), which ``mt_adam`` takes."""
    from apex_tpu_torch.contrib.optimizers import _quantized_sync as qs
    from apex_tpu_torch.optimizers import bucketing

    meta = {k: (torch.empty(s, device="meta") if not isinstance(s, dict)
                else {n: torch.empty(t, device="meta") for n, t in s.items()})
            for k, s in gpt_param_shapes().items()}
    plan = bucketing.plan_of(meta, cap_bytes=100 * 2 ** 20, shard_pad=1, block=qs.QBLOCK)
    return [b.total for b in plan.buckets]


def zero_multi_card(world, data=None):
    """``torchrun --nproc-per-node world -m apex_tpu_torch.pretrain_gpt
    --zero`` (one card a rank, NCCL) against the same command at world 1,
    on the same global batch: losses within the band the CPU tests state
    for a torchrun world-2 run against the JAX package
    (tests/test_torch_pretrain.py ``ZERO_BAND``, 1e-3 relative: bf16
    compute over other row splits).  With ``data`` (the pretrain cell's
    token file) also the cell itself at 8 rows a rank, 10 steps: world 1
    ``--zero`` beside world ``world`` ``--zero``, ``--zero
    --grad-sync-dtype int8`` and replicated (the DDP all-reduce), each
    step's ms from CUDA events."""
    def launch(n, argv):
        res = subprocess.run(["torchrun", "--standalone", f"--nproc-per-node={n}", "-m",
                              "apex_tpu_torch.pretrain_gpt", *argv], cwd=ROOT,
                             capture_output=True, text=True, timeout=900)
        rep = next((json.loads(ln)["pretrain_gpt"] for ln in res.stdout.splitlines()
                    if ln.startswith('{"pretrain_gpt"')), None)
        if res.returncode != 0 or rep is None:
            raise AssertionError(f"torchrun world {n}: exit {res.returncode}\n"
                                 + res.stdout[-3000:] + res.stderr[-3000:])
        return rep

    tiny = ["--layers", "2", "--hidden", "256", "--heads", "4", "--vocab", "4096",
            "--seq", "256", "--global-batch", "8", "--steps", "4", "--zero"]
    one, many = launch(1, tiny), launch(world, tiny)
    rel = max(abs(a - b) / abs(b) for a, b in zip(many["losses"], one["losses"]))
    if rel > 1e-3:
        raise AssertionError(f"zero world {world} against world 1: relative {rel}")
    out = {"ran": True, "cards": torch.cuda.device_count(), "world": world,
           "losses_world_1": one["losses"], f"losses_world_{world}": many["losses"],
           "max_rel_diff": rel, "band": 1e-3, "timed": []}
    if data is None:
        return out
    argv = list(PRETRAIN_ARGV)
    for n, extra in ((1, ["--zero"]), (world, ["--zero"]),
                     (world, ["--zero", "--grad-sync-dtype", "int8"]), (world, [])):
        argv[argv.index("--global-batch") + 1] = str(8 * n)
        rep = launch(n, argv + ["--data", str(data), "--steps", "10", *extra])
        out["timed"].append({"world": n, "flags": extra, "global_batch": 8 * n,
                             "step_ms_median": float(np.median(rep["step_ms"][2:])),
                             "step_ms": rep["step_ms"], "losses": rep["losses"],
                             "graphs": rep["graphs"]})
    return out


# ----------------------------------------------------------------------- tp
#: GPT-345M, Megatron's tensor-parallel configuration (bench.py:2157-2160,
#: ``gpt345_s1024``): 24 layers, hidden 1024, 16 heads, vocab 50304, seq
#: 1024, global batch 8; pretrain_gpt's bf16, full remat, FusedAdam
GPT345_ARGV = ["--layers", "24", "--hidden", "1024", "--heads", "16", "--vocab", "50304",
               "--seq", "1024", "--global-batch", "8"]
#: steps of each one-card tp run (the first with the warm-up and capture)
TP_STEPS = 6
#: tp N against tp 1 on the same global batch, relative: bf16 compute over
#: other row splits (tests/test_torch_pretrain.py ``ZERO_BAND``)
TP_BAND = 1e-3


def _tp345_expect(fused, steps, sizes, L=24):
    from apex_tpu_torch.ops.multi_tensor import mt_plan

    per_step = {"layer_norm_fwd": 4 * L + 1, "layer_norm_bwd": 2 * L + 1,
                "flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
                "ce_fwd": int(fused), "ce_dx": int(fused), "ce_dembed": int(fused),
                "mt_adam": mt_plan("adam", sizes).launches, "mt_scale": 0, "mt_l2norm": 0}
    return per_step, {**{k: steps * v for k, v in per_step.items()},
                      "paged_decode_attention": 0, "paged_decode_attention_wide": 0,
                      "fused_sample": 0}


def _tp345_absent(flags, steps):
    """The pretrain run's step with no tp group (``train_gpt.make_train_step``
    alone, graphed): the same seed-0 params, FusedAdam and batches (the
    Megatron sampler's first rows of the seed-0 corpus).  Its losses."""
    from apex_tpu_torch import pretrain_gpt, train_gpt
    from apex_tpu_torch.models.gpt import init_params
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.tree import tree_leaves

    args = pretrain_gpt.build_args().parse_args(GPT345_ARGV + flags)
    dev = torch.device("cuda", 0)
    config = pretrain_gpt.make_config(args)
    params = init_params(config, 0, dev, keep_fp32=True)
    opt = FusedAdam(lr=args.lr, weight_decay=pretrain_gpt.WEIGHT_DECAY)
    state = opt.init(params)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    step = train_gpt.make_train_step(opt, config)
    corpus = pretrain_gpt.load_corpus(args)
    gb = args.global_batch
    losses = []
    for i in range(steps):
        rows = torch.from_numpy(np.ascontiguousarray(corpus[i * gb:(i + 1) * gb], np.int64))
        losses.append(float(step(params, state, rows[:, :-1].to(dev), rows[:, 1:].to(dev))))
    del step, params, state
    torch.cuda.empty_cache()
    return losses


def _tp345_run(flags, steps=TP_STEPS, profiler=None):
    """``pretrain_gpt --tp 1`` at GPT-345M in this process over the
    registered one-rank groups: the report, its launch counts, the peak
    device memory."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    rep = _pretrain_here(GPT345_ARGV + ["--tp", "1", "--steps", str(steps)] + flags,
                         profiler=profiler)
    counts = launch_counts()
    return rep, counts, torch.cuda.max_memory_allocated() / 1e9


def _gpt345_sizes():
    from apex_tpu_torch.optimizers.tree import tree_leaves

    meta = {k: (torch.empty(s, device="meta") if not isinstance(s, dict)
                else {n: torch.empty(t, device="meta") for n, t in s.items()})
            for k, s in gpt_param_shapes(L=24, H=1024).items()}
    return [t.numel() for t in tree_leaves(meta)]


def check_ce_vocab_shards(dev, tp, N=8192, H=1024, V=50304):
    """The CE kernels on the vocab shards of a (V, H) bf16 embed, as tp
    ranks run them: each shard's forward with targets made shard-local
    (``t - r * V / tp``, ids off the shard miss), the combine of
    ``fused_lm_head_ce`` (m_g = max m, l_g = sum l exp(m - m_g), tgt =
    sum tgt), each shard's dx and dembed with the combined lse.  Held
    against the full-vocab kernel call (lse and tgt; dembed's rows; the
    sum of the shards' dx) and each shard call against its plain version
    with bf16 dots, in the per-element bands of ``check_fused_ce``.
    Targets sit on each shard's first and last row and in each shard's
    tail tile (V / tp is not a multiple of the forward's 256-row tile).
    Times: the first shard's calls (``tp`` 1: the full vocab)."""
    from apex_tpu_torch.ops import fused_ce_kernels as K

    bf = torch.bfloat16
    Vl = V // tp
    rng = np.random.default_rng(N + V + H + tp)
    x = torch.from_numpy(rng.standard_normal((N, H), dtype=np.float32)).to(dev, bf)
    e = torch.from_numpy(0.02 * rng.standard_normal((V, H), dtype=np.float32)).to(dev, bf)
    t_np = rng.integers(0, V, size=N)
    special = []
    for r in range(tp):
        lo, tail = r * Vl, r * Vl + (Vl // 256) * 256
        special += [lo, lo + 1, lo + Vl - 1, tail, tail + 7, lo + Vl - 2]
    special += [V - 1, (V // 256) * 256]
    t_np[:len(special)] = special
    t = torch.from_numpy(t_np.astype(np.int32)).to(dev)
    g = torch.full((N,), 1.0 / N, device=dev)
    m, l, tgt = K.ce_fwd(x, e, t)
    lse = m + torch.log(l)
    dx_full = K.ce_dx(x, e, t, lse, g)
    de_full = K.ce_dembed(x, e, t, lse, g)
    shards = [(e[r * Vl:(r + 1) * Vl], (t.long() - r * Vl).to(torch.int32)) for r in range(tp)]
    stats = [K.ce_fwd(x, e_r, t_r) for e_r, t_r in shards]
    ms = torch.stack([s[0] for s in stats])
    m_g = ms.max(0).values
    l_g = sum(s[1] * torch.exp(s[0] - m_g) for s in stats)
    lse_g, tgt_g = m_g + torch.log(l_g), sum(s[2] for s in stats)
    logit_scale = max(1.0, float(m.abs().max()))
    fwd_tol = CE_TOL["fwd"] * logit_scale
    errs = {"lse_vs_full": float((lse_g - lse).abs().max()),
            "tgt_vs_full": float((tgt_g - tgt).abs().max())}
    band, dxs, des = {}, [], []
    for r, (e_r, t_r) in enumerate(shards):
        pm, pl, ptgt = K.ce_fwd_plain(x, e_r, t_r, dot_dtype=bf)
        errs[f"m_{r}"] = float((stats[r][0] - pm).abs().max())
        errs[f"tgt_{r}"] = float((stats[r][2] - ptgt).abs().max())
        errs[f"l_rel_{r}"] = rel_err(stats[r][1], pl)
        dx_r, de_r = K.ce_dx(x, e_r, t_r, lse_g, g), K.ce_dembed(x, e_r, t_r, lse_g, g)
        allow = ce_term_scales(x, e_r, t_r, lse_g, g)
        band[f"dx_{r}"] = ce_band(dx_r, K.ce_dx_plain(x, e_r, t_r, lse_g, g, dot_dtype=bf),
                                  allow["dx"])
        band[f"dembed_{r}"] = ce_band(de_r, K.ce_dembed_plain(x, e_r, t_r, lse_g, g,
                                                              dot_dtype=bf), allow["dembed"])
        if r == 0:
            lse_c = lse_g + math.log(2.0)
            band["control_dx_0"] = ce_band(K.ce_dx(x, e_r, t_r, lse_c, g),
                                           K.ce_dx_plain(x, e_r, t_r, lse_g, g, dot_dtype=bf),
                                           allow["dx"])
        dxs.append(dx_r)
        des.append(de_r)
        del allow
    allow = ce_term_scales(x, e, t, lse, g)
    band["dembed_vs_full"] = ce_band(torch.cat(des), de_full, allow["dembed"])
    # the shards' bf16 dx summed in fp32: each partial and the full call
    # carry one bf16 rounding of their own
    rounding = 2.0 ** -8 * (sum(d.float().abs() for d in dxs) + dx_full.float().abs())
    band["dx_sum_vs_full"] = ce_band(sum(d.float() for d in dxs), dx_full.float(),
                                     allow["dx"] + rounding)
    del allow
    problems = [f"{k} err {v} > {fwd_tol}" for k, v in errs.items()
                if not k.startswith("l_rel") and not v <= fwd_tol]
    problems += [f"{k} rel err {v} > {CE_TOL['fwd']}" for k, v in errs.items()
                 if k.startswith("l_rel") and not v <= CE_TOL["fwd"]]
    problems += [f"{k} uses {v} of its band" for k, v in band.items()
                 if not k.startswith("control") and not v <= 1.0]
    if not band["control_dx_0"] > 1.0:
        problems.append(f"control (lse + log 2) passed: {band['control_dx_0']}")
    if problems:
        raise AssertionError(f"ce vocab shards tp {tp}: {problems}")
    # times of the first shard's calls at V / tp rows
    F = torch.nn.functional
    e0, t0 = shards[0]
    xl = x.detach().requires_grad_()
    el = e0.detach().requires_grad_()
    loss = F.cross_entropy(torch.matmul(xl, el.T).float(), t0.long().clamp(0, Vl - 1))
    lib_fwd = lambda: F.cross_entropy(torch.matmul(x, e0.T).float(),  # noqa: E731
                                      t0.long().clamp(0, Vl - 1))
    lib_bwd = lambda: torch.autograd.grad(loss, (xl, el), retain_graph=True)  # noqa: E731
    timed = {"fwd": timings(lambda: K.ce_fwd(x, e0, t0),
                            lambda: K.ce_fwd_plain(x, e0, t0, dot_dtype=bf), lib_fwd),
             "dx": timings(lambda: K.ce_dx(x, e0, t0, lse_g, g),
                           lambda: K.ce_dx_plain(x, e0, t0, lse_g, g, dot_dtype=bf), lib_bwd),
             "dembed": timings(lambda: K.ce_dembed(x, e0, t0, lse_g, g),
                               lambda: K.ce_dembed_plain(x, e0, t0, lse_g, g, dot_dtype=bf),
                               lib_bwd)}
    del loss
    row, flops = N * 4, 2.0 * N * Vl * H
    bounds = {"fwd": bound(N * H * 2 + Vl * H * 2 + 4 * row, flops, PEAK_BF16),
              "dx": bound(2 * N * H * 2 + Vl * H * 2 + 3 * row, 2 * flops, PEAK_BF16),
              "dembed": bound(N * H * 2 + Vl * H * 2 + Vl * H * 4 + 3 * row, 2 * flops,
                              PEAK_BF16)}
    return {"tp": tp, "N": N, "H": H, "V": V, "V_local": Vl, "targets_placed": special,
            "errors": errs, "band_used": band, "logit_scale": logit_scale,
            "tolerance": CE_TOL,
            "tolerance_why": "lse and tgt combined over the shards against the full-vocab "
                             "call and each shard's m, tgt against its plain version: abs, "
                             "times max(1, max |logit|); l relative; dx, dembed per element "
                             "as check_fused_ce (each shard against its plain version with "
                             "the combined lse; dembed's rows and the fp32 sum of the "
                             "shards' bf16 dx against the full call, the latter with one "
                             "bf16 rounding of each partial and of the full dx); the "
                             "control (lse + log 2) must exceed the band",
            "timed": {k: {**timed[k], "bound_ms": bounds[k][0], "bound_by": bounds[k][1]}
                      for k in timed}}


def tp_phase(smi):
    """``pretrain_gpt --tp 1`` at GPT-345M in this process, over a
    one-rank NCCL group registered at tp 1 (the tensor-parallel code
    path with a one-rank group): the fused CE head and the dense head,
    graphed and ``--eager``, exact launch counts (97 / 49 / 48 / 24 / 24
    a step, 1 / 1 / 1 CE with the fused head, ``mt_plan``'s ``mt_adam``),
    losses bitwise equal to the same step with no tp group and graphed
    equal to eager; step ms (CUDA events), peak memory, and a profile of
    7 graphed fused steps.  Then the CE kernels on the halves and the
    quarters of the vocab (``check_ce_vocab_shards``), timed at V / tp
    rows.  With two or more cards, ``tp_multi_card``."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    sizes = _gpt345_sizes()
    runs, absent = {}, {}
    multiproc.initialize_distributed("cuda")
    ps.initialize_model_parallel(tensor_model_parallel_size_=1)
    try:
        for name, flags, steps in (("fused", ["--fused-ce"], TP_STEPS),
                                   ("fused_eager", ["--fused-ce", "--eager"], 4),
                                   ("dense", [], TP_STEPS), ("dense_eager", ["--eager"], 4)):
            rep, counts, peak = _tp345_run(flags, steps)
            per_step, expect = _tp345_expect(name.startswith("fused"), steps, sizes)
            if counts != expect:
                raise AssertionError(f"tp {name} launch counts {counts} != expected {expect}")
            ls = rep["losses"]
            if not all(map(math.isfinite, ls)) or rep["tp"] != 1:
                raise AssertionError(f"tp {name}: losses {ls}, tp {rep['tp']}")
            runs[name] = {"losses": ls, "step_ms": rep["step_ms"],
                          "step_ms_median": float(np.median(rep["step_ms"][1:])),
                          "tokens_per_sec": 8 * 1024 / (np.median(rep["step_ms"][1:]) / 1e3),
                          "peak_memory_gb": peak, "graphs": rep["graphs"],
                          "launches_per_step": per_step, "launches": counts}
        for head in ("fused", "dense"):
            eager, graphed = runs[head + "_eager"]["losses"], runs[head]["losses"]
            rel = max(abs(a - b) / abs(b) for a, b in zip(graphed, eager))
            if rel > TRAIN_AB_TOL:
                raise AssertionError(f"tp {head}: graphed {graphed} against eager {eager}")
            runs[head]["graphed_vs_eager"] = "bitwise" if rel == 0 else rel
            absent[head] = _tp345_absent(["--fused-ce"] if head == "fused" else [], TP_STEPS)
            if absent[head] != runs[head]["losses"]:
                raise AssertionError(f"tp 1 {head}: losses {runs[head]['losses']} with the "
                                     f"tp group, {absent[head]} without: not bitwise")
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        rep, _, _ = _tp345_run(["--fused-ce"], 7, profiler=prof)
        idle = _busy_share(prof)
        del prof
    finally:
        multiproc.destroy_distributed()
    dev = torch.device("cuda", 0)
    shards = {tp: check_ce_vocab_shards(dev, tp) for tp in (1, 2, 4)}
    n_cards = torch.cuda.device_count()
    multi = {"ran": False, "cards": n_cards,
             "note": "tp > 1 did not run on a card here: one card"}
    if n_cards >= 2:
        with STALL.multi_card():
            multi = tp_multi_card(min(4, n_cards))
    emit({"phase": "tp", "argv": GPT345_ARGV + ["--tp", "1"], "nvidia_smi": smi,
          "runs": runs, "bitwise_vs_no_tp_group": {h: absent[h] for h in absent},
          "profile_fused": {"idle_share": idle["idle_share"], "busy_ms": idle["busy_ms"],
                            "window_ms": idle["window_ms"],
                            "window_steps": idle["window_steps"],
                            "top_kernels_ms_per_step": dict(
                                list(idle["kernel_ms_per_step"].items())[:20])},
          "ce_vocab_shards": shards, "tp_gt_1": multi,
          "seconds": time.monotonic() - t_phase})
    return absent


def _torchrun_pretrain(n, argv, timeout=900):
    res = subprocess.run(["torchrun", "--standalone", f"--nproc-per-node={n}", "-m",
                          "apex_tpu_torch.pretrain_gpt", *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    rep = next((json.loads(ln)["pretrain_gpt"] for ln in res.stdout.splitlines()
                if ln.startswith('{"pretrain_gpt"')), None)
    if res.returncode != 0 or rep is None:
        raise AssertionError(f"torchrun world {n} {argv}: exit {res.returncode}\n"
                             + res.stdout[-3000:] + res.stderr[-3000:])
    return rep


def tp_multi_card(world):
    """``torchrun --nproc-per-node N -m apex_tpu_torch.pretrain_gpt --tp N``
    (one card a rank, NCCL) against ``--tp 1`` on one card, the same
    global batch: a 2-layer model at tp 2 (and 4 with four cards), the
    dense head, then ``--sequence-parallel --fused-ce``; losses within
    ``TP_BAND``.  Then GPT-345M at each tp (``--fused-ce``, with and
    without ``--sequence-parallel``; the dense head at the largest tp),
    10 steps, step ms from CUDA events (median past the second), and a
    profile of 7 steps at the largest tp with SP (this script's
    ``tp_child`` mode, rank 0's device time by kernel and idle share)."""
    tiny = ["--layers", "2", "--hidden", "256", "--heads", "4", "--vocab", "4096",
            "--seq", "256", "--global-batch", "8", "--steps", "4"]
    tps = [n for n in (2, 4) if n <= world]
    out = {"ran": True, "cards": torch.cuda.device_count(), "world": world, "band": TP_BAND,
           "parity": [], "timed": []}
    for flags in ([], ["--sequence-parallel", "--fused-ce"]):
        one = _torchrun_pretrain(1, tiny + ["--tp", "1"] + [f for f in flags
                                                             if f == "--fused-ce"])
        for n in tps:
            many = _torchrun_pretrain(n, tiny + ["--tp", str(n)] + flags)
            rel = max(abs(a - b) / abs(b) for a, b in zip(many["losses"], one["losses"]))
            if rel > TP_BAND or many["tp"] != n:
                raise AssertionError(f"tp {n} {flags} against tp 1: relative {rel}")
            out["parity"].append({"tp": n, "flags": flags, "losses_tp_1": one["losses"],
                                  "losses": many["losses"], "max_rel_diff": rel})
    for n, flags in [(1, ["--fused-ce"])] + [(n, f) for n in tps for f in (
            ["--fused-ce"], ["--fused-ce", "--sequence-parallel"])] + [(tps[-1], [])]:
        rep = _torchrun_pretrain(n, GPT345_ARGV + ["--tp", str(n), "--steps", "10", *flags])
        out["timed"].append({"tp": n, "flags": flags, "graphs": rep["graphs"],
                             "step_ms_median": float(np.median(rep["step_ms"][2:])),
                             "step_ms": rep["step_ms"], "losses": rep["losses"]})
    n = tps[-1]
    res = subprocess.run(["torchrun", "--standalone", f"--nproc-per-node={n}",
                          str(ROOT / "chip_smoke.py"), "tp_child", *GPT345_ARGV, "--tp", str(n),
                          "--steps", "7", "--fused-ce", "--sequence-parallel"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    prof = next((json.loads(ln)["tp_profile"] for ln in res.stdout.splitlines()
                 if ln.startswith('{"tp_profile"')), None)
    if res.returncode != 0 or prof is None:
        raise AssertionError(f"tp_child world {n}: exit {res.returncode}\n"
                             + res.stdout[-3000:] + res.stderr[-3000:])
    out["profile"] = {"tp": n, "flags": ["--fused-ce", "--sequence-parallel"], **prof}
    return out


def tp_child(argv):
    """One rank of ``torchrun ... chip_smoke.py tp_child <pretrain_gpt
    flags>``: the run under the profiler; rank 0 prints the device's
    busy share over the last steps and its device ms a step by kernel,
    NCCL's beside the rest."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    rep = _pretrain_here(argv, profiler=prof)
    idle = _busy_share(prof)
    if rep["rank"] == 0:
        k = idle["kernel_ms_per_step"]
        nccl = sum(ms for name, ms in k.items() if "nccl" in name.lower())
        print(json.dumps({"tp_profile": {
            "idle_share": idle["idle_share"], "busy_ms": idle["busy_ms"],
            "window_ms": idle["window_ms"], "window_steps": idle["window_steps"],
            "nccl_ms_per_step": nccl, "losses": rep["losses"],
            "top_kernels_ms_per_step": dict(list(k.items())[:25])}}), flush=True)
    return 0


# ----------------------------------------------------------------------- pp
#: the one-card pp phase's microbatches: 4 of 2 rows of the global batch 8
PP_MICRO = 4


def _pp345_expect(fused, steps, sizes, M=PP_MICRO):
    """Launches a step of the pipelined step at GPT-345M: every microbatch
    runs the whole model (the tp phase's counts, M times), one update."""
    per_mb, _ = _tp345_expect(fused, 1, sizes)
    per_step = {k: (v if k.startswith("mt_") else M * v) for k, v in per_mb.items()}
    return per_step, {**{k: steps * v for k, v in per_step.items()},
                      "paged_decode_attention": 0, "paged_decode_attention_wide": 0,
                      "fused_sample": 0}


def _pp345_run(tree, fused, eager, steps, M=PP_MICRO, profiler=None):
    """``make_pp_train_step`` at GPT-345M (pretrain_gpt's config, the
    seed-0 params ``tree``, FusedAdam(wd 0.01), the seed-0 corpus's first rows, the
    batches the tp phase's steps take) over the registered one-rank
    groups: its losses, step ms (CUDA events after each step; the
    batches are on the card first, no host read in the loop), launch
    counts and peak memory; with ``profiler`` the steps run under it."""
    import gc

    from apex_tpu_torch import pretrain_gpt
    from apex_tpu_torch.models.gpt import make_pp_train_step, params_from_numpy
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.tree import tree_leaves
    from apex_tpu_torch.transformer import parallel_state as ps

    args = pretrain_gpt.build_args().parse_args(GPT345_ARGV + (["--fused-ce"] if fused else []))
    dev = torch.device("cuda", 0)
    config = pretrain_gpt.make_config(args)
    corpus = pretrain_gpt.load_corpus(args)
    gb = args.global_batch
    rows = [torch.from_numpy(np.ascontiguousarray(corpus[i * gb:(i + 1) * gb], np.int64)).to(dev)
            for i in range(steps)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    params = params_from_numpy(tree, config, dev, keep_fp32=True)
    opt = FusedAdam(lr=args.lr, weight_decay=pretrain_gpt.WEIGHT_DECAY)
    state = opt.init(params)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    step = make_pp_train_step(config, opt, M, graphs=False if eager else None,
                              dp_group=ps.get_data_parallel_group(),
                              tp_group=ps.get_tensor_model_parallel_group())
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    losses = []
    with profiler if profiler is not None else contextlib.nullcontext():
        for r in rows:
            losses.append(step(params, state, r[:, :-1], r[:, 1:]).detach().clone())
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        torch.cuda.synchronize()
    out = {"losses": [float(x) for x in losses],
           "step_ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])],
           "launches": launch_counts(), "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "graphs": not eager}
    del step, params, state, rows
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pp_phase(smi, absent):
    """``make_pp_train_step`` at GPT-345M in this process over one-rank
    NCCL pipeline, tp and dp groups (the 1F1B runtime at pp 1: the 4
    microbatches' forwards and backwards in turn, grads accumulated): the
    fused CE head and the dense head, graphed and eager, exact launch
    counts, graphed = eager, and the losses against ``absent`` (the tp
    phase's ``make_train_step`` losses on the same batches): the first
    step's (the same params, the forward over other row splits) within
    ``TRAIN_AB_TOL``, every step's within ``TP_BAND`` (each microbatch's
    bf16 weight grads are rounded before they are summed in fp32, as in
    the JAX package's pipeline, and Adam's normalized update carries the
    difference into the later losses); with one microbatch (eager, both
    heads), which takes the split away and leaves the schedule, every
    step within ``TRAIN_AB_TOL``; step ms, peak memory.  With two or
    more cards, ``pp_multi_card``."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch import pretrain_gpt
    from apex_tpu_torch.models.gpt import _init_numpy
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    t_phase = time.monotonic()
    sizes = _gpt345_sizes()
    # the seed-0 params once (both heads share the tree)
    tree = _init_numpy(pretrain_gpt.make_config(pretrain_gpt.build_args().parse_args(
        GPT345_ARGV)), 0)
    runs = {}
    multiproc.initialize_distributed("cuda")
    ps.initialize_model_parallel(tensor_model_parallel_size_=1, pipeline_model_parallel_size_=1)
    try:
        for name, fused, eager, steps, M in (("fused", True, False, TP_STEPS, PP_MICRO),
                                             ("fused_eager", True, True, 4, PP_MICRO),
                                             ("dense", False, False, TP_STEPS, PP_MICRO),
                                             ("dense_eager", False, True, 4, PP_MICRO),
                                             ("fused_m1", True, True, 4, 1),
                                             ("dense_m1", False, True, 4, 1)):
            run = _pp345_run(tree, fused, eager, steps, M=M)
            per_step, expect = _pp345_expect(fused, steps, sizes, M=M)
            if run["launches"] != expect:
                raise AssertionError(f"pp {name} launch counts {run['launches']} != expected "
                                     f"{expect}")
            if not all(map(math.isfinite, run["losses"])):
                raise AssertionError(f"pp {name}: losses {run['losses']}")
            med = float(np.median(run["step_ms"][1:]))
            runs[name] = {**run, "launches_per_step": per_step, "step_ms_median": med,
                          "tokens_per_sec": 8 * 1024 / (med / 1e3)}
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        _pp345_run(tree, True, False, 7, profiler=prof)
        idle = _busy_share(prof)
        del prof
    finally:
        multiproc.destroy_distributed()
    for head in ("fused", "dense"):
        graphed, eager = runs[head]["losses"], runs[head + "_eager"]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(graphed, eager))
        if rel > TRAIN_AB_TOL:
            raise AssertionError(f"pp {head}: graphed {graphed} against eager {eager}")
        runs[head]["graphed_vs_eager"] = "bitwise" if rel == 0 else rel
        rels = [abs(a - b) / abs(b) for a, b in zip(graphed, absent[head])]
        if rels[0] > TRAIN_AB_TOL or max(rels) > TP_BAND:
            raise AssertionError(f"pp {head}: losses {graphed} against make_train_step's "
                                 f"{absent[head]}: relative {rels}, the first step's beyond "
                                 f"{TRAIN_AB_TOL} or a later one's beyond {TP_BAND}")
        runs[head]["vs_make_train_step"] = {"losses": absent[head], "rel_diff": rels}
        # one microbatch: the schedule alone, without the microbatch split
        one = runs[head + "_m1"]["losses"]
        rels = [abs(a - b) / abs(b) for a, b in zip(one, absent[head])]
        if max(rels) > TRAIN_AB_TOL:
            raise AssertionError(f"pp {head} with one microbatch: losses {one} against "
                                 f"make_train_step's {absent[head]}: relative {rels} beyond "
                                 f"{TRAIN_AB_TOL}")
        runs[head + "_m1"]["vs_make_train_step"] = {"rel_diff": rels}
    n_cards = torch.cuda.device_count()
    multi = {"ran": False, "cards": n_cards,
             "note": "pp > 1 did not run on a card here: one card"}
    if n_cards >= 2:
        with STALL.multi_card():
            multi = pp_multi_card(min(4, n_cards))
    emit({"phase": "pp", "argv": GPT345_ARGV, "micro_batches": PP_MICRO, "nvidia_smi": smi,
          "runs": runs, "tolerance": {"first_step": TRAIN_AB_TOL, "every_step": TP_BAND},
          "profile_fused": {"idle_share": idle["idle_share"], "busy_ms": idle["busy_ms"],
                            "window_ms": idle["window_ms"],
                            "window_steps": idle["window_steps"],
                            "top_kernels_ms_per_step": dict(
                                list(idle["kernel_ms_per_step"].items())[:30])},
          "pp_gt_1": multi,
          "seconds": time.monotonic() - t_phase})


def _pp_children(n, args, timeout=900):
    """``torchrun --nproc-per-node n chip_smoke.py pp_child <args>``: the
    JSON objects its ranks print."""
    res = subprocess.run(["torchrun", "--standalone", f"--nproc-per-node={n}",
                          str(ROOT / "chip_smoke.py"), "pp_child", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith('{"pp_')]
    if res.returncode != 0 or not lines:
        raise AssertionError(f"pp_child world {n} {args}: exit {res.returncode}\n"
                             + res.stdout[-3000:] + res.stderr[-3000:])
    return lines


def pp_multi_card(world, eager=False):
    """``torchrun -m apex_tpu_torch.pretrain_gpt --pp N`` (one card a rank,
    NCCL, the stages' messages point to point) at GPT-345M with
    ``--fused-ce``, 10 steps, step ms from CUDA events (median past the
    second): pp 1 on one card (``make_train_step``: at pp 1 ``pretrain_gpt``
    does not split the batch), pp 4 at 8 microbatches and a profile of 7
    such steps (``pp_child``: the first and the last stage's idle share
    and NCCL ms a step), pp 2 at 8 (with four cards), pp 4 at 2 (the
    reference's default, the larger bubble), each one's losses within
    ``TP_BAND`` of pp 1's (the same global batch).  tp x pp and the
    interleaved schedule are refused over NCCL (ROADMAP.md section 3) and
    do not run here.  Each result is printed (a ``pp_multi_card`` line)
    as it comes, and a run beyond the band fails the check only after
    every run has printed.  ``eager`` runs every step eagerly."""
    ex = ["--eager"] if eager else []
    out = {"ran": True, "cards": torch.cuda.device_count(), "world": world, "band": TP_BAND,
           "eager": eager, "timed": []}
    n = 4 if world >= 4 else 2
    runs = [(1, 1, 8), (n, 1, 8), "profile"] + ([(2, 1, 8)] if world >= 4 else []) \
        + [(n, 1, 2)]
    failed = []
    for run in runs:
        if run == "profile":
            out["profile"] = {"pp": n, "micro_batches": 8, "stages": [
                ln["pp_profile"] for ln in _pp_children(n, GPT345_ARGV + [
                    "--pp", str(n), "--micro-batches", "8", "--steps", "7", "--fused-ce"] + ex)]}
            emit({"pp_multi_card": {"profile": out["profile"]}})
            continue
        pp, tp, M = run
        rep = _torchrun_pretrain(pp * tp, GPT345_ARGV + [
            "--pp", str(pp), "--tp", str(tp), "--micro-batches", str(M), "--steps", "10",
            "--fused-ce"] + ex)
        row = {"pp": pp, "tp": tp, "micro_batches": M if pp > 1 else None,
               "graphs": rep["graphs"],
               "step_ms_median": float(np.median(rep["step_ms"][2:])),
               "step_ms": rep["step_ms"], "losses": rep["losses"],
               "peak_memory_gb_rank0": rep["peak_memory_gb"],
               "bubble_share": (pp - 1) / (M + pp - 1)}
        if out["timed"]:
            want = out["timed"][0]["losses"]
            row["max_rel_diff"] = max(abs(a - b) / abs(b) for a, b in zip(row["losses"], want))
            if not row["max_rel_diff"] <= TP_BAND:  # NaN fails too
                failed.append(f"pp {pp} x tp {tp} at M {M}: losses {row['losses']} against "
                              f"pp 1's {want}, beyond {TP_BAND}")
        emit({"pp_multi_card": {"timed": row}})
        out["timed"].append(row)
    if failed:  # after every run, so that one fault keeps the others' numbers
        raise AssertionError("pp_multi_card: " + "; ".join(failed))
    return out


def vpp_child(argv):
    """One rank of ``torchrun ... chip_smoke.py vpp_child --pp N --vpp V
    --micro-batches M --steps S [--eager]``: ``make_pp_train_step`` at
    GPT-345M (pretrain_gpt's config with the fused head, the seed-0
    params in ``params_to_vpp_layout``'s order, FusedAdam(wd 0.01)) over
    NCCL, the seed-0 corpus's rows ``[8i, 8i + 8)`` at step i, CUDA
    events after each step.  The world is torn down with the step (and
    its graph) alive: :func:`apex_tpu_torch.parallel.destroy_distributed`
    frees the graphs first.  Rank 0 prints the losses, step ms, peak
    memory and the teardown's seconds.  Over NCCL ``make_pp_train_step``
    refuses vpp > 1 (ROADMAP.md section 3): this is the run, made
    ``torchrun --standalone --nproc-per-node N chip_smoke.py vpp_child``
    in a copy without the refusal, that would lift it."""
    import argparse

    from apex_tpu_torch import pretrain_gpt
    from apex_tpu_torch.models.gpt import (
        _init_numpy, make_pp_train_step, params_to_vpp_layout, shard_params,
    )
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    ap = argparse.ArgumentParser()
    ap.add_argument("--pp", type=int, required=True)
    ap.add_argument("--vpp", type=int, default=1)
    ap.add_argument("--micro-batches", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--eager", action="store_true")
    a = ap.parse_args(argv)
    dev = multiproc.initialize_distributed("cuda")
    ps.initialize_model_parallel(pipeline_model_parallel_size_=a.pp,
                                 virtual_pipeline_model_parallel_size_=a.vpp if a.vpp > 1
                                 else None)
    args = pretrain_gpt.build_args().parse_args(GPT345_ARGV + ["--fused-ce"])
    config = pretrain_gpt.make_config(args)
    tree = _init_numpy(config, 0)
    if a.vpp > 1:
        tree = params_to_vpp_layout(tree, a.pp, a.vpp)
    params = shard_params(tree, config, ps.get_tensor_model_parallel_group(), dev,
                          keep_fp32=True, pp_group=ps.get_pipeline_model_parallel_group())
    opt = FusedAdam(lr=args.lr, weight_decay=pretrain_gpt.WEIGHT_DECAY)
    state = opt.init(params)
    step = make_pp_train_step(config, opt, a.micro_batches, a.vpp,
                              graphs=False if a.eager else None,
                              dp_group=ps.get_data_parallel_group(),
                              tp_group=ps.get_tensor_model_parallel_group())
    corpus = pretrain_gpt.load_corpus(args)
    gb = args.global_batch
    rows = [torch.from_numpy(np.ascontiguousarray(corpus[i * gb:(i + 1) * gb], np.int64)).to(dev)
            for i in range(a.steps)]
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    losses = []
    for r in rows:
        losses.append(step(params, state, r[:, :-1], r[:, 1:]).detach().clone())
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    torch.cuda.synchronize()
    rep = {"losses": [float(x) for x in losses],
           "step_ms": [e0.elapsed_time(e1) for e0, e1 in zip(events, events[1:])],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    t0 = time.monotonic()
    rank = torch.distributed.get_rank()
    multiproc.destroy_distributed()  # the step, its graph with it, still alive here
    rep["teardown_s"] = time.monotonic() - t0
    if rank == 0:
        print(json.dumps({"vpp_child": rep}), flush=True)
    del step
    return 0


def pp_multi_card_main():
    """``chip_smoke.py pp_multi_card``: the kernels built, then
    :func:`pp_multi_card` alone over the host's cards (two or more, up to
    four), its result as the last line."""
    from apex_tpu_torch.ops import _build

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        raise SystemExit(f"chip_smoke pp_multi_card: needs two or more cards, has {n_cards}")
    emit({"phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
          "nccl": list(torch.cuda.nccl.version()), "count": n_cards, "nvidia_smi": _smi()})
    secs = _build.build(force=True)
    _build.load()
    emit({"phase": "build", "seconds": secs})
    t0 = time.monotonic()
    out = pp_multi_card(min(4, n_cards))
    emit({"phase": "pp_multi_card", **out, "seconds": time.monotonic() - t0})
    return 0


def pp_child(argv):
    """One rank of ``torchrun ... chip_smoke.py pp_child <pretrain_gpt
    flags>``: the run under the profiler; every rank prints its device's
    busy share over the last steps, NCCL's ms a step, its peak memory and
    its top kernels."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    rep = _pretrain_here(argv, profiler=prof)
    idle = _busy_share(prof)
    k = idle["kernel_ms_per_step"]
    nccl = sum(ms for name, ms in k.items() if "nccl" in name.lower())
    print(json.dumps({"pp_profile": {
        "rank": rep["rank"], "idle_share": idle["idle_share"], "busy_ms": idle["busy_ms"],
        "window_ms": idle["window_ms"], "window_steps": idle["window_steps"],
        "nccl_ms_per_step": nccl, "losses": rep["losses"],
        "peak_memory_gb": rep["peak_memory_gb"],
        "top_kernels_ms_per_step": dict(list(k.items())[:12])}}), flush=True)
    return 0


# ------------------------------------------------------------ resilience
def _child(cmd, timeout):
    """``cmd`` in a session of its own (a supervisor's children with it):
    ``(returncode, stdout lines, stderr lines, seconds)``.  Past
    ``timeout`` the whole session is killed and this raises with the last
    lines, so a hung child fails the phase instead of the script."""
    import os
    import signal
    import tempfile

    t0 = time.monotonic()
    with tempfile.TemporaryFile("w+") as out, tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err, text=True,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = None
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)  # whatever the session left
            except ProcessLookupError:
                pass
        out.seek(0)
        err.seek(0)
        lines, errs = out.read().splitlines(), err.read().splitlines()
    if rc is None:
        raise TimeoutError(f"{cmd[2:5]} ran past {timeout} s:\n" + "\n".join(
            lines[-20:] + errs[-40:]))
    return rc, lines, errs, time.monotonic() - t0


def _events(errs, event):
    """The JSON fields of each ``event`` record in ``errs``."""
    return [json.loads(ln.split(f"{event} ", 1)[1]) for ln in errs if f" {event} {{" in ln]


def supervised_phase(smi):
    """The twin of bench.py's supervised elastic-resume section
    (``bench.py:1055-1110``): a :class:`~apex_tpu_torch.resilience
    .Supervisor` runs ``python -m apex_tpu_torch.pretrain_gpt --zero
    --auto-resume --save-every 1 --steps 3 --supervise`` at the pretrain
    phase's GPT-124M shape as its child on this card, its fault script
    killing attempt 0 at step 1 (``--chaos-kill-at-step``, exit 137).
    rc 0 with exactly one restart; the resumed child's losses, its final
    one included, bitwise equal to an unkilled run's at the same steps
    (``--zero`` in this process, 4 steps, exact launch counts).  Prints
    the backoffs and the wall seconds."""
    import shutil
    import tempfile

    from apex_tpu_torch.ops.multi_tensor import mt_plan

    work = Path(tempfile.mkdtemp(prefix="supervised_"))
    try:
        script = work / "faults.json"
        script.write_text(json.dumps({"0": {"args": ["--chaos-kill-at-step", "1"]}}))
        cmd = [sys.executable, "-m", "apex_tpu_torch.pretrain_gpt", *PRETRAIN_ARGV, "--zero",
               "--auto-resume", "--checkpoint", str(work / "ck"), "--save-every", "1",
               "--steps", "3", "--watchdog-secs", "120", "--supervise",
               "--fault-script", str(script), "--backoff-base", "1"]
        rc, lines, errs, wall = _child(cmd, 400)
        restarts = _events(errs, "supervisor.restarting")
        reports = [json.loads(ln)["pretrain_gpt"] for ln in lines
                   if ln.startswith('{"pretrain_gpt"')]
        if rc != 0 or len(restarts) != 1 or restarts[0]["exit_code"] != 137 \
                or len(reports) != 1:
            raise AssertionError(f"supervised pretrain: rc {rc}, restarts {restarts}, "
                                 f"{len(reports)} reports:\n" + "\n".join(errs[-40:]))
        final = reports[0]
        reset_counts()
        clean = _pretrain_here(PRETRAIN_ARGV + ["--zero", "--steps", "4"])
        counts = launch_counts()
        L = 12
        per_step = {"layer_norm_fwd": 4 * L + 1, "layer_norm_bwd": 2 * L + 1,
                    "flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
                    "ce_fwd": 1, "ce_dx": 1, "ce_dembed": 1,
                    "mt_adam": mt_plan("adam", _zero_shard_sizes()).launches, "mt_scale": 0,
                    "mt_l2norm": 0}
        expect = {**{k: 4 * v for k, v in per_step.items()},
                  "paged_decode_attention": 0, "paged_decode_attention_wide": 0,
                  "fused_sample": 0}
        if counts != expect:
            raise AssertionError(f"supervised reference counts {counts} != {expect}")
        want = dict(zip(clean["steps"], clean["losses"]))
        if final["start_step"] not in (0, 1) or final["steps_done"] != 3 or any(
                want.get(st) != loss for st, loss in zip(final["steps"], final["losses"])):
            raise AssertionError(f"supervised losses {final['steps']} {final['losses']} "
                                 f"against the unkilled run's {want}")
        out = {"phase": "supervised", "argv": cmd[3:], "rc": rc, "restarts": len(restarts),
               "exit_codes": [r["exit_code"] for r in restarts],
               "backoffs_s": [r["delay_s"] for r in restarts], "wall_s": wall,
               "resumed_at": final["start_step"], "steps": final["steps"],
               "losses": final["losses"], "unkilled_losses": clean["losses"],
               "bitwise": True, "launches_unkilled": counts, "nvidia_smi": smi}
        emit(out)
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def serve_resilience_phase(smi):
    """``serve_gpt`` at its defaults (GPT-124M, 32 requests), graphed, in
    this process with ``--metrics-dir`` and ``--trace-dir`` off, on, on
    and off: exact launch counts every time, the streams equal token for
    token (the hooks' cost is the mean tokens/s of the two runs on
    against the two off), the metrics files and one ``serve.request``
    span a request.  Then, as a child on this card, ``serve_gpt
    --watchdog-secs 5 --supervise`` with a fault script that
    wedges attempt 0 after 20 decode steps (``--chaos-wedge-decode-step
    20 --chaos-wedge-secs 120``): attempt 0 exits 75 with a
    ``serve.step_wedged`` manifest naming every queued and in-flight
    request, the supervisor restarts it once, and attempt 1 serves every
    request."""
    import shutil
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="serve_resilience_"))
    try:
        # off, on, on, off: the hooks' cost is the mean of each pair, the
        # first run's warm-up on neither side alone
        hooks_on = ["--metrics-dir", str(work / "m"), "--trace-dir", str(work / "t")]
        runs = [serve_run(argv) for argv in ([], hooks_on, hooks_on, [])]
        same = all(streams(r[1]) == streams(runs[0][1]) for r in runs)
        prom = (work / "m" / "metrics.prom").read_text()
        trace = json.loads(Path(runs[2][0]["trace_file"]).read_text())
        requests = sum(1 for e in trace["traceEvents"] if e.get("name") == "serve.request")
        if not same or requests != 32 or "apex_serve_ttft_seconds_count" not in prom:
            raise AssertionError(f"serve hooks: streams equal {same}, {requests} request "
                                 f"spans")
        tps = [r[0]["tokens_per_sec"] for r in runs]
        hooks = {"runs": [{"hooks": bool(i in (1, 2)),
                           **{k: r[0][k] for k in SERVE_AB_KEYS if k in r[0]}}
                          for i, r in enumerate(runs)],
                 "streams_equal": same, "request_spans": requests,
                 "tokens_per_sec_off": (tps[0] + tps[3]) / 2,
                 "tokens_per_sec_on": (tps[1] + tps[2]) / 2}
        hooks["cost_share"] = 1 - hooks["tokens_per_sec_on"] / hooks["tokens_per_sec_off"]
        del runs
        script = work / "faults.json"
        script.write_text(json.dumps({"0": {"args": ["--chaos-wedge-decode-step", "20",
                                                     "--chaos-wedge-secs", "120"]}}))
        cmd = [sys.executable, "-m", "apex_tpu_torch.serve_gpt", "--watchdog-secs", "5",
               "--supervise", "--fault-script", str(script), "--backoff-base", "1"]
        rc, lines, errs, wall = _child(cmd, 400)
        restarts = _events(errs, "supervisor.restarting")
        wedged = _events(errs, "serve.step_wedged")
        report = next((json.loads(ln) for ln in reversed(lines)
                       if ln.startswith('{"requests"')), None)
        if rc != 0 or len(restarts) != 1 or restarts[0]["exit_code"] != 75 \
                or len(wedged) != 1 or report is None:
            raise AssertionError(f"supervised serve: rc {rc}, restarts {restarts}, "
                                 f"{len(wedged)} wedges:\n" + "\n".join(errs[-40:]))
        w = wedged[0]
        named = sorted(w["queued_rids"] + w["inflight_rids"])
        if named != list(range(32)) or w["inflight"] != 8 or report["requests"] != 32 \
                or report["generated_tokens"] != 32 * 32:
            raise AssertionError(f"wedge manifest {w['queued']} queued + {w['inflight']} in "
                                 f"flight; then served {report['requests']}")
        out = {"phase": "serve_resilience", "hooks": hooks,
               "wedge": {"argv": cmd[3:], "exit_code": restarts[0]["exit_code"],
                         "decode_step": w["decode_step"], "queued": w["queued"],
                         "inflight": w["inflight"],
                         "emitted_in_flight": sum(len(m["emitted"]) for m in w["manifest"])},
               "supervised": {"rc": rc, "restarts": len(restarts),
                              "backoffs_s": [r["delay_s"] for r in restarts],
                              "requests": report["requests"],
                              "tokens_per_sec": report["tokens_per_sec"], "wall_s": wall},
               "nvidia_smi": smi}
        emit(out)
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def fleet_phase(smi):
    """The twin of bench.py's fleet row (``bench.py:1445-1502``): two
    :class:`~apex_tpu_torch.inference.fleet.LocalReplica` s of GPT-124M
    (fp32, T = 0, 8 slots each) share this card behind a
    ``FleetFrontend``; 16 requests of 32..64 prompt tokens and 32 new
    ones; replica r0 is killed at its step 3 (``kill_replica_at``, the
    exit-137 shape: its requests replay from the frontend's journal).
    No request dropped or duplicated, every stream bitwise the unkilled
    single-replica run's (the same scheduler shape alone), one death,
    a replay or more; the LN, decode attention and sampling launches of
    every scheduler the fleet built (r0 twice) exactly
    :func:`serve_expect`'s, and the single run's too.  Reports the
    fleet's tokens/s and the longest stall a replayed stream saw."""
    from apex_tpu_torch.inference import (
        ContinuousBatchingScheduler, DecodeConfig, KVCacheConfig, Request, pages_needed,
    )
    from apex_tpu_torch.inference.fleet import FleetFrontend, LocalReplica, RouterConfig
    from apex_tpu_torch.models.gpt import GPTConfig, init_params
    from apex_tpu_torch.resilience.chaos import ChaosMonkey, ChaosPlan

    dev = torch.device("cuda", 0)
    n, prompt_len, max_new, page, L = 8, 64, 32, 16, 12
    config = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=L, num_attention_heads=12,
                       max_seq_len=prompt_len + 2 * max_new + 1,
                       position_embedding_type="rope", compute_dtype=torch.float32,
                       checkpoint_layers=False)
    params = init_params(config, 0, device=dev)
    per = pages_needed(prompt_len + 2 * max_new, page)
    built = []

    def make():
        # max_prompt_len covers a continuation leg's prompt (the original
        # prompt and the tokens already emitted)
        dcfg = DecodeConfig(
            cache=KVCacheConfig(num_pages=1 + n * per, page_size=page, pages_per_seq=per,
                                dtype=torch.float32),
            max_batch=n, max_prompt_len=prompt_len + max_new, temperature=0.0, top_k=0,
            base_seed=0)
        built.append(ContinuousBatchingScheduler(params, config, dcfg, device=dev))
        return built[-1]

    def expect(scheds):
        tot = {}
        for sc in scheds:
            for k, v in serve_expect(sc.stats, L, False).items():
                tot[k] = tot.get(k, 0) + v
        return tot

    rng = np.random.RandomState(0)
    reqs = [(rid, rng.randint(0, 50304, size=int(rng.randint(prompt_len // 2, prompt_len + 1)))
             .tolist()) for rid in range(2 * n)]
    reset_counts()
    single = make()
    for rid, prompt in reqs:
        single.submit(Request(rid, list(prompt), max_new))
    want = {c.rid: list(c.tokens) for c in single.run_until_drained()}
    if launch_counts() != expect([single]):
        raise AssertionError(f"fleet baseline counts {launch_counts()} != {expect([single])}")
    reset_counts()
    monkey = ChaosMonkey(ChaosPlan.make(kill_replica_at={"r0": 3}))
    with monkey.active():
        fe = FleetFrontend([LocalReplica(f"r{i}", make) for i in range(2)],
                           config=RouterConfig(hedge_after_s=0.0,
                                               be_shed_queue_depth=10 ** 6,
                                               reject_queue_depth=10 ** 6,
                                               affinity_min_tokens=10 ** 6)).start()
        t0 = time.perf_counter()
        for rid, prompt in reqs:
            fe.submit(Request(rid, list(prompt), max_new))
        done = fe.run_until_drained()
        wall = time.perf_counter() - t0
    counts, want_counts = launch_counts(), expect(built[1:])
    rids = [c.rid for c in done]
    got = {c.rid: list(c.tokens) for c in done}
    if sorted(rids) != sorted(want) or len(rids) != len(set(rids)) or got != want \
            or fe.stats["replica_deaths"] != 1 or fe.stats["replays"] < 1 \
            or monkey.injected.get("kill_replica:r0") != 1 or len(built) != 4:
        raise AssertionError(f"fleet: {len(rids)} completions ({len(set(rids))} distinct) of "
                             f"{len(want)}, streams equal {got == want}, stats {fe.stats}")
    if counts != want_counts:
        raise AssertionError(f"fleet launch counts {counts} != {want_counts}")
    stalls = [float(np.max(np.diff(c.token_times))) for c in done
              if c.replays and len(c.token_times) > 1]
    out = {"phase": "fleet", "replicas": 2, "requests": len(done), "dropped": 0,
           "duplicates": 0, "bitwise_vs_single": True, "stats": dict(fe.stats),
           "replayed_requests": sum(1 for c in done if c.replays),
           "tokens_per_sec": sum(len(c.tokens) for c in done) / wall, "wall_s": wall,
           "max_replay_stall_ms": 1e3 * max(stalls) if stalls else None,
           "launches": counts, "nvidia_smi": smi}
    emit(out)
    del fe, built, single, params
    torch.cuda.empty_cache()
    return out


#: one process of :func:`serve_hooks_main`, run with the checkout under
#: test as its working directory (so that it imports that checkout's
#: package): ``argv[1]`` is a JSON list of variants, each "default"
#: (``serve_gpt.run`` at its defaults, the serve phase's run) or a list of
#: the hooks to install around the scheduler alone ("metrics", "tracer",
#: "recorder", "anomaly"; [] is none).  Each run prints one line.
SERVE_HOOKS_CHILD = r"""
import hashlib, json, sys, tempfile, time
import numpy as np
from apex_tpu_torch import serve_gpt

def hooked(hooks):
    from apex_tpu_torch.inference import ContinuousBatchingScheduler
    from apex_tpu_torch.observability import AnomalyMonitor, MetricsScope, flightrec, tracing
    from apex_tpu_torch.ops import _build
    args = serve_gpt.build_args().parse_args([])
    config, params, dcfg = serve_gpt.setup(args)
    _build.load()
    tracer = tracing.configure() if "tracer" in hooks else None
    rec = None
    if "recorder" in hooks:
        rec = flightrec.install(flightrec.FlightRecorder(tempfile.mkdtemp(), run_id="serve"))
        if tracer is not None:
            rec.attach(tracer)
    try:
        with MetricsScope():
            sched = ContinuousBatchingScheduler(
                params, config, dcfg, device="cuda", metrics="metrics" in hooks,
                anomaly=AnomalyMonitor() if "anomaly" in hooks else None)
            reqs, arrivals = serve_gpt.make_requests(args, np.random.RandomState(args.seed))
            t0 = time.monotonic()
            done = serve_gpt.serve(sched, reqs, arrivals)
            wall = time.monotonic() - t0
    finally:
        if rec is not None:
            flightrec.uninstall()
        if tracer is not None:
            tracing.disable()
    out = serve_gpt.report(done, wall)
    out["capture_ms"] = 1e3 * sched.capture_seconds
    return out, sched

for variant in json.loads(sys.argv[1]):
    if variant == "default":
        out, sched = serve_gpt.run(serve_gpt.build_args().parse_args([]))[:2]
        out["capture_ms"] = 1e3 * sched.capture_seconds
    else:
        out, sched = hooked(variant)
    streams = sorted((c.rid, c.tokens) for c in sched.completed)
    steps = sched.stats["decode_steps"]
    print(json.dumps({"serve_hooks_run": {
        "variant": variant, "tokens_per_sec": out["tokens_per_sec"],
        "wall_secs": out["wall_secs"], "capture_ms": out["capture_ms"],
        "decode_steps": steps, "prefills": sched.stats["prefills"],
        "ms_per_decode_step": (1e3 * out["wall_secs"] - out["capture_ms"]) / steps,
        "per_token_p50_ms": out["per_token_p50_ms"],
        "streams": hashlib.sha256(repr(streams).encode()).hexdigest()[:16]}}), flush=True)
"""


def serve_hooks_main(argv):
    """``chip_smoke.py serve_hooks [--tree NAME=DIR ...] [--pairs P]``: the
    serving hooks' cost on one card.  Each ``--tree`` is another checkout
    of the repo (an unpacked ``git archive``); this checkout is ``this``.
    Every tree's kernels are built, then ``serve_gpt`` at its defaults
    (the serve phase's run: GPT-124M, 32 requests of 32 new tokens,
    graphed) runs in ``P`` pairs of processes for each other tree, that
    tree and this one, which goes first alternating; a process makes one
    warm-up and five timed runs.  A pair is won by the process with the
    lower median ``ms_per_decode_step`` (a run's wall less its graph
    captures, over its decode steps).  Then, on this tree, one process
    runs the scheduler with each hook alone and all together, five rounds
    of every variant in turn: the cost of each.  Every run's streams must
    be equal.  Prints each run, then a summary (medians and quartiles of
    the runs, the pairs won) with the card."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--pairs", type=int, default=8)
    a = ap.parse_args(argv)
    trees = [(n, str((ROOT / d).resolve())) for n, d in (t.split("=", 1) for t in a.tree)]
    smi = _smi()
    emit({"phase": "card", "torch": torch.__version__, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})
    this = ("this", str(ROOT))
    for name, path in trees + [this]:
        t0 = time.monotonic()
        subprocess.run([sys.executable, "-c", "from apex_tpu_torch.ops import _build; "
                        "_build.build(force=True)"], cwd=path, check=True, timeout=600)
        emit({"serve_hooks_build": name, "seconds": time.monotonic() - t0})

    def child(name, path, variants):
        res = subprocess.run([sys.executable, "-c", SERVE_HOOKS_CHILD, json.dumps(variants)],
                             cwd=path, capture_output=True, text=True, timeout=600)
        runs = [json.loads(ln)["serve_hooks_run"] for ln in res.stdout.splitlines()
                if ln.startswith('{"serve_hooks_run"')]
        if res.returncode != 0 or len(runs) != len(variants):
            raise AssertionError(f"serve_hooks in {path}: exit {res.returncode}\n"
                                 + res.stderr[-3000:])
        for r in runs[1:]:  # the first is the warm-up
            emit({"serve_hooks": {"tree": name, **r}})
        return runs[1:]

    def med(rs):
        return float(np.median([r["ms_per_decode_step"] for r in rs]))

    runs = {name: [] for name, _ in trees + [this]}
    pairs = {name: {"this_won": 0, "lost": 0} for name, _ in trees}
    for i in range(a.pairs):
        for other in trees:
            got = {}
            for name, path in ((other, this) if i % 2 == 0 else (this, other)):
                got[name] = child(name, path, ["default"] * 6)
                runs[name] += got[name]
            pairs[other[0]]["this_won" if med(got["this"]) < med(got[other[0]]) else "lost"] += 1
    variants = [[], ["metrics"], ["tracer"], ["tracer", "recorder"], ["anomaly"],
                ["metrics", "tracer", "recorder", "anomaly"]]
    for r in child("this", str(ROOT), [[]] + variants * 5):
        runs.setdefault("hooks:" + ("+".join(r["variant"]) or "none"), []).append(r)
    digests = {r["streams"] for rs in runs.values() for r in rs}
    if len(digests) != 1:
        raise AssertionError(f"serve_hooks: the streams differ across runs: {digests}")

    def stats(rs):
        ms = np.asarray([r["ms_per_decode_step"] for r in rs])
        return {"ms_per_decode_step_median": float(np.median(ms)),
                "ms_per_decode_step_quartiles": [float(np.percentile(ms, 25)),
                                                 float(np.percentile(ms, 75))],
                "tokens_per_sec_median": float(np.median([r["tokens_per_sec"] for r in rs])),
                "per_token_p50_ms_median": float(np.median([r["per_token_p50_ms"]
                                                             for r in rs])),
                "runs": len(rs)}

    emit({"phase": "serve_hooks", "streams_equal": True, "pairs": pairs,
          "summary": {k: stats(rs) for k, rs in runs.items()}, "nvidia_smi": smi})
    return 0


def resilience_main():
    """``chip_smoke.py resilience``: the kernels built, then the
    supervised, serve_resilience and fleet phases alone on one card."""
    from apex_tpu_torch.ops import _build

    smi = _smi()
    emit({"phase": "card", "torch": torch.__version__, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})
    secs = _build.build(force=True)
    _build.load()
    seconds = {"build": secs}
    for name, fn in (("supervised", supervised_phase),
                     ("serve_resilience", serve_resilience_phase), ("fleet", fleet_phase)):
        t0 = time.monotonic()
        fn(smi)
        seconds[name] = time.monotonic() - t0
    emit({"phase": "seconds", **seconds})
    return 0


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
    if sys.argv[1:2] == ["tp_child"]:
        return tp_child(sys.argv[2:])
    if sys.argv[1:2] == ["pp_child"]:
        return pp_child(sys.argv[2:])
    if sys.argv[1:2] == ["vpp_child"]:
        return vpp_child(sys.argv[2:])
    if sys.argv[1:2] == ["pp_multi_card"]:
        return pp_multi_card_main()
    if sys.argv[1:2] == ["resilience"]:
        return resilience_main()
    if sys.argv[1:2] == ["serve_hooks"]:
        return serve_hooks_main(sys.argv[2:])

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a run that stalls ends, with every thread's stack on stderr, inside
    # the 1200 s it is given
    STALL.start()
    smi = _smi()
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
    # rows: the decode step (8), the verify step (8 x 5), the chunked
    # prefill's sampling head (1) and a full 64-row pass; widths: GPT-124M's
    # and the two past the earlier 1504 limit (timed at T = 1 alone)
    for H in (768, 1600, 2048):
        for N in (8, 40, 1, 64):
            for temperature, top_k in ((0.0, 0), (1.0, 0), (1.0, 50)):
                r = check_sampling(dev, temperature, top_k, N, H,
                                   timed=H == 768 or (temperature, top_k) == (1.0, 0))
                results[("sample", temperature, top_k, N) + ((H,) if H != 768 else ())] = r
                emit({"phase": "kernel", "kernel": "fused_sample", **r})
    _SAMPLE_EMBEDS.clear()
    emit({"phase": "kernel", "kernel": "fused_sample_plan",
          **check_sample_plan(_build.load(), tuple(sorted(
              {132, torch.cuda.get_device_properties(dev).multi_processor_count})))})

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
    emit({"phase": "kernel", "kernel": "ce_plan", **check_ce_plan(_build.load())})
    for case, dtype, kw in flash_cases:
        r = check_flash(dev, dtype, case, **kw)
        results[("flash", case, dtype)] = r
        for name in ("fwd", "dq", "dkv"):
            emit({"phase": "kernel", **r[name]})
    fp16_kernels(dev, results)
    mt_kernels(dev, results, _build.load())
    lap("kernels")
    amp_counts = optimizers_phase(dev)
    lap("optimizers")

    counts, _, params, config = serve_phase()
    lap("serve")
    parity_phase()
    lap("parity")
    profile_phase(params, config)
    profile_phase(params, config, eager=True)
    lap("profile")
    del params
    v2_counts, params, config = serve_v2_phase()
    lap("serve_v2")
    serve_v2_profile_phase(params, config)
    serve_v2_profile_phase(params, config, eager=True)
    lap("serve_v2_profile")
    del params
    serve_streams_phase()
    lap("serve_streams")
    graph_replay_phase()
    lap("graph_replay")
    serve_v2_parity_phase()
    lap("serve_v2_parity")
    train_args, train_counts, dense = train_phase()
    dense_eager = train_phase(eager=True)[2]
    train_ab("train", dense, dense_eager)
    optimizer_ab("train", dense, train_phase(per_leaf=True)[2])
    lap("train")
    fce_args, fce_counts, fused = train_phase(fused=True, dense_report=dense)
    fused_eager = train_phase(fused=True, dense_report=dense_eager, eager=True)[2]
    train_ab("train_fce", fused, fused_eager)
    optimizer_ab("train_fce", fused,
                 train_phase(fused=True, dense_report=dense, per_leaf=True)[2])
    lap("train_fce")
    _, fp16_counts, fp16 = train_phase(fp16=True, dense_report=dense)
    train_ab("train_fp16", fp16, train_phase(fp16=True, dense_report=dense_eager,
                                             eager=True)[2])
    lap("train_fp16")
    amp_overflow_phase()
    lap("amp_overflow")
    train_reproducible_phase(dev)
    lap("train_reproducible")
    flash_grad_parity_phase(dev)
    lap("flash_grad_parity")
    fused_ce_grad_parity_phase(dev)
    lap("fused_ce_grad_parity")
    norm_modules_phase(dev)
    lap("norm_modules")
    train_parity_phase()
    train_fp16_parity_phase()
    lap("train_parity")
    train_profile_phase(train_args, dense["step_ms_median"])
    train_profile_phase(train_args, dense_eager["step_ms_median"], eager=True)
    train_profile_phase(fce_args, fused["step_ms_median"])
    train_profile_phase(fce_args, fused_eager["step_ms_median"], eager=True)
    train_profile_phase(train_args, dense["step_ms_median"], per_leaf=True)
    optimizer_profile_phase(train_args)
    lap("train_profile")
    full = pretrain_phase(smi)
    lap("pretrain")
    remainder_launches = zero_phase(smi, full)
    lap("zero")
    absent = tp_phase(smi)
    lap("tp")
    pp_phase(smi, absent)
    lap("pp")
    supervised_phase(smi)
    lap("supervised")
    serve_resilience_phase(smi)
    lap("serve_resilience")
    fleet_phase(smi)
    lap("fleet")
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
        # no Pallas twin: these replace XLA fusions of the JAX engine
        ("mt_adam", "apex_tpu_torch/csrc/multi_tensor.cu",
         "apex_tpu/optimizers/fused_adam.py:163 (XLA fusion)", results[("mt_adam", "adamw")]),
        ("mt_scale", "apex_tpu_torch/csrc/multi_tensor.cu",
         "apex_tpu/ops/multi_tensor.py:59 (XLA fusion)", results[("mt_scale", "unscale")]),
        ("mt_l2norm", "apex_tpu_torch/csrc/multi_tensor.cu",
         "apex_tpu/ops/multi_tensor.py:90 (XLA fusion)", results[("mt_l2norm", "gpt124")]),
        ("mt_adam_remainder", "apex_tpu_torch/csrc/multi_tensor.cu",
         "apex_tpu/contrib/optimizers/distributed_fused_adam.py:200 (XLA fusion)",
         results[("mt_adam_remainder",)]),
        # the fp16 instantiations (the amp train step's); the reference runs
        # XLA composites at fp16 (the jnp LayerNorm, the flash scan)
        ("layer_norm_fwd_fp16", "apex_tpu_torch/csrc/layer_norm.cu",
         "apex_tpu/ops/layer_norm_pallas.py:39", results[("ln", 8192, torch.float16)]),
        ("layer_norm_bwd_fp16", "apex_tpu_torch/csrc/layer_norm.cu",
         "apex_tpu/ops/layer_norm_pallas.py:108", results[("ln_bwd", torch.float16)]),
        ("flash_fwd_fp16", "apex_tpu_torch/csrc/flash_attention.cu",
         "apex_tpu/ops/flash_attention_pallas.py:145",
         results[("flash", "gpt124", torch.float16)]["fwd"]),
        ("flash_dq_fp16", "apex_tpu_torch/csrc/flash_attention.cu",
         "apex_tpu/ops/flash_attention_pallas.py:339",
         results[("flash", "gpt124", torch.float16)]["dq"]),
        ("flash_dkv_fp16", "apex_tpu_torch/csrc/flash_attention.cu",
         "apex_tpu/ops/flash_attention_pallas.py:394",
         results[("flash", "gpt124", torch.float16)]["dkv"]),
    )
    # launches: the serve phase's for the serving kernels, the serve_v2
    # phase's for the width > 1 layout, the train phase's for the
    # training kernels, the train_fce phase's for the CE kernels
    # (LayerNorm forward and sampling run in several; their lines keep
    # the serve phase's counts); mt_adam the train phase's, mt_scale and
    # mt_l2norm the optimizers phase's amp steps; the fp16 instantiations
    # the train_fp16 phase's; mt_adam_remainder the zero phase's
    # zero_param_remainders replays
    launches = {**train_counts, **amp_counts, "mt_adam": train_counts["mt_adam"],
                "mt_adam_remainder": remainder_launches,
                **{k: counts[k] for k in
                                   ("layer_norm_fwd", "paged_decode_attention",
                                    "fused_sample")},
                "paged_decode_attention_wide": v2_counts["paged_decode_attention_wide"],
                **{k: fce_counts[k] for k in ("ce_fwd", "ce_dx", "ce_dembed")},
                **{f"{k}_fp16": fp16_counts[k] for k in (
                    "layer_norm_fwd", "layer_norm_bwd", "flash_fwd", "flash_dq", "flash_dkv")}}
    unlaunched = [name for name, *_ in main_path if not launches[name]]
    if unlaunched:
        raise AssertionError(f"kernels the main path never launched: {unlaunched}")
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
