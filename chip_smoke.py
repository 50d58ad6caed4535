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
   keys), bf16 at D = 16, 48, 80, 96 and 112 (B = 2), and bf16 at the
   gpt124_s4096 cell's shape (B = 2, S = 4096, with SDPA's time), bf16
   at the bert phase's (B 16, H 16, S 512, D 64, non-causal, a key mask of
   the batch's lengths, with SDPA's time under the boolean mask); the
   ring-chunk mode (bf16 q, k, v; fp32 out; fp32 do; fp32 dq, dk, dv:
   ring attention's chunk kernels) at B 2, H 12, D 64, S = Sk 1024 and
   2048, diagonal (causal) and full, and the diagonal S 4096 chunk, out,
   dq and dk in the bf16 band, dv within 1e-4 and a control (dkv fed do
   rounded to bf16) that must miss it, with SDPA's time; the bf16
   backward's shared memory (and the ring-chunk mode's) as
   ``bwd_launch_plan`` states it against the C entry's at every head
   dim.  The float16 instantiations (the
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
   T = 0 and T = 1, 16 requests each, graphed and eager: equal streams,
   exact counts.
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
8c. train_s4096: bench.py's ``gpt124_s4096`` cell (``train_gpt --seq
   4096 --batch 2``), the dense head and ``--fused-ce``, graphed (1
   warm-up, 5 replays) and eager (3 steps): exact launch counts (flash
   forward 24, dq 12, dkv 12 a step at S 4096; the CE kernels once a
   step at N 8192), CUDA-event step ms, peak memory, graphed = eager.
8f. cp: context parallelism over one-rank NCCL groups (cp 1: one chunk,
   the diagonal one): bench.py's ``ring_attn_cp`` at (2, 12, 4096, 64)
   bf16, serial against overlapped, fwd+bwd bitwise and ms each;
   ``make_train_step(cp_group=)`` at ``gpt124_s4096``, both heads,
   graphed (6 steps) and eager (3): exact launch counts (ring-mode
   forward 24, dq 12, dkv 12 a step, no dense flash launch), graphed =
   eager, the first loss within 1e-5 relative of train_s4096's and
   every step within 1e-3, step ms and peak memory.  ``python3
   chip_smoke.py cp_multi_card`` (four cards; also in ``multi_card``):
   ``ring_attn_cp`` at cp 4 and 2 (bitwise, ms), then GPT-124M at S 4096
   at cp 4 (profiled: NCCL and exposed NCCL ms, idle share and the ring
   kernels' ms a rank), cp 4 with the overlapped ring (bitwise the
   serial one, graphed), cp 2 x dp 2 with ZeRO, cp 2 x tp 2 and pp 2 x
   cp 2, each within 1e-3 of cp 1's losses, step ms and peak a rank.
8g. moe: mixture of experts at train_gpt's GPT-124M step (S 1024, batch
   8, bf16, flash, full remat, FusedAdam) with 8 experts, top 2,
   capacity 1.25 and aux 0.01 in every FFN (about 521 M params), on this
   card alone (every expert local): ``make_train_step`` with the dense
   head and the fused CE, graphed (10 steps) and eager (3): graphed =
   eager bitwise, exact launches a step (LayerNorm 49 / 25, flash 24 /
   12 / 12, CE 1 / 1 / 1 with the fused head, ``mt_plan``'s
   ``mt_adam``), losses finite and falling, ms a step and peak memory
   beside train_fce's; the MoE layer's parts timed forward and backward
   (router, route, dispatch, experts, combine); an fp32 layer of 1024
   tokens on the card against the CPU (out, aux and every grad within
   1e-5 of the largest, the routing equal).  ``python3 chip_smoke.py
   moe`` runs it alone.  ``python3 chip_smoke.py moe_multi_card`` (four
   cards; also in ``multi_card``): the experts over the dp group at ep 4
   (dp 4), dp 2 x tp 2 and pp 2 x dp 2 (2 microbatches), each at ample
   capacity without aux -- the first loss within 1e-4 of the one-card
   run's -- and at the defaults, timed (ms a step, peak a rank), the
   ``all_to_all`` exchanges exactly 6 a layer a microbatch a step (2
   forward, 2 in the remat's recompute, 2 backward), and the layer's
   parts at ep 4, the two exchanges with them.  ``python3 chip_smoke.py
   tp_decode_multi_card`` (two cards; also in ``multi_card``): GPT-124M
   in fp32 at tp 2, 4 prompts of 64 tokens prefilled through
   ``gpt_forward(return_kv=True)`` and 32 greedy ``forward_decode``
   steps on each rank's kv heads: every step's logits within 1e-4 of tp
   1's, the tokens equal, 12 paged decode attention launches a step on
   each rank, ms a decode step at tp 1 and 2.
8h. bert: bench.py's ``bert_base_lamb`` (BERT-Large: 24 layers, hidden
   1024, 16 heads, S 512, batch 16, vocab 30528, bf16, full remat,
   FusedLAMB(1e-3, wd 0.01); key lengths S/2..S, 15 % of the valid
   positions predicted) through ``models.bert.make_train_step``, the
   dense head and the fused CE, each graphed and eager for 10 steps:
   graphed = eager bitwise, exact launches a step (LayerNorm 98 / 50,
   flash 48 / 24 / 24, CE 1 / 1 / 1 with the fused head), losses finite
   and falling, ms a step, tokens/s, peak; the FusedLAMB update alone
   (its share of the step); an fp32 BERT of 2 layers at the same widths
   on the card against the CPU (logits, loss, grads within 1e-5).  The
   kernels phase holds the flash kernels at its attention (``bert_large``:
   (16, 16, 512, 64), non-causal, the batch's key mask) with SDPA's time.
   ``python3 chip_smoke.py bert`` runs it alone.
8i. resnet: bench.py's ``resnet50_b64`` (ResNet-50, one batch of 64 at
   224, FusedSGD(0.1, momentum 0.9, wd 1e-4) with master weights) under
   amp O2 through the ImageNet trainer's step, graphed and eager with
   cuDNN's deterministic algorithms: losses, params, optimizer state and
   running statistics bitwise equal, no hand-written kernel launched,
   losses finite and falling, ms a step, images/s, peak; graphed again
   under the trainer's cuDNN settings (PyTorch's defaults), timed; an fp32
   ResNet18ish at 32 x 32 on the card against the CPU (1e-4); ``python -m
   apex_tpu_torch.imagenet_main_amp --steps 3 --batch-size 64
   --checkpoint``, then ``--resume`` going on at ``step 3``.  ``python3
   chip_smoke.py resnet`` runs it alone.  ``python3 chip_smoke.py
   models_multi_card`` (two cards; also in ``multi_card``): ResNet-50 at
   dp 2 with SyncBN over NCCL (32 rows a rank) against one card at 64
   (fp32 at 64 x 64, the last batch norm of every bottleneck
   zero-scaled: loss, running statistics and every grad within 1e-4, as
   is one card's own spread when it reorders its batch (printed at 224
   too), and the same step with SyncBN's cotangents left unsummed
   outside it; bf16 under amp O2 at 224, timed), SyncBN over 24 + 40
   rows against the full batch, BERT at tp 2 (the fp32 4-layer loss within 1e-4 of tp 1's;
   BERT-Large bf16, timed, launches exact).
8d. inplace_ab: the train_fce step with the donated update (FusedAdam's
   ``mt_adam`` writing the params and state it reads) against the
   copying step (``inplace_update=False``), graphed in turns (copy, in
   place, in place, copy) and eager: losses, params and state bitwise,
   the step ms of each.
8e. attn_bias: ``flash_attention(attn_bias=)`` at (B 1, H 4, S 256, D
   32) against a dense softmax with the bias, out and the bias's
   cotangent; the biased call launches no flash kernel, the unbiased
   one each once.
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
15a. remat_dots: ``pretrain_gpt`` at the pretrain shape for 10 steps
    with ``--remat-policy full`` and ``dots``: losses within 1e-6
    relative (bitwise printed), step ms and peak memory of each.
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
19-21 run under ``python3 chip_smoke.py resilience``, not in the
no-argument run, which they would take past its time:
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
    ``python3 chip_smoke.py multi_card`` (four cards) runs it, ZeRO
    composed with tp and pp, and the backward-overlapped dp sync
    (``overlap_multi_card``, alone by that name: GPT-345M at dp 4,
    flat ZeRO, the (2, 2) wire, its int8 wire and replicated FusedAdam
    with an int8 sync, each with the overlap on against off, losses and
    params bitwise, step ms, NCCL and exposed NCCL ms, peak memory).
    ``python3 chip_smoke.py step_options`` runs 8c-8e and 15a alone.
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

#: timed calls of a kernel (profiled, and between CUDA events); 10 since
#: PR 25, whose full run on a slow host came within 9 s of STALL_SECONDS
ITERS = 10
#: profiled calls of a plain version's timing: its many small ops make
#: each profiled call's trace long, and its time is a yardstick only
PLAIN_ITERS = 3

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
    Both runs are one profiler session (:func:`_cuda_durations_split`).
    CUDA events around the calls when the profiler records nothing."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    one, many = _cuda_durations_split(fn, iters)
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


def _cuda_durations_split(fn, iters):
    """``({name: [us, ...]} of one call, the same of the next ``iters``
    calls)`` from one profiler session: the single call, a synchronize,
    a host marker, then the ``iters`` calls; an activity belongs to the
    single call when it starts before the marker (every one of its
    kernels ended at the synchronize, and the rest launch after it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function("chip_smoke.device_ms.split"):
            pass
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    split = min(e.time_range.start for e in events if e.name == "chip_smoke.device_ms.split")
    one, many = {}, {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            side = one if e.time_range.start < split else many
            side.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return one, many


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
           "plain_ms": device_ms(plain, PLAIN_ITERS)[0], "library_ms": None}
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
    """The bf16 and fp16 backward's shared memory (and the bf16
    ring-chunk mode's) as ``bwd_launch_plan`` states it (the Python plan
    the CPU tests check) against ``apex_flash_smem``, which the launches
    use, at every head dim: equal."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops.flash_attention import bwd_launch_plan

    n = 0
    for which in (1, 2):
        for D in range(16, 129, 16):
            for dtype in (torch.bfloat16, torch.float16):
                for ring in ((False, True) if dtype == torch.bfloat16 else (False,)):
                    got = lib.apex_flash_smem(which, D, _build.DTYPE_CODES[dtype], int(ring))
                    want = bwd_launch_plan(which, 1024, 1024, D, True, ring=ring).smem_bytes
                    if got != want:
                        raise AssertionError(f"flash backward plan which={which} D={D} "
                                             f"{dtype} ring={ring}: C {got} B, Python "
                                             f"{want} B")
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
                q_offset=0, k_offset=0, masked=False, library=False, Sk=None,
                lengths=None):
    """flash_fwd, flash_dq and flash_dkv against their plain versions on
    one input (S q rows, Sk keys, Sk = S by default); the backward
    kernels and plain versions get the kernel's lse and delta, so each
    kernel is held on its own.  ``lengths`` (B valid keys a row, the
    rest padded): a key-padding mask as BERT's, whose valid pairs the
    bound counts, and SDPA with the boolean mask as the library call."""
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops.attention import padding_bias

    rng = np.random.default_rng(S + Hkv)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)

    Sk = Sk or S
    q, do = randn(B * H, S, D), randn(B * H, S, D)
    k, v = randn(B * Hkv, Sk, D), randn(B * Hkv, Sk, D)
    bias = valid = None
    if masked:  # batch row b keeps its first Sk - 100 * b keys
        valid = (torch.arange(Sk, device=dev)[None, :]
                 < (Sk - 100 * torch.arange(B, device=dev))[:, None])
    if lengths is not None:
        valid = (torch.arange(Sk, device=dev)[None, :]
                 < torch.as_tensor(lengths, device=dev)[:, None])
    if valid is not None:
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
    if lengths is not None:  # the valid pairs this run's mask leaves, a (b, h) mean
        pairs = S * float(np.mean(lengths))
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
        q4, k4, v4 = (t.view(B, -1, n, D).detach().requires_grad_()
                      for t, n in ((q, S), (k, Sk), (v, Sk)))
        mask = None if lengths is None else valid[:, None, None, :]
        o4 = sdpa(q4, k4, v4, attn_mask=mask, is_causal=causal)
        do4 = do.view(B, H, S, D)
        lib = {"fwd": lambda: sdpa(q4, k4, v4, attn_mask=mask, is_causal=causal),
               "bwd": lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)}
    t = {"fwd": timings(lambda: fa.flash_fwd(*fwd_args, **kw),
                        lambda: fa.flash_fwd_plain(*fwd_args, **kw), lib["fwd"]),
         "dq": timings(lambda: fa.flash_dq(*bwd_args, **kw),
                       lambda: fa.flash_dq_plain(*bwd_args, **kw), lib["bwd"]),
         "dkv": timings(lambda: fa.flash_dkv(*bwd_args, **kw),
                        lambda: fa.flash_dkv_plain(*bwd_args, **kw), lib["bwd"])}
    base = {"case": case, "B": B, "H": H, "H_kv": Hkv, "S": S, "Sk": Sk, "D": D,
            "causal": causal,
            "q_offset": q_offset, "k_offset": k_offset,
            "kv_bias": masked or lengths is not None,
            "key_lengths": None if lengths is None else [int(n) for n in lengths],
            "dtype": str(dtype).replace("torch.", ""), "fully_masked_rows": dead_rows,
            "rel_errors": errs, "abs_errors": abs_errs, "tolerance": tol,
            "tolerance_why": why}
    outputs = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}
    return {name: {**base, "kernel": f"flash_{name}",
                   "max_abs_err": max(abs_errs[n] for n in outputs[name]),
                   "bound_ms": bounds[name][0], "bound_by": bounds[name][1], **t[name]}
            for name in outputs}


#: the ring-chunk mode's chunks: (case, S, causal) at B 2, H 12, D 64 --
#: the diagonal chunk and a full one at S / cp of bench.py's ring_attn_cp
#: shape (S 4096) for cp 4 and 2, and the cp phase's (cp 1)
FLASH_RING_CASES = (("ring_diag_s1024", 1024, True), ("ring_full_s1024", 1024, False),
                    ("ring_diag_s2048", 2048, True), ("ring_full_s2048", 2048, False),
                    # the cp phase's one chunk at cp 1 (the whole S 4096)
                    ("ring_diag_s4096", 4096, True))


def check_flash_ring(dev, case, S, causal, B=2, H=12, D=64, library=True):
    """The ring-chunk mode of flash_fwd, flash_dq and flash_dkv (bf16 q,
    k, v; fp32 out; fp32 do; fp32 dq, dk, dv) against their plain
    versions on one chunk pair at zero offsets (Sq = Sk = S, the diagonal
    chunk causal, a full one not), the backward fed the kernel's lse and
    delta.  Bands: out, dq, dk within ``FLASH_TOL_BF16`` (p rounded to
    bf16 for p.v and ds for ds.k and ds^T.q, as the Pallas kernels do);
    dv within ``FLASH_TOL_FP32["dv"]`` (its p and do at fp32 grade); lse
    ``FLASH_TOL_BF16["lse"]``.  Control: dkv fed do rounded to bf16 must
    miss dv's band, so the band sees a bf16 cotangent.  Times beside the
    plain versions and SDPA's on the same chunk (bf16 out)."""
    from apex_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(S + int(causal))

    def randn(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)

    q, k, v = (randn(B * H, S, D) for _ in range(3))
    do = randn(B * H, S, D, dtype=torch.float32)
    scale, f32 = 1.0 / math.sqrt(D), torch.float32
    fwd_args = (q, k, v, scale, causal, 0, 0)
    kw = dict(heads=H, kv_heads=H, out_dtype=f32)
    out, lse = fa.flash_fwd(*fwd_args, **kw)
    pout, plse = fa.flash_fwd_plain(*fwd_args, **kw)
    delta = (do * out).sum(-1, keepdim=True)
    bwd_args = (q, k, v, do, lse, delta, scale, causal, 0, 0)
    dq = fa.flash_dq(*bwd_args, **kw)
    pdq = fa.flash_dq_plain(*bwd_args, **kw)
    dk, dv = fa.flash_dkv(*bwd_args, **kw)
    pdk, pdv = fa.flash_dkv_plain(*bwd_args, **kw)
    do_bf16 = do.to(torch.bfloat16).float()
    _, dv_ctl = fa.flash_dkv(q, k, v, do_bf16, lse, delta, scale, causal, 0, 0, **kw)
    torch.cuda.synchronize()
    outs = {"out": (out, pout), "dq": (dq, pdq), "dk": (dk, pdk), "dv": (dv, pdv)}
    if any(t.dtype != f32 for t in (out, dq, dk, dv)):
        raise AssertionError(f"flash {case}: the ring-chunk mode's outputs are not fp32")
    errs = {n: rel_err(a, b) for n, (a, b) in outs.items()}
    errs["lse"] = float((lse - plse).abs().max())
    abs_errs = {n: float((a - b).abs().max()) for n, (a, b) in outs.items()}
    tol = {"out": FLASH_TOL_BF16["out"], "dq": FLASH_TOL_BF16["dq"],
           "dk": FLASH_TOL_BF16["dk"], "dv": FLASH_TOL_FP32["dv"], "lse": FLASH_TOL_BF16["lse"]}
    control = rel_err(dv_ctl, pdv)
    finite = all(bool(torch.isfinite(t).all()) for t in (out, lse, dq, dk, dv))
    bad = {n: e for n, e in errs.items() if not e <= tol[n]}
    if bad or not finite or not control > tol["dv"]:
        raise AssertionError(f"flash {case}: errors {errs} over {tol} (finite={finite}); "
                             f"the bf16-do control's dv error {control} must exceed "
                             f"{tol['dv']}")
    BH, pairs = B * H, causal_pairs(S, S, causal, 0, 0)
    t16, t32, rb = BH * S * D * 2, BH * S * D * 4, BH * S * 4
    # every product at the bf16 tensor-core rate, the fp32-grade ones
    # (dp and dv) counted once: a lower bound
    bounds = {"fwd": bound(3 * t16 + t32 + rb, 4 * D * pairs * BH, PEAK_BF16),
              "dq": bound(3 * t16 + 2 * t32 + 2 * rb, 6 * D * pairs * BH, PEAK_BF16),
              "dkv": bound(3 * t16 + 3 * t32 + 2 * rb, 8 * D * pairs * BH, PEAK_BF16)}
    lib = {"fwd": None, "bwd": None}
    if library:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        q4, k4, v4 = (t.view(B, H, S, D).detach().requires_grad_() for t in (q, k, v))
        o4 = sdpa(q4, k4, v4, is_causal=causal)
        do4 = do.view(B, H, S, D).to(torch.bfloat16)
        lib = {"fwd": lambda: sdpa(q4, k4, v4, is_causal=causal),
               "bwd": lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)}
    t = {"fwd": timings(lambda: fa.flash_fwd(*fwd_args, **kw),
                        lambda: fa.flash_fwd_plain(*fwd_args, **kw), lib["fwd"]),
         "dq": timings(lambda: fa.flash_dq(*bwd_args, **kw),
                       lambda: fa.flash_dq_plain(*bwd_args, **kw), lib["bwd"]),
         "dkv": timings(lambda: fa.flash_dkv(*bwd_args, **kw),
                        lambda: fa.flash_dkv_plain(*bwd_args, **kw), lib["bwd"])}
    base = {"case": case, "B": B, "H": H, "S": S, "Sk": S, "D": D, "causal": causal,
            "mode": "ring_chunk", "dtype": "bfloat16 in, fp32 do and outputs",
            "rel_errors": errs, "abs_errors": abs_errs, "tolerance": tol,
            "bf16_do_control_dv_rel_error": control,
            "tolerance_why": ("max |kernel - plain| / max |plain|: out, dq, dk see p and "
                              "ds rounded to bf16 (as the Pallas kernels round them), dv "
                              "its p and do at fp32 grade (hi + lo splits); lse abs"),
            "bound_note": "products counted once at the bf16 rate (a lower bound)"}
    outputs = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}
    return {name: {**base, "kernel": f"flash_{name}_ring",
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


#: requests of each serve_streams run (the serve defaults' 32 halved:
#: each slot still serves two requests in turn)
#: 8 since PR 25 (16 before), to keep the full run inside STALL_SECONDS
STREAM_REQUESTS = 8


def serve_streams_phase():
    """Graphed against eager, token for token, at the serve and the
    serving-v2 commands in bf16 and fp32 (compute and KV), T = 0 and
    T = 1, each with exact launch counts (bf16 at T = 1 are the serve
    and serve_v2 phases' own A/B), ``STREAM_REQUESTS`` requests a run."""
    t0 = time.monotonic()
    cases = {}
    for cell, base in (("serve", []), ("serve_v2", SERVE_V2_ARGS)):
        for dtype in ("bfloat16", "float32"):
            for T in ("0", "1"):
                if (dtype, T) == ("bfloat16", "1"):
                    continue
                argv = base + ["--compute-dtype", dtype, "--kv-dtype", dtype,
                               "--temperature", T, "--requests", str(STREAM_REQUESTS)]
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


# ------------------------------------------------------ the step's options
#: bench.py's ``gpt124_s4096`` cell (bench.py:2157-2160): GPT-124M at seq
#: 4096, batch 2 (8192 tokens a step, the gpt124_s1024 cell's)
S4096_ARGV = ["--layers", "12", "--hidden", "768", "--heads", "12", "--seq", "4096",
              "--batch", "2"]
#: the remat_dots phase's band: dots against full remat, relative, if the
#: losses are not bitwise equal (the saved products are the ones full
#: remat recomputes: only another cuBLAS algorithm could move them)
REMAT_TOL = 1e-6
#: the attn_bias check's bands (tests/test_attention.py's): out, then the
#: bias's cotangent, fp32 scan against a dense softmax
ATTN_BIAS_TOL = {"out": (1e-4, 1e-5), "db": (2e-4, 2e-5)}


def _train_expect(args, sizes, n):
    """The launch counts of ``n`` train_gpt steps at ``args``: the
    train phase's per-step counts (full remat: the flash and LayerNorm
    forwards twice a layer), the CE kernels only when the fused head
    runs (``--fused-ce`` and a ``--seq`` its chunk divides)."""
    from apex_tpu_torch.ops.multi_tensor import mt_plan

    L = args.layers
    fused = int(args.fused_ce and args.seq % args.fused_ce_chunk == 0)
    per_step = {"layer_norm_fwd": 4 * L + 1, "layer_norm_bwd": 2 * L + 1,
                "flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
                "ce_fwd": fused, "ce_dx": fused, "ce_dembed": fused,
                "mt_adam": mt_plan("adam", sizes).launches, "mt_scale": 0, "mt_l2norm": 0}
    return per_step, {**{k: v * n for k, v in per_step.items()},
                      "paged_decode_attention": 0, "paged_decode_attention_wide": 0,
                      "fused_sample": 0}


def _train_events(argv, steps, inplace=True, keep=False):
    """``train_gpt``'s step at ``argv`` (its config, seed-0 params and
    batch, FusedAdam on the engine), ``--warmup`` eager steps (the last
    capturing unless ``--eager``) then ``steps`` more, each step's time
    between CUDA events recorded after it; ``inplace`` False takes the
    copying step.  Returns the report (losses, step ms, median past the
    warm-up, peak GB, exact launches checked) and, with ``keep``, the
    params and state."""
    import gc

    from apex_tpu_torch import train_gpt
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    args = train_gpt.build_args().parse_args(argv)
    config, params, tokens, targets = train_gpt.setup(args)
    opt = FusedAdam(lr=args.lr, weight_decay=train_gpt.WEIGHT_DECAY)
    state = opt.init(params)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step = train_gpt.make_train_step(opt, config, graphs=False if args.eager else None,
                                     warmup=args.warmup, inplace_update=inplace)
    n = args.warmup + steps
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    losses = []
    for _ in range(n):
        losses.append(step(params, state, tokens, targets).detach().clone())
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    torch.cuda.synchronize()
    counts = launch_counts()
    per_step, expect = _train_expect(args, [p.numel() for p in tree_leaves(params)], n)
    if counts != expect:
        raise AssertionError(f"train {argv}: launch counts {counts} != expected {expect}")
    losses = [float(x) for x in losses]
    # early steps on the seed's batch can rise: falling is asked of six or more
    if not all(math.isfinite(x) for x in losses) or (n >= 6 and not losses[-1] < losses[0]):
        raise AssertionError(f"train {argv}: losses not finite and falling: {losses}")
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    report = {"losses": losses, "step_ms": step_ms,
              "step_ms_median": float(np.median(step_ms[args.warmup:])),
              "tokens_per_sec": 1e3 * args.batch * args.seq / float(np.median(
                  step_ms[args.warmup:])),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "graphs": getattr(step, "graph", None) is not None, "inplace": inplace,
              "launches_per_step": per_step, "launches": counts}
    if keep:
        return report, params, state
    del step, params, state
    return report


def train_s4096_phase():
    """bench.py's ``gpt124_s4096`` cell through ``train_gpt``: the dense
    head and ``--fused-ce``, graphed (1 warm-up, 5 timed replays) and
    ``--eager`` (3 steps), each with exact launch counts (the flash
    kernels at S 4096: forward 24, dq 12, dkv 12 a step under full
    remat; the CE kernels once a step at N 8192 rows), CUDA-event step
    times, peak memory, and the graphed losses against the eager ones
    (bitwise, or ``TRAIN_AB_TOL``)."""
    t0 = time.monotonic()
    out = {}
    for head in ("dense", "fused_ce"):
        argv = S4096_ARGV + (["--fused-ce"] if head == "fused_ce" else [])
        graphed = _train_events(argv, 5)
        eager = _train_events(argv + ["--eager"], 2)
        if not graphed["graphs"] or eager["graphs"]:
            raise AssertionError(f"train_s4096 {head}: graphed {graphed['graphs']}, eager "
                                 f"{eager['graphs']}")
        gl, el = graphed["losses"][:3], eager["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(gl, el))
        if gl != el and not rel <= TRAIN_AB_TOL:
            raise AssertionError(f"train_s4096 {head}: graphed {gl} against eager {el}")
        out[head] = {"graphed": graphed, "eager": eager, "graphed_eager_bitwise": gl == el,
                     "graphed_eager_max_rel": rel}
    emit({"phase": "train_s4096", "argv": S4096_ARGV, **out,
          "seconds": time.monotonic() - t0})
    return out


def inplace_ab_phase():
    """The donated update against the copying step at the train_fce cell
    (GPT-124M, seq 1024, batch 8, fused CE), graphed, in turns (copy,
    in place, in place, copy; 1 warm-up and 5 timed replays each): the
    losses and every param and Adam state tensor bitwise equal, and the
    step ms of each; then the same pair eager (2 steps), bitwise."""
    from apex_tpu_torch.optimizers.tree import tree_leaves

    t0 = time.monotonic()
    runs, ref = [], None
    for inplace in (False, True, True, False):
        rep, params, state = _train_events(["--fused-ce"], 5, inplace=inplace, keep=True)
        tensors = tree_leaves((params, state))
        if ref is None:
            ref = (rep["losses"], [t.detach().clone() for t in tensors])
        elif rep["losses"] != ref[0] or not all(
                torch.equal(a, b) for a, b in zip(tensors, ref[1], strict=True)):
            raise AssertionError(f"inplace_ab: in place={inplace} not bitwise the first run "
                                 f"(losses {rep['losses']} against {ref[0]})")
        del params, state, tensors
        runs.append({k: rep[k] for k in ("inplace", "step_ms", "step_ms_median",
                                         "peak_memory_gb")})
    del ref
    eager = [_train_events(["--fused-ce", "--eager"], 1, inplace=i)["losses"]
             for i in (False, True)]
    if eager[0] != eager[1]:
        raise AssertionError(f"inplace_ab eager: {eager[1]} against the copying {eager[0]}")
    med = {k: float(np.mean([r["step_ms_median"] for r in runs if r["inplace"] == k]))
           for k in (False, True)}
    emit({"phase": "inplace_ab", "runs": runs, "bitwise": True,
          "step_ms_copy": med[False], "step_ms_inplace": med[True],
          "step_ms_saved": med[False] - med[True], "eager_bitwise": True,
          "seconds": time.monotonic() - t0})


def remat_dots_phase():
    """``pretrain_gpt`` at the pretrain phase's GPT-124M shape (fused CE,
    seq 1024, 8 rows) for 10 steps with ``--remat-policy full`` and then
    ``dots`` (save the no-batch-dims matmul outputs, recompute the rest):
    losses within ``REMAT_TOL`` relative (bitwise printed), each run's
    CUDA-event step ms (median past the first two) and peak memory (dots
    holds six products a layer more)."""
    t0 = time.monotonic()
    out = {}
    for policy in ("full", "dots"):
        torch.cuda.reset_peak_memory_stats()
        rep = _pretrain_here(PRETRAIN_ARGV + ["--steps", "10", "--remat-policy", policy])
        out[policy] = {"losses": rep["losses"],
                       "step_ms_median": float(np.median(rep["step_ms"][2:])),
                       "peak_memory_gb": rep["peak_memory_gb"]}
    a, b = out["dots"]["losses"], out["full"]["losses"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(a, b, strict=True))
    emit({"phase": "remat_dots", **out, "bitwise": a == b, "max_rel": rel,
          "band": REMAT_TOL, "seconds": time.monotonic() - t0})
    if not (all(map(math.isfinite, a)) and rel <= REMAT_TOL):
        raise AssertionError(f"remat_dots: dots {a} against full {b}: rel {rel}")


def attn_bias_phase(dev, B=1, H=4, S=256, D=32):
    """``flash_attention(attn_bias=)`` on the card at an OpenFold-like
    shape (a (B, H, S, S) pair bias, fp32): out and the bias's cotangent
    against a dense softmax with the bias added (``mha_reference``'s
    arithmetic), in ``ATTN_BIAS_TOL``; the call leaves the flash kernels'
    launch counters where they were (the scan path), and the same call
    without the bias moves each by one (the kernels)."""
    from apex_tpu_torch.ops import flash_attention as tfa
    from apex_tpu_torch.ops.attention import flash_attention

    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(B, H, S, D, device=dev, generator=g) for _ in range(3))
    bias = torch.randn(B, H, S, S, device=dev, generator=g).requires_grad_(True)
    before = (tfa.FWD_LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES)
    out = flash_attention(q, k, v, causal=False, attn_bias=bias)
    (db,) = torch.autograd.grad(torch.sin(out).sum(), [bias])
    biased_counts = (tfa.FWD_LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES)
    ref_bias = bias.detach().clone().requires_grad_(True)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(D) + ref_bias
    ref = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)
    (ref_db,) = torch.autograd.grad(torch.sin(ref).sum(), [ref_bias])
    qb, kb, vb = (t.to(torch.bfloat16).requires_grad_(True) for t in (q, k, v))
    flash_attention(qb, kb, vb, causal=True).float().sum().backward()
    after = (tfa.FWD_LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES)
    errs = {"out": float((out - ref).detach().abs().max()), "db": float((db - ref_db).abs().max())}
    ok = all(torch.allclose(a, b, rtol=ATTN_BIAS_TOL[n][0], atol=ATTN_BIAS_TOL[n][1])
             for n, a, b in (("out", out, ref), ("db", db, ref_db)))
    launches = {"biased_call": [b - a for a, b in zip(before, biased_counts)],
                "unbiased_call": [b - a for a, b in zip(biased_counts, after)]}
    emit({"phase": "attn_bias", "shape": [B, H, S, D], "max_abs_err": errs,
          "bands": ATTN_BIAS_TOL, "flash_launches_fwd_dq_dkv": launches})
    if not ok or launches != {"biased_call": [0, 0, 0], "unbiased_call": [1, 1, 1]}:
        raise AssertionError(f"attn_bias: errors {errs}, flash launches {launches}")


def step_options_main():
    """``chip_smoke.py step_options``: the kernels built, the flash check
    at S 4096, then the train_s4096, inplace_ab, remat_dots and attn_bias
    phases alone, with their seconds."""
    from apex_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    emit({"phase": "card", "torch": torch.__version__, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": _smi()})
    seconds = {"build": _build.build(force=True)}
    _build.load()
    for case, dtype, kw in FLASH_S4096:
        t0 = time.monotonic()
        r = check_flash(dev, dtype, case, **kw)
        for name in ("fwd", "dq", "dkv"):
            emit({"phase": "kernel", **r[name]})
        seconds["flash_s4096"] = time.monotonic() - t0
    for name, fn in (("train_s4096", train_s4096_phase), ("inplace_ab", inplace_ab_phase),
                     ("remat_dots", remat_dots_phase),
                     ("attn_bias", lambda: attn_bias_phase(dev))):
        t0 = time.monotonic()
        fn()
        seconds[name] = time.monotonic() - t0
    emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
    return 0


#: the flash kernels at the gpt124_s4096 cell's shape (B 2, 12 heads, S 4096)
FLASH_S4096 = (("gpt124_s4096", torch.bfloat16, {"B": 2, "S": 4096, "library": True}),)


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
    if world >= 4:
        out["model_parallel"] = zero_mp_multi_card()
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


def zero_mp_multi_card():
    """ZeRO composed with model parallelism on four cards (``zero_child``,
    GPT-345M, fused CE, graphed, 8 rows a dp rank): ``--tp 2`` (dp 2),
    ``--pp 2 --micro-batches 8`` (dp 2) and ``--tp 2 --pp 2
    --micro-batches 8`` (dp 1, ``model_mult`` 4), each against FusedAdam
    in the same layout within 1e-3 relative; then the (2, 2) split's wide
    and int8 wires at dp 4 against the flat ZeRO wire, within 1e-3 and
    ``QUANT_BAND``.  Every run's step ms, peak GB a rank, NCCL ms a step
    and idle share are printed (a ``zero_multi_card`` line) as they come;
    a run beyond its band fails only after the last."""
    out, failed = [], []
    for flags, pairs in ((["--tp", "2"], (("zero", "fused_adam", 1e-3),)),
                         (["--pp", "2", "--micro-batches", "8"], (("zero", "fused_adam", 1e-3),)),
                         (["--tp", "2", "--pp", "2", "--micro-batches", "8"],
                          (("zero", "fused_adam", 1e-3),)),
                         (["--hier"], (("zero_hier", "zero_flat", 1e-3),
                                       ("zero_hier_int8", "zero_flat", QUANT_BAND)))):
        rep = _pp_children(4, flags, timeout=400, script="zero_child",
                           prefix='{"zero_child"')[0]["zero_child"]
        row = {"flags": flags, "dp": rep["dp"], "micro_batches": rep["micro_batches"]}
        for name in [k for k in rep if isinstance(rep[k], dict)]:
            r = rep[name]
            row[name] = {"losses": r["losses"], "step_ms_median": r["step_ms_median"],
                         "peak_memory_gb_per_rank": [x["peak_memory_gb"] for x in r["ranks"]],
                         "nccl_ms_per_step_per_rank": [x["nccl_ms_per_step"] for x in r["ranks"]],
                         "idle_share_per_rank": [x["idle_share"] for x in r["ranks"]]}
        for got, want, band in pairs:
            rel = max(abs(a - b) / abs(b) for a, b in zip(row[got]["losses"],
                                                         row[want]["losses"]))
            row[got]["max_rel_diff_vs_" + want] = rel
            if not rel <= band:  # NaN fails too
                failed.append(f"{flags} {got}: {row[got]['losses']} against {want}'s "
                              f"{row[want]['losses']}, beyond {band}")
        emit({"zero_multi_card": row})
        out.append(row)
    if failed:
        raise AssertionError("zero_mp_multi_card: " + "; ".join(failed))
    return out


def overlap_multi_card_main():
    """``chip_smoke.py overlap_multi_card`` on four cards: the kernels
    built, then :func:`overlap_multi_card` alone."""
    from apex_tpu_torch.ops import _build

    n_cards = torch.cuda.device_count()
    if n_cards < 4:
        raise SystemExit(f"chip_smoke overlap_multi_card: needs four cards, has {n_cards}")
    emit({"phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
          "nccl": list(torch.cuda.nccl.version()), "count": n_cards, "nvidia_smi": _smi()})
    emit({"phase": "build", "seconds": _build.build(force=True)})
    _build.load()
    t0 = time.monotonic()
    overlap_multi_card()
    emit({"phase": "overlap_multi_card", "ok": True, "seconds": time.monotonic() - t0})
    return 0


def multi_card_main():
    """``chip_smoke.py multi_card`` on four cards: the kernels built once,
    then :func:`pp_multi_card`, :func:`zero_mp_multi_card` (ZeRO composed
    with tp and pp, and the hierarchical wire), :func:`overlap_multi_card`
    (the backward-overlapped dp sync), :func:`cp_multi_card` (context
    parallelism), :func:`moe_multi_card` (expert parallelism) and
    :func:`tp_decode_multi_card` (tensor-parallel decoding, two of the
    cards), each result printed as it comes; fails after the last if one
    did."""
    from apex_tpu_torch.ops import _build

    n_cards = torch.cuda.device_count()
    if n_cards < 4:
        raise SystemExit(f"chip_smoke multi_card: needs four cards, has {n_cards}")
    emit({"phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
          "nccl": list(torch.cuda.nccl.version()), "count": n_cards, "nvidia_smi": _smi()})
    emit({"phase": "build", "seconds": _build.build(force=True)})
    _build.load()
    errors = []
    for name, fn in (("pp_multi_card", lambda: pp_multi_card(4)),
                     ("zero_mp_multi_card", zero_mp_multi_card),
                     ("overlap_multi_card", overlap_multi_card),
                     ("cp_multi_card", cp_multi_card),
                     ("moe_multi_card", moe_multi_card),
                     ("tp_decode_multi_card", tp_decode_multi_card),
                     ("models_multi_card", models_multi_card)):
        t0 = time.monotonic()
        try:
            fn()  # its rows printed as they came
            emit({"phase": name, "ok": True, "seconds": time.monotonic() - t0})
        except Exception as exc:  # noqa: BLE001 - the other check still runs
            errors.append(f"{name}: {exc}")
            emit({"phase": name, "error": str(exc)[-6000:], "seconds": time.monotonic() - t0})
    if errors:
        raise SystemExit("multi_card: " + " | ".join(e[:2000] for e in errors))
    return 0


# ----------------------------------------------------------------------- cp
#: bench.py's ``ring_attn_cp`` section (bench.py:503): B, H, S, D, bf16,
#: causal, the sequence split over the cp group
RING_SHAPE = (2, 12, 4096, 64)
#: the cp phase's bands against the train_s4096 phase's losses (the same
#: params, batch and optimizer): the first step's -- at cp 1 the ring
#: runs one chunk, the diagonal one, and its result is taken as it is,
#: what merging it with the empty partial gives exactly, so the forward
#: is the dense flash path's; only the backward's fp32 delta and dv
#: differ -- and every step's (Adam carries that difference on)
CP_FIRST_TOL = 1e-5
CP_BAND = 1e-3
#: each one-card cp run's steps (the first the warm-up and capture)
CP_STEPS = 6
#: the four-card layouts of ``cp_child``: name -> (tp, pp, cp, ZeRO,
#: microbatches, the overlapped ring)
CP_LAYOUTS = {"cp4": (1, 1, 4, False, None, False),
              "cp4_overlap": (1, 1, 4, False, None, True),
              "cp2_dp2_zero": (1, 1, 2, True, None, False),
              "cp2_tp2": (2, 1, 2, False, None, False),
              "pp2_cp2": (1, 2, 2, False, 2, False)}


def ring_counts():
    """The flash kernels' ring-chunk launches (counted apart from the
    dense path's)."""
    from apex_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd_ring": fa.RING_FWD_LAUNCHES, "flash_dq_ring": fa.RING_DQ_LAUNCHES,
            "flash_dkv_ring": fa.RING_DKV_LAUNCHES}


def ring_ab(cg, iters=10):
    """bench.py's ``ring_attn_cp`` at this rank's cp group: the sequence
    of ``RING_SHAPE`` (bf16, seed 0) split over the group, one fwd+bwd of
    this rank's chunk (``ring_attention``, causal, the chunk kernels)
    with the serial and the overlapped hop schedule: out, dq, dk, dv
    bitwise equal; each schedule also captured as one CUDA graph (after
    a warm-up on a side stream), its replay bitwise the eager call (the
    compiled step bench.py times); each schedule's ms eager and replayed
    (CUDA events over ``iters`` calls, in turns serial, overlapped,
    overlapped, serial; every rank calls alike)."""
    from apex_tpu_torch.transformer.context_parallel import ring_attention

    dev = torch.device("cuda", torch.cuda.current_device())
    B, H, S, D = RING_SHAPE
    rng = np.random.default_rng(0)
    full = [rng.standard_normal((B, H, S, D), dtype=np.float32) for _ in range(4)]
    n, r = S // cg.size(), cg.rank()
    q, k, v, g = (torch.from_numpy(np.ascontiguousarray(a[:, :, r * n:(r + 1) * n])).to(
        dev, torch.bfloat16) for a in full)
    q, k, v = (t.requires_grad_() for t in (q, k, v))

    def run(overlap):
        out = ring_attention(q, k, v, cg, causal=True, overlap=overlap)
        return (out,) + torch.autograd.grad(out, (q, k, v), g)

    got = {ov: [t.detach().clone() for t in run(ov)] for ov in (False, True)}
    bitwise = all(torch.equal(a, b) for a, b in zip(got[False], got[True], strict=True))
    finite = all(bool(torch.isfinite(t).all()) for t in got[False])
    graphs, replayed = {}, {}
    for ov in (False, True):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run(ov)
        torch.cuda.current_stream().wait_stream(side)
        graphs[ov] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[ov]):
            outs = run(ov)
        graphs[ov].replay()
        torch.cuda.synchronize()
        replayed[ov] = all(torch.equal(a, b) for a, b in zip(outs, got[ov], strict=True))
    ms = {False: [], True: []}
    gms = {False: [], True: []}
    for ov in (False, True, True, False):
        ms[ov].append(call_ms(lambda: run(ov), iters))
        gms[ov].append(call_ms(graphs[ov].replay, iters))
    del graphs
    return {"shape": list(RING_SHAPE), "cp": cg.size(), "rank": r, "bitwise": bitwise,
            "finite": finite, "replay_bitwise_eager": replayed[False] and replayed[True],
            "serial_ms": float(np.mean(ms[False])), "overlapped_ms": float(np.mean(ms[True])),
            "graphed_serial_ms": float(np.mean(gms[False])),
            "graphed_overlapped_ms": float(np.mean(gms[True])),
            "turns_ms": {"serial": ms[False], "overlapped": ms[True],
                         "graphed_serial": gms[False], "graphed_overlapped": gms[True]}}


def _cp_train(head, groups, steps, eager=False, zero=False, micro=None, overlap=False,
              profile=False, tree=None):
    """GPT-124M at bench.py's ``gpt124_s4096`` shape (S 4096, global batch
    2, bf16, full remat, FusedAdam as train_gpt's, ``head`` "dense" or
    "fused_ce") over ``groups`` = (tp, pp, cp, dp) ``AxisGroup``s, each
    rank its dp rows and cp chunk of train_gpt's batch: ``make_train_step(
    cp_group=)``, or at pp > 1 ``make_pp_train_step(cp_axis=)`` with
    ``micro`` microbatches; ZeRO with ``zero``; ``config.cp_overlap`` from
    ``overlap``.  ``steps`` steps on the batch (the first the warm-up and
    capture), CUDA-event ms, peak memory, losses, launch counts (the
    dense path's and the ring's), and with ``profile`` 4 more under the
    profiler (NCCL ms a step, the part no kernel overlaps, idle share)."""
    import dataclasses
    import gc

    from apex_tpu_torch import train_gpt
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.models.gpt import (
        _init_numpy, make_pp_train_step, param_specs, shard_params,
    )
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.tree import tree_leaves

    tg, pg, cg, dg = groups
    args = train_gpt.build_args().parse_args(
        S4096_ARGV + (["--fused-ce"] if head == "fused_ce" else []))
    config = dataclasses.replace(train_gpt.make_config(args), cp_overlap=overlap)
    dev = torch.device("cuda", torch.cuda.current_device())

    def cut(a):
        rows, n = a.shape[0] // dg.size(), a.shape[1] // cg.size()
        return torch.from_numpy(np.ascontiguousarray(
            a[rows * dg.rank():rows * (dg.rank() + 1), n * cg.rank():n * (cg.rank() + 1)],
            np.int64)).to(dev)

    tokens, targets = (cut(a) for a in train_gpt.make_batch(args))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tree = _init_numpy(config, args.seed) if tree is None else tree
    pipe = pg.size() > 1
    params = shard_params(tree, config, tg, dev, keep_fp32=True, pp_group=pg if pipe else None)
    if zero:
        opt = DistributedFusedAdam(lr=args.lr, weight_decay=train_gpt.WEIGHT_DECAY)
        state = opt.init(params, world_size=dg.size(), param_specs=param_specs(config, pipe),
                         axis_sizes={"tp": tg.size(), "pp": pg.size()})
    else:
        opt = FusedAdam(lr=args.lr, weight_decay=train_gpt.WEIGHT_DECAY)
        state = opt.init(params)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    kw = dict(graphs=False if eager else None, dp_group=dg, tp_group=tg)
    if pipe:
        step = make_pp_train_step(config, opt, micro, pp_group=pg, cp_axis=cg, **kw)
    else:
        step = train_gpt.make_train_step(opt, config, cp_group=cg, **kw)
    reset_counts()
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    losses = []
    for _ in range(steps):
        losses.append(step(params, state, tokens, targets).detach().clone())
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    rec = {"losses": [float(x) for x in losses], "step_ms": step_ms,
           "step_ms_median": float(np.median(step_ms[1:])),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launch_counts(), "ring_launches": ring_counts(),
           "graphs": getattr(step, "graph", None) is not None,
           "sizes": [p.numel() for p in tree_leaves(params)]}
    if profile:
        from torch.profiler import ProfilerActivity, profile as _profile

        prof = _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        with prof:
            for _ in range(4):
                step(params, state, tokens, targets)
            torch.cuda.synchronize()
        exposed, nccl = _exposed_nccl_ms(prof)
        idle = _busy_share(prof, skip=1)
        rec.update(nccl_ms_per_step=nccl, exposed_nccl_ms_per_step=exposed,
                   idle_share=idle["idle_share"],
                   ring_kernel_ms_per_step=sum(
                       ms for name, ms in idle["kernel_ms_per_step"].items()
                       if "flash" in name and ("true>" in name or "Lb1E" in name)))
        del prof
    del step, params, state, opt
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _cp_expect(rec, L, rank, n):
    """``rec``'s launch counts against a ring step's: the train phase's
    per-step counts with no dense flash launch, and the ring-chunk mode's
    2 L (r + 1) forwards (full remat), L (r + 1) dq and dkv a step at cp
    rank r (chunks 0..r: the others are masked and launch nothing)."""
    from apex_tpu_torch import train_gpt

    head = rec["head"]
    args = train_gpt.build_args().parse_args(
        S4096_ARGV + (["--fused-ce"] if head == "fused_ce" else []))
    per_step, expect = _train_expect(args, rec["sizes"], n)
    expect = {**expect, "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    ring = {"flash_fwd_ring": 2 * L * (rank + 1) * n, "flash_dq_ring": L * (rank + 1) * n,
            "flash_dkv_ring": L * (rank + 1) * n}
    if rec["launches"] != expect or rec["ring_launches"] != ring:
        raise AssertionError(f"cp {head}: launches {rec['launches']}, ring "
                             f"{rec['ring_launches']} != expected {expect}, {ring}")
    return {**{k: v for k, v in per_step.items() if not k.startswith("flash")},
            **{k: v // n for k, v in ring.items()}}


def cp_phase(smi, s4096):
    """Context parallelism on one card, over one-rank NCCL groups (cp 1:
    every ring has one chunk, the diagonal one): bench.py's
    ``ring_attn_cp`` at (2, 12, 4096, 64) bf16, serial against
    overlapped, fwd+bwd bitwise, ms each; then ``make_train_step`` with
    the one-rank cp group at ``gpt124_s4096``, both heads, graphed
    (``CP_STEPS``) and eager (3 steps), exact launch counts (ring-mode
    forward 2 L, dq and dkv L a step; no dense flash launch), graphed =
    eager, and the losses against ``s4096`` (the train_s4096 phase's,
    the same params and batch): the first within ``CP_FIRST_TOL``, every
    step within ``CP_BAND``; step ms and peak memory."""
    from apex_tpu_torch.models.gpt import _init_numpy
    from apex_tpu_torch import train_gpt
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    t0 = time.monotonic()
    multiproc.initialize_distributed("cuda")
    ps.initialize_model_parallel(context_parallel_size_=1)
    runs = {}
    try:
        groups = (ps.get_tensor_model_parallel_group(), ps.get_pipeline_model_parallel_group(),
                  ps.get_context_parallel_group(), ps.get_data_parallel_group())
        ring = ring_ab(groups[2])
        if not (ring["bitwise"] and ring["finite"] and ring["replay_bitwise_eager"]):
            raise AssertionError(f"cp ring at cp 1: {ring}")
        args = train_gpt.build_args().parse_args(S4096_ARGV)
        tree = _init_numpy(train_gpt.make_config(args), args.seed)
        for head in ("dense", "fused_ce"):
            for eager, n in ((False, CP_STEPS), (True, 3)):
                rec = {**_cp_train(head, groups, n, eager=eager, tree=tree), "head": head}
                rec["launches_per_step"] = _cp_expect(rec, args.layers, 0, n)
                if not all(map(math.isfinite, rec["losses"])):
                    raise AssertionError(f"cp {head}: losses {rec['losses']}")
                runs[head + ("_eager" if eager else "")] = rec
        del tree
    finally:
        multiproc.destroy_distributed()
    for head in ("dense", "fused_ce"):
        graphed, eager = runs[head]["losses"], runs[head + "_eager"]["losses"]
        if not runs[head]["graphs"] or runs[head + "_eager"]["graphs"]:
            raise AssertionError(f"cp {head}: graphed {runs[head]['graphs']}, eager "
                                 f"{runs[head + '_eager']['graphs']}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(graphed, eager))
        if graphed[:3] != eager and not rel <= TRAIN_AB_TOL:
            raise AssertionError(f"cp {head}: graphed {graphed} against eager {eager}")
        runs[head]["graphed_vs_eager"] = "bitwise" if graphed[:3] == eager else rel
        want = s4096[head]["graphed"]["losses"]
        rels = [abs(a - b) / abs(b) for a, b in zip(graphed, want)]
        if rels[0] > CP_FIRST_TOL or max(rels) > CP_BAND:
            raise AssertionError(f"cp {head}: losses {graphed} against train_s4096's {want}: "
                                 f"relative {rels} (first within {CP_FIRST_TOL}, every "
                                 f"step within {CP_BAND})")
        runs[head]["vs_train_s4096"] = {"losses": want, "rel_diff": rels,
                                        "first_bitwise": graphed[0] == want[0]}
        runs[head]["vs_train_s4096_step_ms"] = s4096[head]["graphed"]["step_ms_median"]
    for rec in runs.values():
        rec.pop("sizes")
    emit({"phase": "cp", "argv": S4096_ARGV, "nvidia_smi": smi, "ring_attn_cp": ring,
          "tolerance": {"first_step": CP_FIRST_TOL, "every_step": CP_BAND},
          "runs": runs, "seconds": time.monotonic() - t0})
    return runs


def cp_child(argv):
    """One rank of ``torchrun --nproc-per-node 4 chip_smoke.py cp_child
    [--steps S]``: ``ring_ab`` at cp 4 and 2, then each of
    ``CP_LAYOUTS`` (GPT-124M at S 4096, fused CE, graphed; S steps, the
    cp 4 run profiled); rank 0 prints one ``cp_child`` line with every
    rank's records."""
    import argparse

    from apex_tpu_torch.models.gpt import _init_numpy
    from apex_tpu_torch import train_gpt
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    a = ap.parse_args(argv)
    multiproc.initialize_distributed("cuda")
    rank = torch.distributed.get_rank()
    args = train_gpt.build_args().parse_args(S4096_ARGV)
    tree = _init_numpy(train_gpt.make_config(args), args.seed)

    def setup(tp, pp, cp):
        ps.destroy_model_parallel()
        ps.initialize_model_parallel(tensor_model_parallel_size_=tp,
                                     pipeline_model_parallel_size_=pp, context_parallel_size_=cp)
        return (ps.get_tensor_model_parallel_group(), ps.get_pipeline_model_parallel_group(),
                ps.get_context_parallel_group(), ps.get_data_parallel_group())

    def gather(mine):
        ranks = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(ranks, mine)
        return ranks

    out = {"ring": {}, "layouts": {}}
    for cp in (4, 2):
        out["ring"][cp] = gather(ring_ab(setup(1, 1, cp)[2]))
    for name, (tp, pp, cp, zero, micro, overlap) in CP_LAYOUTS.items():
        groups = setup(tp, pp, cp)
        rec = _cp_train("fused_ce", groups, a.steps, zero=zero, micro=micro, overlap=overlap,
                        profile=name == "cp4", tree=tree)
        rec.pop("sizes")
        rec.update(rank=rank, cp_rank=groups[2].rank(), pp_rank=groups[1].rank())
        out["layouts"][name] = gather(rec)
    multiproc.destroy_distributed()
    if rank == 0:
        print(json.dumps({"cp_child": out}), flush=True)
    return 0


def cp_multi_card(steps=10):
    """Context parallelism on four cards: ``make_train_step`` at cp 1 in
    this process over one-rank groups (GPT-124M, S 4096, fused CE,
    graphed, ``steps`` steps), then ``cp_child`` over NCCL, one card a
    rank: ``ring_attn_cp``'s serial against overlapped at cp 4 and 2
    (bitwise, eager and graph replays bitwise, ms of each), and the
    ``CP_LAYOUTS`` runs -- cp 4 (profiled: NCCL
    ms, exposed NCCL ms, idle share, ring kernels' ms a rank: rank r
    runs r + 1 chunks), cp 4 with the overlapped ring (bitwise the serial
    run, graphed), cp 2 x dp 2 with ZeRO, cp 2 x tp 2 and pp 2 x cp 2 (2
    microbatches) -- each rank's losses within ``CP_BAND`` of cp 1's, step
    ms and peak memory a rank.  Each result prints as it comes; a miss
    fails after the last."""
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    multiproc.initialize_distributed("cuda")
    ps.initialize_model_parallel()
    try:
        groups = (ps.get_tensor_model_parallel_group(), ps.get_pipeline_model_parallel_group(),
                  ps.get_context_parallel_group(), ps.get_data_parallel_group())
        base = _cp_train("fused_ce", groups, steps)
    finally:
        multiproc.destroy_distributed()
    base.pop("sizes")
    emit({"phase": "cp_multi_card", "run": "cp1", "losses": base["losses"],
          "step_ms_median": base["step_ms_median"], "peak_memory_gb": base["peak_memory_gb"]})
    lines = _pp_children(4, [], timeout=900, script="cp_child",
                         extra=["--steps", str(steps)], prefix='{"cp_child"')
    res = lines[0]["cp_child"]
    failed = []
    for cp, ranks in res["ring"].items():
        ok = all(r["bitwise"] and r["finite"] and r["replay_bitwise_eager"] for r in ranks)
        emit({"phase": "cp_multi_card", "run": f"ring_attn_cp{cp}", "bitwise": ok,
              **{k: [r[k] for r in ranks] for k in (
                  "serial_ms", "overlapped_ms", "graphed_serial_ms",
                  "graphed_overlapped_ms")}})
        if not ok:
            failed.append(f"ring cp {cp}: serial and overlapped, or a replay and the eager "
                          f"call, differ, or are not finite")
    serial = None
    for name, ranks in res["layouts"].items():
        rels = [max(abs(x - y) / abs(y) for x, y in zip(r["losses"], base["losses"]))
                for r in ranks]
        row = {"phase": "cp_multi_card", "run": name, "layout": dict(zip(
                   ("tp", "pp", "cp", "zero", "micro_batches", "overlap"), CP_LAYOUTS[name])),
               "max_rel_vs_cp1": max(rels), "graphs": all(r["graphs"] for r in ranks),
               "step_ms_median": [r["step_ms_median"] for r in ranks],
               "peak_memory_gb": [r["peak_memory_gb"] for r in ranks],
               "ring_launches_per_rank": [r["ring_launches"] for r in ranks],
               "losses": ranks[0]["losses"]}
        if name == "cp4":
            serial = ranks
            row.update({k: [r[k] for r in ranks] for k in (
                "nccl_ms_per_step", "exposed_nccl_ms_per_step", "idle_share",
                "ring_kernel_ms_per_step")})
        if name == "cp4_overlap":
            row["bitwise_vs_serial"] = all(
                r["losses"] == s["losses"] for r, s in zip(ranks, serial))
            if not row["bitwise_vs_serial"]:
                failed.append("cp4_overlap: losses not bitwise the serial ring's")
        emit(row)
        if not max(rels) <= CP_BAND or not row["graphs"]:
            failed.append(f"{name}: losses {max(rels)} from cp 1's (band {CP_BAND}), "
                          f"graphs {row['graphs']}")
    if failed:
        raise AssertionError("cp_multi_card: " + "; ".join(failed))
    return res


def cp_main():
    """``chip_smoke.py cp`` on one card: the kernels built, the ring-chunk
    kernel checks of the kernels phase, then train_s4096 and the cp
    phase (which holds its losses against train_s4096's) alone."""
    from apex_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    emit({"phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    emit({"phase": "build", "seconds": _build.build(force=True)})
    _build.load()
    t0 = time.monotonic()
    dev = torch.device("cuda", 0)
    for case, S, causal in FLASH_RING_CASES:
        r = check_flash_ring(dev, case, S, causal)
        for name in ("fwd", "dq", "dkv"):
            emit({"phase": "kernel", **r[name]})
    emit({"phase": "kernel", "kernel": "flash_bwd_plan", **check_flash_plan(_build.load())})
    cp_phase(smi, train_s4096_phase())
    emit({"phase": "cp_main", "ok": True, "seconds": time.monotonic() - t0})
    return 0


def cp_multi_card_main():
    """``chip_smoke.py cp_multi_card`` on four cards: the kernels built,
    then :func:`cp_multi_card` alone."""
    from apex_tpu_torch.ops import _build

    n_cards = torch.cuda.device_count()
    if n_cards < 4:
        raise SystemExit(f"chip_smoke cp_multi_card: needs four cards, has {n_cards}")
    emit({"phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
          "nccl": list(torch.cuda.nccl.version()), "count": n_cards, "nvidia_smi": _smi()})
    emit({"phase": "build", "seconds": _build.build(force=True)})
    _build.load()
    t0 = time.monotonic()
    cp_multi_card()
    emit({"phase": "cp_multi_card", "ok": True, "seconds": time.monotonic() - t0})
    return 0


# ---------------------------------------------------------------------- moe
#: the MoE configuration on the card: train_gpt's GPT-124M step (S 1024,
#: batch 8, bf16, flash, full remat, FusedAdam(3e-4, wd 0.1)) with the
#: JAX GPTConfig's MoE defaults in every FFN: 8 experts, top 2, capacity
#: factor 1.25, aux coefficient 0.01 (about 521 M params)
MOE = {"moe_num_experts": 8, "moe_top_k": 2, "moe_capacity_factor": 1.25,
       "moe_aux_coef": 0.01}
#: the four-card parity runs' overrides: every token kept (C = T) and no
#: aux (a per-shard product of means), so each layout's loss is the
#: one-card step's on the same global batch
MOE_AMPLE = {"moe_capacity_factor": 4.0, "moe_aux_coef": 0.0}
#: each layout's first parity loss against the one-card run's, relative
MOE_BAND = 1e-4
#: an fp32 MoE layer on the card against the CPU: of each leaf's largest
#: entry
MOE_CPU_TOL = 1e-5
#: steps of each graphed MoE run (the first the warm-up and capture), of
#: each eager one, and of each parity run
MOE_STEPS, MOE_EAGER_STEPS, MOE_PARITY_STEPS = 10, 3, 3
#: the four-card layouts of ``moe_child`` (experts over dp): name -> (tp,
#: pp, microbatches)
MOE_LAYOUTS = {"ep4": (1, 1, None), "dp2_tp2": (2, 1, None), "pp2_dp2": (1, 2, 2)}


def a2a_launches():
    """The MoE layer's ``all_to_all`` exchanges issued (and replayed)."""
    from apex_tpu_torch.transformer import expert_parallel

    return expert_parallel.A2A_LAUNCHES


def _moe_args(head):
    from apex_tpu_torch import train_gpt

    return train_gpt.build_args().parse_args(["--fused-ce"] if head == "fused_ce" else [])


def _moe_config(args, over=None):
    import dataclasses

    from apex_tpu_torch import train_gpt

    return dataclasses.replace(train_gpt.make_config(args), **{**MOE, **(over or {})})


def _moe_train(head, steps, groups=None, eager=False, tree=None, over=None, micro=None,
               profile=False):
    """train_gpt's GPT-124M step with MoE (``head`` "dense" or
    "fused_ce"; ``over`` config overrides) for ``steps`` steps on its
    batch (the first the warm-up and capture): with no ``groups`` on this
    card alone; with ``groups`` = (tp, pp, dp) ``AxisGroup``s each rank
    its dp rows, the experts over dp, ``make_pp_train_step`` with
    ``micro`` microbatches when pp > 1.  Losses, CUDA-event ms a step,
    peak memory, launch counts, the ``all_to_all`` exchanges; with
    ``profile`` 4 more steps under the profiler: NCCL's ms a step (the
    exchanges -- NCCL's send/receive or all-to-all kernels -- apart from
    the rest), the part no other kernel overlaps, the idle share."""
    import gc

    from apex_tpu_torch import train_gpt
    from apex_tpu_torch.models.gpt import _init_numpy, make_pp_train_step, shard_params
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.tree import tree_leaves

    args = _moe_args(head)
    config = _moe_config(args, over)
    dev = torch.device("cuda", torch.cuda.current_device())
    tg, pg, dg = groups if groups is not None else (None, None, None)
    tokens, targets = train_gpt.make_batch(args)
    if dg is not None:
        n = args.batch // dg.size()
        tokens, targets = (a[n * dg.rank():n * (dg.rank() + 1)] for a in (tokens, targets))
    tokens, targets = (torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)
                       for a in (tokens, targets))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tree = _init_numpy(config, args.seed) if tree is None else tree
    pipe = pg is not None and pg.size() > 1
    params = shard_params(tree, config, tg, dev, keep_fp32=True,
                          pp_group=pg if pipe else None, ep_group=dg)
    opt = FusedAdam(lr=args.lr, weight_decay=train_gpt.WEIGHT_DECAY)
    state = opt.init(params)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    kw = dict(graphs=False if eager else None, dp_group=dg, tp_group=tg)
    if pipe:
        step = make_pp_train_step(config, opt, micro, pp_group=pg, **kw)
    else:
        step = train_gpt.make_train_step(opt, config, **kw)
    reset_counts()
    a2a = a2a_launches()
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    losses = []
    for _ in range(steps):
        losses.append(step(params, state, tokens, targets).detach().clone())
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    rec = {"head": head, "losses": [float(x) for x in losses], "step_ms": step_ms,
           "step_ms_median": float(np.median(step_ms[1:])) if steps > 1 else None,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launch_counts(), "a2a": a2a_launches() - a2a,
           "graphs": getattr(step, "graph", None) is not None,
           "params": sum(p.numel() for p in tree_leaves(params)),
           "sizes": [p.numel() for p in tree_leaves(params)]}
    if profile:
        from torch.profiler import ProfilerActivity, profile as _profile

        prof = _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        with prof:
            for _ in range(4):
                step(params, state, tokens, targets)
            torch.cuda.synchronize()
        exposed, nccl = _exposed_nccl_ms(prof)
        idle = _busy_share(prof, skip=1)
        by_name = idle["kernel_ms_per_step"]
        rec.update(nccl_ms_per_step=nccl, exposed_nccl_ms_per_step=exposed,
                   idle_share=idle["idle_share"],
                   busy_ms_per_step=idle["busy_ms"] / idle["window_steps"],
                   a2a_ms_per_step=sum(ms for n, ms in by_name.items()
                                       if "sendrecv" in n.lower() or "alltoall" in n.lower()),
                   top_kernels_ms_per_step=dict(list(by_name.items())[:12]))
        del prof
    del step, params, state, opt
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _moe_expect(rec, n):
    """``rec``'s launch counts against ``n`` one-card MoE steps: the
    train phase's a step (LayerNorm 49 / 25, flash 24 / 12 / 12, the CE
    kernels once each with the fused head, ``mt_plan``'s ``mt_adam``
    launches) and no exchange."""
    per_step, expect = _train_expect(_moe_args(rec["head"]), rec["sizes"], n)
    if rec["launches"] != expect or rec["a2a"]:
        raise AssertionError(f"moe {rec['head']}: launches {rec['launches']}, all_to_all "
                             f"{rec['a2a']} != expected {expect}, 0")
    return per_step


def moe_layer_split(group=None, T=8192, H=768, F=3072, E=8, top_k=2, cf=1.25, iters=10):
    """The MoE layer at GPT-124M's widths (bf16, ``T`` tokens: a step's
    8 x 1024 on one card) in parts, device ms a call (:func:`device_ms`:
    the profiler's kernel times over ``iters`` calls; CUDA events over
    them, after a barrier, for what runs a collective) each: the router (fp32 logits and softmax), the route (top-k,
    capacity, the indices), dispatch, the experts (two batched matmuls,
    bias, GELU), combine and, with ``group`` (the experts over it), each
    ``all_to_all`` exchange; the forward of each and the backward of each
    that has one (a ones cotangent), and the whole layer's forward and
    forward + backward.  Every rank of ``group`` calls it alike."""
    import torch.nn.functional as Fn

    from apex_tpu_torch.transformer import expert_parallel as epm

    dev = torch.device("cuda", torch.cuda.current_device())
    g = group if group is not None and group.size() > 1 else None
    ep = 1 if g is None else g.size()
    gen = torch.Generator().manual_seed(0)
    full = epm.moe_init(gen, H, F, E)
    El, r = E // ep, 0 if g is None else g.rank()
    p = {k: (v if k == "router" else v[r * El:(r + 1) * El]).to(dev).requires_grad_()
         for k, v in full.items()}
    x = torch.randn(T, H, generator=gen).to(dev, torch.bfloat16).requires_grad_()
    cd, C = torch.bfloat16, epm.capacity_of(T, E, top_k, cf)

    def router():
        return torch.softmax(torch.matmul(x.float(), p["router"].float()), dim=-1)

    probs = router()

    def route():
        return epm._Route(probs.detach(), top_k, C)

    rt = route()

    def dispatch():
        return epm._Dispatch.apply(x, rt.src, rt.dest).reshape(E, C, H)

    xin = dispatch()

    def to_experts():
        return epm._Exchange.apply(xin, g, True)

    ein = to_experts() if g is not None else xin

    def experts():
        h = torch.matmul(ein, p["w1"].transpose(-1, -2).to(cd))
        h = Fn.gelu(h + p["b1"].to(cd)[:, None, :], approximate="tanh")
        return torch.matmul(h, p["w2"].transpose(-1, -2).to(cd)) + p["b2"].to(cd)[:, None, :]

    y = experts()

    def from_experts():
        return epm._Exchange.apply(y, g, False)

    yb = from_experts() if g is not None else y
    w = (rt.weights * rt.keep).to(cd).requires_grad_()

    def combine():
        return epm._Combine.apply(yb.reshape(E * C, H), w, rt.dest, rt.owner, rt.src)

    out = combine()

    def backward(outp, inputs):
        cot = torch.ones_like(outp)
        return lambda: torch.autograd.grad(outp, inputs, cot, retain_graph=True)

    parts = {"router": (router, backward(probs, [x, p["router"]])), "route": (route, None),
             "dispatch": (dispatch, backward(xin, [x])),
             "experts": (experts, backward(y, [ein] + [p[k] for k in epm.EXPERT_PARAM_KEYS])),
             "combine": (combine, backward(out, [yb, w]))}
    if g is not None:
        parts["all_to_all_in"] = (to_experts, backward(ein, [xin]))
        parts["all_to_all_out"] = (from_experts, backward(yb, [y]))

    def layer():
        return epm.moe_ffn(x, p, top_k=top_k, capacity_factor=cf, ep_group=g)

    def layer_fwd_bwd():
        o, aux = layer()
        return torch.autograd.grad((o.float().sum() + aux), [x] + list(p.values()))

    def timed(fn, collective):
        # a collective's device time waits on the slowest rank: CUDA events
        # over the calls, the ranks lined up by a barrier first
        if not collective:
            return device_ms(fn, iters)[0]
        torch.distributed.barrier()
        return call_ms(fn, iters)

    res = {"tokens": T, "num_experts": E, "ep": ep, "capacity": C,
           "layer_fwd_ms": timed(layer, g is not None),
           "layer_fwd_bwd_ms": timed(layer_fwd_bwd, g is not None)}
    for name, (fwd, bwd) in parts.items():
        coll = name.startswith("all_to_all")
        res[name] = {"fwd_ms": timed(fwd, coll),
                     "bwd_ms": timed(bwd, coll) if bwd is not None else None}
    return res


def moe_cpu_parity(T=1024, H=768, F=3072, E=8, top_k=2, cf=1.25):
    """An fp32 MoE layer at GPT-124M's widths on ``T`` tokens (seeded),
    on the card and on the CPU (the same call): out, aux and the grads of
    ``sum(sin(out)) + aux`` for x and every param, each within
    ``MOE_CPU_TOL`` of the leaf's largest entry; the routing (experts and
    kept assignments) equal, with the smallest gap between a token's
    chosen and next prob (how close the routing came to a tie)."""
    from apex_tpu_torch.transformer import expert_parallel as epm

    gen = torch.Generator().manual_seed(1)
    params = epm.moe_init(gen, H, F, E)
    x = torch.randn(T, H, generator=gen)

    def run(dev):
        p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
        xx = x.to(dev).requires_grad_()
        out, aux = epm.moe_ffn(xx, p, top_k=top_k, capacity_factor=cf)
        grads = torch.autograd.grad(torch.sin(out).sum() + aux, [xx] + [p[k] for k in sorted(p)])
        with torch.no_grad():
            probs = torch.softmax(xx @ p["router"], -1)
            rt = epm._Route(probs, top_k, epm.capacity_of(T, E, top_k, cf))
        named = dict(zip(["out", "aux", "x"] + [f"d{k}" for k in sorted(p)],
                         (out, aux.reshape(1)) + grads))
        return ({k: v.detach().cpu() for k, v in named.items()}, rt.expert.cpu(), rt.keep.cpu(),
                probs.cpu())

    card, cpu = run(torch.device("cuda", torch.cuda.current_device())), run("cpu")
    errs = {k: rel_err(card[0][k], cpu[0][k]) for k in cpu[0]}
    top = torch.sort(cpu[3], dim=-1, descending=True).values
    res = {"tokens": T, "errors": errs, "tolerance": MOE_CPU_TOL,
           "routing_equal": torch.equal(card[1], cpu[1]) and torch.equal(card[2], cpu[2]),
           "min_prob_gap": float((top[:, :top_k + 1][:, :-1] - top[:, 1:top_k + 1]).min())}
    if not res["routing_equal"] or max(errs.values()) > MOE_CPU_TOL:
        raise AssertionError(f"moe card against CPU: {res}")
    return res


def moe_phase(smi, train_fce_ms=None):
    """MoE on one card: ``make_train_step`` at train_gpt's GPT-124M step
    with ``MOE`` (no dp group: every expert local, no exchange), the
    dense head and the fused CE, graphed (``MOE_STEPS``) and eager
    (``MOE_EAGER_STEPS``): graphed = eager bitwise, exact launches a step
    (LayerNorm 49 / 25, flash 24 / 12 / 12, CE 1 / 1 / 1 with the fused
    head, ``mt_plan``'s ``mt_adam``), losses finite and falling, ms a
    step and peak memory beside ``train_fce_ms`` (the train_fce phase's
    step median); then the layer's split (:func:`moe_layer_split`) and an
    fp32 layer card against CPU (:func:`moe_cpu_parity`)."""
    from apex_tpu_torch.models.gpt import _init_numpy

    t0 = time.monotonic()
    tree = _init_numpy(_moe_config(_moe_args("dense")), 0)
    runs = {}
    for head in ("dense", "fused_ce"):
        graphed = _moe_train(head, MOE_STEPS, tree=tree)
        eager = _moe_train(head, MOE_EAGER_STEPS, tree=tree, eager=True)
        per_step = _moe_expect(graphed, MOE_STEPS)
        _moe_expect(eager, MOE_EAGER_STEPS)
        losses = graphed["losses"]
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"moe {head}: losses {losses} not finite and falling")
        if not graphed["graphs"] or eager["graphs"]:
            raise AssertionError(f"moe {head}: graphed {graphed['graphs']}, eager "
                                 f"{eager['graphs']}")
        if losses[:MOE_EAGER_STEPS] != eager["losses"]:
            raise AssertionError(f"moe {head}: graphed {losses} against eager "
                                 f"{eager['losses']}: not bitwise")
        for rec in (graphed, eager):
            rec.pop("sizes")
        runs[head] = {**graphed, "launches_per_step": per_step, "graphed_vs_eager": "bitwise",
                      "eager_step_ms": eager["step_ms"][1:],
                      "eager_step_ms_median": eager["step_ms_median"]}
    del tree
    emit({"phase": "moe_train", "nvidia_smi": smi,
          "config": {**MOE, "layers": 12, "hidden": 768, "heads": 12, "seq": 1024, "batch": 8},
          "params": runs["dense"]["params"], "runs": runs, "train_fce_step_ms": train_fce_ms})
    emit({"phase": "moe", "nvidia_smi": smi, "layer_split": moe_layer_split(),
          "card_vs_cpu": moe_cpu_parity(), "seconds": time.monotonic() - t0})
    return runs


def moe_main():
    """``chip_smoke.py moe`` on one card: the kernels built, then the moe
    phase alone."""
    from apex_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    emit({"phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    emit({"phase": "build", "seconds": _build.build(force=True)})
    _build.load()
    t0 = time.monotonic()
    moe_phase(smi)
    emit({"phase": "moe_main", "ok": True, "seconds": time.monotonic() - t0})
    return 0


def moe_child(argv):
    """One rank of ``torchrun --nproc-per-node 4 chip_smoke.py moe_child``:
    each of ``MOE_LAYOUTS`` (the fused CE head, graphed): a parity run
    (``MOE_AMPLE``, ``MOE_PARITY_STEPS`` steps) and a timed one (``MOE``,
    ``--steps``), then the layer's split at ep 4 (each rank its 2 x 1024
    tokens); rank 0 prints one ``moe_child`` line with every rank's
    records."""
    import argparse

    from apex_tpu_torch.models.gpt import _init_numpy
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=MOE_STEPS)
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    multiproc.initialize_distributed("cuda")
    rank = torch.distributed.get_rank()
    tree = _init_numpy(_moe_config(_moe_args("fused_ce")), 0)

    def setup(tp, pp):
        ps.destroy_model_parallel()
        ps.initialize_model_parallel(tensor_model_parallel_size_=tp,
                                     pipeline_model_parallel_size_=pp)
        return (ps.get_tensor_model_parallel_group(), ps.get_pipeline_model_parallel_group(),
                ps.get_data_parallel_group())

    def gather(mine):
        ranks = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(ranks, mine)
        return ranks

    out = {"layouts": {}}
    for name, (tp, pp, micro) in MOE_LAYOUTS.items():
        groups = setup(tp, pp)
        recs = {}
        for kind, over, n in (("parity", MOE_AMPLE, MOE_PARITY_STEPS), ("timed", None, a.steps)):
            rec = _moe_train("fused_ce", n, groups, tree=tree, over=over, micro=micro,
                             profile=kind == "timed" and name == "ep4")
            rec.pop("sizes")
            rec.update(rank=rank, dp=groups[2].size(), pp_rank=groups[1].rank(),
                       layers_on_rank=12 // pp, micro=micro or 1)
            recs[kind] = rec
        out["layouts"][name] = gather(recs)
    del tree
    out["split"] = gather(moe_layer_split(setup(1, 1)[2], T=2048))
    multiproc.destroy_distributed()
    if rank == 0:
        print(json.dumps({"moe_child": out}), flush=True)
    return 0


def moe_multi_card(steps=8):
    """MoE on four cards: the one-card run in this process (no dp group:
    every expert local) at ``MOE_AMPLE`` (``MOE_PARITY_STEPS`` steps) and
    at ``MOE`` (``steps``), then ``moe_child`` over NCCL, one card a rank,
    the experts over the dp group: ep 4 (dp 4), dp 2 x tp 2 and pp 2 x
    dp 2 (2 microbatches), each at ``MOE_AMPLE`` -- every rank's first
    loss within ``MOE_BAND`` of the one-card run's -- and at ``MOE``,
    timed (ms a step, peak memory a rank); the ``all_to_all`` exchanges
    exactly 6 a layer a microbatch a step on every rank (2 forward, 2 in
    the remat's recompute, 2 backward); the layer's split at ep 4.  Each
    result prints as it comes; a miss fails after the last."""
    base = {kind: _moe_train("fused_ce", n, over=over)
            for kind, over, n in (("parity", MOE_AMPLE, MOE_PARITY_STEPS),
                                  ("timed", None, steps))}
    for rec in base.values():
        rec.pop("sizes")
    smi = _smi()
    emit({"phase": "moe_multi_card", "run": "ep1", "nvidia_smi": smi, **{
        kind: {k: rec[k] for k in ("losses", "step_ms_median", "peak_memory_gb")}
        for kind, rec in base.items()}})
    lines = _pp_children(4, [], timeout=900, script="moe_child",
                         extra=["--steps", str(steps)], prefix='{"moe_child"')
    res = lines[0]["moe_child"]
    failed = []
    want = base["parity"]["losses"]
    for name, ranks in res["layouts"].items():
        rels = [[abs(x - y) / abs(y) for x, y in zip(r["parity"]["losses"], want)]
                for r in ranks]
        a2a = [r["timed"]["a2a"] for r in ranks]
        expect = [6 * r["timed"]["layers_on_rank"] * r["timed"]["micro"] * steps for r in ranks]
        row = {"phase": "moe_multi_card", "run": name, "nvidia_smi": smi,
               "layout": dict(zip(("tp", "pp", "micro_batches"), MOE_LAYOUTS[name])),
               "parity_rel_vs_ep1": rels, "parity_losses": ranks[0]["parity"]["losses"],
               "graphs": all(r[k]["graphs"] for r in ranks for k in ("parity", "timed")),
               "step_ms_median": [r["timed"]["step_ms_median"] for r in ranks],
               "peak_memory_gb": [r["timed"]["peak_memory_gb"] for r in ranks],
               "a2a": a2a, "a2a_expected": expect, "losses": ranks[0]["timed"]["losses"]}
        if name == "ep4":
            row.update({k: [r["timed"][k] for r in ranks] for k in (
                "nccl_ms_per_step", "exposed_nccl_ms_per_step", "a2a_ms_per_step",
                "idle_share", "busy_ms_per_step")})
            row["top_kernels_ms_per_step_rank0"] = ranks[0]["timed"]["top_kernels_ms_per_step"]
        emit(row)
        if max(r[0] for r in rels) > MOE_BAND:
            failed.append(f"{name}: first parity loss {max(r[0] for r in rels)} from ep 1's "
                          f"(band {MOE_BAND})")
        if a2a != expect or not row["graphs"]:
            failed.append(f"{name}: all_to_all {a2a} != {expect}, graphs {row['graphs']}")
        if not all(math.isfinite(x) for r in ranks for x in r["timed"]["losses"]):
            failed.append(f"{name}: losses not finite")
    emit({"phase": "moe_multi_card", "run": "layer_split_ep4", "nvidia_smi": smi,
          "ranks": res["split"]})
    if failed:
        raise AssertionError("moe_multi_card: " + "; ".join(failed))
    return res


def moe_multi_card_main():
    """``chip_smoke.py moe_multi_card`` on four cards: the kernels built,
    then :func:`moe_multi_card` alone."""
    return _multi_card_alone("moe_multi_card", moe_multi_card, 4)


def _multi_card_alone(name, fn, n):
    from apex_tpu_torch.ops import _build

    n_cards = torch.cuda.device_count()
    if n_cards < n:
        raise SystemExit(f"chip_smoke {name}: needs {n} cards, has {n_cards}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
          "nccl": list(torch.cuda.nccl.version()), "count": n_cards, "nvidia_smi": _smi()})
    emit({"phase": "build", "seconds": _build.build(force=True)})
    _build.load()
    t0 = time.monotonic()
    fn()
    emit({"phase": name, "ok": True, "seconds": time.monotonic() - t0})
    return 0


# ---------------------------------------------------------------- tp decode
#: tensor-parallel decoding: GPT-124M (rope, as serve_gpt's defaults) in
#: fp32, 4 prompts of 64 tokens prefilled through ``gpt_forward(
#: return_kv=True)``, then 32 greedy ``forward_decode`` steps over pages
#: of 16 positions
TP_DECODE = {"batch": 4, "prompt": 64, "steps": 32, "page_size": 16}
#: tp 2's fp32 logits against tp 1's, absolute
TP_DECODE_TOL = 1e-4


def tp_decode_run(tg=None):
    """:data:`TP_DECODE` at tp = ``tg``'s size (None: tp 1): the logits
    of each decode step (the rank's vocab shard gathered), the greedy
    tokens, ms a decode step (host clock around the synchronized loop,
    eager) and the paged decode attention
    launches of the decode loop."""
    from apex_tpu_torch.inference import KVCacheConfig, alloc_pools, write_prompt_kv
    from apex_tpu_torch.models.gpt import (
        GPTConfig, _init_numpy, forward_decode, gpt_forward, shard_params,
    )
    from apex_tpu_torch.transformer.tensor_parallel.mappings import all_gather_dim

    dev = torch.device("cuda", torch.cuda.current_device())
    B, S, n, ps_ = (TP_DECODE[k] for k in ("batch", "prompt", "steps", "page_size"))
    V = 50304
    config = GPTConfig(vocab_size=V, hidden_size=768, num_layers=12, num_attention_heads=12,
                       max_seq_len=1024, position_embedding_type="rope",
                       compute_dtype=torch.float32, checkpoint_layers=False)
    tp = 1 if tg is None else tg.size()
    params = shard_params(_init_numpy(config, 0), config, tg, dev)
    per_seq = -(-(S + n) // ps_)
    pools = alloc_pools(config.num_layers, config.kv_heads // tp, config.head_dim,
                        KVCacheConfig(num_pages=B * per_seq + 1, page_size=ps_,
                                      pages_per_seq=per_seq, dtype=torch.float32), device=dev)
    tables = (1 + torch.arange(B * per_seq, dtype=torch.int32, device=dev)).reshape(B, per_seq)
    prompts = torch.from_numpy(np.random.RandomState(0).randint(0, V, (B, S))).to(dev)

    def whole(logits):
        return logits if tg is None else all_gather_dim(logits, tg, -1)

    logits_all, tokens = [], []
    with torch.no_grad():
        logits, (k, v) = gpt_forward(params, prompts, config, return_kv=True, axis_name=tg)
        for b in range(B):
            write_prompt_kv(pools["k"], pools["v"], k[:, b].transpose(1, 2),
                            v[:, b].transpose(1, 2), tables[b], S)
        tok = whole(logits[-1]).argmax(-1)
        active = torch.ones(B, dtype=torch.bool, device=dev)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for i in range(n):
            pos = torch.full((B,), S + i, dtype=torch.long, device=dev)
            h, _ = forward_decode(params, tok, pos, active, pools, tables, config, axis_name=tg)
            step_logits = whole(torch.matmul(h.float(), params["embed"].float().T))
            logits_all.append(step_logits)
            tok = step_logits.argmax(-1)
            tokens.append(tok)
        torch.cuda.synchronize()
    return (torch.stack(logits_all).cpu(), torch.stack(tokens).cpu().tolist(),
            1e3 * (time.perf_counter() - t0) / n, launch_counts()["paged_decode_attention"])


def tp_decode_child(argv):
    """One rank of ``torchrun --nproc-per-node 2 chip_smoke.py
    tp_decode_child REF``: :func:`tp_decode_run` at tp 2, held against
    the tp 1 run saved at REF (``torch.save`` of its logits and tokens);
    rank 0 prints one ``tp_decode_child`` line with both ranks'
    records."""
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multiproc.initialize_distributed("cuda")
    ps.initialize_model_parallel(tensor_model_parallel_size_=2)
    ref = torch.load(argv[0])
    logits, tokens, ms, launches = tp_decode_run(ps.get_tensor_model_parallel_group())
    mine = {"rank": torch.distributed.get_rank(),
            "max_abs_diff": float((logits - ref["logits"]).abs().max()),
            "tokens_equal": tokens == ref["tokens"], "decode_step_ms": ms,
            "decode_attention_launches": launches}
    ranks = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(ranks, mine)
    multiproc.destroy_distributed()
    if mine["rank"] == 0:
        print(json.dumps({"tp_decode_child": ranks}), flush=True)
    return 0


def tp_decode_multi_card():
    """Tensor-parallel decoding on two cards: :data:`TP_DECODE` at tp 1 in
    this process, then ``tp_decode_child`` at tp 2 over NCCL: every
    rank's fp32 logits within ``TP_DECODE_TOL`` of tp 1's at each of the
    32 steps, its greedy tokens equal to tp 1's, 12 paged decode
    attention launches a step on each rank, ms a decode step at each tp."""
    import tempfile

    logits, tokens, ms, launches = tp_decode_run()
    n = TP_DECODE["steps"]
    with tempfile.TemporaryDirectory() as d:
        ref = str(Path(d) / "tp1.pt")
        torch.save({"logits": logits, "tokens": tokens}, ref)
        ranks = _pp_children(2, [ref], timeout=600, script="tp_decode_child",
                             prefix='{"tp_decode_child"')[0]["tp_decode_child"]
    row = {"phase": "tp_decode_multi_card", "nvidia_smi": _smi(), **TP_DECODE,
           "tp1_decode_step_ms": ms,
           "tp1_decode_attention_launches": launches, "tolerance": TP_DECODE_TOL, "tp2": ranks}
    emit(row)
    bad = [r for r in ranks if not (r["max_abs_diff"] <= TP_DECODE_TOL and r["tokens_equal"]
                                    and r["decode_attention_launches"] == 12 * n)]
    if launches != 12 * n or bad:
        raise AssertionError(f"tp_decode_multi_card: tp 1 launches {launches} (want {12 * n}); "
                             f"{bad}")
    return row


def tp_decode_multi_card_main():
    """``chip_smoke.py tp_decode_multi_card`` on two cards: the kernels
    built, then :func:`tp_decode_multi_card` alone."""
    return _multi_card_alone("tp_decode_multi_card", tp_decode_multi_card, 2)


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


def _pp345_run(tree, fused, eager, steps, M=PP_MICRO, profiler=None, zero=False):
    """``make_pp_train_step`` at GPT-345M (pretrain_gpt's config, the
    seed-0 params ``tree``, FusedAdam(wd 0.01), the seed-0 corpus's first rows, the
    batches the tp phase's steps take) over the registered one-rank
    groups: its losses, step ms (CUDA events after each step; the
    batches are on the card first, no host read in the loop), launch
    counts and peak memory; with ``profiler`` the steps run under it.
    ``zero``: DistributedFusedAdam (the same lr and decay) in FusedAdam's
    place, its state over the model-parallel specs (pretrain_gpt's
    ``--zero`` init)."""
    import gc

    from apex_tpu_torch import pretrain_gpt
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.models.gpt import make_pp_train_step, param_specs, params_from_numpy
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
    if zero:
        opt = DistributedFusedAdam(lr=args.lr, weight_decay=pretrain_gpt.WEIGHT_DECAY)
        state = opt.init(params, world_size=1, param_specs=param_specs(config),
                         axis_sizes={"tp": 1})
    else:
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
                                             ("dense_m1", False, True, 4, 1),
                                             ("zero_fused", True, False, TP_STEPS, PP_MICRO),
                                             ("zero_fused_eager", True, True, 4, PP_MICRO)):
            run = _pp345_run(tree, fused, eager, steps, M=M, zero=name.startswith("zero"))
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
    # ZeRO through the pipelined step (world 1, pp 1, its state over the
    # model specs): every loss bitwise FusedAdam's, graphed and eager
    zero = {}
    for name in ("fused", "fused_eager"):
        got, want = runs["zero_" + name]["losses"], runs[name]["losses"]
        if got != want:
            raise AssertionError(f"zero pp {name}: losses {got} against FusedAdam's {want}")
        zero[name] = {k: runs["zero_" + name][k] for k in (
            "losses", "step_ms_median", "peak_memory_gb", "launches_per_step", "graphs")}
        zero[name]["fused_adam"] = {k: runs[name][k] for k in ("step_ms_median",
                                                                "peak_memory_gb")}
    emit({"phase": "zero_pp", "argv": GPT345_ARGV + ["--fused-ce"], "micro_batches": PP_MICRO,
          "nvidia_smi": smi, "vs_fused_adam": "bitwise", "runs": zero})
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


def _pp_children(n, args, timeout=300, script="pp_child", extra=(), prefix='{"pp_'):
    """``torchrun --nproc-per-node n chip_smoke.py <script> <args>`` (its
    session killed past ``timeout``): the JSON objects its ranks print."""
    rc, out, errs, _ = _child(["torchrun", "--standalone", f"--nproc-per-node={n}",
                               str(ROOT / "chip_smoke.py"), script, *args, *extra], timeout)
    lines = [json.loads(ln) for ln in out if ln.startswith(prefix)]
    if rc != 0 or not lines:
        raise AssertionError(f"{script} world {n} {args} {list(extra)}: exit {rc}\n"
                             + "\n".join(out[-20:] + errs[-40:]))
    return lines


def _profile_window(step, args_of, n=4):
    """``n`` more steps of ``step`` under the profiler (``args_of(i)`` the
    i-th call's arguments): the busy and idle share between the first and
    the last step's update and NCCL's device ms a step."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        for i in range(n):
            step(*args_of(i))
        torch.cuda.synchronize()
    idle = _busy_share(prof, skip=1)
    k = idle["kernel_ms_per_step"]
    return {"idle_share": idle["idle_share"], "window_steps": idle["window_steps"],
            "nccl_ms_per_step": sum(ms for name, ms in k.items() if "nccl" in name.lower()),
            "top_kernels_ms_per_step": dict(list(k.items())[:8])}


def _stages(ranks):
    """A run's per-rank records (``rank``, ``pp_rank``, idle share, NCCL ms,
    peak) as one row a pipeline stage, the stage's first rank's."""
    out = {}
    for r in sorted(ranks, key=lambda r: r["rank"]):
        out.setdefault(r["pp_rank"], {k: r[k] for k in (
            "rank", "idle_share", "nccl_ms_per_step", "peak_memory_gb") if k in r})
    return [out[k] for k in sorted(out)]


def pp_multi_card(world, eager=False):
    """The pipelined layouts over NCCL, one card a rank, at GPT-345M with
    ``--fused-ce``, 10 steps each, held within ``TP_BAND`` of ``--pp 1``'s
    losses on the same global batch: ``torchrun -m
    apex_tpu_torch.pretrain_gpt --pp 1`` (one card, ``make_train_step``),
    then under the profiler (``pp_child``: every rank's step ms from CUDA
    events, idle share and NCCL ms a step, peak) pp 2 at 8 microbatches
    (with four cards), pp 4 at 8 and at 2 (the reference's default),
    tp 2 x pp 2 at 8 with the fused and the dense head (four cards), and
    the interleaved schedule (``vpp_child``, vpp 2) at pp 2 and pp 4.
    The bubble share is ``(pp - 1) / (vpp M + pp - 1)``.  Each result is
    printed (a ``pp_multi_card`` line) as it comes, and a run beyond the
    band fails the check only after every run has printed.  ``eager``
    runs every step eagerly."""
    ex = ["--eager"] if eager else []
    out = {"ran": True, "cards": torch.cuda.device_count(), "world": world, "band": TP_BAND,
           "eager": eager, "timed": []}
    n = 4 if world >= 4 else 2
    runs = [(1, 1, 8, 1, "fused")] + ([(2, 1, 8, 1, "fused")] if world >= 4 else []) \
        + [(n, 1, 8, 1, "fused"), (n, 1, 2, 1, "fused")] \
        + ([(2, 2, 8, 1, "fused"), (2, 2, 8, 1, "dense")] if world >= 4 else []) \
        + [(2, 1, 8, 2, "fused")] + ([(4, 1, 8, 2, "fused")] if world >= 4 else [])
    failed = []
    for pp, tp, M, vpp, head in runs:
        head_flag = ["--fused-ce"] if head == "fused" else []
        if pp == 1:
            rep = _torchrun_pretrain(1, GPT345_ARGV + ["--steps", "10"] + head_flag + ex)
            ranks, losses, step_ms = [], rep["losses"], rep["step_ms"]
        elif vpp > 1:
            lines = _pp_children(pp, [], script="vpp_child", extra=[
                "--pp", str(pp), "--vpp", str(vpp), "--micro-batches", str(M), "--steps",
                "10"] + ex, prefix='{"vpp_child"')
            rep = lines[0]["vpp_child"]
            ranks, losses, step_ms = rep["ranks"], rep["losses"], rep["step_ms"]
        else:
            lines = _pp_children(pp * tp, GPT345_ARGV + [
                "--pp", str(pp), "--tp", str(tp), "--micro-batches", str(M), "--steps", "10"]
                + head_flag + ex)
            ranks = [ln["pp_profile"] for ln in lines]
            r0 = next(r for r in ranks if r["rank"] == 0)
            losses, step_ms = r0["losses"], r0["step_ms"]
        row = {"pp": pp, "tp": tp, "vpp": vpp, "head": head,
               "micro_batches": M if pp > 1 else None,
               "step_ms_median": float(np.median(step_ms[2:])), "step_ms": step_ms,
               "losses": losses, "profiled": pp > 1,
               "bubble_share": (pp - 1) / (vpp * M + pp - 1), "stages": _stages(ranks)}
        if out["timed"]:
            want = out["timed"][0]["losses"]
            row["max_rel_diff"] = max(abs(a - b) / abs(b) for a, b in zip(row["losses"], want))
            if not row["max_rel_diff"] <= TP_BAND:  # NaN fails too
                failed.append(f"pp {pp} x tp {tp} vpp {vpp} at M {M} ({head}): losses "
                              f"{row['losses']} against pp 1's {want}, beyond {TP_BAND}")
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
    events after each step, then 4 steps under the profiler (each rank's
    idle share and NCCL ms a step).  The world is torn down with the step
    (and its graph) alive: :func:`apex_tpu_torch.parallel.destroy_distributed`
    frees the graphs first.  Rank 0 prints the losses, step ms, every
    rank's profile and peak memory, and the teardown's seconds: the run
    that lifted the interleaved schedule's refusal over NCCL (ROADMAP.md
    section 3)."""
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
    torch.cuda.reset_peak_memory_stats()
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
    rank = torch.distributed.get_rank()
    mine = {"rank": rank, "pp_rank": ps.get_pipeline_model_parallel_rank(),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            **_profile_window(step, lambda i: (params, state, rows[i][:, :-1],
                                               rows[i][:, 1:]))}
    ranks = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(ranks, mine)
    rep = {"losses": [float(x) for x in losses],
           "step_ms": [e0.elapsed_time(e1) for e0, e1 in zip(events, events[1:])],
           "ranks": ranks}
    t0 = time.monotonic()
    multiproc.destroy_distributed()  # the step, its graph with it, still alive here
    rep["teardown_s"] = time.monotonic() - t0
    if rank == 0:
        print(json.dumps({"vpp_child": rep}), flush=True)
    del step
    return 0


#: ``zero_child``'s dp split for the hierarchical wire (2 x 2 at world 4)
ZERO_HIER = {"dp_out": 2, "dp_in": 2}


def zero_child(argv):
    """One rank of ``torchrun --nproc-per-node N chip_smoke.py zero_child
    --tp T --pp P [--micro-batches M] [--hier] [--steps S]``: GPT-345M
    (pretrain_gpt's config, the fused head, the seed-0 params), graphed,
    8 rows of the seed-0 corpus a dp rank a step, through
    ``make_train_step`` (pp 1) or ``make_pp_train_step``.  For each
    optimizer in turn -- FusedAdam, then ``DistributedFusedAdam`` over
    the model specs (pretrain_gpt's ``--zero``); with ``--hier`` the flat
    ZeRO wire, then the (2, 2) split's wide and int8 wires -- S timed
    steps (CUDA events), then 4 under the profiler; every rank's peak
    memory, idle share and NCCL ms a step gathered to rank 0, which
    prints one ``zero_child`` line."""
    import argparse
    import gc

    from apex_tpu_torch import pretrain_gpt
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.models.gpt import (
        _init_numpy, make_pp_train_step, param_specs, shard_params,
    )
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.tree import tree_leaves
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.train_gpt import make_train_step
    from apex_tpu_torch.transformer import parallel_state as ps

    ap = argparse.ArgumentParser()
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--micro-batches", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--hier", action="store_true")
    a = ap.parse_args(argv)
    dev = multiproc.initialize_distributed("cuda")
    ps.initialize_model_parallel(tensor_model_parallel_size_=a.tp,
                                 pipeline_model_parallel_size_=a.pp)
    args = pretrain_gpt.build_args().parse_args(GPT345_ARGV + ["--fused-ce"])
    config = pretrain_gpt.make_config(args)
    tree = _init_numpy(config, 0)
    dp_g, tp_g, pp_g = (ps.get_data_parallel_group(), ps.get_tensor_model_parallel_group(),
                        ps.get_pipeline_model_parallel_group())
    pipe = pp_g if a.pp > 1 else None
    dp = dp_g.size()
    corpus = pretrain_gpt.load_corpus(args)
    gb = 8 * dp
    rows = [torch.from_numpy(np.ascontiguousarray(
        corpus[i * gb + 8 * dp_g.rank():i * gb + 8 * dp_g.rank() + 8], np.int64)).to(dev)
        for i in range(a.steps + 4)]
    sizes = {"tp": a.tp, **({"pp": a.pp} if a.pp > 1 else {})}
    hier = {"dp_axes": tuple(ZERO_HIER)}
    variants = ([("zero_flat", {}), ("zero_hier", hier),
                 ("zero_hier_int8", {**hier, "grad_sync_dtype": "int8"})] if a.hier
                else [("fused_adam", None), ("zero", {})])
    rank = torch.distributed.get_rank()
    out = {}
    for name, kw in variants:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = shard_params(tree, config, tp_g, dev, keep_fp32=True, pp_group=pipe)
        dp_group = dp_g
        if kw is None:
            opt = FusedAdam(lr=args.lr, weight_decay=pretrain_gpt.WEIGHT_DECAY)
            state = opt.init(params)
        else:
            opt = DistributedFusedAdam(lr=args.lr, weight_decay=pretrain_gpt.WEIGHT_DECAY, **kw)
            state = opt.init(params, world_size=dp, param_specs=param_specs(config, a.pp > 1),
                             axis_sizes={**sizes, **(ZERO_HIER if "dp_axes" in kw else {})})
            if "dp_axes" in kw:
                dp_group = ps.get_data_parallel_hop_groups(tuple(ZERO_HIER),
                                                           tuple(ZERO_HIER.values()))
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        step = (make_pp_train_step(config, opt, a.micro_batches, dp_group=dp_group,
                                   tp_group=tp_g) if a.pp > 1
                else make_train_step(opt, config, dp_group=dp_group, tp_group=tp_g))
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()
        losses = []
        for r in rows[:a.steps]:
            losses.append(step(params, state, r[:, :-1], r[:, 1:]).detach().clone())
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        torch.cuda.synchronize()
        mine = {"rank": rank, "pp_rank": pp_g.rank(),
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                **_profile_window(step, lambda i: (params, state, rows[a.steps + i][:, :-1],
                                                   rows[a.steps + i][:, 1:]))}
        ranks = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(ranks, mine)
        step_ms = [e0.elapsed_time(e1) for e0, e1 in zip(events, events[1:])]
        out[name] = {"losses": [float(x) for x in losses], "step_ms": step_ms,
                     "step_ms_median": float(np.median(step_ms[2:])), "ranks": ranks}
        del step, params, state, opt
    multiproc.destroy_distributed()
    if rank == 0:
        print(json.dumps({"zero_child": {"tp": a.tp, "pp": a.pp, "dp": dp,
                                         "micro_batches": a.micro_batches if a.pp > 1 else None,
                                         **out}}), flush=True)
    return 0


#: the overlap check's runs: (name, optimizer, its kwargs, hierarchical,
#: the step's grad_sync_dtype)
OVERLAP_RUNS = (("zero_flat", "zero", {}, False, None),
                ("zero_hier", "zero", {"dp_axes": tuple(ZERO_HIER)}, True, None),
                ("zero_hier_int8", "zero", {"dp_axes": tuple(ZERO_HIER),
                                            "grad_sync_dtype": "int8"}, True, None),
                ("fused_adam_int8", "fused_adam", {}, False, "int8"))


def _exposed_nccl_ms(prof, skip=1, kernel="mt_adam_kernel"):
    """``(exposed, total)``: NCCL's device ms a step that no other kernel
    overlaps (what the compute waits on) and all of NCCL's ms a step,
    over the steps after the ``skip``-th (from the end of that step's
    update, as :func:`_busy_share` takes its window)."""
    from torch.autograd import DeviceType

    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    ends = sorted(end for _, end, name in spans if kernel in name)
    if len(ends) <= skip:
        raise AssertionError(f"overlap profile: {len(ends)} {kernel} records")
    lo, hi = ends[skip - 1], ends[-1]

    def union(iv):
        out = []
        for s, e in sorted((max(s, lo), min(e, hi)) for s, e in iv if e > lo and s < hi):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    nccl = union([(s, e) for s, e, n in spans if "nccl" in n.lower()])
    other = union([(s, e) for s, e, n in spans if "nccl" not in n.lower()])
    covered = sum(max(0.0, min(e, oe) - max(s, os_)) for s, e in nccl for os_, oe in other)
    total = sum(e - s for s, e in nccl)
    steps = len(ends) - skip
    return (total - covered) / 1e3 / steps, total / 1e3 / steps


def overlap_child(argv):
    """One rank of ``torchrun --nproc-per-node 4 chip_smoke.py
    overlap_child [--steps S]``: GPT-345M (pretrain_gpt's config, the
    fused head, the seed-0 params), graphed, 8 rows of the seed-0 corpus
    a dp rank a step, dp 4, through ``make_train_step`` with
    ``overlap_grad_sync`` off and then on for each of ``OVERLAP_RUNS``:
    DistributedFusedAdam on the flat group, on the (2, 2) split and on
    its int8 wire, and FusedAdam with ``grad_sync_dtype="int8"``.  Each
    run: S timed steps (CUDA events), the losses and every param held
    bitwise against the run with the overlap off, then 4 steps under the
    profiler (NCCL ms a step, the part no other kernel overlaps, idle
    share) and the peak memory; rank 0 prints one ``overlap_child`` line
    with every rank's records."""
    import argparse
    import gc

    from apex_tpu_torch import pretrain_gpt
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.models.gpt import _init_numpy, params_from_numpy
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.tree import tree_leaves
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.train_gpt import make_train_step
    from apex_tpu_torch.transformer import parallel_state as ps

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    a = ap.parse_args(argv)
    dev = multiproc.initialize_distributed("cuda")
    ps.initialize_model_parallel()
    args = pretrain_gpt.build_args().parse_args(GPT345_ARGV + ["--fused-ce"])
    config = pretrain_gpt.make_config(args)
    tree = _init_numpy(config, 0)
    dp_g = ps.get_data_parallel_group()
    hops = ps.get_data_parallel_hop_groups(tuple(ZERO_HIER), tuple(ZERO_HIER.values()))
    dp = dp_g.size()
    corpus = pretrain_gpt.load_corpus(args)
    gb = 8 * dp
    rows = [torch.from_numpy(np.ascontiguousarray(
        corpus[i * gb + 8 * dp_g.rank():i * gb + 8 * dp_g.rank() + 8], np.int64)).to(dev)
        for i in range(a.steps + 4)]
    rank = torch.distributed.get_rank()
    out = {}
    for name, kind, kw, hier, gsd in OVERLAP_RUNS:
        ref = None
        for overlap in (False, True):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            params = params_from_numpy(tree, config, dev, keep_fp32=True)
            if kind == "zero":
                opt = DistributedFusedAdam(lr=args.lr, weight_decay=pretrain_gpt.WEIGHT_DECAY,
                                           **kw)
                state = opt.init(params, world_size=dp,
                                 axis_sizes=dict(ZERO_HIER) if hier else None)
            else:
                opt = FusedAdam(lr=args.lr, weight_decay=pretrain_gpt.WEIGHT_DECAY)
                state = opt.init(params)
            for leaf in tree_leaves(params):
                leaf.requires_grad_(True)
            step = make_train_step(opt, config, dp_group=hops if hier else dp_g,
                                   overlap_grad_sync=overlap, grad_sync_dtype=gsd)
            events = [torch.cuda.Event(enable_timing=True)]
            events[0].record()
            losses = []
            for r in rows[:a.steps]:
                losses.append(step(params, state, r[:, :-1], r[:, 1:]).detach().clone())
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            torch.cuda.synchronize()
            losses = [float(x) for x in losses]
            leaves = [t.detach() for t in tree_leaves((params, state))]
            if ref is None:
                ref = (losses, [t.clone() for t in leaves])
                bitwise = None
            else:
                bitwise = losses == ref[0] and all(
                    torch.equal(x, y) for x, y in zip(leaves, ref[1], strict=True))
            del leaves
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            with prof:
                for i in range(4):
                    step(params, state, rows[a.steps + i][:, :-1], rows[a.steps + i][:, 1:])
                torch.cuda.synchronize()
            exposed, nccl = _exposed_nccl_ms(prof)
            mine = {"rank": rank, "bitwise_vs_off": bitwise,
                    "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "nccl_ms_per_step": nccl, "exposed_nccl_ms_per_step": exposed,
                    "idle_share": _busy_share(prof, skip=1)["idle_share"]}
            ranks = [None] * torch.distributed.get_world_size()
            torch.distributed.all_gather_object(ranks, mine)
            step_ms = [e0.elapsed_time(e1) for e0, e1 in zip(events, events[1:])]
            out.setdefault(name, {})["on" if overlap else "off"] = {
                "losses": losses, "step_ms": step_ms,
                "step_ms_median": float(np.median(step_ms[2:])), "ranks": ranks}
            del step, params, state, opt, prof
        del ref
    multiproc.destroy_distributed()
    if rank == 0:
        print(json.dumps({"overlap_child": {"dp": dp, **out}}), flush=True)
    return 0


def overlap_multi_card():
    """The backward-overlapped dp grad sync on four cards
    (``overlap_child``, GPT-345M, dp 4, fused CE, graphed, 10 steps): for
    each of ``OVERLAP_RUNS`` the overlap on against off, losses and
    params bitwise on every rank, with each run's step ms, NCCL ms and
    exposed NCCL ms a step and peak memory a rank (one
    ``overlap_multi_card`` line a run); fails after the last run if one
    was not bitwise."""
    rep = _pp_children(4, [], timeout=600, script="overlap_child",
                       prefix='{"overlap_child"')[0]["overlap_child"]
    failed = []
    for name, *_ in OVERLAP_RUNS:
        r = rep[name]
        row = {"run": name, "dp": rep["dp"]}
        for side in ("off", "on"):
            x = r[side]
            row[side] = {"losses": x["losses"], "step_ms_median": x["step_ms_median"],
                         "peak_memory_gb_per_rank": [y["peak_memory_gb"] for y in x["ranks"]],
                         "nccl_ms_per_step_per_rank": [y["nccl_ms_per_step"]
                                                       for y in x["ranks"]],
                         "exposed_nccl_ms_per_step_per_rank": [
                             y["exposed_nccl_ms_per_step"] for y in x["ranks"]],
                         "idle_share_per_rank": [y["idle_share"] for y in x["ranks"]]}
        row["bitwise"] = all(y["bitwise_vs_off"] for y in r["on"]["ranks"])
        row["step_ms_saved"] = r["off"]["step_ms_median"] - r["on"]["step_ms_median"]
        emit({"overlap_multi_card": row})
        if not row["bitwise"] or not all(map(math.isfinite, r["on"]["losses"])):
            failed.append(f"{name}: on {r['on']['losses']} against off {r['off']['losses']}")
    if failed:
        raise AssertionError("overlap_multi_card: " + "; ".join(failed))
    return rep


#: the tp 2 x pp 2 bisection (ROADMAP.md section 3): each variant one
#: ``torchrun --nproc-per-node 4 chip_smoke.py pp_bisect_child`` at GPT-345M
#: width (hidden 1024, 16 heads, vocab 50304, seq 1024, global batch 8)
BISECT_VARIANTS = (
    ("tp2pp2_24L_m8_fused_graphed", ["--tp", "2", "--layers", "24"]),
    ("pp2_24L_m8_fused_graphed", ["--tp", "1", "--pp", "2", "--layers", "24"]),
    ("tp2pp2_4L_m8_fused_eager", ["--tp", "2", "--layers", "4", "--eager", "--probe"]),
    ("tp2pp2_4L_m8_dense_eager", ["--tp", "2", "--layers", "4", "--eager", "--dense",
                                  "--probe"]),
    ("tp2pp2_4L_m2_fused_eager", ["--tp", "2", "--layers", "4", "--eager",
                                  "--micro-batches", "2", "--probe"]),
    ("tp2pp2_4L_m8_fused_eager_sp", ["--tp", "2", "--layers", "4", "--eager",
                                     "--sequence-parallel", "--probe"]),
    ("tp2pp2_24L_m8_fused_eager", ["--tp", "2", "--layers", "24", "--eager", "--probe"]),
    ("pp2_4L_m8_fused_eager", ["--tp", "1", "--pp", "2", "--layers", "4", "--eager",
                               "--probe"]),
    ("tp2pp2_4L_m8_fused_eager_sync", ["--tp", "2", "--layers", "4", "--eager", "--probe",
                                       "--sync-p2p"]),
)


def pp_bisect_child(argv):
    """One rank of ``torchrun --nproc-per-node 4 chip_smoke.py pp_bisect_child
    --tp T [--pp P] --layers L [--micro-batches M] [--steps S] [--eager]
    [--dense] [--sequence-parallel] [--probe] [--sync-p2p]``:
    ``make_pp_train_step`` at GPT-345M width (pretrain_gpt's config, the
    seed-0 params, FusedAdam(wd 0.01), the seed-0 corpus's rows) over
    NCCL, with ``faulthandler`` on.  ``--probe`` checks every unit's
    input, output and cotangents for non-finite values (the first one a
    rank meets is reported with its step, unit, chunk and microbatch),
    keeps a float64 sum of every message sent and received (each pair's
    sequences are compared after the run), and on the last stage holds
    each microbatch's fused CE head against the dense one on the same
    activations; ``--sync-p2p`` synchronizes the device after each
    stage-to-stage exchange.  Rank 0 prints one ``pp_bisect`` line."""
    import argparse
    import dataclasses
    import faulthandler

    from apex_tpu_torch import pretrain_gpt
    from apex_tpu_torch.models import gpt as tgpt
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.tree import tree_leaves
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication as p2p
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import tick_schedule as ts

    faulthandler.enable()
    ap = argparse.ArgumentParser()
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--pp", type=int, default=2)
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--micro-batches", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--sequence-parallel", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--sync-p2p", action="store_true")
    a = ap.parse_args(argv)
    dev = multiproc.initialize_distributed("cuda")
    ps.initialize_model_parallel(tensor_model_parallel_size_=a.tp,
                                 pipeline_model_parallel_size_=a.pp)
    flags = list(GPT345_ARGV)
    flags[flags.index("--layers") + 1] = str(a.layers)
    flags += ([] if a.dense else ["--fused-ce"]) + (
        ["--sequence-parallel"] if a.sequence_parallel else [])
    args = pretrain_gpt.build_args().parse_args(flags)
    config = pretrain_gpt.make_config(args)
    tp_g, pp_g = ps.get_tensor_model_parallel_group(), ps.get_pipeline_model_parallel_group()
    params = tgpt.shard_params(tgpt._init_numpy(config, 0), config, tp_g, dev, keep_fp32=True,
                               pp_group=pp_g)
    rank = torch.distributed.get_rank()
    rec = {"rank": rank, "pp_rank": pp_g.rank(), "tp_rank": tp_g.rank(),
           "params_finite": all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)),
           "first_nonfinite": None, "messages": [], "head": []}
    where = {"step": -1}

    def csum(t):
        return float(t.detach().double().sum())

    def check(what, t):
        if t is None or rec["first_nonfinite"] is not None:
            return
        if not bool(torch.isfinite(t).all()):
            rec["first_nonfinite"] = {"step": where["step"], "at": what,
                                      "nan": int(torch.isnan(t).sum()),
                                      "inf": int(torch.isinf(t).sum()), "numel": t.numel()}

    comm = p2p._communicate

    def communicate(send_next, send_prev, recv_prev, recv_next, shape, dtype, device,
                    group=None):
        g = p2p._group(group)
        n, me = g.size(), g.rank()
        nxt, prv = g.ranks[(me + 1) % n], g.ranks[(me - 1) % n]
        if a.probe:
            for t, peer, kind in ((send_next, nxt, "act"), (send_prev, prv, "grad")):
                if t is not None:
                    rec["messages"].append(["send", peer, kind, csum(t)])
        out = comm(send_next, send_prev, recv_prev, recv_next, shape, dtype, device, group)
        if a.sync_p2p:
            torch.cuda.synchronize()
        if a.probe:
            for t, peer, kind in ((out[0], prv, "act"), (out[1], nxt, "grad")):
                if t is not None:
                    rec["messages"].append(["recv", peer, kind, csum(t)])
        return out

    p2p._communicate = communicate
    if a.probe:
        fwd, bwd, head = ts._Units.forward, ts._Units.backward, tgpt.lm_head_loss

        def forward(self, v, m, x_in):
            check(f"F chunk {v} mb {m} input", x_in)
            y = fwd(self, v, m, x_in)
            check(f"F chunk {v} mb {m} output", y if y is not None else self.loss_sum)
            return y

        def backward(self, v, m, dy):
            check(f"B chunk {v} mb {m} cotangent in", dy)
            dx = bwd(self, v, m, dy)
            check(f"B chunk {v} mb {m} cotangent out", dx)
            return dx

        def lm_head_loss(x, embed, targets, cfg, axis_name=None):
            check("head input", x)
            out = head(x, embed, targets, cfg, axis_name)
            if cfg.fused_ce and torch.is_grad_enabled():
                with torch.no_grad():
                    ref = head(x, embed, targets, dataclasses.replace(cfg, fused_ce=False),
                               axis_name)
                rec["head"].append([where["step"], float(out.detach().mean()),
                                    float(ref.mean())])
            return out

        ts._Units.forward, ts._Units.backward = forward, backward
        tgpt.lm_head_loss = lm_head_loss
    opt = FusedAdam(lr=args.lr, weight_decay=pretrain_gpt.WEIGHT_DECAY)
    state = opt.init(params)
    step = tgpt.make_pp_train_step(config, opt, a.micro_batches,
                                   graphs=False if a.eager else None,
                                   dp_group=ps.get_data_parallel_group(), tp_group=tp_g)
    corpus = pretrain_gpt.load_corpus(args)
    gb = args.global_batch
    losses = []
    for i in range(a.steps):
        where["step"] = i
        r = torch.from_numpy(np.ascontiguousarray(corpus[i * gb:(i + 1) * gb], np.int64)).to(dev)
        losses.append(float(step(params, state, r[:, :-1], r[:, 1:])))
    rec["losses"] = losses
    recs = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(recs, rec)
    multiproc.destroy_distributed()
    if rank != 0:
        return 0
    # each ordered pair's messages: what one rank sent against what the
    # other received, in order
    bad = []
    for src in recs:
        for dst in recs:
            for kind in ("act", "grad"):
                sent = [s for op, peer, k, s in src["messages"]
                        if op == "send" and peer == dst["rank"] and k == kind]
                got = [s for op, peer, k, s in dst["messages"]
                       if op == "recv" and peer == src["rank"] and k == kind]
                if sent != got:
                    i = next((j for j, (x, y) in enumerate(zip(sent, got)) if x != y),
                             min(len(sent), len(got)))
                    bad.append({"src": src["rank"], "dst": dst["rank"], "kind": kind,
                                "sent": len(sent), "received": len(got), "first_differs": i})
    print(json.dumps({"pp_bisect": {
        "argv": argv, "losses": losses, "messages_checked": sum(
            len(r["messages"]) for r in recs) if a.probe else None,
        "message_mismatches": bad if a.probe else None,
        "ranks": [{k: r[k] for k in ("rank", "pp_rank", "tp_rank", "params_finite",
                                     "first_nonfinite", "head")} for r in recs]}}),
          flush=True)
    return 0


def pp_bisect_main():
    """``chip_smoke.py pp_bisect`` on four cards: the kernels built, then
    each of :data:`BISECT_VARIANTS` as its own ``torchrun`` world (180 s
    each, its session killed past that).  Every result is printed as it
    comes (a ``pp_bisect`` line); after the last, it raises if a world
    did not end with rc 0, a loss or a probed tensor was not finite, or
    a message arrived other than it was sent."""
    from apex_tpu_torch.ops import _build

    n_cards = torch.cuda.device_count()
    if n_cards < 4:
        raise SystemExit(f"chip_smoke pp_bisect: needs four cards, has {n_cards}")
    emit({"phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
          "nccl": list(torch.cuda.nccl.version()), "count": n_cards, "nvidia_smi": _smi()})
    emit({"phase": "build", "seconds": _build.build(force=True)})
    _build.load()

    def world(cmd, timeout=180):
        t0 = time.monotonic()
        try:
            rc, lines, errs, _ = _child(cmd, timeout)
        except TimeoutError as exc:
            return {"rc": None, "error": str(exc)[-4000:], "seconds": time.monotonic() - t0}
        out = {"rc": rc, "seconds": time.monotonic() - t0}
        for ln in lines:
            if ln.startswith("{"):
                out.update(json.loads(ln))
        if rc != 0:
            out["stderr"] = "\n".join(errs[-40:])
        return out

    failed = []
    for name, flags in BISECT_VARIANTS:
        pp = int(flags[flags.index("--pp") + 1]) if "--pp" in flags else 2
        n = pp * int(flags[flags.index("--tp") + 1])
        res = world(["torchrun", "--standalone", f"--nproc-per-node={n}",
                     str(ROOT / "chip_smoke.py"), "pp_bisect_child", *flags])
        emit({"pp_bisect": {"variant": name, **res}})
        rep = res.get("pp_bisect")
        if res["rc"] != 0 or rep is None:
            failed.append(f"{name}: rc {res['rc']}")
        elif not all(np.isfinite(rep["losses"])) or rep["message_mismatches"] or any(
                r["first_nonfinite"] is not None for r in rep["ranks"]):
            failed.append(f"{name}: losses {rep['losses']}, first non-finite "
                          f"{[r['first_nonfinite'] for r in rep['ranks']]}, message "
                          f"mismatches {rep['message_mismatches']}")
    if failed:  # after every world, so that one fault keeps the others' lines
        raise AssertionError("pp_bisect: " + "; ".join(failed))
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

    from apex_tpu_torch import pretrain_gpt

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    rep = _pretrain_here(argv, profiler=prof)
    args = pretrain_gpt.build_args().parse_args(argv)
    idle = _busy_share(prof)
    k = idle["kernel_ms_per_step"]
    nccl = sum(ms for name, ms in k.items() if "nccl" in name.lower())
    print(json.dumps({"pp_profile": {
        "rank": rep["rank"], "pp_rank": (rep["rank"] // args.tp) % args.pp,
        "step_ms": rep["step_ms"],
        "idle_share": idle["idle_share"], "busy_ms": idle["busy_ms"],
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


def _phases_alone(phases):
    """One card: the kernels built, then each of ``phases`` (``(name,
    fn(smi))``) in turn, with their seconds (``chip_smoke.py bert``,
    ``resnet``, ``resilience``)."""
    from apex_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    emit({"phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    seconds = {"build": _build.build(force=True)}
    _build.load()
    for name, fn in phases:
        t0 = time.monotonic()
        fn(smi)
        seconds[name] = time.monotonic() - t0
    emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
    return 0


#: the phases ``chip_smoke.py resilience`` runs alone (not in the
#: no-argument run)
RESILIENCE_PHASES = (("supervised", supervised_phase),
                     ("serve_resilience", serve_resilience_phase), ("fleet", fleet_phase))


# ----------------------------------------------------------- bert, resnet
#: bench.py's ``bert_base_lamb`` section (bench.py:658-735): BERT-Large
#: (24 layers, hidden 1024, 16 heads), S 512, batch 16, vocab 30528, bf16,
#: full remat, ``FusedLAMB(lr=1e-3, weight_decay=0.01)``
BERT_LARGE = {"num_layers": 24, "hidden_size": 1024, "num_attention_heads": 16,
              "max_seq_len": 512, "vocab_size": 30528}
BERT_BATCH = 16
BERT_LAMB = {"lr": 1e-3, "weight_decay": 0.01}
#: steps of each bert run (graphed and eager; the first warms up, the
#: graphed run captures after it)
BERT_STEPS = 10
#: the fp32 card-against-CPU checks (relative to the largest entry; a
#: grad leaf against the largest of its own entries, :func:`_grads_errs`)
BERT_CPU_TOL = 1e-5
RESNET_CPU_TOL = 1e-4
#: models_multi_card: BERT's first fp32 loss at tp 2 (4 layers) against
#: tp 1; ResNet-50's fp32 first step at dp 2 (SyncBN) against one card at
#: the same global batch (the loss, the running statistics, every grad
#: leaf and the grads' L2), taken with the last batch norm of every
#: bottleneck zero-scaled and at :data:`RESNET_PARITY_SIZE`
#: (:func:`_resnet50_fp32_step`); SyncBN over an uneven split against the
#: full batch
BERT_TP_TOL = 1e-4
RESNET_DP_TOL = 1e-4
SYNCBN_TOL = 1e-4
#: the resnet phase: bench.py's ``resnet50_b64`` section (bench.py:607-655:
#: ResNet-50, one batch of 64 at 224 x 224 repeated, 1000 classes,
#: FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4) with master
#: weights) through the trainer's step under amp O2
RESNET_SGD = {"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-4}
RESNET_STEPS = 10
#: the uneven SyncBN split of models_multi_card, rows a rank, and its shape
SYNCBN_SPLIT = (24, 40)
SYNCBN_SHAPE = (64, 256, 56, 56)
#: the image size of ResNet-50's fp32 dp 2 parity (a batch of 64)
RESNET_PARITY_SIZE = 64


def bert_batch(B=BERT_BATCH, S=512, V=30528):
    """bench.py's BERT batch (``np.random.RandomState(0)``): tokens,
    targets, key lengths S/2..S, the padding mask and the loss mask (15 %
    of the valid positions)."""
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, V, size=(B, S))
    targets = rng.randint(0, V, size=(B, S))
    lengths = rng.randint(S // 2, S + 1, size=B)
    pad = np.arange(S)[None, :] < lengths[:, None]
    loss_mask = ((rng.rand(B, S) < 0.15) & pad).astype(np.float32)
    return tokens, targets, lengths, pad, loss_mask


#: the flash kernels at the bert phase's attention: (16, 16, 512, 64),
#: bidirectional, the batch's key-padding mask
BERT_FLASH = {"B": BERT_BATCH, "H": 16, "Hkv": 16, "S": 512, "D": 64, "causal": False,
              "lengths": tuple(int(n) for n in bert_batch()[2])}


def bert_expect(fused, L=24):
    """Kernel launches of one BERT train step: LayerNorm forward 2 + 2L
    and 2L more in the layers' recompute, backward 2 + 2L; flash forward
    L + L recomputed, dq and dkv L; the CE kernels once with the fused
    head."""
    return {"layer_norm_fwd": 2 + 4 * L, "layer_norm_bwd": 2 + 2 * L, "flash_fwd": 2 * L,
            "flash_dq": L, "flash_dkv": L, "ce_fwd": int(fused), "ce_dx": int(fused),
            "ce_dembed": int(fused)}


def _grads_rel(got, want):
    """The largest of :func:`_grads_errs`."""
    return max(_grads_errs(got, want))


def _grads_l2(got, want):
    """||got - want|| / ||want|| over every leaf at once."""
    num = sum(float(((g.double() - w.double()) ** 2).sum()) for g, w in zip(got, want))
    return math.sqrt(num / sum(float((w.double() ** 2).sum()) for w in want))


def _grads_errs(got, want):
    """Per leaf, max |got - want| / max |want|.  A leaf
    whose largest |want| is under 1e-6 of the largest of any leaf has a
    gradient that is zero but for rounding (BERT's key bias: softmax does
    not see a per-row constant); it counts by its largest |got| and
    |want| over that largest one instead, which must be as small."""
    top = max(float(w.abs().max()) for w in want)
    errs = []
    for g, w in zip(got, want):
        if float(w.abs().max()) < 1e-6 * top:
            errs.append(max(float(g.abs().max()), float(w.abs().max())) / top)
        else:
            errs.append(float((g.float() - w.float()).abs().max()) / float(w.abs().max()))
    return errs


def _bert_tensors(dev, B=BERT_BATCH):
    tokens, targets, _, pad, loss_mask = (a[:B] for a in bert_batch())
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (tokens, targets, loss_mask, pad)]


def _bert_train(cfg, pristine, batch, eager, axis_name=None, steps=BERT_STEPS):
    """``steps`` of ``models.bert.make_train_step`` with FusedLAMB from a
    copy of ``pristine``: losses, per-step launches (counted from 0), ms
    a step (median after the warm-up and capture), peak GB."""
    from apex_tpu_torch.models import bert
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map

    dev = batch[0].device
    params = tree_map(lambda t: t.detach().clone(), pristine)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt = FusedLAMB(**BERT_LAMB)
    state = opt.init(params)
    step = bert.make_train_step(opt, cfg, graphs=False if eager else None, axis_name=axis_name)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(step(params, state, *batch).clone())
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    counts = launch_counts()
    ms = 1e3 * float(np.median(times[2:]))
    rec = {"losses": [float(x) for x in losses], "step_ms": [1e3 * t for t in times],
           "step_ms_median": ms, "counts": counts,
           "tokens_per_sec": batch[0].numel() / ms * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "graphs": not eager and getattr(step, "graph", None) is not None}
    del params, state, step
    torch.cuda.empty_cache()
    return rec


def bert_lamb_ms(pristine, iters=10):
    """The FusedLAMB update alone over BERT-Large's params (the engine
    path, in place, fp32 grads of 1e-3 noise): ms a call between CUDA
    events, the optimizer's share of a bert step."""
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.optimizers.tree import tree_map

    params = tree_map(lambda t: t.detach().clone(), pristine)
    gen = torch.Generator(device=next(iter(params.values())).device).manual_seed(0)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=gen, device=t.device) * 1e-3,
                     params)
    opt = FusedLAMB(**BERT_LAMB)
    state = opt.init(params)
    ms = call_ms(lambda: opt.update(grads, state, params, inplace=True), iters)
    del params, grads, state
    torch.cuda.empty_cache()
    return ms


def bert_cpu_parity(dev, layers=2, B=2):
    """An fp32 BERT of ``layers`` layers at BERT-Large's widths, ``B`` rows
    of the bert batch: logits, MLM loss and every grad on the card against
    the same calls on the CPU (the flash and LN kernels' fp32
    instantiations against their plain versions)."""
    from apex_tpu_torch.models import bert
    from apex_tpu_torch.optimizers.tree import leaves_with_path, tree_leaves

    cfg = bert.BertConfig(**{**BERT_LARGE, "num_layers": layers}, compute_dtype=torch.float32,
                          checkpoint_layers=False)
    tree = bert._init_numpy(cfg, torch.Generator().manual_seed(1))
    out = {}
    for d in ("cpu", dev):
        tokens, targets, loss_mask, pad = _bert_tensors(d, B)
        p = bert.params_from_numpy(tree, cfg, d)
        with torch.no_grad():
            logits = bert.bert_forward(p, tokens, pad_mask=pad, config=cfg).cpu()
        leaves = tree_leaves(p)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = bert.bert_mlm_loss(p, tokens, targets, loss_mask, cfg, pad_mask=pad)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        out[str(d)] = (logits, float(loss.detach()), [g.cpu() for g in grads])
    (lc, sc, gc), (lg, sg, gg) = out["cpu"], out[str(dev)]
    by_leaf = dict(zip((k for k, _ in leaves_with_path(p)), _grads_errs(gg, gc)))
    errs = {"logits": rel_err(lg, lc), "loss": abs(sg - sc) / abs(sc),
            "grads": max(by_leaf.values())}
    rec = {"layers": layers, "rows": B, "errors": errs, "tolerance": BERT_CPU_TOL,
           "worst_grad_leaves": dict(sorted(by_leaf.items(), key=lambda kv: -kv[1])[:4])}
    if not all(e <= BERT_CPU_TOL for e in errs.values()):
        raise AssertionError(f"bert card vs CPU: {rec}")
    return rec


def bert_phase(smi):
    """BERT-Large MLM with FusedLAMB on one card (:data:`BERT_LARGE`, the
    bench batch): ``models.bert.make_train_step``, the dense head and the
    fused CE, each graphed and eager for :data:`BERT_STEPS` steps: graphed
    bitwise eager, exact launches a step (:func:`bert_expect`), losses
    finite and falling, ms a step, tokens/s and peak; then
    :func:`bert_cpu_parity`."""
    import dataclasses

    from apex_tpu_torch.models import bert
    from apex_tpu_torch.optimizers.tree import tree_leaves

    t0 = time.monotonic()
    dev = torch.device("cuda", 0)
    cfg = bert.BertConfig(**BERT_LARGE, compute_dtype=torch.bfloat16, checkpoint_layers=True)
    pristine = bert.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    n_params = sum(t.numel() for t in tree_leaves(pristine))
    batch = _bert_tensors(dev)
    runs = {}
    for head, fused in (("dense", False), ("fused_ce", True)):
        hcfg = dataclasses.replace(cfg, fused_ce=fused)
        graphed = _bert_train(hcfg, pristine, batch, eager=False)
        eager = _bert_train(hcfg, pristine, batch, eager=True)
        want = bert_expect(fused)
        for name, rec in (("graphed", graphed), ("eager", eager)):
            per = {k: v / BERT_STEPS for k, v in rec["counts"].items()}
            bad = {k: per[k] for k in want if per[k] != want[k]}
            if bad:
                raise AssertionError(f"bert {head} {name}: launches a step {bad}, want "
                                     f"{ {k: want[k] for k in bad} }")
            rec["launches_per_step"] = per
        losses = graphed["losses"]
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"bert {head}: losses {losses} not finite and falling")
        if not graphed["graphs"] or losses != eager["losses"]:
            raise AssertionError(f"bert {head}: graphed {losses} against eager "
                                 f"{eager['losses']} (graphs {graphed['graphs']}): not bitwise")
        runs[head] = {**{k: v for k, v in graphed.items() if k != "counts"},
                      "graphed_vs_eager": "bitwise",
                      "eager_step_ms_median": eager["step_ms_median"]}
    lamb_ms = bert_lamb_ms(pristine)
    del pristine
    torch.cuda.empty_cache()
    emit({"phase": "bert_train", "nvidia_smi": smi,
          "config": {**BERT_LARGE, "batch": BERT_BATCH, "dtype": "bfloat16", "remat": "full",
                     "optimizer": BERT_LAMB},
          "params": n_params, "runs": runs, "lamb_update_ms": lamb_ms,
          "lamb_share_of_fused_step": lamb_ms / runs["fused_ce"]["step_ms_median"]})
    emit({"phase": "bert", "nvidia_smi": smi, "card_vs_cpu": bert_cpu_parity(dev),
          "seconds": time.monotonic() - t0})
    return runs


def resnet_cpu_parity(dev, size=32, B=8):
    """An fp32 ResNet18ish at ``size`` x ``size`` on the card against the
    same call on the CPU: the training-mode logits, the new running
    statistics and every grad (cuDNN against the CPU's convolutions; the
    flax padding on both)."""
    from apex_tpu_torch.imagenet_main_amp import loss_and_grads, synthetic_batch
    from apex_tpu_torch.models.resnet import ResNet18ish

    x, y = synthetic_batch(np.random.default_rng(1), B, size)
    out = {}
    for d in ("cpu", dev):
        model = ResNet18ish(dtype=torch.float32, device=d,
                            generator=torch.Generator().manual_seed(0))
        v = model.variables()
        params = {k: t.clone().requires_grad_(True) for k, t in v["params"].items()}
        xt, yt = torch.from_numpy(x).to(d), torch.from_numpy(y).to(d)
        with torch.no_grad():
            logits, stats = model.apply(params, v["batch_stats"], xt, train=True)
        _, grads = loss_and_grads(model, params, {k: t.clone() for k, t in
                                                  v["batch_stats"].items()}, xt, yt)
        out[str(d)] = (logits.cpu(), [s.cpu() for s in stats.values()],
                       [grads[k].cpu() for k in sorted(grads)])
    (lc, sc, gc), (lg, sg, gg) = out["cpu"], out[str(dev)]
    errs = {"logits": rel_err(lg, lc), "batch_stats": _grads_rel(sg, sc),
            "grads": _grads_rel(gg, gc)}
    rec = {"model": "ResNet18ish", "image_size": size, "batch": B, "errors": errs,
           "tolerance": RESNET_CPU_TOL}
    if not all(e <= RESNET_CPU_TOL for e in errs.values()):
        raise AssertionError(f"resnet card vs CPU: {rec}")
    return rec


def resnet_batch(dev, rows=slice(None), batch=64, size=224, classes=1000):
    """bench.py's ResNet batch (``np.random.RandomState(0)``: one batch
    of ``batch`` images, repeated every step), ``rows`` of it on
    ``dev``."""
    rng = np.random.RandomState(0)
    x = rng.randn(batch, size, size, 3).astype(np.float32)
    y = rng.randint(0, classes, size=(batch,))
    return torch.from_numpy(x[rows]).to(dev), torch.from_numpy(y[rows]).to(dev)


def _resnet_train(dev, eager, group=None, rows=slice(None), steps=RESNET_STEPS):
    """The trainer's step (``imagenet_main_amp.make_train_step``: amp O2,
    ``FusedSGD(master_weights=True)``, SyncBN and the grad all-reduce
    over ``group``) on ResNet-50 with seed-0 params, ``steps`` steps on
    ``rows`` of :func:`resnet_batch`: losses, ms a step (median after the
    warm-up and capture), images/s over the global batch, peak GB,
    launches (counted from 0) and the final state."""
    from apex_tpu_torch import amp
    from apex_tpu_torch import imagenet_main_amp as im
    from apex_tpu_torch.models.resnet import ResNet50
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map

    model = ResNet50(sync_bn_group=group, device=dev)
    v = model.variables()
    params, _ = amp.initialize(v["params"], opt_level="O2")
    params = tree_map(lambda t: t.clone(), params)
    stats = tree_map(lambda t: t.clone(), v["batch_stats"])
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt = FusedSGD(**RESNET_SGD, master_weights=True)
    state = opt.init(params)
    step = im.make_train_step(model, opt, group, graphs=False if eager else None)
    x, y = resnet_batch(dev, rows)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(step(params, state, stats, x, y).clone())
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.median(times[2:]))
    rec = {"losses": [float(t) for t in losses], "step_ms": [1e3 * t for t in times],
           "step_ms_median": ms, "images_per_sec": 64 / ms * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "counts": launch_counts(),
           "graphs": not eager and getattr(step, "graph", None) is not None}
    state_out = {"params": params, "opt_state": state, "batch_stats": stats}
    del step
    return rec, state_out


def resnet_trainer_resume(steps=3, batch=64):
    """``python -m apex_tpu_torch.imagenet_main_amp --steps 3 --batch-size
    64 --checkpoint F``, then ``--resume F``, which must go on at ``step
    3``."""
    import tempfile

    cmd = [sys.executable, "-m", "apex_tpu_torch.imagenet_main_amp", "--batch-size", str(batch)]
    with tempfile.TemporaryDirectory() as d:
        ck = str(Path(d) / "resnet.pt")
        rc, out, errs, s1 = _child(cmd + ["--steps", str(steps), "--checkpoint", ck], 600)
        rc2, out2, errs2, s2 = _child(cmd + ["--steps", "2", "--resume", ck], 600)
    first = [ln for ln in out if ln.startswith("step ")]
    resumed = [ln for ln in out2 if ln.startswith("step ")]
    rec = {"first": first, "resumed": resumed, "seconds": [s1, s2],
           "throughput": [ln for ln in out + out2 if ln.startswith("throughput")]}
    if (rc, rc2) != (0, 0) or len(first) != steps or not resumed or not resumed[0].startswith(
            f"step {steps}:"):
        raise AssertionError(f"imagenet_main_amp checkpoint/resume: exit {rc}, {rc2}; {rec}\n"
                             + "\n".join(errs[-20:] + errs2[-20:]))
    return rec


def resnet_phase(smi):
    """ResNet-50 under amp O2 on one card through the trainer's step
    (:func:`_resnet_train`: bench.py's resnet50_b64 section, :data:`RESNET_SGD`,
    :data:`RESNET_STEPS` steps), graphed then eager (cuDNN's
    deterministic algorithms): losses, running statistics
    and params bitwise equal, losses finite and falling, no hand-written
    kernel launched (the path is cuDNN and PyTorch ops, as XLA ops in the
    reference), ms a step, images/s, peak; then graphed once more under
    the trainer's cuDNN settings (PyTorch's defaults: algorithms not held
    deterministic, no autotuning), timed; then :func:`resnet_cpu_parity`
    and :func:`resnet_trainer_resume`."""
    from apex_tpu_torch.graphs import tensor_leaves

    t0 = time.monotonic()
    dev = torch.device("cuda", 0)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        graphed, g_state = _resnet_train(dev, eager=False)
        eager, e_state = _resnet_train(dev, eager=True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    same = {k: all(torch.equal(a, b) for a, b in zip(tensor_leaves(g_state[k]),
                                                     tensor_leaves(e_state[k]), strict=True))
            for k in g_state}
    del g_state, e_state
    torch.cuda.empty_cache()
    default, _ = _resnet_train(dev, eager=False)
    torch.cuda.empty_cache()
    losses = graphed["losses"]
    launched = {k: v for r in (graphed, eager, default) for k, v in r["counts"].items() if v}
    for run in (losses, default["losses"]):
        if not all(map(math.isfinite, run)) or not run[-1] < run[0]:
            raise AssertionError(f"resnet: losses {run} not finite and falling")
    if not graphed["graphs"] or losses != eager["losses"] or not all(same.values()):
        raise AssertionError(f"resnet: graphed {losses} against eager {eager['losses']}, "
                             f"state bitwise {same}")
    if launched:
        raise AssertionError(f"resnet: the path launched hand-written kernels {launched}")
    emit({"phase": "resnet", "nvidia_smi": smi,
          "config": {"model": "ResNet-50", "batch": 64, "image_size": 224, "classes": 1000,
                     "opt_level": "O2", "optimizer": {**RESNET_SGD, "master_weights": True},
                     "steps": RESNET_STEPS},
          "graphed": {k: v for k, v in graphed.items() if k != "counts"},
          "cudnn": "deterministic algorithms, no autotuning (graphed and eager)",
          "graphed_trainer_cudnn": {k: v for k, v in default.items() if k != "counts"},
          "eager_step_ms_median": eager["step_ms_median"], "graphed_vs_eager": "bitwise "
          "(losses, params, optimizer state, running statistics)", "kernel_launches": 0,
          "card_vs_cpu": resnet_cpu_parity(dev),
          "trainer_resume": resnet_trainer_resume(), "seconds": time.monotonic() - t0})
    return graphed


def _resnet50_fp32_step(dev, group=None, rows=slice(None), order=None, last_bn_scale=0.0,
                        size=RESNET_PARITY_SIZE):
    """ResNet-50 in fp32 (seed-0 params with the last batch norm of
    every bottleneck scaled by ``last_bn_scale``, the trainer's first
    batch of 64 at ``size``, its rows permuted by ``order``): the loss,
    the grads (all-reduced over ``group``, the mean) and the new running
    statistics of ``rows``, on the CPU.

    Where this network's fp32 backward is well conditioned: with the
    last BN scale zero (the zero-init flax's ImageNet example uses) the
    bottlenecks pass their input through, so the stem's and the
    projections' batch norms carry the backward, and every batch norm's
    statistics reach the grads of the scales and shifts; at the init's
    scale of 1 the backward runs through every branch and a reordering
    of the batch moves the grads by percents.  Some grads are residues
    of sums that cancel (a batch norm's backward sums to zero over each
    channel, so a shift's grad downstream of it is what is left), and at
    224 x 224 the one card's own reordering moves those by percents even
    zero-scaled; :func:`models_multi_card` prints that spread at 224 and
    at the parity's 64 x 64, where it must lie within the band."""
    from apex_tpu_torch.imagenet_main_amp import loss_and_grads, synthetic_batch
    from apex_tpu_torch.models.resnet import ResNet50
    from apex_tpu_torch.parallel import allreduce_gradients

    rng = np.random.default_rng(0)
    x, y = synthetic_batch(rng, 64, size)
    if order is not None:
        x, y = x[order], y[order]
    model = ResNet50(dtype=torch.float32, sync_bn_group=group, device=dev)
    v = model.variables()
    params = {k: (t.clone() if not k.endswith("bn3.weight")
                  else torch.full_like(t, last_bn_scale)).requires_grad_(True)
              for k, t in v["params"].items()}
    stats = {k: t.clone() for k, t in v["batch_stats"].items()}
    loss, grads = loss_and_grads(model, params, stats, torch.from_numpy(x[rows]).to(dev),
                                 torch.from_numpy(y[rows]).to(dev))
    if group is not None and group.size() > 1:
        grads = allreduce_gradients(grads, group)
        torch.distributed.all_reduce(loss, group=group.group)
        loss = loss / group.size()
    return {"loss": float(loss), "grads": {k: g.cpu() for k, g in grads.items()},
            "stats": {k: s.cpu() for k, s in stats.items()}}


@contextlib.contextmanager
def _syncbn_cotangents_unsummed():
    """The must-fail control of models_multi_card's dp 2 parity: SyncBN's
    backward with the all-reduce of the cotangents skipped (each rank
    keeps its own), for the calls inside."""
    from apex_tpu_torch.parallel import sync_batchnorm

    fn = sync_batchnorm._SumOverGroup
    saved = fn.__dict__["backward"]
    fn.backward = staticmethod(lambda ctx, g: (g.clone(), None))
    try:
        yield
    finally:
        fn.backward = saved


def _syncbn_uneven(dev, group=None, rows=slice(None)):
    """SyncBatchNorm (256 channels, fp32, affine 1.5 / -0.25) on ``rows``
    of a (64, 256, 56, 56) batch: its output rows and running
    statistics, on the CPU."""
    from apex_tpu_torch.parallel import SyncBatchNorm

    x = torch.from_numpy(np.random.default_rng(2).standard_normal(SYNCBN_SHAPE,
                                                                  dtype=np.float32))
    bn = SyncBatchNorm(SYNCBN_SHAPE[1], group=group, device=dev)
    with torch.no_grad():
        bn.weight.fill_(1.5)
        bn.bias.fill_(-0.25)
        y = bn(x[rows].to(dev))
    return {"out": y.cpu(), "running_mean": bn.running_mean.cpu(),
            "running_var": bn.running_var.cpu()}


def _bert_fp32_loss(dev, axis_name=None, layers=4):
    """The first MLM loss of an fp32 BERT of ``layers`` layers at
    BERT-Large's widths on the bert batch (seed-1 params), over the
    tensor-parallel group ``axis_name``."""
    from apex_tpu_torch.models import bert

    cfg = bert.BertConfig(**{**BERT_LARGE, "num_layers": layers}, compute_dtype=torch.float32,
                          checkpoint_layers=False)
    tree = bert._init_numpy(cfg, torch.Generator().manual_seed(1))
    p = bert.shard_params(tree, cfg, axis_name, dev)
    tokens, targets, loss_mask, pad = _bert_tensors(dev)
    with torch.no_grad():
        return float(bert.bert_mlm_loss(p, tokens, targets, loss_mask, cfg, axis_name, pad))


def _resnet_compare(got, want):
    """Loss, running statistics and grads of one ResNet-50 fp32 step
    against another's: relative errors, the grads also as one L2 over
    every leaf."""
    keys = sorted(want["grads"])
    g, w = [got["grads"][k] for k in keys], [want["grads"][k] for k in keys]
    return {"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grads_rel": _grads_rel(g, w), "grads_l2": _grads_l2(g, w),
            "stats_rel": _grads_rel([got["stats"][k] for k in sorted(want["stats"])],
                                    [want["stats"][k] for k in sorted(want["stats"])])}


def models_child(argv):
    """One rank of ``torchrun --nproc-per-node 2 chip_smoke.py
    models_child REF``: at dp 2 (SyncBN over NCCL) ResNet-50's fp32 first
    step on 32 rows, held against the one-card step at REF, and again
    with SyncBN's cotangents left unsummed (the control); the trainer's
    bf16 amp-O2 step at dp 2, timed; SyncBN over the uneven
    :data:`SYNCBN_SPLIT`; then at tp 2 BERT's first fp32 loss (4 layers)
    and BERT-Large's bf16 FusedLAMB step, timed.  Rank 0 prints one
    ``models_child`` line with both ranks' records."""
    from apex_tpu_torch.models import bert
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = multiproc.initialize_distributed("cuda")
    ps.initialize_model_parallel()
    dp = ps.get_data_parallel_group()
    rank = dp.rank()
    ref = torch.load(argv[0])
    mine = {"rank": rank}
    got = _resnet50_fp32_step(dev, dp, slice(32 * rank, 32 * (rank + 1)))
    mine["resnet_fp32"] = {"loss": got["loss"], **_resnet_compare(got, ref["resnet"])}
    with _syncbn_cotangents_unsummed():
        got = _resnet50_fp32_step(dev, dp, slice(32 * rank, 32 * (rank + 1)))
    mine["resnet_fp32_control"] = _resnet_compare(got, ref["resnet"])
    del got
    torch.cuda.empty_cache()
    run, _ = _resnet_train(dev, eager=False, group=dp, rows=slice(32 * rank, 32 * (rank + 1)))
    mine["resnet_bf16"] = {k: run[k] for k in ("losses", "step_ms_median", "images_per_sec",
                                               "peak_memory_gb", "graphs")}
    torch.cuda.empty_cache()
    a = SYNCBN_SPLIT[0]
    rows = slice(0, a) if rank == 0 else slice(a, SYNCBN_SHAPE[0])
    bn = _syncbn_uneven(dev, dp, rows)
    want = ref["syncbn"]
    mine["syncbn_uneven"] = {
        "rows": rows.stop - rows.start,
        "out_rel": rel_err(bn["out"], want["out"][rows]),
        "stats_rel": _grads_rel([bn["running_mean"], bn["running_var"]],
                                [want["running_mean"], want["running_var"]])}
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(tensor_model_parallel_size_=2)
    tg = ps.get_tensor_model_parallel_group()
    loss = _bert_fp32_loss(dev, tg)
    mine["bert_tp2_fp32"] = {"loss": loss, "loss_rel": abs(loss - ref["bert_loss"])
                             / abs(ref["bert_loss"])}
    cfg = bert.BertConfig(**BERT_LARGE, compute_dtype=torch.bfloat16, checkpoint_layers=True)
    tree = bert._init_numpy(cfg, torch.Generator().manual_seed(0))
    run = _bert_train(cfg, bert.shard_params(tree, cfg, tg, dev), _bert_tensors(dev),
                      eager=False, axis_name=tg)
    del tree
    mine["bert_tp2_bf16"] = {k: run[k] for k in ("losses", "step_ms_median", "tokens_per_sec",
                                               "peak_memory_gb", "graphs")}
    mine["bert_tp2_bf16"]["launches_per_step"] = {k: v / BERT_STEPS
                                                  for k, v in run["counts"].items() if v}
    ranks = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(ranks, mine)
    multiproc.destroy_distributed()
    if rank == 0:
        print(json.dumps({"models_child": ranks}), flush=True)
    return 0


def models_multi_card():
    """BERT and ResNet across two cards: the one-card references in this
    process (ResNet-50's fp32 first step at batch 64 of 64 x 64 images
    with every bottleneck's last batch norm zero-scaled, SyncBN on the full
    batch, BERT's fp32 4-layer loss at tp 1), then ``models_child`` over
    NCCL (:func:`models_child`): ResNet-50 dp 2's loss, running
    statistics and grads after ``allreduce_gradients`` within
    :data:`RESNET_DP_TOL` (the one card's own spread under a reordering of
    its batch printed beside them; the same step with SyncBN's cotangents
    left unsummed must miss the band), SyncBN over 24 + 40 rows within
    :data:`SYNCBN_TOL`, BERT tp 2 within :data:`BERT_TP_TOL`; the bf16
    ResNet-50 dp 2 and BERT-Large tp 2 steps timed, their losses falling
    and their launches exact."""
    import tempfile

    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    ref = {"resnet": _resnet50_fp32_step(dev), "syncbn": _syncbn_uneven(dev),
           "bert_loss": _bert_fp32_loss(dev)}
    # the one card's own spread: the same step with the batch's halves
    # swapped (every sum over the batch in another order), zero-scaled at
    # the parity's size and at 224, and at the init's scale of 1 at 224
    swap = np.r_[32:64, 0:32]
    spread = {f"zero_scaled_{RESNET_PARITY_SIZE}": _resnet_compare(
        _resnet50_fp32_step(dev, order=swap), ref["resnet"])}
    for name, scale in (("zero_scaled_224", 0.0), ("init_scale_1_224", 1.0)):
        spread[name] = _resnet_compare(
            _resnet50_fp32_step(dev, order=swap, last_bn_scale=scale, size=224),
            _resnet50_fp32_step(dev, last_bn_scale=scale, size=224))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "ref.pt")
        torch.save(ref, path)
        ranks = _pp_children(2, [path], timeout=1200, script="models_child",
                             prefix='{"models_child"')[0]["models_child"]
    row = {"phase": "models_multi_card", "nvidia_smi": _smi(),
           "resnet_fp32_loss_1card": ref["resnet"]["loss"], "resnet_fp32_1card_spread": spread,
           "bert_fp32_loss_tp1": ref["bert_loss"],
           "tolerance": {"resnet_dp2": RESNET_DP_TOL, "syncbn": SYNCBN_TOL,
                         "bert_tp2": BERT_TP_TOL},
           "ranks": ranks, "seconds": time.monotonic() - t0}
    emit(row)
    want = bert_expect(False)
    bad = []
    e = spread[f"zero_scaled_{RESNET_PARITY_SIZE}"]
    if not max(e.values()) <= RESNET_DP_TOL:
        bad.append(("resnet_fp32_1card_spread", e))
    for r in ranks:
        e = r["resnet_fp32"]
        if not max(e["loss_rel"], e["stats_rel"], e["grads_rel"], e["grads_l2"]) <= RESNET_DP_TOL:
            bad.append(("resnet_fp32", r["rank"], e))
        if not r["resnet_fp32_control"]["grads_l2"] > RESNET_DP_TOL:
            bad.append(("resnet_fp32_control_within_band", r["rank"], r["resnet_fp32_control"]))
        e = r["syncbn_uneven"]
        if not max(e["out_rel"], e["stats_rel"]) <= SYNCBN_TOL:
            bad.append(("syncbn_uneven", r["rank"], e))
        if not r["bert_tp2_fp32"]["loss_rel"] <= BERT_TP_TOL:
            bad.append(("bert_tp2_fp32", r["rank"], r["bert_tp2_fp32"]))
        for name in ("resnet_bf16", "bert_tp2_bf16"):
            losses = r[name]["losses"]
            if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
                bad.append((name, r["rank"], losses))
        per = r["bert_tp2_bf16"]["launches_per_step"]
        if any(per.get(k, 0) != v for k, v in want.items()):
            bad.append(("bert_tp2_launches", r["rank"], per))
    if bad:
        raise AssertionError(f"models_multi_card: {bad}")
    return row


def models_multi_card_main():
    """``chip_smoke.py models_multi_card`` (two cards): the kernels built,
    then :func:`models_multi_card` alone."""
    return _multi_card_alone("models_multi_card", models_multi_card, 2)


# ---------------------------------------------------------------------- t5
#: T5-small (``google-t5/t5-small``'s widths, the JAX ``T5Config``
#: defaults, ``apex_tpu/models/t5.py:58-76``): d_model 512, d_ff 2048, 6
#: + 6 layers, 8 heads of 64, vocab 32128, learned positions of 512 a
#: side; 61,032,960 params
T5_SMALL = {"vocab_size": 32128, "hidden_size": 512, "num_encoder_layers": 6,
            "num_decoder_layers": 6, "num_attention_heads": 8, "max_src_len": 512,
            "max_tgt_len": 512}
T5_BATCH = 16
#: steps of each t5 run (graphed and eager; the first warms up, the graphed
#: run captures after it); FusedAdam at pretrain_t5's lr
T5_STEPS = 10
T5_LR = 1e-3
#: the fp32 2 + 2-layer step card against CPU: logits and loss (as
#: BERT_CPU_TOL); each grad leaf's error against float64 within
#: T5_FP32_SPREAD times the CPU fp32's own (:func:`t5_cpu_parity`)
T5_CPU_TOL = 1e-5
T5_FP32_SPREAD = 10.0
#: t5_multi_card: each layout's fp32 loss against the one-card step on
#: the same global batch (the band of BERT_TP_TOL); each grad leaf's error
#: against a float64 step within T5_FP32_SPREAD times the one-card fp32
#: step's own, plus this band (:func:`t5_multi_card`)
T5_MULTI_TOL = 1e-4
T5_PARITY_BATCH = 8
#: t5_multi_card's layouts: name -> (tp, pp, split, microbatches); dp is
#: what the four cards leave; pp 4 split 1 puts the 6 encoder layers on
#: one stage and 2 decoder layers on each of three
T5_LAYOUTS = {"pp4_split2": (1, 4, 2, 8), "pp2_split1_tp2": (2, 2, 1, 4),
              "pp4_split1": (1, 4, 1, 8), "dp2_pp2_split1": (1, 2, 1, 2),
              "tp2_dp2": (2, 1, None, 1)}


def t5_batch(B=T5_BATCH, S=512, V=32128):
    """pretrain_t5's copy task (``np.random.RandomState(0)``): the source,
    the decoder's input (<bos> + src[:-1]) and the targets (src)."""
    from apex_tpu_torch.pretrain_t5 import make_batch

    return make_batch(np.random.RandomState(0), B, S, V)


def _t5_tensors(dev, rows=slice(None), B=T5_BATCH):
    return [torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev) for a in t5_batch(B)]


def t5_expect(fused, Le=6, Ld=6):
    """Kernel launches of one T5 train step under full remat: RMS forward 2
    an encoder layer, 4 a decoder layer and 1 final, the layers' again in
    their recompute; RMS backward once each; no flash kernel (T5 runs the
    einsum attention); the CE kernels once with the fused head."""
    n = 2 * Le + 4 * Ld
    return {"layer_norm_fwd": 2 * n + 1, "layer_norm_bwd": n + 1, "flash_fwd": 0,
            "flash_dq": 0, "flash_dkv": 0, "ce_fwd": int(fused), "ce_dx": int(fused),
            "ce_dembed": int(fused)}


def t5_kernels(dev, results):
    """T5-small's shapes in the kernels phase: the RMS-affine LayerNorm
    forward and backward at R 8192 (16 x 512 tokens), H 512, bf16 x and an
    fp32 scale (and fp32 x), with ``F.rms_norm``; the CE kernels at N 8192,
    H 512, V 32128, bf16 x and an fp32 embed, with the dense bf16 head."""
    for dtype in (torch.bfloat16, torch.float32):
        r = check_layer_norm(dev, 8192, dtype, "rms_affine", H=512)
        results[("ln", 8192, dtype, "rms_affine", 512, False)] = r
        emit({"phase": "kernel", "kernel": "layer_norm_fwd", **r})
        r = check_layer_norm_bwd(dev, dtype, "rms_affine", H=512)
        results[("ln_bwd", dtype, "rms_affine", 512, False)] = r
        emit({"phase": "kernel", "kernel": "layer_norm_bwd", **r})
    r = check_fused_ce(dev, "t5_small", N=8192, H=512, V=32128)
    results[("ce", "t5_small")] = r
    for name in ("fwd", "dx", "dembed"):
        emit({"phase": "kernel", **r[name]})


def _t5_train(cfg, pristine, batch, eager, build=None, steps=T5_STEPS, rows=None):
    """``steps`` of a T5 step (``build(opt, graphs)``, by default
    ``models.t5.make_train_step``) with FusedAdam from a copy of
    ``pristine``: losses, per-step launches (counted from 0), ms a step
    (median after the warm-up and capture), target tokens a second
    (pretrain_t5's count: ``rows`` x S_tgt, the batch's rows by default)
    and peak GB."""
    from apex_tpu_torch.models import t5
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map

    dev = batch[0].device
    params = tree_map(lambda t: t.detach().clone(), pristine)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt = FusedAdam(lr=T5_LR)
    state = opt.init(params)
    graphs = False if eager else None
    step = (build(opt, graphs) if build is not None
            else t5.make_train_step(cfg, opt, graphs=graphs))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(step(params, state, *batch).clone())
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    counts = launch_counts()
    ms = 1e3 * float(np.median(times[2:]))
    tokens = (rows or batch[0].shape[0]) * batch[1].shape[1]
    rec = {"losses": [float(x) for x in losses], "step_ms": [1e3 * t for t in times],
           "step_ms_median": ms, "counts": counts, "tokens_per_sec": tokens / ms * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "graphs": not eager and getattr(step, "graph", None) is not None}
    del params, state, step
    torch.cuda.empty_cache()
    return rec


def t5_cpu_parity(dev, layers=2, B=2):
    """An fp32 T5 of ``layers`` encoder and decoder layers at T5-small's
    widths, ``B`` rows of the t5 batch: logits, loss and every grad on the
    card against the same calls on the CPU (the RMS kernels' fp32
    instantiation against its plain version, cuBLAS against the CPU's
    products) and against a float64 run on the CPU.  The logits and loss
    are held at :data:`T5_CPU_TOL` of the CPU's.  Each grad leaf's error
    against float64 is held at :data:`T5_FP32_SPREAD` times the CPU's own
    fp32 error there (plus :data:`T5_CPU_TOL`): at init the encoder's
    grads are residues of sums that cancel (its self-attention and the
    cross-attention's keys see a near-uniform softmax), so fp32 rounding
    alone moves them by up to ~1e-3 of their largest entry on either
    device, and a fixed band would hold the rounding, not the port."""
    import dataclasses

    from apex_tpu_torch.models import t5
    from apex_tpu_torch.optimizers.tree import leaves_with_path, tree_leaves, tree_map

    cfg = t5.T5Config(**{**T5_SMALL, "num_encoder_layers": layers,
                         "num_decoder_layers": layers},
                      compute_dtype=torch.float32, checkpoint_layers=False)
    tree = t5._init_numpy(cfg, torch.Generator().manual_seed(1))
    out = {}
    for name, d, dtype in (("cpu", "cpu", torch.float32), ("cuda", dev, torch.float32),
                           ("cpu64", "cpu", torch.float64)):
        c = dataclasses.replace(cfg)
        object.__setattr__(c, "compute_dtype", dtype)  # float64: the reference only
        src, dec_in, tgt = _t5_tensors(d, slice(0, B))
        p = tree_map(lambda a: a.to(dtype), t5.params_from_numpy(tree, cfg, d))
        with torch.no_grad():
            logits = t5.t5_forward(p, src, dec_in, c).cpu()
        leaves = tree_leaves(p)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = t5.t5_loss(p, src, dec_in, tgt, c)
        grads = torch.autograd.grad(loss, leaves)
        out[name] = (logits, float(loss.detach()), [g.cpu().double() for g in grads])
    names = [k for k, _ in leaves_with_path(p)]
    (lc, sc, gc), (lg, sg, gg), (_, _, g64) = out["cpu"], out["cuda"], out["cpu64"]
    card = dict(zip(names, _grads_errs(gg, g64)))
    cpu = dict(zip(names, _grads_errs(gc, g64)))
    vs_cpu = dict(zip(names, _grads_errs(gg, gc)))
    over = {k: card[k] / (T5_FP32_SPREAD * cpu[k] + T5_CPU_TOL) for k in names}
    errs = {"logits": rel_err(lg, lc), "loss": abs(sg - sc) / abs(sc)}
    worst = sorted(names, key=lambda k: -over[k])[:4]
    rec = {"layers": layers, "rows": B, "errors": errs, "tolerance": T5_CPU_TOL,
           "grads_band": f"card vs float64 <= {T5_FP32_SPREAD} x (CPU fp32 vs float64) + "
                         f"{T5_CPU_TOL}, per leaf",
           "grads_band_used_max": over[worst[0]],
           "worst_grad_leaves": {k: {"card_vs_f64": card[k], "cpu_vs_f64": cpu[k],
                                     "card_vs_cpu": vs_cpu[k]} for k in worst},
           "grads_card_vs_cpu_max": max(vs_cpu.values())}
    if not (all(e <= T5_CPU_TOL for e in errs.values()) and over[worst[0]] <= 1.0):
        raise AssertionError(f"t5 card vs CPU: {rec}")
    return rec


def t5_phase(smi):
    """T5-small on one card (:data:`T5_SMALL`, :data:`T5_BATCH` rows of
    512 + 512 tokens, bf16, full remat, FusedAdam):
    ``models.t5.make_train_step``, the dense head and the fused CE, each
    graphed and eager for :data:`T5_STEPS` steps: graphed bitwise eager,
    exact launches a step (:func:`t5_expect`), losses finite, ms a step,
    target tokens/s and peak; then :func:`t5_cpu_parity`.  Returns the
    runs (the graphed fused run's counts feed the kernels line)."""
    import dataclasses

    from apex_tpu_torch.models import t5
    from apex_tpu_torch.optimizers.tree import tree_leaves

    t0 = time.monotonic()
    dev = torch.device("cuda", 0)
    cfg = t5.T5Config(**T5_SMALL, compute_dtype=torch.bfloat16, checkpoint_layers=True)
    pristine = t5.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    n_params = sum(t.numel() for t in tree_leaves(pristine))
    batch = _t5_tensors(dev)
    runs = {}
    for head, fused in (("dense", False), ("fused_ce", True)):
        hcfg = dataclasses.replace(cfg, fused_ce=fused)
        graphed = _t5_train(hcfg, pristine, batch, eager=False)
        eager = _t5_train(hcfg, pristine, batch, eager=True)
        want = t5_expect(fused)
        for name, rec in (("graphed", graphed), ("eager", eager)):
            per = {k: v / T5_STEPS for k, v in rec["counts"].items()}
            bad = {k: per[k] for k in want if per[k] != want[k]}
            if bad:
                raise AssertionError(f"t5 {head} {name}: launches a step {bad}, want "
                                     f"{ {k: want[k] for k in bad} }")
            rec["launches_per_step"] = per
        losses = graphed["losses"]
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"t5 {head}: losses {losses} not finite")
        if not graphed["graphs"] or losses != eager["losses"]:
            raise AssertionError(f"t5 {head}: graphed {losses} against eager "
                                 f"{eager['losses']} (graphs {graphed['graphs']}): not bitwise")
        runs[head] = {**graphed, "graphed_vs_eager": "bitwise",
                      "eager_step_ms_median": eager["step_ms_median"]}
    del pristine
    torch.cuda.empty_cache()
    emit({"phase": "t5_train", "nvidia_smi": smi,
          "config": {**T5_SMALL, "batch": T5_BATCH, "dtype": "bfloat16", "remat": "full",
                     "optimizer": {"FusedAdam": {"lr": T5_LR}}},
          "params": n_params,
          "runs": {h: {k: v for k, v in r.items() if k != "counts"} for h, r in runs.items()}})
    emit({"phase": "t5", "nvidia_smi": smi, "card_vs_cpu": t5_cpu_parity(dev),
          "seconds": time.monotonic() - t0})
    return runs


def _t5_fp32_step(dev, layout=None, rows=slice(None), dtype=torch.float32):
    """One fp32 T5-small step (no remat) on :data:`T5_PARITY_BATCH` rows of
    the t5 batch from the seed-1 params: the loss and every grad, the
    whole tree in the layout without a pipeline, on the CPU.  ``layout``
    (a :data:`T5_LAYOUTS` entry, the groups registered) runs it through
    the layout's step over this process's ranks (``rows`` its dp rows);
    None is one device's ``t5_loss``, in ``dtype`` (float64 on the CPU:
    the reference only)."""
    import dataclasses

    from apex_tpu_torch.models import t5
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map, tree_unflatten
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        unpad_stage_layout_encdec,
    )

    cfg = t5.T5Config(**T5_SMALL, compute_dtype=torch.float32, checkpoint_layers=False)
    tree = t5._init_numpy(cfg, torch.Generator().manual_seed(1))
    batch = _t5_tensors(dev, rows, T5_PARITY_BATCH)
    if layout is None:
        c = dataclasses.replace(cfg)
        object.__setattr__(c, "compute_dtype", dtype)
        p = tree_map(lambda a: a.to(dtype), t5.params_from_numpy(tree, cfg, dev))
        leaves = tree_leaves(p)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = t5.t5_loss(p, *batch, c)
        grads = tree_unflatten(p, list(torch.autograd.grad(loss, leaves)))
        return {"loss": float(loss.detach()),
                "grads": {k: v.cpu() for k, v in _flat_leaves(grads).items()}}
    tp, pp, split, M = layout
    tg, pg, dp = (ps.get_tensor_model_parallel_group(), ps.get_pipeline_model_parallel_group(),
                  ps.get_data_parallel_group())

    class Recording(FusedAdam):
        def update(self, grads, state, params, **kw):
            self.grads = grads
            return super().update(grads, state, params, **kw)

    opt = Recording(lr=T5_LR)
    if pp > 1:
        p = t5.shard_params(t5.params_to_pp_layout(tree, pp, split), cfg, tg, dev, pg)
        step = t5.make_pp_train_step(cfg, opt, M, split, dp_group=dp, tp_group=tg,
                                     pp_group=pg, graphs=False)
    else:
        p = t5.shard_params(tree, cfg, tg, dev)
        step = t5.make_train_step(cfg, opt, dp_group=dp, tp_group=tg, graphs=False)
    loss = float(step(p, opt.init(p), *batch))
    grads = t5.gather_params(opt.grads, cfg, tg, pg if pp > 1 else None)
    if pp > 1:
        enc, dec = unpad_stage_layout_encdec(grads["enc_layers"], grads["dec_layers"], pp, split)
        grads = {**grads, "enc_layers": enc, "dec_layers": dec}
    return {"loss": loss, "grads": {k: v.cpu() for k, v in _flat_leaves(grads).items()}}


def _t5_reference(dev):
    """The one-device fp32 step of :func:`_t5_fp32_step` on ``dev``, with
    the same step in float64 on the CPU beside it (``grads64``,
    ``loss64``) and each grad leaf's fp32 error against it (``spread``,
    :func:`_grads_errs`)."""
    ref = _t5_fp32_step(dev)
    f64 = _t5_fp32_step(torch.device("cpu"), dtype=torch.float64)
    keys = sorted(ref["grads"])
    ref["grads64"], ref["loss64"] = f64["grads"], f64["loss"]
    ref["spread"] = dict(zip(keys, _grads_errs([ref["grads"][k].double() for k in keys],
                                               [f64["grads"][k] for k in keys])))
    return ref


def _flat_leaves(tree):
    from apex_tpu_torch.optimizers.tree import leaves_with_path

    return dict(leaves_with_path(tree))


def t5_child(argv):
    """One rank of ``torchrun --nproc-per-node 4 chip_smoke.py t5_child
    REF``: each layout of :data:`T5_LAYOUTS` takes an fp32 step held
    against REF (:func:`_t5_reference`: the loss against the one-card
    step, every grad leaf against the float64 step in the band of
    :func:`t5_multi_card`), then
    T5-small's bf16 step (graphed, :data:`T5_BATCH` rows, full remat) is
    timed in it; last an fp16 pp 4 split 2 run (the dense head) with the
    scaler at 2**127, whose first step overflows in the fp16 backward and
    must leave every param and the optimizer state bitwise as they were
    on every stage.  Rank 0 prints one ``t5_child`` line with every
    rank's records."""
    import dataclasses

    from apex_tpu_torch.amp import DynamicLossScaler
    from apex_tpu_torch.graphs import tensor_leaves
    from apex_tpu_torch.models import t5
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = multiproc.initialize_distributed("cuda")
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    ref = torch.load(argv[0])
    keys = sorted(ref["grads"])
    mine = {"rank": rank}
    cfg = t5.T5Config(**T5_SMALL, compute_dtype=torch.bfloat16, checkpoint_layers=True)
    tree = t5._init_numpy(cfg, torch.Generator().manual_seed(0))
    for name, layout in T5_LAYOUTS.items():
        tp, pp, split, M = layout
        ps.destroy_model_parallel()
        ps.initialize_model_parallel(tensor_model_parallel_size_=tp,
                                     pipeline_model_parallel_size_=pp,
                                     pipeline_model_parallel_split_rank_=split)
        tg, pg, dp = (ps.get_tensor_model_parallel_group(),
                      ps.get_pipeline_model_parallel_group(), ps.get_data_parallel_group())
        n = T5_PARITY_BATCH // dp.size()
        got = _t5_fp32_step(dev, layout, slice(n * dp.rank(), n * (dp.rank() + 1)))
        g = [got["grads"][k].double() for k in keys]
        vs_1card = dict(zip(keys, _grads_errs(g, [ref["grads"][k] for k in keys])))
        vs_f64 = dict(zip(keys, _grads_errs(g, [ref["grads64"][k] for k in keys])))
        used = {k: vs_f64[k] / (T5_FP32_SPREAD * ref["spread"][k] + T5_MULTI_TOL) for k in keys}
        worst = sorted(keys, key=lambda k: -used[k])[:3]
        rec = {"dp": dp.size(), "loss": got["loss"],
               "loss_rel": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
               "grads_band_used": used[worst[0]],
               "grads_rel_1card_max": max(vs_1card.values()),
               "worst_grad_leaves": {k: {"vs_f64": vs_f64[k], "1card_vs_f64": ref["spread"][k],
                                         "vs_1card": vs_1card[k]} for k in worst}}
        del got
        torch.cuda.empty_cache()
        rows = T5_BATCH // dp.size()
        batch = _t5_tensors(dev, slice(rows * dp.rank(), rows * (dp.rank() + 1)))
        if pp > 1:
            pristine = t5.shard_params(t5.params_to_pp_layout(tree, pp, split), cfg, tg, dev, pg)

            def build(opt, graphs, M=M, split=split, tg=tg, pg=pg, dp=dp):
                return t5.make_pp_train_step(cfg, opt, M, split, dp_group=dp, tp_group=tg,
                                             pp_group=pg, graphs=graphs)
        else:
            pristine = t5.shard_params(tree, cfg, tg, dev)

            def build(opt, graphs, tg=tg, dp=dp):
                return t5.make_train_step(cfg, opt, dp_group=dp, tp_group=tg, graphs=graphs)
        run = _t5_train(cfg, pristine, batch, eager=False, build=build, rows=T5_BATCH)
        rec["bf16"] = {k: run[k] for k in ("losses", "step_ms_median", "tokens_per_sec",
                                           "peak_memory_gb", "graphs")}
        rec["bf16"]["launches_per_step"] = {k: v / T5_STEPS for k, v in run["counts"].items()
                                            if v}
        mine[name] = rec
        del pristine, run
        torch.cuda.empty_cache()
    # fp16, pp 4 split 2: the first step overflows (scale 2**127) and is
    # skipped on every stage, the scale backs off to 2**12
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(pipeline_model_parallel_size_=4,
                                 pipeline_model_parallel_split_rank_=2)
    pg = ps.get_pipeline_model_parallel_group()
    fcfg = dataclasses.replace(cfg, compute_dtype=torch.float16)
    p = t5.shard_params(t5.params_to_pp_layout(tree, 4, 2), fcfg, None, dev, pg)
    opt = FusedAdam(lr=T5_LR)
    st = opt.init(p)
    scaler = DynamicLossScaler(**OVERFLOW_SCALER)
    sst = scaler.init(dev)
    step = t5.make_pp_train_step(fcfg, opt, 8, loss_scaler=scaler, pp_group=pg)
    batch = _t5_tensors(dev)
    before = [t.detach().clone() for t in tensor_leaves((p, st))]
    fp16 = {"losses": [], "scales": [], "adam_steps": []}
    for i in range(6):
        fp16["losses"].append(float(step(p, st, sst, *batch)))
        fp16["scales"].append(float(sst.loss_scale))
        fp16["adam_steps"].append(int(st.step))
        if i == 0:
            fp16["first_step_unchanged"] = all(
                torch.equal(a, b) for a, b in zip(before, tensor_leaves((p, st))))
    del before
    mine["fp16_pp4_split2"] = fp16
    ranks = [None] * world
    torch.distributed.all_gather_object(ranks, mine)
    multiproc.destroy_distributed()
    if rank == 0:
        print(json.dumps({"t5_child": ranks}), flush=True)
    return 0


def t5_multi_card():
    """T5-small across four cards: the one-card fp32 step (no remat, seed-1
    params, :data:`T5_PARITY_BATCH` rows) and the same step in float64 on
    the CPU, in this process (:func:`_t5_reference`), then ``t5_child``
    over NCCL (:func:`t5_child`): each layout of :data:`T5_LAYOUTS` with
    its loss within :data:`T5_MULTI_TOL` of the one card's and each grad
    leaf's error against float64 within :data:`T5_FP32_SPREAD` times the
    one card's own plus :data:`T5_MULTI_TOL` (at init a few ReLU gates
    sit at zero and flip under any change of rounding, and the attention
    grads are residues of sums that cancel: the one card's fp32 grads
    are up to ~1e-3 to 7e-3 of a leaf's largest entry off float64, so a
    fixed 1e-4 would hold the rounding, not the layouts), its bf16 step
    timed with finite losses, and the fp16 pp 4 run's first step skipped
    on every stage."""
    import tempfile

    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    ref = _t5_reference(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "ref.pt")
        torch.save(ref, path)
        ranks = _pp_children(4, [path], timeout=1500, script="t5_child",
                             prefix='{"t5_child"')[0]["t5_child"]
    row = {"phase": "t5_multi_card", "nvidia_smi": _smi(), "fp32_loss_1card": ref["loss"],
           "f64_loss_cpu": ref["loss64"], "tolerance": T5_MULTI_TOL,
           "grads_band": f"per leaf: vs float64 <= {T5_FP32_SPREAD} x (one card's fp32 vs "
                         f"float64) + {T5_MULTI_TOL}",
           "one_card_fp32_vs_f64_worst": dict(sorted(ref["spread"].items(),
                                                     key=lambda kv: -kv[1])[:4]),
           "layouts": T5_LAYOUTS, "ranks": ranks, "seconds": time.monotonic() - t0}
    emit(row)
    bad = []
    for r in ranks:
        for name in T5_LAYOUTS:
            e = r[name]
            if not (e["loss_rel"] <= T5_MULTI_TOL and e["grads_band_used"] <= 1.0):
                bad.append((name, r["rank"], e["loss_rel"], e["grads_band_used"]))
            if not (all(map(math.isfinite, e["bf16"]["losses"])) and e["bf16"]["graphs"]):
                bad.append((name, "bf16", r["rank"], e["bf16"]))
        f = r["fp16_pp4_split2"]
        if not (f["first_step_unchanged"] and f["adam_steps"][0] == 0
                and f["scales"][0] == OVERFLOW_SCALER["init_scale"]
                * OVERFLOW_SCALER["backoff_factor"]
                and all(map(math.isfinite, f["losses"][1:]))):
            bad.append(("fp16_pp4_split2", r["rank"], f))
    if bad:
        raise AssertionError(f"t5_multi_card: {bad}")
    return row


def t5_multi_card_main():
    """``chip_smoke.py t5_multi_card`` (four cards): the kernels built, then
    :func:`t5_multi_card` alone."""
    return _multi_card_alone("t5_multi_card", t5_multi_card, 4)


def t5_main():
    """``chip_smoke.py t5`` (one card): the kernels built, T5-small's kernel
    shapes (:func:`t5_kernels`), then :func:`t5_phase`."""
    dev = torch.device("cuda", 0)
    return _phases_alone([("t5_kernels", lambda smi: t5_kernels(dev, {})),
                          ("t5", t5_phase)])


# ----------------------------------------------------------------- contrib
#: fmha at BERT-Large's attention: 32 sequences of lengths drawn from the
#: seed in [128, 512], padded to max_s 512, 16 heads of 64
FMHA_MAX_S = 512
FMHA_HEADS, FMHA_D = 16, 64
FMHA_LENGTHS = tuple(int(n) for n in np.random.RandomState(0).randint(128, 513, size=32))
#: the flash kernels at fmha's dense shape in fp16 (a key mask, non-causal)
#: and at EncdecMultiheadAttn's (Sq 256 against Sk 512, non-causal, a key
#: mask): the contrib phase's new kernel shapes, each against its plain
#: version with its bound and SDPA's time
FMHA_FLASH = {"B": len(FMHA_LENGTHS), "H": FMHA_HEADS, "Hkv": FMHA_HEADS, "S": FMHA_MAX_S,
              "D": FMHA_D, "causal": False, "lengths": FMHA_LENGTHS, "library": True}
ENCDEC_FLASH = {"B": 16, "H": 16, "Hkv": 16, "S": 256, "Sk": 512, "D": 64, "causal": False,
                "lengths": FMHA_LENGTHS[:16], "library": True}
CONTRIB_FLASH_CASES = (("fmha_fp16", torch.float16, FMHA_FLASH),
                       ("encdec", torch.bfloat16, ENCDEC_FLASH))
#: the MHA modules: hidden 1024, 16 heads, S 512 (Sq 256 for the
#: cross attention), batch 16, the key lengths of ENCDEC_FLASH
MHA_HIDDEN, MHA_HEADS, MHA_S, MHA_BATCH = 1024, 16, 512, 16
#: card against CPU, fp32: outputs within 1e-5 of their largest entry;
#: grads that pass through the flash backward within its fp32 band
#: (FLASH_TOL_FP32's 1e-4), the rest within 1e-5
CONTRIB_CPU_TOL = 1e-5
CONTRIB_GRAD_TOL = FLASH_TOL_FP32["dq"]
#: timed calls of each contrib path (CUDA events and the profiler)
CONTRIB_ITERS = 5
#: DCGAN: the steps of each run (graphed and eager) at the driver's batch
DCGAN_STEPS = 5
#: attention_core at OpenFold's Evoformer widths: MSA row attention (128
#: sequences x 256 residues, 8 heads of 32) and triangle attention (256 x
#: 256, 4 heads of 32): (name, lead dims, heads, S, D)
EVOFORMER_CASES = (("msa_row", (1, 128), 8, 256, 32), ("triangle", (1, 256), 4, 256, 32))
#: xentropy (N, C); focal_loss (batch, anchors, classes); group_norm NHWC
#: shapes (a diffusion UNet's); index_mul_2d (rows, width); conv_bias_relu
#: NHWC input (ResNet-50's stage 1, 3 x 3); the transducer
XENT_SHAPE = (8192, 32768)
FOCAL_SHAPE = (16, 100000, 80)
GN_SHAPES = ((8, 64, 64, 320), (8, 32, 32, 640))
INDEX_MUL_SHAPE = (1 << 20, 32)
CONV_SHAPE = (64, 56, 56, 64)
TRANSDUCER = {"B": 16, "T": 200, "U": 64, "V": 1024, "joint": 512}


def _path_times(fn, iters=CONTRIB_ITERS, prefix="", profiled=True):
    """``{prefix}ms``: CUDA events around ``iters`` calls of ``fn`` (the
    device's time, or the host's where dispatch is slower); and, when
    ``profiled``, ``{prefix}device_ms``: the device time of its kernels a
    call (:func:`device_ms`, the profiler; left out where a path's many
    small ops make the trace long and the events already read its device
    time)."""
    out = {f"{prefix}ms": call_ms(fn, iters)}
    if profiled:
        out[f"{prefix}device_ms"] = device_ms(fn, iters)[0]
    return out


def _fwd_bwd(fn, inputs, cot):
    """``(out, grads)``: ``fn(*inputs)`` and its gradients under ``cot``
    with respect to the inputs that require grad."""
    out = fn(*inputs)
    return out, torch.autograd.grad(out, [t for t in inputs if t.requires_grad], cot)


def _leaf(a, dev, dtype=None, grad=False):
    t = torch.from_numpy(np.array(a)).to(dev)
    if dtype is not None:
        t = t.to(dtype)
    return t.requires_grad_(grad)


def _card_vs_cpu(name, fn_of, arrays, cot, diff, dev, dtype=torch.float32,
                 tol=CONTRIB_CPU_TOL, grad_tol=CONTRIB_CPU_TOL):
    """``fn_of(device)`` (a function of the inputs built for that device)
    on the card and on the CPU (the plain versions) from the same numpy
    ``arrays`` (those at ``diff`` differentiated, float inputs cast to
    ``dtype``): the output's and each grad's ``rel_err`` against the
    CPU's, raising past ``tol`` / ``grad_tol``."""
    def run(d):
        ins = [_leaf(a, d, dtype if np.asarray(a).dtype.kind == "f" else None, i in diff)
               for i, a in enumerate(arrays)]
        return _fwd_bwd(fn_of(d), ins, _leaf(cot, d, dtype))

    (out, grads), (pout, pgrads) = run(dev), run(torch.device("cpu"))
    errs = {"out": rel_err(out.detach().cpu(), pout.detach())}
    errs.update({f"grad{i}": rel_err(g.cpu(), p) for i, g, p in zip(diff, grads, pgrads)})
    bad = {k: e for k, e in errs.items() if not e <= (tol if k == "out" else grad_tol)}
    finite = bool(torch.isfinite(out).all()) and all(bool(torch.isfinite(g).all())
                                                     for g in grads)
    if bad or not finite:
        raise AssertionError(f"contrib {name}: card against CPU {errs} over {tol} / "
                             f"{grad_tol} (finite={finite})")
    return errs


def _counted(fn, want):
    """Run ``fn()`` once from zeroed counters; the counts of ``want``'s
    kernels must equal it."""
    torch.cuda.synchronize()
    reset_counts()
    fn()
    torch.cuda.synchronize()
    got = launch_counts()
    bad = {k: got[k] for k, v in want.items() if got[k] != v}
    if bad:
        raise AssertionError(f"launches {bad}, want { {k: want[k] for k in bad} }")
    return got


FLASH3 = {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
NO_FLASH = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
LN2 = {"layer_norm_fwd": 1, "layer_norm_bwd": 1}


def _add(total, counts, keys, suffix=""):
    for k in keys:
        total[k + suffix] = total.get(k + suffix, 0) + counts[k]


def _fmha_varlen_path(dev, dtype, totals):
    """fmha_varlen forward and backward at FMHA_LENGTHS: exact flash
    launches 1 / 1 / 1, ms of the path against SDPA with the boolean mask
    on the dense batch; the first two sequences card against CPU (plain
    versions from the same ``dtype`` inputs) in the flash bands."""
    from apex_tpu_torch.contrib.fmha import fmha_varlen

    rng = np.random.RandomState(1)
    lengths = np.asarray(FMHA_LENGTHS)
    cu = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    qkv = rng.standard_normal((int(cu[-1]), 3, FMHA_HEADS, FMHA_D)).astype(np.float32)
    cot = rng.standard_normal((int(cu[-1]), FMHA_HEADS, FMHA_D)).astype(np.float32)
    x = _leaf(qkv, dev, dtype, True)
    g = _leaf(cot, dev, dtype)
    cu_t = torch.from_numpy(cu).to(dev)
    fn = lambda t: fmha_varlen(t, cu_t, FMHA_MAX_S)  # noqa: E731
    counts = _counted(lambda: _fwd_bwd(fn, [x], g), FLASH3)
    _add(totals, counts, FLASH3, "_fp16" if dtype == torch.float16 else "")
    times = _path_times(lambda: _fwd_bwd(fn, [x], g), CONTRIB_ITERS)
    # SDPA on the dense padded batch with the boolean key mask
    B, S = len(lengths), FMHA_MAX_S
    dense = [_leaf(rng.standard_normal((B, FMHA_HEADS, S, FMHA_D)).astype(np.float32), dev,
                   dtype, True) for _ in range(3)]
    mask = (torch.arange(S, device=dev)[None, :]
            < torch.from_numpy(lengths).to(dev)[:, None])[:, None, None, :]
    sdpa = lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask)
    dg = torch.randn_like(dense[0])
    lib_times = _path_times(lambda: _fwd_bwd(sdpa, dense, dg), CONTRIB_ITERS, "sdpa_")
    n2 = int(cu[2])
    tol = FLASH_TOL_BF16 if dtype == torch.bfloat16 else FLASH_TOL_FP16
    errs = _card_vs_cpu(f"fmha_varlen {dtype}",
                        lambda d: (lambda t: fmha_varlen(t, torch.from_numpy(cu[:3]).to(d),
                                                         FMHA_MAX_S)),
                        [qkv[:n2]], cot[:n2], [0], dev, dtype, tol["out"], tol["dq"])
    return {"dtype": str(dtype).replace("torch.", ""), "tokens": int(cu[-1]),
            "sequences": B, "max_s": S, "launches": {k: counts[k] for k in FLASH3},
            **times, **lib_times, "card_vs_cpu_first2": errs}


def _mha_path(dev, kind, include_norm_add, totals):
    """SelfMultiheadAttn (S 512) or EncdecMultiheadAttn (Sq 256 against
    Sk 512) at hidden 1024, 16 heads, batch 16, bf16, the key padding
    mask of ENCDEC_FLASH's lengths: exact launches (LN 1 / 1 with
    ``include_norm_add``, flash 1 / 1 / 1), the block's forward and
    backward ms, and an fp32 copy at batch 2 card against CPU."""
    import copy

    from apex_tpu_torch.contrib import multihead_attn as mha

    H, nh, B = MHA_HIDDEN, MHA_HEADS, MHA_BATCH
    Sq = MHA_S if kind == "self" else MHA_S // 2
    rng = np.random.RandomState(2)
    lengths = np.asarray(ENCDEC_FLASH["lengths"])
    pad = np.arange(MHA_S)[None, :] >= lengths[:, None]            # True = PAD
    q = rng.standard_normal((Sq, B, H)).astype(np.float32)
    k = rng.standard_normal((MHA_S, B, H)).astype(np.float32)
    cot = rng.standard_normal((Sq, B, H)).astype(np.float32)

    def build(d):
        if kind == "self":
            return mha.SelfMultiheadAttn(H, nh, include_norm_add=include_norm_add,
                                         device="cpu").to(d)
        return mha.EncdecMultiheadAttn(H, nh, use_bias=True, include_norm_add=include_norm_add,
                                       device="cpu").to(d)

    cpu_module = build(torch.device("cpu"))
    card_module = copy.deepcopy(cpu_module).to(dev)

    def fn_of(module, d, rows=slice(None)):
        mask = torch.from_numpy(pad[rows]).to(d)
        if kind == "self":
            return lambda x: module(x, mask, train=False)
        return lambda x, kk: module(x, kk, mask, train=False)

    arrays = [q] if kind == "self" else [q, k]
    ins = [_leaf(a, dev, torch.bfloat16, True) for a in arrays]
    g = _leaf(cot, dev, torch.bfloat16)
    fn = fn_of(card_module, dev)
    want = {**FLASH3, **(LN2 if include_norm_add else
                         {"layer_norm_fwd": 0, "layer_norm_bwd": 0})}
    counts = _counted(lambda: _fwd_bwd(fn, ins, g), want)
    _add(totals, counts, want)
    times = _path_times(lambda: _fwd_bwd(fn, ins, g), CONTRIB_ITERS)
    rows = slice(0, 2)
    errs = _card_vs_cpu(
        f"{kind}_mha norm_add={include_norm_add}",
        lambda d: fn_of(card_module if d.type == "cuda" else cpu_module, d, rows),
        [a[:, rows] for a in arrays], cot[:, rows], list(range(len(arrays))), dev,
        grad_tol=CONTRIB_GRAD_TOL)
    return {"kind": kind, "include_norm_add": include_norm_add, "Sq": Sq, "Sk": MHA_S,
            "batch": B, "hidden": H, "heads": nh, "dtype": "bfloat16",
            "launches": {k: counts[k] for k in want}, **times, "card_vs_cpu_b2": errs}


def _attention_core_path(dev, name, lead, H, S, D, totals):
    """openfold's attention_core at an Evoformer shape, bf16, a residue
    mask (…, 1, 1, S) and the fp32 pair bias (1, 1, H, S, S), forward and
    backward (the bias's grad too): the scan path, no flash launch; ms
    against SDPA with the summed float mask; four rows card against CPU
    in fp32."""
    from apex_tpu_torch.contrib.openfold_triton import attention_core

    rng = np.random.RandomState(3)
    shape = (*lead, H, S, D)
    q, k, v, cot = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    mask = (rng.rand(*lead, 1, 1, S) > 0.1).astype(np.float32)
    bias = rng.standard_normal((1, 1, H, S, S)).astype(np.float32)
    ins = [_leaf(q, dev, torch.bfloat16, True), _leaf(k, dev, torch.bfloat16, True),
           _leaf(v, dev, torch.bfloat16, True), _leaf(mask, dev), _leaf(bias, dev, grad=True)]
    g = _leaf(cot, dev, torch.bfloat16)
    fn = lambda q, k, v, m, b: attention_core(q, k, v, mask=m, bias=b)  # noqa: E731
    counts = _counted(lambda: _fwd_bwd(fn, ins, g), NO_FLASH)
    times = _path_times(lambda: _fwd_bwd(fn, ins, g), CONTRIB_ITERS)
    n = int(np.prod(lead))
    sq = [t.detach().reshape(n, H, S, D).requires_grad_() for t in ins[:3]]
    fb = (torch.where(ins[3].bool(), 0.0, -1e9) + ins[4].detach()).expand(*lead, H, S, S)
    fb = fb.reshape(n, H, S, S).to(torch.bfloat16)
    sdpa = lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=fb)
    lib_times = _path_times(lambda: _fwd_bwd(sdpa, sq, g.reshape(n, H, S, D)),
                            CONTRIB_ITERS, "sdpa_")
    small = (*lead[:-1], 4)
    errs = _card_vs_cpu(f"attention_core {name}", lambda d: fn,
                        [q[..., :4, :, :, :], k[..., :4, :, :, :], v[..., :4, :, :, :],
                         mask[..., :4, :, :, :], bias], cot[..., :4, :, :, :], [0, 1, 2, 4], dev,
                        grad_tol=CONTRIB_CPU_TOL)
    del ins, sq, fb
    return {"case": name, "lead": list(lead), "heads": H, "S": S, "D": D, "dtype": "bfloat16",
            "flash_launches": {k: counts[k] for k in NO_FLASH}, **times, **lib_times,
            "card_vs_cpu_rows": list(small), "card_vs_cpu": errs}


def _adam_swa_path(dev, totals, steps=5):
    """FusedAdamSWA over bench.py's leaves (the optimizers phase's 99
    tensors): ``mt_plan``'s ``mt_adam`` launches a step, the step's ms;
    five steps with the third skipped (grads_finite false) card against
    CPU on the odd shapes, within 1e-7 of the largest entry."""
    from apex_tpu_torch.contrib.openfold_triton import FusedAdamSWA
    from apex_tpu_torch.ops.multi_tensor import mt_plan

    params, grads = bench_params(dev)
    opt = FusedAdamSWA(lr=1e-3, weight_decay=0.01)
    state = opt.init(params)
    want = mt_plan("adam", [p.numel() for p in params.values()]).launches
    counts = _counted(lambda: opt.update(grads, state, params, inplace=True),
                      {"mt_adam": want})
    _add(totals, counts, ("mt_adam",))
    times = _path_times(lambda: opt.update(grads, state, params, inplace=True), 10,
                        profiled=False)
    rng = np.random.RandomState(4)
    p0 = {f"p{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate(ODD_SHAPES)}
    gs = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
          for _ in range(steps)]
    runs = []
    for d in (dev, torch.device("cpu")):
        o = FusedAdamSWA(lr=1e-2, weight_decay=0.01)
        p = {k: torch.from_numpy(v).to(d) for k, v in p0.items()}
        s = o.init(p)
        for i, g in enumerate(gs):
            p, s = o.update({k: torch.from_numpy(v).to(d) for k, v in g.items()}, s, p,
                            grads_finite=torch.tensor(i != 2, device=d))
        runs.append((p, s))
    (p, s), (cp, cs) = runs
    errs = {"params": max(rel_err(p[k].cpu(), cp[k]) for k in p),
            "swa": max(rel_err(s.swa_params[k].cpu(), cs.swa_params[k]) for k in p)}
    n = (int(s.n_averaged), int(cs.n_averaged))
    if not max(errs.values()) <= 1e-7 or n != (steps - 1, steps - 1):
        raise AssertionError(f"FusedAdamSWA card against CPU: {errs}, n_averaged {n}")
    del params, grads, state
    return {"tensors": len(bench_param_shapes()), "mt_adam_launches": counts["mt_adam"],
            **times, "card_vs_cpu": errs, "n_averaged": n[0]}


def _loss_paths(dev):
    """xentropy (8192 x 32768, bf16, smoothing 0.1) against
    ``F.cross_entropy(label_smoothing=0.1)``; focal_loss (16 x 100,000
    anchors x 80 classes, fp32); each forward and backward ms, and a
    slice card against CPU in fp32."""
    from apex_tpu_torch.contrib.focal_loss import focal_loss
    from apex_tpu_torch.contrib.xentropy import softmax_xentropy

    out = {}
    rng = np.random.RandomState(5)
    N, C = XENT_SHAPE
    x = torch.randn(N, C, device=dev, dtype=torch.bfloat16, requires_grad=True)
    y = torch.randint(0, C, (N,), device=dev)
    g = torch.rand(N, device=dev)
    fn = lambda x: softmax_xentropy(x, y, 0.1)  # noqa: E731
    ce = lambda x: torch.nn.functional.cross_entropy(  # noqa: E731
        x.float(), y, reduction="none", label_smoothing=0.1)
    times = _path_times(lambda: _fwd_bwd(fn, [x], g), profiled=False)
    lib_times = _path_times(lambda: _fwd_bwd(ce, [x], g), prefix="cross_entropy_",
                            profiled=False)
    labels = rng.randint(0, C, size=256)
    errs = _card_vs_cpu("xentropy", lambda d: (lambda t, lab: softmax_xentropy(t, lab, 0.1)),
                        [rng.standard_normal((256, C)).astype(np.float32) * 3, labels],
                        rng.rand(256).astype(np.float32), [0], dev)
    out["xentropy"] = {"N": N, "C": C, "dtype": "bfloat16", "smoothing": 0.1, **times,
                       **lib_times, "card_vs_cpu_256_rows": errs}
    del x
    B, A, K = FOCAL_SHAPE
    logits = torch.randn(B, A, K, device=dev, requires_grad=True)
    t = torch.randint(-1, K + 1, (B, A), device=dev)
    nps = (t > 0).sum().float()
    one = torch.ones((), device=dev)
    fn = lambda x: focal_loss(x, t, nps, K)  # noqa: E731
    times = _path_times(lambda: _fwd_bwd(fn, [logits], one), profiled=False)
    tt = rng.randint(-1, K + 1, size=(2, 1000))
    errs = _card_vs_cpu("focal_loss",
                        lambda d: (lambda x, tg: focal_loss(x, tg, float((tt > 0).sum()), K)),
                        [rng.standard_normal((2, 1000, K)).astype(np.float32), tt],
                        np.float32(1.0), [0], dev)
    out["focal_loss"] = {"shape": [B, A, K], "dtype": "float32", **times,
                         "card_vs_cpu_2x1000": errs}
    del logits
    torch.cuda.empty_cache()
    return out


def _norm_conv_paths(dev):
    """group_norm NHWC + SiLU (32 groups, bf16) at a diffusion UNet's
    (8, 64, 64, 320) and (8, 32, 32, 640) against ``F.group_norm`` +
    ``F.silu`` on the channels_last view; index_mul_2d; conv_bias_relu at
    ResNet-50's (64, 56, 56, 64) 3 x 3; each forward and backward ms and
    a slice card against CPU in fp32."""
    from apex_tpu_torch.contrib.conv_bias_relu import ConvBiasReLU
    from apex_tpu_torch.contrib.group_norm import group_norm_nhwc
    from apex_tpu_torch.contrib.index_mul_2d import index_mul_2d

    F = torch.nn.functional
    rng = np.random.RandomState(6)
    out = {"group_norm": []}
    for shape in GN_SHAPES:
        C = shape[-1]
        x = torch.randn(shape, device=dev, dtype=torch.bfloat16, requires_grad=True)
        w = torch.rand(C, device=dev, requires_grad=True)
        b = torch.randn(C, device=dev, requires_grad=True)
        g = torch.randn(shape, device=dev, dtype=torch.bfloat16)
        fn = lambda x, w, b: group_norm_nhwc(x, 32, w, b, act="silu")  # noqa: E731
        lib = lambda x, w, b: F.silu(F.group_norm(  # noqa: E731
            x.permute(0, 3, 1, 2), 32, w.to(x.dtype), b.to(x.dtype))).permute(0, 2, 3, 1)
        times = _path_times(lambda: _fwd_bwd(fn, [x, w, b], g), profiled=False)
        lib_times = _path_times(lambda: _fwd_bwd(lib, [x, w, b], g),
                                prefix="group_norm_silu_", profiled=False)
        small = (1, *shape[1:])
        errs = _card_vs_cpu("group_norm", lambda d: fn,
                            [rng.standard_normal(small).astype(np.float32),
                             rng.rand(C).astype(np.float32),
                             rng.standard_normal(C).astype(np.float32)],
                            rng.standard_normal(small).astype(np.float32), [0, 1, 2], dev)
        out["group_norm"].append({"shape": list(shape), "groups": 32, "act": "silu",
                                  "dtype": "bfloat16", **times,
                                  **lib_times, "card_vs_cpu_n1": errs})
    # index_mul_2d at OpenFold's (N 1,048,576 rows of 32, K the same, repeated indices)
    N, D = INDEX_MUL_SHAPE
    in1 = torch.randn(N, D, device=dev, requires_grad=True)
    in2 = torch.randn(N, D, device=dev, requires_grad=True)
    idx = torch.randint(0, N, (N,), device=dev)
    g = torch.randn(N, D, device=dev)
    fn = lambda a, b: index_mul_2d(a, b, idx)  # noqa: E731
    times = _path_times(lambda: _fwd_bwd(fn, [in1, in2], g), profiled=False)
    ii = rng.randint(0, 64, size=256)
    errs = _card_vs_cpu("index_mul_2d", lambda d: (lambda a, b, i: index_mul_2d(a, b, i)),
                        [rng.standard_normal((64, D)).astype(np.float32),
                         rng.standard_normal((256, D)).astype(np.float32), ii],
                        rng.standard_normal((256, D)).astype(np.float32), [0, 1], dev)
    out["index_mul_2d"] = {"N": N, "D": D, "K": N, "dtype": "float32", **times,
                           "card_vs_cpu": errs}
    # conv_bias_relu at ResNet-50's stage-1 3 x 3
    C = CONV_SHAPE[-1]
    x = torch.randn(CONV_SHAPE, device=dev, dtype=torch.bfloat16, requires_grad=True)
    w = (torch.randn(3, 3, C, C, device=dev) / 24).to(torch.bfloat16).requires_grad_()
    b = torch.randn(C, device=dev, dtype=torch.bfloat16, requires_grad=True)
    g = torch.randn(CONV_SHAPE, device=dev, dtype=torch.bfloat16)
    times = _path_times(lambda: _fwd_bwd(ConvBiasReLU, [x, w, b], g), profiled=False)
    errs = _card_vs_cpu("conv_bias_relu", lambda d: ConvBiasReLU,
                        [rng.standard_normal((2, *CONV_SHAPE[1:])).astype(np.float32),
                         (rng.standard_normal((3, 3, C, C)) / 24).astype(np.float32),
                         rng.standard_normal(C).astype(np.float32)],
                        rng.standard_normal((2, *CONV_SHAPE[1:])).astype(np.float32),
                        [0, 1, 2], dev)
    out["conv_bias_relu"] = {"shape": list(CONV_SHAPE), "kernel": [3, 3, C, C],
                             "dtype": "bfloat16", **times, "card_vs_cpu_b2": errs}
    return out


def _transducer_path(dev):
    """TransducerJoint (ReLU) and transducer_loss at B 16, T 200, U 64, V
    1024, joint width 512 (a linear 512 -> V between them), bf16 joint and
    fp32 loss, forward and backward ms; B 2, T 40, U 12 card against CPU
    in fp32."""
    from apex_tpu_torch.contrib.transducer import TransducerJoint, transducer_loss

    B, T, U, V, Hj = (TRANSDUCER[k] for k in ("B", "T", "U", "V", "joint"))
    rng = np.random.RandomState(7)
    joint = TransducerJoint(relu=True)

    def path(f, g, w, targets, f_len, y_len):
        h = joint(f, g)
        logits = h @ w.to(h.dtype)
        return transducer_loss(logits, targets, f_len, y_len)

    f = torch.randn(B, T, Hj, device=dev, dtype=torch.bfloat16, requires_grad=True)
    g = torch.randn(B, U, Hj, device=dev, dtype=torch.bfloat16, requires_grad=True)
    w = (torch.randn(Hj, V, device=dev) / Hj ** 0.5).requires_grad_()
    targets = torch.randint(1, V, (B, U - 1), device=dev)
    f_len = torch.from_numpy(rng.randint(T // 2, T + 1, size=B)).to(dev)
    y_len = torch.from_numpy(rng.randint(U // 2, U, size=B)).to(dev)
    cot = torch.ones(B, device=dev)
    fn = lambda f, g, w: path(f, g, w, targets, f_len, y_len)  # noqa: E731
    loss, _ = _fwd_bwd(fn, [f, g, w], cot)
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError(f"transducer: loss {loss} not finite")
    times = _path_times(lambda: _fwd_bwd(fn, [f, g, w], cot), 2, profiled=False)
    b, t, u = 2, 40, 12
    tg = rng.randint(1, V, size=(b, u - 1))
    fl, yl = np.array([t, t - 7]), np.array([u - 1, u - 4])
    errs = _card_vs_cpu("transducer", lambda d: (lambda f, g, w, tg, fl, yl: path(
                            f, g, w, tg, fl, yl)),
                        [rng.standard_normal((b, t, Hj)).astype(np.float32),
                         rng.standard_normal((b, u, Hj)).astype(np.float32),
                         (rng.standard_normal((Hj, V)) / Hj ** 0.5).astype(np.float32),
                         tg, fl, yl], np.ones(b, np.float32), [0, 1, 2], dev)
    del f, g, w
    return {"B": B, "T": T, "U": U, "V": V, "joint_width": Hj, "joint_dtype": "bfloat16",
            "mean_loss": float(loss.detach().mean()), **times, "card_vs_cpu_b2": errs}


def _dcgan_path(dev):
    """``dcgan_main_amp.run`` at its widths and batch (32, bf16), graphed
    and eager for DCGAN_STEPS steps each under cuDNN's deterministic
    algorithms: losses, params and both optimizers' states bitwise equal;
    the graphed median step ms (both networks)."""
    from apex_tpu_torch import dcgan_main_amp as dc
    from apex_tpu_torch.graphs import tensor_leaves

    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = {}
        for name, extra in (("graphed", []), ("eager", ["--eager"])):
            args = dc.build_args().parse_args(["--steps", str(DCGAN_STEPS)] + extra)
            with contextlib.redirect_stdout(sys.stderr):
                runs[name] = dc.run(args)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    gr, eg = runs["graphed"], runs["eager"]
    same = gr["losses"] == eg["losses"] and all(
        torch.equal(a, b) for a, b in zip(tensor_leaves((gr["params"], gr["states"])),
                                          tensor_leaves((eg["params"], eg["states"]))))
    finite = all(math.isfinite(x) for pair in gr["losses"] for x in pair)
    if not (gr["graphs"] and same and finite):
        raise AssertionError(f"dcgan: graphed {gr['losses']} against eager {eg['losses']} "
                             f"(graphs {gr['graphs']}, bitwise {same}, finite {finite})")
    return {"steps": DCGAN_STEPS, "batch": 32, "compute_dtype": "bfloat16",
            "losses": gr["losses"], "graphed_vs_eager": "bitwise (cudnn deterministic)",
            "step_ms_median": gr["step_ms"], "eager_step_ms_median": eg["step_ms"],
            "loss_scales": gr["loss_scales"]}


def _ddp_path():
    """``distributed_data_parallel.run`` at world 1 over NCCL."""
    from apex_tpu_torch import distributed_data_parallel as ddp

    with contextlib.redirect_stdout(sys.stderr):
        t0 = time.perf_counter()
        r = ddp.run(ddp.build_args().parse_args([]))
    return {"world": r["world"], "losses": r["losses"], "err": r["err"],
            "seconds": time.perf_counter() - t0}


def contrib_kernels(dev, results):
    """The flash kernels at the contrib phase's new shapes
    (CONTRIB_FLASH_CASES), each against its plain version."""
    for case, dtype, kw in CONTRIB_FLASH_CASES:
        r = check_flash(dev, dtype, case, **kw)
        results[("flash", case, dtype)] = r
        for name in ("fwd", "dq", "dkv"):
            emit({"phase": "kernel", **r[name]})


def contrib_phase(smi):
    """The contrib modules and the two drivers on one card: each path
    forward and backward at the widths its users run, its ms (CUDA
    events over CONTRIB_ITERS calls), exact launches where it runs the
    port's kernels, and a slice of it card against CPU (the plain
    versions) in fp32; see each ``_*_path``.  Returns the LN, flash and
    ``mt_adam`` launches of the counted runs (they add to the kernels
    line)."""
    t0 = time.monotonic()
    dev = torch.device("cuda", 0)
    totals = {}
    rec = {}

    def path(name, fn):
        t = time.monotonic()
        rec[name] = fn()
        emit({"phase": "contrib_path", "path": name, "result": rec[name],
              "seconds": time.monotonic() - t})
        torch.cuda.empty_cache()

    path("fmha_varlen", lambda: [_fmha_varlen_path(dev, dt, totals)
                                 for dt in (torch.bfloat16, torch.float16)])
    path("self_mha", lambda: [_mha_path(dev, "self", na, totals) for na in (False, True)])
    path("encdec_mha", lambda: [_mha_path(dev, "encdec", na, totals) for na in (False, True)])
    path("attention_core", lambda: [_attention_core_path(dev, *case, totals)
                                    for case in EVOFORMER_CASES])
    path("fused_adam_swa", lambda: _adam_swa_path(dev, totals))
    path("losses", lambda: _loss_paths(dev))
    path("norm_conv", lambda: _norm_conv_paths(dev))
    path("transducer", lambda: _transducer_path(dev))
    path("dcgan", lambda: _dcgan_path(dev))
    path("distributed_data_parallel", _ddp_path)
    emit({"phase": "contrib", "nvidia_smi": smi, "launches": totals,
          "seconds": time.monotonic() - t0})
    return totals


def contrib_main():
    """``chip_smoke.py contrib`` (one card): the kernels built, the flash
    kernels at the contrib shapes (:func:`contrib_kernels`), then
    :func:`contrib_phase`."""
    dev = torch.device("cuda", 0)
    return _phases_alone([("contrib_kernels", lambda smi: contrib_kernels(dev, {})),
                          ("contrib", contrib_phase)])


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
    if sys.argv[1:2] == ["pp_bisect"]:
        return pp_bisect_main()
    if sys.argv[1:2] == ["zero_child"]:
        return zero_child(sys.argv[2:])
    if sys.argv[1:2] == ["overlap_child"]:
        return overlap_child(sys.argv[2:])
    if sys.argv[1:2] == ["overlap_multi_card"]:
        return overlap_multi_card_main()
    if sys.argv[1:2] == ["step_options"]:
        return step_options_main()
    if sys.argv[1:2] == ["multi_card"]:
        return multi_card_main()
    if sys.argv[1:2] == ["cp_child"]:
        return cp_child(sys.argv[2:])
    if sys.argv[1:2] == ["cp_multi_card"]:
        return cp_multi_card_main()
    if sys.argv[1:2] == ["cp"]:
        return cp_main()
    if sys.argv[1:2] == ["moe"]:
        return moe_main()
    if sys.argv[1:2] == ["moe_child"]:
        return moe_child(sys.argv[2:])
    if sys.argv[1:2] == ["moe_multi_card"]:
        return moe_multi_card_main()
    if sys.argv[1:2] == ["tp_decode_child"]:
        return tp_decode_child(sys.argv[2:])
    if sys.argv[1:2] == ["tp_decode_multi_card"]:
        return tp_decode_multi_card_main()
    if sys.argv[1:2] == ["pp_bisect_child"]:
        return pp_bisect_child(sys.argv[2:])
    if sys.argv[1:2] == ["resilience"]:
        return _phases_alone(RESILIENCE_PHASES)
    if sys.argv[1:2] == ["serve_hooks"]:
        return serve_hooks_main(sys.argv[2:])
    if sys.argv[1:2] == ["bert"]:
        return _phases_alone([("bert", bert_phase)])
    if sys.argv[1:2] == ["resnet"]:
        return _phases_alone([("resnet", resnet_phase)])
    if sys.argv[1:2] == ["models_child"]:
        return models_child(sys.argv[2:])
    if sys.argv[1:2] == ["models_multi_card"]:
        return models_multi_card_main()
    if sys.argv[1:2] == ["t5"]:
        return t5_main()
    if sys.argv[1:2] == ["t5_child"]:
        return t5_child(sys.argv[2:])
    if sys.argv[1:2] == ["t5_multi_card"]:
        return t5_multi_card_main()
    if sys.argv[1:2] == ["contrib"]:
        return contrib_main()

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
                     ("ragged", {"N": 1000, "V": 50257, "library": False}),
                     # a vocab split of the last, partial tile alone: tp 2's
                     # shard of GPT-345M's vocab at 1024 rows (one row of
                     # 1024 positions a microbatch), the shape whose NaN
                     # ROADMAP.md section 3 logs
                     ("partial_tile_split", {"N": 1024, "H": 1024, "V": 25152,
                                             "library": False}),
                     *CE_GRID):
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
        # the gpt124_s4096 cell's shape (the train_s4096 phase)
        *FLASH_S4096,
        # the bert phase's: BERT-Large, bidirectional, key-padding mask
        ("bert_large", torch.bfloat16, {**BERT_FLASH, "library": True}),
        # the contrib phase's: fmha's dense shape in fp16, the cross attention
        *CONTRIB_FLASH_CASES,
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
    for case, S, causal in FLASH_RING_CASES:
        r = check_flash_ring(dev, case, S, causal)
        results[("flash_ring", case)] = r
        for name in ("fwd", "dq", "dkv"):
            emit({"phase": "kernel", **r[name]})
    t5_kernels(dev, results)
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
    s4096 = train_s4096_phase()
    lap("train_s4096")
    cp_runs = cp_phase(smi, s4096)
    lap("cp")
    moe_phase(smi, fused["step_ms_median"])
    lap("moe")
    bert_phase(smi)
    lap("bert")
    resnet_phase(smi)
    lap("resnet")
    t5_runs = t5_phase(smi)
    lap("t5")
    contrib_counts = contrib_phase(smi)
    lap("contrib")
    inplace_ab_phase()
    lap("inplace_ab")
    attn_bias_phase(dev)
    lap("attn_bias")
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
    remat_dots_phase()
    lap("remat_dots")
    remainder_launches = zero_phase(smi, full)
    lap("zero")
    absent = tp_phase(smi)
    lap("tp")
    pp_phase(smi, absent)
    lap("pp")
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
        # the ring-chunk mode (bf16 in, fp32 do and outputs) at the cp
        # phase's chunk, ring attention's per-chunk kernels
        ("flash_fwd_ring", "apex_tpu_torch/csrc/flash_attention.cu",
         "apex_tpu/ops/flash_attention_pallas.py:145",
         results[("flash_ring", "ring_diag_s4096")]["fwd"]),
        ("flash_dq_ring", "apex_tpu_torch/csrc/flash_attention.cu",
         "apex_tpu/ops/flash_attention_pallas.py:339",
         results[("flash_ring", "ring_diag_s4096")]["dq"]),
        ("flash_dkv_ring", "apex_tpu_torch/csrc/flash_attention.cu",
         "apex_tpu/ops/flash_attention_pallas.py:394",
         results[("flash_ring", "ring_diag_s4096")]["dkv"]),
    )
    # launches: the serve phase's for the serving kernels, the serve_v2
    # phase's for the width > 1 layout, the train phase's for the
    # training kernels, the train_fce phase's for the CE kernels
    # (LayerNorm forward and sampling run in several; their lines keep
    # the serve phase's counts); mt_adam the train phase's, mt_scale and
    # mt_l2norm the optimizers phase's amp steps; the fp16 instantiations
    # the train_fp16 phase's; mt_adam_remainder the zero phase's
    # zero_param_remainders replays; the ring-chunk mode the cp phase's
    # graphed fused-CE run
    launches = {**train_counts, **amp_counts, "mt_adam": train_counts["mt_adam"],
                "mt_adam_remainder": remainder_launches,
                **{k: counts[k] for k in
                                   ("layer_norm_fwd", "paged_decode_attention",
                                    "fused_sample")},
                "paged_decode_attention_wide": v2_counts["paged_decode_attention_wide"],
                **{k: fce_counts[k] for k in ("ce_fwd", "ce_dx", "ce_dembed")},
                **{f"{k}_fp16": fp16_counts[k] for k in (
                    "layer_norm_fwd", "layer_norm_bwd", "flash_fwd", "flash_dq", "flash_dkv")},
                **cp_runs["fused_ce"]["ring_launches"]}
    # T5's RMS and CE launches (the t5 phase's graphed fused-CE run) add to
    # the LayerNorm and CE kernels' counts
    for k in ("layer_norm_fwd", "layer_norm_bwd", "ce_fwd", "ce_dx", "ce_dembed"):
        launches[k] += t5_runs["fused_ce"]["counts"][k]
    # the contrib phase's counted runs (fmha, the MHA modules, FusedAdamSWA)
    # add to the LayerNorm, flash (bf16 and fp16) and mt_adam counts
    for k, n in contrib_counts.items():
        launches[k] += n
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
