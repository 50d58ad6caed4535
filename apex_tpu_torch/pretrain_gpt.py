"""GPT pretraining with the trainer's host runtime -- the port's twin of
``examples/gpt/pretrain_gpt.py``: data-, tensor- and pipeline-parallel
over a ``torch.distributed`` group of one process a rank.

    python -m apex_tpu_torch.pretrain_gpt --steps 8                # on the GPU
    python -m apex_tpu_torch.pretrain_gpt --device cpu --steps 4   # plain versions
    python -m apex_tpu_torch.pretrain_gpt --zero                   # ZeRO-2
    ... --zero --grad-sync-dtype int8            # the quantized grad wire
    torchrun --nproc-per-node 2 -m apex_tpu_torch.pretrain_gpt --device cpu --zero
    #   two ranks under gloo (NCCL and one card a rank on CUDA)
    torchrun --nproc-per-node 2 -m apex_tpu_torch.pretrain_gpt --tp 2 --sequence-parallel
    #   tensor (and sequence) parallel over two ranks
    torchrun --nproc-per-node 4 -m apex_tpu_torch.pretrain_gpt --device cpu --tp 2 --pp 2
    #   two pipeline stages of two tensor-parallel ranks each (1F1B over
    #   --micro-batches 2)
    torchrun --nproc-per-node 4 -m apex_tpu_torch.pretrain_gpt --zero --tp 2 --pp 2 \
        --micro-batches 8 --fused-ce
    #   ZeRO over the same layout: each rank's optimizer state is the dp
    #   shard of its own (pp, tp) slice (dp 1 here; --zero --tp 2 on four
    #   ranks is dp 2)
    ... --checkpoint /tmp/gpt_ck --steps 4       # then: --resume /tmp/gpt_ck
    ... --checkpoint /tmp/gpt_ck --auto-resume   # SIGTERM saves, drains and
    #   exits 0; rerunning the same line resumes from the newest valid
    #   checkpoint (torn files skipped)
    ... --data tokens.bin --data-dtype uint16    # a memmapped token corpus
    ... --metrics-dir /tmp/m --trace-dir /tmp/t  # telemetry, goodput, spans
    ... --watchdog-secs 60                       # wedged step: drain, exit 75
    ... --chaos-kill-at-step 3                   # chaos: die hard (exit 137, no save)
    ... --chaos-wedge-step 4 --chaos-wedge-secs 300 --watchdog-secs 3   # a wedged step
    ... --supervise --zero --checkpoint /tmp/gpt_ck --auto-resume --save-every 1
    #   self-healing: a supervisor relaunches this same command as its
    #   child on 75 / 137 / a crash with full-jitter backoff, quarantines
    #   a corrupt newest checkpoint, opens its breaker (exit 76) after
    #   --crash-loop-threshold failures with no progress, and prints the
    #   whole job's goodput (apex_tpu_torch.resilience.supervisor)

The flags, their defaults and the printed lines are the reference
driver's where they apply.  The step is :func:`apex_tpu_torch.train_gpt
.make_train_step` (flash attention, full remat, FusedAdam(weight_decay=
0.01) on the multi-tensor engine, ``--fp16``'s DynamicLossScaler(2**12)),
captured as one CUDA graph unless ``--eager``.

Data parallelism: the process group comes from the ``torchrun``
environment (:func:`apex_tpu_torch.parallel.initialize_distributed`:
NCCL on CUDA, gloo with ``--device cpu``); without it the run is a
one-rank group, whose collectives still run.  Each rank takes its
``--global-batch / dp`` rows of every global batch (its own Megatron
sample).  ``--zero`` trains with ``DistributedFusedAdam(lr,
weight_decay=0.01, axis_name="dp", grad_sync_dtype=...)``, which owns the
grad sync (per-bucket reduce-scatter, the shard update, per-bucket
all-gather, all inside the captured step); without it a world above one
all-reduces the grads a bucket at a time (the DDP sync) before
FusedAdam.  The printed loss is the mean over the ranks.  Only rank 0
prints and writes the metrics and goodput files.

Tensor parallelism: ``--tp N`` splits the model over groups of N
consecutive ranks (:mod:`apex_tpu_torch.transformer.parallel_state`:
rank = dp_rank * N + tp_rank, the JAX mesh's layout), dp = world / N;
each rank holds its slices of the params (``models.gpt.shard_params`` of
the seed-0 tree, the slice ``shard_map`` gives the same device) and of
FusedAdam's state, and the step runs the loss over the group
(``train_gpt.make_train_step(tp_group=)``); ``--sequence-parallel``
splits the layers' activations over the sequence too.  The tp ranks of
a dp rank take the same rows.

Pipeline parallelism: ``--pp N`` splits the layers into N stages of L /
N (rank = (dp_rank * N + pp_rank) * tp + tp_rank) and trains with
``models.gpt.make_pp_train_step``: each dp rank's rows split into
``--micro-batches`` microbatches driven through the 1F1B schedule, the
stages exchanging activations and cotangents point to point
(:mod:`apex_tpu_torch.transformer.pipeline_parallel`); every stage holds
the embedding and the final LayerNorm, whose grads are summed over the
stages, and every rank of a dp replica reads the same rows.  At pp 1
``--micro-batches`` changes nothing, as in the reference.  ``--zero``
composes with both (``examples/gpt/pretrain_gpt.py``'s ``init(params,
world_size=dp, param_specs=train_param_specs(), axis_sizes={"tp": N,
"pp": M})``): each rank's ZeRO state is the dp shard of its own (pp, tp)
slice of the params.  With ``--metrics-dir`` or
``--trace-dir`` a :class:`~apex_tpu_torch.observability.StepStats` window
rides it in fixed device buffers.  The loop reads no device value on the
host: each step's loss (and scale) goes to an
:class:`~apex_tpu_torch.observability.AsyncFetcher` and prints when its
copy has landed; the telemetry window is fetched every
``--telemetry-every`` steps and reset in stream order.

``--zero`` checkpoints are elastic ``step_<N>/`` directories (one shard
file a dp rank and an index, :mod:`apex_tpu_torch.resilience.elastic`;
under ``--tp`` / ``--pp`` the params whole and each dp rank's state with
its model segments, ``mesh_axes`` the layout): a save at one dp world
resumes at another, one at another tp or pp is refused as the reference
refuses it, and a JAX ``--zero`` directory resumes here.  Other
checkpoints are the JAX trainer's single-file ``step_<N>.ckpt`` in its byte layout and tree (``{"params", "state":
AdamState, "step", "scaler"}``; rank 0 writes it), written by an :class:`~apex_tpu_torch.io.AsyncCheckpointer`
that snapshots to host before ``save`` returns.  Under ``--tp`` or
``--pp`` the params and moments are all-gathered over the groups into
that whole tree before the save, and the file gains ``"mesh": {"tp",
"pp"}`` (the model layout, which the reference records in its elastic
checkpoints, ``mesh_meta``); a resume at the same tp and pp shards the
file again, bitwise, and one at another raises as a layout change
(``TP_LAYOUT_ITEM``).  A file the JAX trainer wrote is a whole tree and
is sharded to this run's tp and pp, as the reference resumes it on any
mesh; ``--keep`` prunes to the
newest ``max(keep, 3)``.  ``--resume`` takes that directory (the newest
valid file in it) or one file.  Batches are Megatron-sampled rows of
``seq + 1`` tokens (``--data``: a flat memmapped token file; else a
random corpus from seed 0), gathered by the native ``gather_rows`` on a
prefetch thread.

``--supervise`` is handled by :func:`main` before anything touches the
device (the parent must not hold the card its child needs): it runs
:func:`apex_tpu_torch.resilience.supervisor.run_supervised_cli` over
``python -m apex_tpu_torch.pretrain_gpt`` and the same flags less the
supervisor's own.  The ``--chaos-*`` faults are delivered at the top of
the planned step, after the watchdog's heartbeat: a kill raises
:class:`~apex_tpu_torch.resilience.chaos.ChaosHostKilled` (exit 137, no
save, no drain) on rank 0, a wedge sleeps the step's dispatch.
``--auto-resume`` does not degrade kernel failures to a fallback as the
reference's does: a kernel that fails to build or launch raises, as
everywhere in the port.

Before the reference's final ``N steps in Xs (T tokens/s)`` line the
port prints one JSON line, ``{"pretrain_gpt": {...}}``: every step's loss
as fetched, the step times from CUDA events recorded after each step (no
host sync in the loop; the first step includes the warm-up and the
capture), each save's blocking host time, and each checkpoint write's
seconds and bytes on the writer thread.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: the reference driver's FusedAdam weight decay
WEIGHT_DECAY = 0.01
#: ``--fp16``'s scaler (its other settings at their defaults)
FP16_INIT_SCALE = 2.0 ** 12

#: what a resume at another tp or pp than the checkpoint's waits for
TP_LAYOUT_ITEM = ("a tp/pp reshape is a state-layout change, which the reference refuses too "
                  "(ROADMAP.md queue 1 item 13)")

def build_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--micro-batches", type=int, default=2,
                   help="pipeline microbatches a step (each dp rank's rows split into "
                        "them; at --pp 1 unused)")
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--fp16", action="store_true",
                   help="float16 compute + dynamic loss scaling")
    p.add_argument("--rope", action="store_true",
                   help="rotary position embeddings (no learned table)")
    p.add_argument("--num-query-groups", type=int, default=None,
                   help="grouped-query attention: kv-head groups (1 = MQA)")
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-2: shard optimizer state over dp")
    p.add_argument("--grad-sync-dtype", default=None,
                   choices=["int8", "float8_e4m3fn", "float8_e5m2"],
                   help="quantized ZeRO gradient sync (needs --zero): the per-bucket "
                        "reduce-scatter carries int8/fp8 payloads with per-block fp32 scales, "
                        "and the quantization error rides the optimizer state as an "
                        "error-feedback residual (checkpointed; resume must pass the same flag)")
    p.add_argument("--sequence-parallel", action="store_true",
                   help="Megatron sequence parallelism over the --tp group")
    p.add_argument("--remat-policy", default="full", choices=["full", "dots"],
                   help="layer remat: 'full' saves only layer inputs ('dots' is not "
                        "ported yet)")
    p.add_argument("--fused-ce", action="store_true",
                   help="chunked fused LM-head+CE: never materializes the fp32 logits")
    p.add_argument("--checkpoint", default=None, help="save dir (async)")
    p.add_argument("--save-every", type=int, default=4)
    p.add_argument("--keep", type=int, default=3,
                   help="retain this many step_* files (min 3 — younger files may "
                        "still be writing)")
    p.add_argument("--data", default=None,
                   help="memmapped token file (flat binary of ids); consumed as "
                        "non-overlapping seq+1 windows. Default: a synthetic random corpus")
    p.add_argument("--data-dtype", default="uint16", choices=["uint16", "int32"],
                   help="token id dtype of --data")
    p.add_argument("--resume", default=None,
                   help="checkpoint dir (its newest valid file) or file to resume")
    p.add_argument("--watchdog-secs", type=float, default=None,
                   help="step watchdog: a step exceeding this many seconds is declared "
                        "dead — the async checkpoint queue is drained and the process "
                        "exits with code 75 (EX_TEMPFAIL) so a supervisor restarts it")
    p.add_argument("--watchdog-compile-grace", type=float, default=600.0,
                   help="the FIRST step's watchdog allowance (the kernels' build and "
                        "the graph capture make it legitimately slow)")
    p.add_argument("--chaos-kill-at-step", type=int, default=None,
                   help="chaos: die hard (exit 137, no save, no drain) at this loop "
                        "step; rerunning the same command resumes")
    p.add_argument("--chaos-wedge-step", type=int, default=None,
                   help="chaos: wedge this loop step's dispatch for --chaos-wedge-secs "
                        "(pair with --watchdog-secs for the drain-and-exit path)")
    p.add_argument("--chaos-wedge-secs", type=float, default=120.0)
    p.add_argument("--metrics-dir", default=None,
                   help="observability sink dir: device-side StepStats telemetry "
                        "fetched asynchronously, windows in metrics.jsonl, a final "
                        "Prometheus snapshot in metrics.prom, goodput accounting in "
                        "goodput_*.json + goodput_report.json")
    p.add_argument("--telemetry-every", type=int, default=8,
                   help="StepStats fetch cadence (steps per window)")
    p.add_argument("--run-id", default="gpt",
                   help="correlation id stamped on structured logs, metrics points "
                        "and trace spans (join key is (run_id, step))")
    p.add_argument("--trace-dir", default=None,
                   help="host-side tracing + crash forensics: spans over the loop's "
                        "host phases, exported as trace_<run-id>_<pid>.json (Perfetto) "
                        "plus spans JSONL; a flight recorder dumps here on watchdog "
                        "wedge, StepGuard abort and preemption")
    p.add_argument("--trace-capacity", type=int, default=4096,
                   help="finished-span ring size (oldest dropped)")
    p.add_argument("--auto-resume", action="store_true",
                   help="preemption-safe mode (needs --checkpoint): resume from the "
                        "newest VALID checkpoint in the dir if one exists (torn files "
                        "are skipped) and install a SIGTERM hook that saves and "
                        "flushes before exiting; the same command line works for the "
                        "first launch and every restart.  Unlike the reference, kernel "
                        "failures are not degraded to a fallback: they raise")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu' for the "
                        "kernels' plain versions")
    p.add_argument("--eager", action="store_true",
                   help="run the step eagerly instead of as a captured CUDA graph")
    from apex_tpu_torch.resilience.supervisor import add_supervisor_args

    add_supervisor_args(p)
    return p


def make_config(args):
    from apex_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(
        vocab_size=args.vocab, hidden_size=args.hidden, num_layers=args.layers,
        num_attention_heads=args.heads, max_seq_len=args.seq,
        compute_dtype=torch.float16 if args.fp16 else torch.bfloat16,
        checkpoint_layers=True, remat_policy=args.remat_policy,
        sequence_parallel=args.sequence_parallel,
        position_embedding_type="rope" if args.rope else "learned",
        num_query_groups=args.num_query_groups, use_flash_attention=True,
        fused_ce=args.fused_ce,
        # largest divisor of seq <= 128, so the flag always engages
        fused_ce_chunk=next(c for c in range(min(128, args.seq), 0, -1) if args.seq % c == 0))


def load_corpus(args):
    """``(n, seq + 1)`` token rows: the ``--data`` memmap (only the rows a
    batch touches page in) or a random corpus from seed 0."""
    if args.data:
        raw = np.memmap(args.data, dtype=args.data_dtype, mode="r")
        n = len(raw) // (args.seq + 1)
        if n < args.global_batch:
            raise ValueError(
                f"--data holds {n} samples of seq+1={args.seq + 1} tokens; "
                f"need at least one global batch ({args.global_batch})")
        return raw[: n * (args.seq + 1)].reshape(n, args.seq + 1)
    return np.random.RandomState(0).randint(0, args.vocab, size=(4096, args.seq + 1))


def run(args):
    """The training loop; returns the report the JSON line prints.  The
    process group is started here unless one is up already, and torn
    down with the run when it was started here."""
    if args.supervise:
        raise ValueError("--supervise runs this command as a supervised child process: "
                         "call main(), not run()")
    if args.auto_resume and not args.checkpoint:
        raise SystemExit("--auto-resume needs --checkpoint (the dir it both resumes "
                         "from and saves into)")
    if args.telemetry_every < 1:
        raise SystemExit("--telemetry-every must be >= 1 (steps per StepStats fetch window)")
    if args.grad_sync_dtype and not args.zero:
        raise SystemExit("--grad-sync-dtype needs --zero: the quantized wire's error-feedback "
                         "residual lives in the ZeRO optimizer's sharded state")
    import torch.distributed as dist

    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    owns_group = not dist.is_initialized()
    dev = multiproc.initialize_distributed(args.device)
    try:
        if not ps.model_parallel_is_initialized():
            ps.initialize_model_parallel(tensor_model_parallel_size_=args.tp,
                                         pipeline_model_parallel_size_=args.pp)
        for flag, n, have in (("--tp", args.tp, ps.get_tensor_model_parallel_world_size()),
                              ("--pp", args.pp, ps.get_pipeline_model_parallel_world_size())):
            if n != have:
                raise ValueError(f"{flag} {n}, but the registered group has {have} ranks")
        return _train(args, dev, ps.get_data_parallel_group(),
                      ps.get_tensor_model_parallel_group(),
                      ps.get_pipeline_model_parallel_group())
    finally:
        if owns_group:
            multiproc.destroy_distributed()


def _train(args, dev, dp_group, tp_group, pp_group):
    """The loop of :func:`run` on ``dev``, data-parallel over
    ``dp_group``, tensor-parallel over ``tp_group`` and pipelined over
    ``pp_group``."""
    from apex_tpu_torch import io, observability as obs, resilience
    from apex_tpu_torch.amp import DynamicLossScaler
    from apex_tpu_torch.models.gpt import (
        _host_f32,
        _init_numpy,
        gather_params,
        make_pp_train_step,
        map_specs,
        param_specs,
        shard_params,
        train_state_from_numpy,
    )
    from apex_tpu_torch.observability import flightrec, goodput as gp, stepstats, tracing
    from apex_tpu_torch.observability.tracing import span
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map
    from apex_tpu_torch.resilience.elastic import top_of_step
    from apex_tpu_torch.train_gpt import make_train_step
    from apex_tpu_torch.transformer._data import MegatronPretrainingSampler

    cuda = dev.type == "cuda"
    if cuda:
        from apex_tpu_torch.ops import _build

        _build.load()  # the kernels build before anything runs
    import torch.distributed as dist

    dp, rank = dp_group.size(), dp_group.rank()
    tp, pp = tp_group.size(), pp_group.size()
    pipe = pp_group if pp > 1 else None
    lead = dist.get_rank() == 0

    def say(*a):
        """Rank 0 prints, as in the reference."""
        if lead:
            print(*a, flush=True)

    say(f"mesh: dp={dp} pp={pp} tp={tp} ({dp * pp * tp} devices)")
    if args.global_batch % dp:
        raise SystemExit(f"--global-batch {args.global_batch} does not split over dp={dp}")
    if args.sequence_parallel and args.seq % tp:
        raise SystemExit(f"--sequence-parallel: --seq {args.seq} does not split over tp={tp}")
    if pp > 1 and (args.global_batch // dp) % args.micro_batches:
        raise SystemExit(f"--global-batch {args.global_batch} over dp={dp} does not split into "
                         f"--micro-batches {args.micro_batches}")
    # only rank 0 writes the metrics and goodput files
    metrics_dir = args.metrics_dir if lead else None

    config = make_config(args)
    params = shard_params(_init_numpy(config, 0), config, tp_group, dev, keep_fp32=True,
                          pp_group=pipe)
    if args.zero:
        from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam

        optimizer = DistributedFusedAdam(lr=args.lr, weight_decay=WEIGHT_DECAY, axis_name="dp",
                                         grad_sync_dtype=args.grad_sync_dtype)
        # the JAX trainer's init: the specs of every model axis the params
        # split over, each rank's state its model segment's dp shard
        axis_sizes = {"tp": tp, **({"pp": pp} if pp > 1 else {})}
        state = optimizer.init(params, world_size=dp, param_specs=param_specs(config, pp > 1),
                               axis_sizes=axis_sizes)
    else:
        optimizer = FusedAdam(lr=args.lr, weight_decay=WEIGHT_DECAY)
        state = optimizer.init(params)
    # the model layout an elastic checkpoint must match (only dp is elastic)
    mesh_meta = {"tp": args.tp, "pp": args.pp}
    scaler = DynamicLossScaler(init_scale=FP16_INIT_SCALE) if args.fp16 else None
    scaler_state = scaler.init(dev) if scaler else None

    # Observability: the StepStats window rides the captured step and is
    # fetched asynchronously; even without --metrics-dir the loss print
    # goes through the async fetcher.
    obs.set_step_context(run_id=args.run_id, step=0)
    fetcher = stepstats.AsyncFetcher()
    # every rank runs the window: under tp or pp its norms are collectives
    telemetry = (stepstats.StepTelemetry() if (args.metrics_dir or args.trace_dir) else None)
    registry = obs.get_metrics()
    tracer = None
    if args.trace_dir:
        Path(args.trace_dir).mkdir(parents=True, exist_ok=True)
        tracer = tracing.configure(capacity=args.trace_capacity)
    flight_dir = flightrec.default_dir(metrics_dir=metrics_dir, trace_dir=args.trace_dir)
    recorder = None
    if flight_dir is not None:
        recorder = flightrec.install(flightrec.FlightRecorder(flight_dir, run_id=args.run_id))
        if tracer is not None:
            recorder.attach(tracer)
    anomaly = obs.AnomalyMonitor() if (metrics_dir or args.trace_dir) else None
    if metrics_dir:
        Path(metrics_dir).mkdir(parents=True, exist_ok=True)
    acct = obs.GoodputAccountant(metrics_dir, run_id=args.run_id) \
        if metrics_dir else None
    metrics_jsonl = Path(metrics_dir) / "metrics.jsonl" if metrics_dir else None

    #: wall time of the previous StepStats harvest (the window-level
    #: step-time series the anomaly detector watches)
    last_window_wall = [time.time(), 0]
    #: checkpoint-save seconds since the last drain, deducted from the
    #: window samples (a save is not step time)
    excluded_wall = [0.0]
    losses, scales = {}, {}

    def observe_window_span(at_step):
        """One anomaly sample per drain batch: wall time since the
        previous drain over the steps it covered."""
        now, prev_step = time.time(), last_window_wall[1]
        dt = now - last_window_wall[0] - excluded_wall[0]
        excluded_wall[0] = 0.0
        if anomaly is not None and at_step > prev_step > 0 and dt > 0:
            w_steps = at_step - prev_step
            anomaly.observe("step_time", dt / w_steps)
            anomaly.observe("tokens_per_sec",
                            w_steps * args.global_batch * args.seq / max(dt, 1e-9))
        last_window_wall[0], last_window_wall[1] = now, at_step

    def emit_harvested(kind, at_step, tree):
        """Print/record one harvested fetch (host numpy values)."""
        if kind == "loss":
            losses[at_step] = float(tree["loss"])
            extra = ""
            if "scale" in tree:
                scales[at_step] = float(tree["scale"])
                extra = f" scale={scales[at_step]:.0f}"
            say(f"step {at_step}: loss={losses[at_step]:.4f}{extra}")
            return
        s = stepstats.StepTelemetry.emit(registry, tree)
        if recorder is not None:
            recorder.record_stats(at_step, s)
            recorder.checkpoint()  # republish the rolling recording
        if metrics_jsonl is not None:
            registry.snapshot_jsonl(metrics_jsonl, window_end_step=at_step)
        if acct is not None:
            acct.heartbeat()
        say(f"telemetry[{at_step}]: loss_mean={s['loss_mean']:.4f} "
              f"grad_norm={s['grad_norm_last']:.3g} bad={s['bad_steps']}")

    corpus = load_corpus(args)
    start_step = 0

    def whole(tree_fn, st):
        """``st`` (a FusedAdam state) with ``tree_fn`` over its
        params-shaped fields."""
        return type(st)(step=st.step, exp_avg=tree_fn(st.exp_avg),
                        exp_avg_sq=tree_fn(st.exp_avg_sq),
                        master=None if st.master is None else tree_fn(st.master))

    def scaler_dict():
        """The scaler's state dict, cast on the device to the dtypes the
        reference's Python scalars take (float64, int64): no host read
        here, the snapshot copies."""
        if scaler is None:
            return None
        return {"loss_scale": scaler_state.loss_scale.to(torch.float64),
                "growth_tracker": scaler_state.growth_tracker.to(torch.int64),
                "hysteresis": scaler_state.hysteresis.to(torch.int64)}

    mesh_layout = {"tp": np.int64(tp), "pp": np.int64(pp)}
    split = tp > 1 or pp > 1

    def ckpt_tree(step_no):
        """The reference trainer's checkpoint tree.  Under --tp or --pp the
        params and moments are gathered whole (collectives: every rank
        calls them) and the tree gains the layout."""
        gather = lambda t: gather_params(t, config, tp_group, pipe)  # noqa: E731
        if not split or args.zero:
            # ZeRO: the state is each rank's shard; the params whole
            return {"params": gather(params) if split else params, "state": state,
                    "step": np.int64(step_no), "scaler": scaler_dict()}
        return {"params": gather(params), "state": whole(gather, state),
                "step": np.int64(step_no), "scaler": scaler_dict(), "mesh": mesh_layout}

    def whole_meta(t):
        """A params-shaped tree of this rank's slices as the whole tree's
        shapes (meta tensors)."""
        def one(a, spec):
            shape = list(a.shape)
            if spec.tp_dim is not None:
                shape[spec.tp_dim] *= tp
            if spec.pp_dim is not None:
                shape[spec.pp_dim] *= pp
            return torch.empty(shape, dtype=a.dtype, device="meta")

        return map_specs(one, t, config, pp=True)

    def ckpt_template(with_mesh):
        """The whole tree's structure and shapes (meta tensors), to load
        a file by."""
        tree = {"params": whole_meta(params), "state": whole(whole_meta, state),
                "step": np.int64(0), "scaler": scaler_dict()}
        return {**tree, "mesh": mesh_layout} if with_mesh else tree

    ckpt = io.AsyncCheckpointer() if args.checkpoint else None
    # --zero: elastic step_* directories, every rank its own shard
    run_ctl = (resilience.ElasticRunController(args.checkpoint, optimizer, world_size=dp,
                                               mesh_axes=mesh_meta, checkpointer=ckpt,
                                               keep=args.keep)
               if args.zero and args.checkpoint else None)

    # --resume points at a dir (or file) and fails loudly if nothing valid
    # is there; --auto-resume resumes from --checkpoint when it holds a
    # valid checkpoint and starts fresh otherwise
    t_restore = time.time()
    resume_dir = args.resume or (args.checkpoint if args.auto_resume else None)
    if resume_dir and args.zero:
        # elastic resume: a save at another world (or by the JAX
        # package) reshards; AllCheckpointsTornError (dirs exist, none
        # complete) stays loud even under --auto-resume
        restored = resilience.restore_elastic_checkpoint(
            resume_dir, optimizer=optimizer, world_size=dp, mesh_axes=mesh_meta,
            opt_state=state, params=whole_meta(params) if split else params,
            scaler_state=scaler_dict())
        if restored is None and args.resume:
            raise FileNotFoundError(f"no elastic checkpoint under {resume_dir}")
        if restored is not None:
            params = shard_params(tree_map(_host_f32, restored.params), config, tp_group, dev,
                                  keep_fp32=True, pp_group=pipe)
            state = restored.opt_state
            start_step = restored.step
            if scaler is not None:
                if restored.scaler is None:
                    raise ValueError(f"checkpoint in {resume_dir} has no loss-scaler state "
                                     "(saved by a run without --fp16)")
                scaler_state = scaler.load_state_dict(
                    {k: np.asarray(v).item() for k, v in restored.scaler.items()}, dev)
            msg = f"resumed at step {start_step}"
            if restored.resharded:
                msg += f" (elastic reshard: dp={restored.saved_world} -> dp={dp})"
            say(msg)
    elif resume_dir:
        if Path(resume_dir).is_file():
            io.validate_checkpoint(resume_dir)
            path = resume_dir
        else:
            try:
                # torn files are skipped; AllCheckpointsTornError (files
                # exist, none valid) stays loud even under --auto-resume
                path = io.latest_checkpoint(resume_dir)
            except io.AllCheckpointsTornError:
                raise
            except FileNotFoundError:
                if args.resume:
                    raise
                if any(Path(resume_dir).glob("step_*/index.json")):
                    raise ValueError(
                        f"{resume_dir} holds elastic step_* checkpoints (saved by a "
                        "--zero run); resume with --zero or point at a matching run's dir")
                path = None  # --auto-resume first launch: fresh start
        if path is not None:
            # the port's own files carry their layout; the JAX trainer's are
            # whole trees, sharded to this run's tp and pp
            saved = (tp, pp)
            if not io.written_by_jax(path):
                lazy = io.open_checkpoint_lazy(path)
                saved = ((int(lazy["mesh"]["tp"].load()), int(lazy["mesh"]["pp"].load()))
                         if "mesh" in lazy else (1, 1))
            if saved != (tp, pp):
                raise ValueError(f"{path} was saved at tp={saved[0]}, pp={saved[1]}; resuming "
                                 f"it at tp={tp}, pp={pp} is refused: {TP_LAYOUT_ITEM}")
            has_mesh = split and not io.written_by_jax(path)
            ck = io.load_checkpoint(path, template=ckpt_template(has_mesh))
            params, state, scaler_state, start_step = train_state_from_numpy(
                ck, config, dev, loss_scaler=scaler, axis_name=tp_group, pp_group=pipe)
            say(f"resumed at step {start_step}")
    if acct is not None and start_step:
        acct.add_segment("restore", time.time() - t_restore)
    if tracer is not None and resume_dir and start_step:
        tracer.emit("train.checkpoint_restore", t_restore, time.time() - t_restore,
                    resumed_step=start_step)

    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    stats = telemetry.init(dev) if telemetry is not None else None
    small = [] if scaler is None else [scaler_state]
    graphs = False if args.eager else None
    if pp > 1:
        built = make_pp_train_step(config, optimizer, args.micro_batches, loss_scaler=scaler,
                                   graphs=graphs, telemetry=telemetry, dp_group=dp_group,
                                   tp_group=tp_group)
    else:
        built = make_train_step(optimizer, config, loss_scaler=scaler, graphs=graphs,
                                telemetry=telemetry, dp_group=dp_group, tp_group=tp_group)
    step = tracing.TracedStep(built, name="train.step.dispatch")
    tracing.emit_sync_plan(optimizer)

    def epoch_cycling_batches(consumed):
        """Megatron sampling with epoch wrap: the sampler is single-epoch
        by design, so restart it from zero each time the corpus is
        exhausted."""
        consumed %= (len(corpus) // args.global_batch) * args.global_batch
        while True:
            yield from MegatronPretrainingSampler(
                total_samples=len(corpus), consumed_samples=consumed,
                micro_batch_size=args.global_batch // dp, data_parallel_rank=rank,
                data_parallel_size=dp)
            consumed = 0

    def assemble(idx):
        """One batch off the training thread: the native gather of the
        sampled rows, the ids checked (a bad id in --data fails loudly),
        tokens and targets as int64, pinned for an asynchronous copy."""
        batch = io.native.gather_rows(corpus, np.asarray(idx))
        if args.data:
            lo, hi = int(batch.min()), int(batch.max())
            if lo < 0 or hi >= args.vocab:
                raise ValueError(f"--data batch has token id {lo if lo < 0 else hi} "
                                 f"outside [0, vocab={args.vocab})")
        out = [torch.from_numpy(np.ascontiguousarray(batch[:, a:b], dtype=np.int64))
               for a, b in ((0, -1), (1, None))]
        return [t.pin_memory() for t in out] if cuda else out

    prefetch = io.PrefetchIterator(epoch_cycling_batches(start_step * args.global_batch),
                                   size=2, transform=assemble)

    # SIGTERM -> finish the current step, save, flush the queue, exit 0
    pre = resilience.PreemptionHandler().install() if args.auto_resume else None

    # the faults armed from the command line: a hard kill of rank 0, a
    # wedged step
    chaos = None
    if args.chaos_kill_at_step is not None or args.chaos_wedge_step is not None:
        chaos = resilience.ChaosMonkey(resilience.ChaosPlan.make(
            kill_at=({0: args.chaos_kill_at_step}
                     if args.chaos_kill_at_step is not None else None),
            wedge_step_at=args.chaos_wedge_step, wedge_step_seconds=args.chaos_wedge_secs))

    def on_wedge(info):
        """Watchdog pre-exit hook, each piece best-effort on its own: the
        forced step-time alert, a final metrics snapshot, the trace, and
        the goodput session stamped wedged."""
        for piece in (
                (lambda: (anomaly.wedge(info.get("elapsed_s"), step=info.get("step")),
                          anomaly.persist(metrics_dir or args.trace_dir)))
                if anomaly is not None else None,
                (lambda: registry.snapshot_jsonl(metrics_jsonl, wedged=True))
                if metrics_jsonl is not None else None,
                (lambda: tracing.export_run(args.trace_dir, args.run_id, tracer))
                if tracer is not None else None,
                (lambda: acct.finalize("wedge")) if acct is not None else None):
            if piece is None:
                continue
            try:
                piece()
            except Exception:  # noqa: BLE001 — one broken sink must not rob the others
                pass

    watchdog = None
    if args.watchdog_secs is not None:
        watchdog = resilience.StepWatchdog(
            args.watchdog_secs, checkpointer=ckpt, preemption=pre,
            first_deadline_sec=args.watchdog_compile_grace, on_wedge=on_wedge)
        watchdog.start()

    saves = []

    def save_at(step_no):
        t0 = time.time()
        try:
            with span("train.checkpoint_save", save_step=step_no):
                if acct is None:
                    _save_at(step_no)
                else:
                    with acct.attribute("checkpoint"):
                        _save_at(step_no)
        finally:
            excluded_wall[0] += time.time() - t0
            saves.append({"step": step_no, "block_ms": 1e3 * (time.time() - t0)})

    def _save_at(step_no):
        if run_ctl is not None:
            # --zero: this rank's shard of an elastic step_* directory
            tree = ckpt_tree(step_no)
            run_ctl.save(step_no, tree["params"], tree["state"], scaler_state=tree["scaler"])
            return
        tree = ckpt_tree(step_no)  # under --tp every rank joins the gathers
        if not lead:
            return  # a replicated state: rank 0's file holds it
        # step-named files (atomic publish) so a preempted restart picks
        # the newest VALID one; bounded disk: keep the newest
        # max(keep, 3), counting the saves still queued or writing among
        # them before they exist (the reference globs the disk alone, and
        # keeps a file too many for each write still pending)
        ckpt.save(Path(args.checkpoint) / f"step_{step_no:08d}.ckpt", tree)
        pending = {Path(f) for f in ckpt.in_flight()}
        files = sorted(set(Path(args.checkpoint).glob("step_*.ckpt")) | pending)
        for f in files[:-max(args.keep, 3)]:
            if f in pending:
                continue
            try:
                f.unlink()
            except OSError:
                pass

    window_steps = 0
    events = []
    if cuda:
        events.append(torch.cuda.Event(enable_timing=True))
        events[0].record()
    t0 = time.time()
    last_saved = None
    done = 0
    for i in range(start_step, start_step + args.steps):
        done = i - start_step + 1
        # a wedge sleeps past the watchdog's deadline; a kill exits 137
        top_of_step(i, watchdog, chaos, dist.get_rank(),
                    deadline=args.watchdog_compile_grace if i == start_step else None)
        obs.set_step_context(step=i)
        with span("train.data_wait"):
            tokens, targets = next(prefetch)
        tokens = tokens.to(dev, non_blocking=True)
        targets = targets.to(dev, non_blocking=True)
        loss = step(params, state, *small, *([stats] if stats is not None else []),
                    tokens, targets)
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        if stats is not None:
            window_steps += 1
        # the async seam: hand the device scalars to the fetcher and print
        # whatever earlier steps have landed — no blocking host read here
        push = {"loss": loss}
        if scaler is not None:
            push["scale"] = scaler_state.loss_scale
        fetcher.put("loss", i, push)
        if acct is not None:
            acct.step_done(tokens=args.global_batch * args.seq)
        if telemetry is not None and (i + 1 - start_step) % args.telemetry_every == 0:
            fetcher.put("stats", i + 1, stats)
            telemetry.reset(stats)  # after the copy, before the next step
            window_steps = 0
        harvested = fetcher.ready()
        if harvested:
            with span("train.telemetry_fetch", harvested=len(harvested)):
                for kind, at_step, tree in harvested:
                    emit_harvested(kind, at_step, tree)
                batch_stats = [s for k, s, _ in harvested if k == "stats"]
                if batch_stats:
                    observe_window_span(batch_stats[-1])
        if ckpt and (i + 1) % args.save_every == 0:
            save_at(i + 1)
            last_saved = i + 1
        if pre is not None and pre.preempted:
            if ckpt and last_saved != i + 1:
                save_at(i + 1)
            if ckpt:
                pre.drain(ckpt)  # every accepted save is durable
            say(f"preempted ({pre.reason}) after step {i}; rerun the same command "
                  f"to resume")
            break
    # final harvest: the tail window plus any loss lines still in flight
    # (blocking is correct here — the run is over); the watchdog still
    # watches, since the replays queued behind the host finish only now
    if telemetry is not None and window_steps > 0:
        fetcher.put("stats", start_step + done, stats)
    flushed = fetcher.flush()
    for kind, at_step, tree in flushed:
        emit_harvested(kind, at_step, tree)
    tail_stats = [s for k, s, _ in flushed if k == "stats"]
    if tail_stats:
        observe_window_span(tail_stats[-1])
    if cuda:
        torch.cuda.synchronize(dev)
    if watchdog is not None:
        watchdog.stop()  # the queue flush below may outlast a step deadline
    if ckpt:
        t_close = time.time()
        ckpt.close()
        if acct is not None:
            acct.add_segment("checkpoint", time.time() - t_close)
        say(f"checkpoint: {args.checkpoint}")
    if metrics_dir:
        (Path(metrics_dir) / "metrics.prom").write_text(registry.prometheus_text())
    if acct is not None:
        acct.finalize("preempted" if (pre is not None and pre.preempted) else "clean")
        # the whole model's params: each leaf's count times its splits
        whole = sum(tree_leaves(map_specs(
            lambda a, spec: a.numel() * (tp if spec.tp_dim is not None else 1)
            * (pp if spec.pp_dim is not None else 1), params, config, pp=True)))
        report = gp.goodput_report(
            metrics_dir, flops_per_token=gp.model_flops_per_token(
                whole, args.layers, args.seq, args.hidden))
        (Path(metrics_dir) / "goodput_report.json").write_text(json.dumps(report, indent=1))
        say("goodput: " + " ".join(f"{k}={v:.1%}"
                                   for k, v in sorted(report["fractions"].items())))
    if anomaly is not None:
        anomaly.persist(metrics_dir or args.trace_dir)
        counts = anomaly.counts()
        if counts:
            say("anomalies: " + " ".join(f"{k}={v}" for k, v in sorted(counts.items())))
    if tracer is not None:
        exp = tracing.export_run(args.trace_dir, args.run_id, tracer)
        say(f"trace: {args.trace_dir} ({exp['events']} events, {exp['dropped']} dropped)")
    # the process-wide hooks this run installed go with it
    if pre is not None:
        pre.uninstall()
    if recorder is not None:
        flightrec.uninstall()
    if tracer is not None:
        tracing.disable()
    dt = time.time() - t0
    steps = sorted(losses)
    return {
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "rank": dist.get_rank(), "dp": dp, "tp": tp, "pp": pp,
        "micro_batches": args.micro_batches if pp > 1 else None,
        "sequence_parallel": bool(args.sequence_parallel), "zero": bool(args.zero),
        "grad_sync_dtype": args.grad_sync_dtype,
        "graphs": not args.eager and cuda,
        "start_step": start_step, "steps_done": done,
        "preempted": bool(pre is not None and pre.preempted),
        "steps": steps, "losses": [losses[s] for s in steps],
        "loss_scales": [scales[s] for s in steps] if scaler is not None else None,
        # device time between consecutive steps' end events (the first
        # from the loop's start: warm-up and capture included)
        "step_ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])],
        "saves": saves,
        "writes": [] if ckpt is None else list(ckpt.writes),
        "wall_secs": dt,
        "tokens_per_sec": args.global_batch * args.seq * done / dt,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None,
    }


def main(argv=None):
    args = build_args().parse_args(argv)
    if args.supervise:
        # before anything touches the device: the child needs the card
        from apex_tpu_torch.resilience.supervisor import run_supervised_cli

        if args.checkpoint and not args.auto_resume:
            raise SystemExit("--supervise needs --auto-resume with --checkpoint: a "
                             "restarted child that does not resume would retrain from "
                             "step 0")
        return run_supervised_cli(args, None if argv is None else ["pretrain_gpt", *argv],
                                  module="apex_tpu_torch.pretrain_gpt")
    report = run(args)
    if report["rank"] == 0:
        print(json.dumps({"pretrain_gpt": report}), flush=True)
        print(f"{report['steps_done']} steps in {report['wall_secs']:.1f}s "
              f"({report['tokens_per_sec']:.0f} tokens/s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
