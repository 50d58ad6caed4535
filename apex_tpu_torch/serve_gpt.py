"""Serve GPT with continuous batching — the port's load generator.

Counterpart of ``examples/gpt/serve_gpt.py`` with the same defaults: a
GPT at the 124M width (12 layers, hidden 768, 12 heads, vocab 50304,
rope, bf16) with random weights from ``--seed``, 8 decode slots, 32
requests queued up front with prompts of 4..64 tokens and 32 new tokens
each, temperature 1.0.  Reports decode throughput (tokens/sec),
time-to-first-token and per-token latency percentiles as one JSON line.

    python -m apex_tpu_torch.serve_gpt                    # on the GPU
    python -m apex_tpu_torch.serve_gpt --device cpu \\
        --layers 2 --hidden 64 --heads 4 --vocab 128      # plain versions
    # serving v2: speculative decode + a shared system prompt + chunked
    # prefill + a preemptible best-effort lane, one command
    python -m apex_tpu_torch.serve_gpt --draft-len 4 --prefix-sharing \\
        --system-prompt-len 128 --prefill-chunk 64 --best-effort-frac 0.5

The serving-v2 flags and their defaults are those of
``examples/gpt/serve_gpt.py``; the report then adds
``accepted_tokens_per_step``, ``page_dedupe_ratio`` and time to first
token by lane.

Every step is compiled: captured as a CUDA graph on its first call and
replayed after (:mod:`apex_tpu_torch.graphs`), and the report says
``"graphs": true``.  ``--eager`` runs the plain steps instead, the
counterpart of ``JAX_DISABLE_JIT=1``.  The kernel library is built (or
found current) before the clock starts; the graphs are captured on the
clock, at each step's first call, as the reference compiles its steps,
and ``capture_ms`` reports the host time the captures took.

The reference driver's observability and resilience flags (the
scheduler's hooks, host code around the steps):

    python -m apex_tpu_torch.serve_gpt --metrics-dir /tmp/m --trace-dir /tmp/t
    #   serving gauges and latency histograms (with trace-id exemplars) in
    #   metrics[_<replica>].jsonl / .prom, per-request spans in a
    #   Perfetto trace, a flight recorder, per-lane anomaly counts
    python -m apex_tpu_torch.serve_gpt --watchdog-secs 10 \
        --chaos-wedge-decode-step 5 --chaos-wedge-secs 60
    #   a wedged decode step: the serve.step_wedged manifest (every
    #   queued and in-flight request), exit 75
    python -m apex_tpu_torch.serve_gpt --supervise --watchdog-secs 10
    #   the same command as a supervised child, restarted after exit 75

``--watchdog-compile-grace`` is the first step's allowance: in the port
it covers the kernels' build and the graph captures.  ``--supervise`` is
handled by :func:`main` before anything touches the device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.inference import (
    ContinuousBatchingScheduler, DecodeConfig, KVCacheConfig, Request,
)
from apex_tpu_torch.models.gpt import GPTConfig, gpt_forward, init_params

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--streams", type=int, default=8,
                   help="decode slots (max concurrent sequences)")
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--arrival-rate", type=float, default=0.0,
                   help="Poisson arrivals per second (0 = all queued up front)")
    p.add_argument("--prompt-len", type=int, default=64,
                   help="max prompt length (per-request lengths are uniform "
                        "in [4, prompt-len])")
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--hidden", type=int, default=768)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--kv-groups", type=int, default=None,
                   help="GQA query groups (None = MHA)")
    p.add_argument("--vocab", type=int, default=50304)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=None,
                   help="pool pages (default: streams x worst-case request + "
                        "1 garbage page)")
    p.add_argument("--kv-dtype", default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--compute-dtype", default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    # ---- serving v2 (all off by default: the plain engine) ----
    p.add_argument("--draft-len", type=int, default=0,
                   help="speculative decode: n-gram drafts of up to k tokens "
                        "verified per step in one pass (0 disables)")
    p.add_argument("--ngram-max", type=int, default=3,
                   help="longest prompt-lookup n-gram the drafter sweeps")
    p.add_argument("--ngram-min", type=int, default=1)
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="chunked prefill: admit prompts as C-token chunks "
                        "interleaved with decode steps (None = one padded "
                        "prefill, prompts capped at the prompt length)")
    p.add_argument("--prefix-sharing", action="store_true",
                   help="dedupe identical prompt-prefix pages through the "
                        "refcounted trie, copy-on-write on first divergence")
    p.add_argument("--system-prompt-len", type=int, default=0,
                   help="prepend one shared system prompt of this many tokens "
                        "to every request (0 = fully random prompts)")
    p.add_argument("--best-effort-frac", type=float, default=0.0,
                   help="fraction of requests submitted on the preemptible "
                        "best_effort lane (the rest are interactive)")
    p.add_argument("--eager", action="store_true",
                   help="run the steps eagerly instead of as captured CUDA graphs")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu' for "
                        "the kernels' plain versions")
    # ---- observability and resilience (the reference driver's flags) ----
    p.add_argument("--metrics-dir", default=None,
                   help="observability sink dir: the serving gauges and latency "
                        "histograms land in metrics.jsonl plus a Prometheus snapshot "
                        "metrics.prom")
    p.add_argument("--run-id", default="serve",
                   help="correlation id on metrics points and trace spans")
    p.add_argument("--replica-id", default=None,
                   help="this process's fleet replica id: suffixes the metrics files "
                        "(metrics_<id>.jsonl / .prom) and folds into --run-id, so "
                        "replicas share one --metrics-dir / --trace-dir")
    p.add_argument("--trace-dir", default=None,
                   help="per-request spans (admission wait, prefill chunks, decode and "
                        "verify steps with their accept counts), each with the "
                        "request's trace_id, exported as trace_<run-id>_<pid>.json; a "
                        "flight recorder dumps here on a wedged step")
    p.add_argument("--watchdog-secs", type=float, default=None,
                   help="serving step watchdog: a step exceeding this many seconds logs "
                        "the requeue manifest (serve.step_wedged), records "
                        "apex_serve_wedges_total and exits 75 for a supervisor")
    p.add_argument("--watchdog-compile-grace", type=float, default=600.0,
                   help="the FIRST step's watchdog allowance (the kernels' build and "
                        "the graph captures make it slow)")
    p.add_argument("--chaos-wedge-decode-step", type=int, default=None,
                   help="chaos: wedge the step after this many decode steps for "
                        "--chaos-wedge-secs (pair with --watchdog-secs)")
    p.add_argument("--chaos-wedge-secs", type=float, default=120.0)
    from apex_tpu_torch.resilience.supervisor import add_supervisor_args

    add_supervisor_args(p)
    return p


def make_requests(args, rng):
    """The requests of ``examples/gpt/serve_gpt.py``, drawn from ``rng`` in
    its order: the shared system prompt, then per request its length,
    its tokens and its lane."""
    reqs, arrivals = [], []
    t = 0.0
    sysp = (rng.randint(0, args.vocab, size=args.system_prompt_len).tolist()
            if args.system_prompt_len > 0 else [])
    for rid in range(args.requests):
        lo = min(4, args.prompt_len)
        plen = int(rng.randint(lo, args.prompt_len + 1))
        prompt = sysp + rng.randint(0, args.vocab, size=plen).tolist()
        lane = "best_effort" if rng.uniform() < args.best_effort_frac else "interactive"
        reqs.append(Request(rid=rid, prompt=prompt, max_new_tokens=args.max_new,
                            lane=lane))
        if args.arrival_rate > 0:
            t += float(rng.exponential(1.0 / args.arrival_rate))
        arrivals.append(t)
    return reqs, arrivals


def serve(sched, reqs, arrivals):
    """Submit on (wall-clock) arrival, step until drained."""
    t0 = time.monotonic()
    pending = list(zip(arrivals, reqs))
    while pending or not sched.idle():
        now = time.monotonic() - t0
        while pending and pending[0][0] <= now:
            sched.submit(pending[0][1])
            pending.pop(0)
        if not sched.step() and pending:
            time.sleep(min(0.01, max(0.0, pending[0][0] - now)))
    return sched.completed


def report(completions, wall_secs):
    per_token, ttft = [], []
    lane_ttft = {}
    n_tokens = 0
    for c in completions:
        n_tokens += len(c.tokens)
        t = c.token_times[0] - c.submit_time
        ttft.append(t)
        lane_ttft.setdefault(c.lane, []).append(t)
        per_token.extend(np.diff(c.token_times))
    out = {
        "requests": len(completions),
        "generated_tokens": n_tokens,
        "wall_secs": round(wall_secs, 3),
        "tokens_per_sec": round(n_tokens / max(wall_secs, 1e-9), 2),
        "ttft_p50_ms": round(1e3 * float(np.percentile(ttft, 50)), 2),
        "ttft_p99_ms": round(1e3 * float(np.percentile(ttft, 99)), 2),
    }
    if len(lane_ttft) > 1:  # mixed lanes: time to first token by lane
        out["lanes"] = {
            lane: {"requests": len(ts),
                   "ttft_p50_ms": round(1e3 * float(np.percentile(ts, 50)), 2),
                   "ttft_p99_ms": round(1e3 * float(np.percentile(ts, 99)), 2)}
            for lane, ts in sorted(lane_ttft.items())}
    if per_token:
        out["per_token_p50_ms"] = round(1e3 * float(np.percentile(per_token, 50)), 2)
        out["per_token_p99_ms"] = round(1e3 * float(np.percentile(per_token, 99)), 2)
    return out


@torch.inference_mode()
def check_greedy_parity(params, config, completions, max_check=3):
    """Every generated token must be the full forward's argmax
    continuation (greedy serving only)."""
    for c in completions[:max_check]:
        seq = list(c.prompt)
        for tok in c.tokens:
            logits = gpt_forward(params, [seq], config)
            pred = int(torch.argmax(logits[len(seq) - 1, 0]))
            if pred != tok:
                raise AssertionError(
                    f"rid={c.rid}: decode produced {tok} where the full "
                    f"forward's greedy continuation is {pred} at position "
                    f"{len(seq)}")
            seq.append(tok)


def setup(args):
    """``(config, params, dcfg)`` for ``args``."""
    device = resolve_device(args.device)
    total_prompt = args.system_prompt_len + args.prompt_len
    config = GPTConfig(
        vocab_size=args.vocab, hidden_size=args.hidden,
        num_layers=args.layers, num_attention_heads=args.heads,
        num_query_groups=args.kv_groups,
        max_seq_len=max(total_prompt + args.max_new + args.draft_len + 1, 64),
        position_embedding_type="rope",
        compute_dtype=_DTYPES[args.compute_dtype],
        checkpoint_layers=False,
    )
    params = init_params(config, args.seed, device=device)
    # worst case: the full prompt, the generation budget and the
    # speculative write window (draft k/v land past the accepted stream)
    pages_per_seq = -(-(total_prompt + args.max_new + args.draft_len) // args.page_size)
    num_pages = args.num_pages or 1 + args.streams * pages_per_seq
    dcfg = DecodeConfig(
        cache=KVCacheConfig(num_pages=num_pages, page_size=args.page_size,
                            pages_per_seq=pages_per_seq,
                            dtype=_DTYPES[args.kv_dtype]),
        max_batch=args.streams, max_prompt_len=total_prompt,
        temperature=args.temperature, top_k=args.top_k, base_seed=args.seed,
        draft_len=args.draft_len, ngram_max=args.ngram_max, ngram_min=args.ngram_min,
        prefill_chunk=args.prefill_chunk, prefix_sharing=args.prefix_sharing,
    )
    return config, params, dcfg


def run(args):
    """Serve ``args.requests`` requests; returns ``(report, scheduler,
    params, config)``.  The hooks this run installs (tracer, flight
    recorder, watchdog, chaos plan) go with it."""
    from apex_tpu_torch.observability import AnomalyMonitor, flightrec, tracing
    from apex_tpu_torch.observability import get_metrics, set_step_context
    from apex_tpu_torch.resilience import ChaosMonkey, ChaosPlan, StepWatchdog

    if args.supervise:
        raise ValueError("--supervise runs this command as a supervised child process: "
                         "call main(), not run()")
    config, params, dcfg = setup(args)
    rep_sfx = f"_{args.replica_id}" if args.replica_id else ""
    run_id = f"{args.run_id}_{args.replica_id}" if args.replica_id else args.run_id
    set_step_context(run_id=run_id, step=0)
    registry = get_metrics()  # where the scheduler's gauges and histograms land
    tracer = None
    if args.trace_dir:
        Path(args.trace_dir).mkdir(parents=True, exist_ok=True)
        tracer = tracing.configure()
    flight_dir = flightrec.default_dir(metrics_dir=args.metrics_dir, trace_dir=args.trace_dir)
    recorder = None
    if flight_dir is not None:
        recorder = flightrec.install(flightrec.FlightRecorder(flight_dir, run_id=run_id))
        if tracer is not None:
            recorder.attach(tracer)
    anomaly = AnomalyMonitor() if (args.metrics_dir or args.trace_dir) else None
    # a wedged step logs the requeue manifest and exits 75 (no
    # checkpointer to drain: a server's state is its requests)
    watchdog = None
    if args.watchdog_secs is not None:
        watchdog = StepWatchdog(args.watchdog_secs,
                                first_deadline_sec=args.watchdog_compile_grace)
    monkey = None
    if args.chaos_wedge_decode_step is not None:
        monkey = ChaosMonkey(ChaosPlan.make(wedge_step_at=args.chaos_wedge_decode_step,
                                            wedge_step_seconds=args.chaos_wedge_secs))
    try:
        sched = ContinuousBatchingScheduler(params, config, dcfg, device=args.device,
                                            graphs=False if args.eager else None,
                                            watchdog=watchdog, anomaly=anomaly,
                                            metrics=bool(args.metrics_dir))
        if sched.device.type == "cuda":
            from apex_tpu_torch.ops import _build

            _build.load()  # set-up: build or load the kernels before the clock
        reqs, arrivals = make_requests(args, np.random.RandomState(args.seed))
        if watchdog is not None:
            watchdog.start()
        t0 = time.monotonic()
        if monkey is not None:
            with monkey.active():
                completions = serve(sched, reqs, arrivals)
        else:
            completions = serve(sched, reqs, arrivals)
        wall = time.monotonic() - t0
    finally:
        if watchdog is not None:
            watchdog.stop()
        if recorder is not None:
            flightrec.uninstall()
        if tracer is not None:
            tracing.disable()
    out = report(completions, wall)
    out["graphs"] = sched.device.type == "cuda" and not args.eager
    out["capture_ms"] = round(1e3 * sched.capture_seconds, 2)
    out["stats"] = dict(sched.stats)
    if args.draft_len > 0:
        out["accepted_tokens_per_step"] = round(
            sched.stats["spec_emitted"] / max(sched.stats["spec_steps"], 1), 3)
    if args.prefix_sharing:
        full_per = args.system_prompt_len // args.page_size
        out["page_dedupe_ratio"] = round(
            sched.stats["shared_full_pages"] / max(len(completions) * full_per, 1), 3)
    if args.metrics_dir:
        mdir = Path(args.metrics_dir)
        mdir.mkdir(parents=True, exist_ok=True)
        registry.snapshot_jsonl(mdir / f"metrics{rep_sfx}.jsonl")
        (mdir / f"metrics{rep_sfx}.prom").write_text(registry.prometheus_text())
        out["metrics_dir"] = str(mdir)
    if anomaly is not None:
        anomaly.persist(args.metrics_dir or args.trace_dir)
        out["anomaly"] = {"counts": anomaly.counts(), "by_lane": anomaly.counts_by("lane")}
    if tracer is not None:
        out["trace_file"] = tracing.export_run(args.trace_dir, run_id, tracer)["chrome"]
    return out, sched, params, config


def main(argv=None):
    args = build_args().parse_args(argv)
    if args.supervise:
        # the trainer's supervisor, with no checkpoint dir: a serving
        # restart is stateless (the wedge manifest in the log is what a
        # frontend replays)
        from apex_tpu_torch.resilience.supervisor import run_supervised_cli

        return run_supervised_cli(args, None if argv is None else ["serve_gpt", *argv],
                                  module="apex_tpu_torch.serve_gpt", checkpoint_dir=None)
    out = run(args)[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
