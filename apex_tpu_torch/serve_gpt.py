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
"""

import argparse
import json
import sys
import time

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
    params, config)``."""
    config, params, dcfg = setup(args)
    sched = ContinuousBatchingScheduler(params, config, dcfg, device=args.device,
                                        graphs=False if args.eager else None)
    if sched.device.type == "cuda":
        from apex_tpu_torch.ops import _build

        _build.load()  # set-up: build or load the kernels before the clock
    reqs, arrivals = make_requests(args, np.random.RandomState(args.seed))
    t0 = time.monotonic()
    completions = serve(sched, reqs, arrivals)
    wall = time.monotonic() - t0
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
    return out, sched, params, config


def main(argv=None):
    out = run(build_args().parse_args(argv))[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
