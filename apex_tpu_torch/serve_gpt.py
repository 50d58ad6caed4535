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

The kernel library is built (or found current) before the clock starts.
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
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu' for "
                        "the kernels' plain versions")
    return p


def make_requests(args, rng):
    reqs, arrivals = [], []
    t = 0.0
    for rid in range(args.requests):
        lo = min(4, args.prompt_len)
        plen = int(rng.randint(lo, args.prompt_len + 1))
        prompt = rng.randint(0, args.vocab, size=plen).tolist()
        reqs.append(Request(rid=rid, prompt=prompt, max_new_tokens=args.max_new))
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
    n_tokens = 0
    for c in completions:
        n_tokens += len(c.tokens)
        ttft.append(c.token_times[0] - c.submit_time)
        per_token.extend(np.diff(c.token_times))
    out = {
        "requests": len(completions),
        "generated_tokens": n_tokens,
        "wall_secs": round(wall_secs, 3),
        "tokens_per_sec": round(n_tokens / max(wall_secs, 1e-9), 2),
        "ttft_p50_ms": round(1e3 * float(np.percentile(ttft, 50)), 2),
        "ttft_p99_ms": round(1e3 * float(np.percentile(ttft, 99)), 2),
    }
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
    config = GPTConfig(
        vocab_size=args.vocab, hidden_size=args.hidden,
        num_layers=args.layers, num_attention_heads=args.heads,
        num_query_groups=args.kv_groups,
        max_seq_len=max(args.prompt_len + args.max_new + 1, 64),
        position_embedding_type="rope",
        compute_dtype=_DTYPES[args.compute_dtype],
        checkpoint_layers=False,
    )
    params = init_params(config, args.seed, device=device)
    pages_per_seq = -(-(args.prompt_len + args.max_new) // args.page_size)
    num_pages = args.num_pages or 1 + args.streams * pages_per_seq
    dcfg = DecodeConfig(
        cache=KVCacheConfig(num_pages=num_pages, page_size=args.page_size,
                            pages_per_seq=pages_per_seq,
                            dtype=_DTYPES[args.kv_dtype]),
        max_batch=args.streams, max_prompt_len=args.prompt_len,
        temperature=args.temperature, top_k=args.top_k, base_seed=args.seed,
    )
    return config, params, dcfg


def run(args):
    """Serve ``args.requests`` requests; returns ``(report, scheduler,
    params, config)``."""
    config, params, dcfg = setup(args)
    sched = ContinuousBatchingScheduler(params, config, dcfg, device=args.device)
    if sched.device.type == "cuda":
        from apex_tpu_torch.ops import _build

        _build.load()  # set-up: build or load the kernels before the clock
    reqs, arrivals = make_requests(args, np.random.RandomState(args.seed))
    t0 = time.monotonic()
    completions = serve(sched, reqs, arrivals)
    wall = time.monotonic() - t0
    out = report(completions, wall)
    out["stats"] = dict(sched.stats)
    return out, sched, params, config


def main(argv=None):
    out = run(build_args().parse_args(argv))[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
