"""Train GPT on one device -- the port's training-step entry point.

Counterpart of the step ``bench.py`` times (``_bench_gpt_at_batch``,
bench.py:401-440) with its headline shape as the defaults: GPT-124M
(12 layers, hidden 768, 12 heads, vocab 50304, learned positions), seq
1024, batch 8, bf16 compute, flash attention, full layer remat, the
dense fp32 LM head (``fused_ce=False``); each step is the loss and its
gradients followed by ``FusedAdam(lr=3e-4, weight_decay=0.1).update``.
``--fused-ce`` takes the fused LM-head CE instead (``fused_ce=True``,
``fused_ce_chunk=128``: bench.py's ``gpt124_s1024_fce`` A/B section,
bench.py:2166-2189).  As in the JAX package, a ``--seq`` that
``--fused-ce-chunk`` does not divide takes the dense head.
Weights are random from ``--seed`` (numpy); tokens are
``np.random.RandomState(seed).randint(0, vocab, (batch, seq))`` with
targets rolled by one, the same batch every step.

    python -m apex_tpu_torch.train_gpt                    # on the GPU
    python -m apex_tpu_torch.train_gpt --device cpu --layers 2 --hidden 64 \\
        --heads 4 --vocab 128 --seq 32 --batch 2          # plain versions
    python -m apex_tpu_torch.train_gpt --fused-ce         # the fused CE head
    python -m apex_tpu_torch.train_gpt --fused-ce --fused-ce-chunk 8 --device cpu \
        --layers 2 --hidden 64 --heads 4 --vocab 128 --seq 32 --batch 2

Prints one JSON line: the loss of every step, the median step time
(host clock around a synchronized step), tokens/s and peak device
memory.  The kernel library is built before the clock starts, and the
``--warmup`` steps are not timed.
"""

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models.gpt import GPTConfig, gpt_loss, init_params, params_from_numpy
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers.base import tree_leaves, tree_unflatten

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: bench.py's FusedAdam weight decay
WEIGHT_DECAY = 0.1


def build_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--hidden", type=int, default=768)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--vocab", type=int, default=50304)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=5, help="timed steps")
    p.add_argument("--warmup", type=int, default=1, help="untimed steps first")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--compute-dtype", default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fused-ce", action="store_true",
                   help="the fused LM-head cross entropy (bench.py's gpt124_s1024_fce) "
                        "in place of the dense head")
    p.add_argument("--fused-ce-chunk", type=int, default=128,
                   help="with --fused-ce: sequence positions per chunk; the fused "
                        "head runs only when --seq is a multiple (bench.py: 128)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu' for "
                        "the kernels' plain versions")
    return p


def make_config(args) -> GPTConfig:
    """bench.py's ``GPTConfig`` for this shape."""
    return GPTConfig(
        vocab_size=args.vocab, hidden_size=args.hidden, num_layers=args.layers,
        num_attention_heads=args.heads, max_seq_len=args.seq,
        compute_dtype=_DTYPES[args.compute_dtype], use_flash_attention=True,
        checkpoint_layers=True, remat_policy="full", fused_ce=args.fused_ce,
        fused_ce_chunk=args.fused_ce_chunk)


def make_batch(args):
    """``(tokens, targets)`` (B, S) int64 numpy, as bench.py draws them."""
    tokens = np.random.RandomState(args.seed).randint(0, args.vocab,
                                                      size=(args.batch, args.seq))
    return tokens, np.roll(tokens, -1, axis=1)


def setup(args, params_tree=None):
    """``(config, params, tokens, targets)`` on ``args.device``: fp32
    params (``params_tree``, a numpy tree of the JAX package's layout,
    or random from ``args.seed``) and the batch."""
    dev = resolve_device(args.device)
    config = make_config(args)
    if params_tree is None:
        params = init_params(config, args.seed, dev, keep_fp32=True)
    else:
        params = params_from_numpy(params_tree, config, dev, keep_fp32=True)
    tokens, targets = make_batch(args)
    return config, params, torch.from_numpy(tokens).to(dev), torch.from_numpy(targets).to(dev)


def loss_and_grads(params, tokens, targets, config):
    """``value_and_grad(gpt_loss)``: the loss and a tree of gradients
    shaped like ``params``."""
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = gpt_loss(params, tokens, targets, config)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, grads)


def train_step(params, state, opt, tokens, targets, config):
    loss, grads = loss_and_grads(params, tokens, targets, config)
    params, state = opt.update(grads, state, params)
    return params, state, loss


def run(args, params_tree=None):
    """Train ``args.warmup + args.steps`` steps; returns ``(report,
    params, state)``."""
    config, params, tokens, targets = setup(args, params_tree)
    dev = tokens.device
    cuda = dev.type == "cuda"
    if cuda:
        from apex_tpu_torch.ops import _build

        _build.load()
        torch.cuda.reset_peak_memory_stats(dev)
    opt = FusedAdam(lr=args.lr, weight_decay=WEIGHT_DECAY)
    state = opt.init(params)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    losses, times = [], []
    for i in range(args.warmup + args.steps):
        sync()
        t0 = time.perf_counter()
        params, state, loss = train_step(params, state, opt, tokens, targets, config)
        sync()
        if i >= args.warmup:
            times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    step_s = statistics.median(times) if times else None
    report = {
        "model": {"layers": args.layers, "hidden": args.hidden, "heads": args.heads,
                  "vocab": args.vocab, "seq": args.seq, "batch": args.batch,
                  "compute_dtype": args.compute_dtype, "fused_ce": args.fused_ce,
                  "fused_ce_chunk": args.fused_ce_chunk},
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "warmup_steps": args.warmup,
        "losses": losses,
        "step_ms": [1e3 * t for t in times],
        "step_ms_median": None if step_s is None else 1e3 * step_s,
        "tokens_per_sec": None if step_s is None else args.batch * args.seq / step_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None,
    }
    return report, params, state


def main(argv=None):
    args = build_args().parse_args(argv)
    report = run(args)[0]
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
