"""T5 (encoder-decoder) pretraining on a synthetic copy task over tp x pp
x dp: the port's twin of ``examples/t5/pretrain_t5.py``.

The pipeline carries two activation streams (encoder stages before the
split rank, decoder stages and the forwarded encoder output from it on)
through the encoder/decoder 1F1B schedule
(:func:`apex_tpu_torch.models.t5.make_pp_train_step`); without a
pipeline the step is :func:`~apex_tpu_torch.models.t5.make_train_step`.
The decoder must reproduce the source (its input is ``<bos>`` and the
source shifted right), so the loss falls within a few steps.

    python -m apex_tpu_torch.pretrain_t5 --device cpu --steps 6
    torchrun --nproc-per-node 4 -m apex_tpu_torch.pretrain_t5 --pp 4 --split 2 --steps 4
    #   four ranks (NCCL, one card each; gloo with --device cpu); flags
    #   compose: --tp 2, --fp16 (dynamic loss scaling through the
    #   pipeline), --fused-ce (the fused LM-head CE kernels)

The flags and defaults are the JAX driver's, with ``--device`` added;
so are the printed lines (``step N: loss=X``, ``N steps in Xs (T
tokens/s)``, rank 0).  The world is the ``torchrun`` ranks (one rank
without it), laid out (dp, pp, tp) with tp innermost: dp = world / (tp
x pp).  ``--split`` defaults to ``max(pp // 2, 1)``.  The batches are a
pool of 4 drawn from ``np.random.RandomState(0)``, cycled, as the JAX
driver draws them; the params are drawn from a ``torch.Generator``
seeded 0.  The step is compiled (one CUDA graph) on CUDA.
"""

import argparse
import time

import numpy as np
import torch

__all__ = ["parse_args", "make_batch", "run", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--split", type=int, default=None,
                   help="pipeline rank where encoder hands to decoder (default pp//2)")
    p.add_argument("--micro-batches", type=int, default=2)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--enc-layers", type=int, default=2)
    p.add_argument("--dec-layers", type=int, default=2)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--fp16", action="store_true",
                   help="dynamic loss scaling through the pipeline")
    p.add_argument("--fused-ce", action="store_true",
                   help="the fused LM-head CE kernels (ops/fused_ce.py)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    return p.parse_args(argv)


def make_batch(rng, batch, seq, vocab):
    """Copy task: the decoder's input is <bos> + src[:-1], the target src."""
    src = rng.randint(2, vocab, size=(batch, seq))
    dec_in = np.concatenate([np.ones((batch, 1), src.dtype), src[:, :-1]], 1)
    return src, dec_in, src


def run(args):
    """Train ``args.steps`` steps; returns the report (losses, seconds,
    tokens/s).  Starts the process group unless one is up, and tears down
    what it started."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import multiproc

    owns_group = not dist.is_initialized()
    dev = multiproc.initialize_distributed(args.device)
    try:
        return _train(args, dev)
    finally:
        if owns_group:
            multiproc.destroy_distributed()


def _train(args, dev):
    import torch.distributed as dist

    from apex_tpu_torch.models.t5 import (
        T5Config,
        _init_numpy,
        make_pp_train_step,
        make_train_step,
        params_to_pp_layout,
        shard_params,
    )
    from apex_tpu_torch.observability.stepstats import AsyncFetcher
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer import parallel_state as ps

    world = dist.get_world_size()
    dp = world // (args.tp * args.pp)
    assert dp >= 1 and dp * args.tp * args.pp == world, (
        f"tp({args.tp}) x pp({args.pp}) must divide device count {world}")
    split = args.split if args.split is not None else max(args.pp // 2, 1)
    ps.initialize_model_parallel(tensor_model_parallel_size_=args.tp,
                                 pipeline_model_parallel_size_=args.pp,
                                 pipeline_model_parallel_split_rank_=split if args.pp > 1
                                 else None)
    tp_group = ps.get_tensor_model_parallel_group()
    pp_group = ps.get_pipeline_model_parallel_group()
    dp_group = ps.get_data_parallel_group()

    config = T5Config(
        vocab_size=args.vocab, hidden_size=args.hidden,
        num_encoder_layers=args.enc_layers, num_decoder_layers=args.dec_layers,
        num_attention_heads=args.heads, max_src_len=args.seq, max_tgt_len=args.seq,
        compute_dtype=torch.float16 if args.fp16 else torch.bfloat16,
        checkpoint_layers=True, fused_ce=args.fused_ce,
        fused_ce_chunk=next(c for c in range(min(128, args.seq), 0, -1) if args.seq % c == 0))
    tree = _init_numpy(config, torch.Generator().manual_seed(0))
    opt = FusedAdam(lr=args.lr)

    scaler = small = None
    if args.fp16:
        from apex_tpu_torch.amp import DynamicLossScaler

        scaler = DynamicLossScaler(init_scale=2.0 ** 15)
        small = scaler.init(dev)

    if args.pp > 1:
        params = shard_params(params_to_pp_layout(tree, args.pp, split), config, tp_group, dev,
                              pp_group)
        state = opt.init(params)
        step = make_pp_train_step(config, opt, args.micro_batches, split, loss_scaler=scaler,
                                  dp_group=dp_group, tp_group=tp_group, pp_group=pp_group)
    else:
        params = shard_params(tree, config, tp_group, dev)
        state = opt.init(params)
        step = make_train_step(config, opt, tp_group=tp_group, dp_group=dp_group)
        assert scaler is None, "--fp16 demo path requires --pp > 1"

    # a small fixed pool of batches: a fresh random batch a step keeps the
    # copy task at uniform-entropy loss for tens of steps at this size;
    # cycling a pool makes the loss fall visibly within one epoch
    rng = np.random.RandomState(0)
    pool = [make_batch(rng, args.global_batch, args.seq, args.vocab) for _ in range(4)]
    rows = args.global_batch // dp
    mine = slice(dp_group.rank() * rows, (dp_group.rank() + 1) * rows)
    pool = [tuple(torch.from_numpy(np.ascontiguousarray(a[mine])).to(dev) for a in batch)
            for batch in pool]
    rank0 = dist.get_rank() == 0
    fetcher = AsyncFetcher()
    losses = []

    def emit(harvested):
        for _, s, t in harvested:
            losses.append(float(t["loss"]))
            if rank0:
                print(f"step {s}: loss={losses[-1]:.4f}", flush=True)

    t0 = time.time()
    for i in range(args.steps):
        batch = pool[i % len(pool)]
        loss = step(params, state, small, *batch) if scaler is not None else \
            step(params, state, *batch)
        # a captured step's loss is its static output: copy it before the
        # next replay writes it
        fetcher.put("loss", i, {"loss": loss.clone()})
        emit(fetcher.ready())
    emit(fetcher.flush())
    dt = time.time() - t0
    tok = args.steps * args.global_batch * args.seq
    if rank0:
        print(f"{args.steps} steps in {dt:.1f}s ({tok / dt:.0f} tokens/s)", flush=True)
    return {"losses": losses, "seconds": dt, "tokens_per_sec": tok / dt, "dp": dp,
            "tp": args.tp, "pp": args.pp, "split": split if args.pp > 1 else None,
            "loss_scale": float(small.loss_scale) if small is not None else None}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
