"""ImageNet trainer: ResNet-50 under amp O2 -- the port's twin of
``examples/imagenet/main_amp.py`` (the reference's canonical end-to-end
example): bf16 convolutions with fp32 batch norms and fp32 master
weights (``amp.initialize(params, "O2")``), ``FusedSGD(master_weights=
True)``, data parallelism with SyncBN over the dp group, and a
checkpoint with resume.

    python -m apex_tpu_torch.imagenet_main_amp --steps 20 --batch-size 64
    python -m apex_tpu_torch.imagenet_main_amp --device cpu --small --steps 2 \\
        --batch-size 4 --image-size 32 --checkpoint /tmp/ck.pt   # then --resume /tmp/ck.pt
    torchrun --nproc-per-node 2 -m apex_tpu_torch.imagenet_main_amp --dp 2
    #   two ranks (NCCL, one card each; gloo with --device cpu): each takes
    #   --batch-size / 2 rows of every global batch, the batch norms'
    #   statistics span both, the grads are all-reduced

The flags and the printed lines (``step N: loss X``, ``throughput: ...
images/sec``) are the JAX driver's, with ``--device`` added.  The
batches are synthetic, drawn from ``np.random.default_rng(0)`` as the
JAX driver draws them (one batch for the init, then one a step);
a resumed run first draws the batches of the steps it skips, so its
losses are those of the run it continues.  The step
(:func:`make_train_step`) is the loss, its gradients, the dp all-reduce
and the optimizer's in-place update, captured as one CUDA graph on
CUDA.  ``--dp`` must equal the ``torchrun`` world; without
``torchrun`` the run is a one-rank group.  The checkpoint is one file
written atomically (``io.native.atomic_output``): the params, the
optimizer state, the running statistics, the step and the amp state.
"""

import argparse
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["build_args", "synthetic_batch", "loss_and_grads", "make_train_step", "run",
           "main"]

NUM_CLASSES = 1000


def build_args():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=32, help="global batch")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--opt-level", default="O2")
    p.add_argument("--dp", type=int, default=1, help="data-parallel ways (the torchrun world)")
    p.add_argument("--small", action="store_true", help="tiny model (CI)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    return p


def synthetic_batch(rng, batch, size, num_classes=NUM_CLASSES):
    """One (x (batch, size, size, 3) fp32 NHWC, y (batch,) int64) numpy
    batch, drawn as the JAX driver draws it."""
    x = rng.standard_normal((batch, size, size, 3), dtype=np.float32)
    y = rng.integers(0, num_classes, size=(batch,))
    return x, y


def loss_and_grads(model, params, batch_stats, x, y):
    """The mean one-hot cross entropy of the model's logits and its
    gradients (a tree shaped like ``params``, in the params' dtypes), the
    running statistics written into ``batch_stats``."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        logits, _ = model.apply(params, batch_stats, x, train=True, inplace=True)
        onehot = F.one_hot(y.long(), logits.shape[-1]).to(logits.dtype)
        loss = -torch.mean(torch.sum(onehot * F.log_softmax(logits, dim=-1), dim=-1))
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(model, opt, dp_group=None, graphs=None):
    """``step(params, opt_state, batch_stats, x, y) -> loss``: the JAX
    driver's ``local_step``: :func:`loss_and_grads`, with a ``dp_group``
    of more than one rank the grads all-reduced (``allreduce_gradients``,
    the mean) and the loss averaged over it, then ``opt.update(...,
    inplace=True)``.  The params, optimizer state and running statistics
    are updated in place (the donated buffers of the JAX step).  Compiled
    unless ``graphs=False``: a :class:`~apex_tpu_torch.graphs.CapturedStep`
    (one eager step, then one CUDA graph replayed; on the CPU the
    static buffers run without capture)."""
    from apex_tpu_torch.graphs import CapturedStep
    from apex_tpu_torch.parallel import allreduce_gradients

    dp = dp_group is not None and dp_group.size() > 1

    def step(params, opt_state, batch_stats, x, y):
        loss, grads = loss_and_grads(model, params, batch_stats, x, y)
        if dp:
            import torch.distributed as dist

            grads = allreduce_gradients(grads, dp_group)
            loss = loss.clone()
            dist.all_reduce(loss, group=dp_group.group)
            loss = loss / dp_group.size()
        opt.update(grads, opt_state, params, inplace=True)
        return loss

    if graphs is False:
        return step
    return CapturedStep(step, donate=(0, 1, 2))


def _to_host(tree):
    return tree_map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t, tree)


def save_checkpoint(path, params, opt_state, batch_stats, step, amp_state):
    """One atomic file: ``{"params", "opt_state", "batch_stats", "step",
    "amp"}`` (the optimizer state as a dict of its fields), as the JAX
    driver's pickle."""
    from pathlib import Path

    from apex_tpu_torch.io import native

    ck = {"params": _to_host(params), "opt_state": _to_host(opt_state._asdict()),
          "batch_stats": _to_host(batch_stats), "step": int(step), "amp": amp_state}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with native.atomic_output(path) as f:
        torch.save(ck, f)


def run(args):
    """Train ``args.steps`` steps; returns the report (losses,
    images/s, peak memory).  Starts the process group unless one is up,
    and tears down what it started."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    owns_group = not dist.is_initialized()
    dev = multiproc.initialize_distributed(args.device)
    try:
        if not ps.model_parallel_is_initialized():
            ps.initialize_model_parallel()
        dp_group = ps.get_data_parallel_group()
        if args.dp != dp_group.size():
            raise ValueError(f"--dp {args.dp}, but the world has {dp_group.size()} ranks "
                             f"(start --dp N as N torchrun ranks)")
        return _train(args, dev, dp_group)
    finally:
        if owns_group:
            multiproc.destroy_distributed()


def _train(args, dev, dp_group):
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.resnet import ResNet18ish, ResNet50
    from apex_tpu_torch.observability.stepstats import AsyncFetcher
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.optimizers.fused_sgd import SGDState

    if args.batch_size % args.dp:
        raise ValueError(f"--batch-size {args.batch_size} must divide over --dp {args.dp}")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    rank, local = dp_group.rank(), args.batch_size // args.dp
    cls = ResNet18ish if args.small else ResNet50
    model = cls(sync_bn_group=dp_group if args.dp > 1 else None, num_classes=NUM_CLASSES,
                device=dev)
    rng = np.random.default_rng(0)
    synthetic_batch(rng, args.batch_size, args.image_size)  # the JAX driver's init batch

    variables = model.variables()
    params, amp_state = amp.initialize(variables["params"], opt_level=args.opt_level)
    params = tree_map(lambda t: t.clone(), params)
    batch_stats = tree_map(lambda t: t.clone(), variables["batch_stats"])
    opt = FusedSGD(lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
                   master_weights=True)
    opt_state = opt.init(params)
    scaler_state = amp_state.init_state(device=dev)

    start_step = 0
    if args.resume:
        ck = torch.load(args.resume, map_location=dev, weights_only=True)
        params = ck["params"]
        opt_state = SGDState(**ck["opt_state"])
        batch_stats = ck["batch_stats"]
        start_step = int(ck["step"])
        if ck.get("amp") and amp_state.scaler:
            scaler_state = amp_state.load_state_dict(ck["amp"], dev)
        for _ in range(start_step):  # the batches of the steps this run continues after
            synthetic_batch(rng, args.batch_size, args.image_size)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)

    step_fn = make_train_step(model, opt, dp_group)
    if rank == 0:
        print(f"training {'ResNet-small' if args.small else 'ResNet-50'}: {args.steps} "
              f"steps, global batch {args.batch_size}, dp={args.dp}, "
              f"opt_level={args.opt_level}", flush=True)

    fetcher = AsyncFetcher()
    losses = []

    def emit(harvested):
        for _, s, tree in harvested:
            losses.append(float(tree["loss"]))
            if rank == 0:
                print(f"step {s}: loss {losses[-1]:.4f}", flush=True)

    t_start = None
    for step in range(start_step, start_step + args.steps):
        x, y = synthetic_batch(rng, args.batch_size, args.image_size)
        rows = slice(rank * local, (rank + 1) * local)
        x = torch.from_numpy(x[rows]).to(dev, non_blocking=True)
        y = torch.from_numpy(y[rows]).to(dev, non_blocking=True)
        loss = step_fn(params, opt_state, batch_stats, x, y)
        if step == start_step:
            if cuda:
                torch.cuda.synchronize(dev)
            t_start = time.perf_counter()  # the first step builds and captures
        # a captured step's loss is its static output: copy it before the
        # next replay writes it
        fetcher.put("loss", step, {"loss": loss.clone()})
        emit(fetcher.ready())
    emit(fetcher.flush())
    if cuda:
        torch.cuda.synchronize(dev)
    ips = None
    if t_start and args.steps > 1:
        dt = time.perf_counter() - t_start
        ips = args.batch_size * (args.steps - 1) / dt
        if rank == 0:
            print(f"throughput: {ips:.1f} images/sec", flush=True)
    if args.checkpoint and rank == 0:
        save_checkpoint(args.checkpoint, params, opt_state, batch_stats,
                        start_step + args.steps,
                        amp_state.state_dict(scaler_state) if amp_state.scaler else None)
        print(f"checkpoint saved to {args.checkpoint}", flush=True)
    if args.checkpoint and args.dp > 1:
        import torch.distributed as dist

        dist.barrier(group=dp_group.group)
    report = {
        "model": "ResNet-small" if args.small else "ResNet-50",
        "batch_size": args.batch_size, "image_size": args.image_size, "dp": args.dp,
        "opt_level": args.opt_level, "start_step": start_step, "losses": losses,
        "images_per_sec": ips,
        "step_ms": None if ips is None else 1e3 * args.batch_size / ips,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None,
        "graphs": cuda,
    }
    return report


def main(argv=None):
    run(build_args().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
