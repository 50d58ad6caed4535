"""The smallest data-parallel training script: the port's twin of
``examples/simple/distributed/distributed_data_parallel.py`` (reference
``examples/simple/distributed/distributed_data_parallel.py``).

    torchrun --nproc-per-node 2 -m apex_tpu_torch.distributed_data_parallel
    torchrun --nproc-per-node 2 -m apex_tpu_torch.distributed_data_parallel --device cpu
    python -m apex_tpu_torch.distributed_data_parallel      # a one-rank group

One process a rank in a dp group (NCCL on CUDA, gloo with ``--device
cpu``; without ``torchrun`` a one-rank group).  Every rank draws the JAX
driver's data from ``np.random.RandomState(0)`` (a linear model, 64 rows
a rank) and takes rows ``[64 r, 64 r + 64)``; each step takes the mean
squared error, all-reduces the gradients over the group
(:func:`~apex_tpu_torch.parallel.allreduce_gradients`, the mean) and
averages the loss over it, then applies ``FusedSGD(lr=0.02,
momentum=0.9)``.  Losses are printed through
:class:`~apex_tpu_torch.observability.stepstats.AsyncFetcher` (no
blocking device read in the loop).  The run fails unless
``max |w - w_true| < 0.1`` after 60 steps, as the JAX driver asserts.
"""

import argparse
import sys

import numpy as np
import torch

__all__ = ["build_args", "data", "run", "main"]

ROWS = 64
FEATURES = 16
STEPS = 60


def build_args():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    return p


def data(world: int):
    """The JAX driver's ``(w_true (16, 1), X (64 world, 16), Y (64 world,
    1))``, fp32 numpy, drawn in its order from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    w_true = rng.randn(FEATURES, 1).astype(np.float32)
    X = rng.randn(ROWS * world, FEATURES).astype(np.float32)
    Y = X @ w_true + 0.01 * rng.randn(ROWS * world, 1).astype(np.float32)
    return w_true, X, Y


def run(args):
    """The 60 steps; returns ``{"world", "losses", "err", "w"}`` (the
    printed losses by step, ``max |w - w_true|`` and the final weights as
    numpy).  Starts the process group unless one is up, and tears down
    what it started."""
    import torch.distributed as dist

    from apex_tpu_torch.observability.stepstats import AsyncFetcher
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.parallel import allreduce_gradients, multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    owns_group = not dist.is_initialized()
    dev = multiproc.initialize_distributed(args.device)
    try:
        if not ps.model_parallel_is_initialized():
            ps.initialize_model_parallel()
        group = ps.get_data_parallel_group()
        world, rank = group.size(), group.rank()
        if rank == 0:
            print(f"{world} ranks, dp group ({dist.get_backend()})", flush=True)
        w_true, X, Y = data(world)
        rows = slice(ROWS * rank, ROWS * (rank + 1))
        x = torch.from_numpy(X[rows]).to(dev)
        y = torch.from_numpy(Y[rows]).to(dev)
        params = {"w": torch.zeros((FEATURES, 1), dtype=torch.float32, device=dev,
                                   requires_grad=True)}
        opt = FusedSGD(lr=0.02, momentum=0.9)
        state = opt.init(params)

        def step():
            with torch.enable_grad():
                loss = torch.mean((x @ params["w"] - y) ** 2)
                (g,) = torch.autograd.grad(loss, [params["w"]])
            grads = allreduce_gradients({"w": g}, group)  # the DDP sync
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=group.group)
            opt.update(grads, state, params, inplace=True)
            return loss / world

        fetcher = AsyncFetcher()
        losses = {}

        def emit(harvested):
            for _, s, tree in harvested:
                losses[s] = float(tree["loss"])
                if rank == 0:
                    print(f"step {s}: loss {losses[s]:.6f}", flush=True)

        for i in range(STEPS):
            loss = step()
            if i % 15 == 0:
                fetcher.put("loss", i, {"loss": loss})
            emit(fetcher.ready())
        emit(fetcher.flush())
        w = params["w"].detach().cpu().numpy()
        err = float(np.max(np.abs(w - w_true)))
        if rank == 0:
            print(f"max |w - w_true| = {err:.4f}", flush=True)
        if not err < 0.1:
            raise AssertionError(f"max |w - w_true| = {err} (must be < 0.1)")
        return {"world": world, "losses": losses, "err": err, "w": w}
    finally:
        if owns_group:
            multiproc.destroy_distributed()


def main(argv=None):
    run(build_args().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
