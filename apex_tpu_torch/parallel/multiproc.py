"""Starting the default process group (counterpart of
:mod:`apex_tpu.parallel.multiproc`).

Reference: ``apex/parallel/multiproc.py``, a launcher from before
``torch.distributed.launch``.  The JAX package calls
``jax.distributed.initialize`` in each host's process; here each rank is
a process of its own, started by ``torchrun`` (``torchrun
--nproc-per-node N -m apex_tpu_torch.pretrain_gpt ...``), and each calls
:func:`initialize_distributed`:

- the backend follows the device: NCCL for CUDA, gloo for the CPU.
  There is no other choice and no silent switch;
- the rendezvous is ``init_method`` when given, else the ``torchrun``
  environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``), else a world of one rank on an in-process store, so
  a run without ``torchrun`` still has a one-rank group and its
  collectives run at world 1 (as the JAX package's dp = 1 mesh still
  lowers its collectives).

:func:`launch` is the reference's launcher in the small: it starts one
process a rank on this host with the ``torchrun`` environment (a port
the OS picked free) and waits for all of them.  The tests start their
gloo worlds with it; on the card ``torchrun`` does the same.
"""

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import torch

__all__ = ["initialize_distributed", "destroy_distributed", "backend_for", "launch"]


def backend_for(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device!r}")


def initialize_distributed(device="cuda", init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> torch.device:
    """Start the default process group for ``device`` and return the
    device this rank runs on (``cuda:LOCAL_RANK`` under ``torchrun``).
    A group that is already up is kept (its backend must match).  Raises
    if the backend cannot start: nothing falls back."""
    import torch.distributed as dist

    from apex_tpu_torch._device import resolve_device

    dev = torch.device(device)
    backend = backend_for(dev)
    env = "WORLD_SIZE" in os.environ and init_method is None
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0")) if env else None
        dev = resolve_device("cuda" if local is None else f"cuda:{local}")
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the default process group runs {dist.get_backend()}; "
                               f"device {dev} needs {backend}")
        return dev
    kw = {"device_id": dev} if backend == "nccl" else {}
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=int(world_size), rank=int(rank), **kw)
    elif env:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0, **kw)
    return dev


def destroy_distributed() -> None:
    """Tear the default group (and every group built over it) down."""
    import torch.distributed as dist

    from apex_tpu_torch.transformer import parallel_state

    parallel_state.destroy_model_parallel()
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: Sequence[str], nproc: int, env: Optional[dict] = None,
           timeout: float = 600.0, cwd=None) -> List[subprocess.CompletedProcess]:
    """Run ``python argv...`` as ``nproc`` ranks on this host with the
    ``torchrun`` environment (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, a free ``MASTER_PORT``) and
    one CPU thread a rank; returns each rank's completed process (output
    captured).  Raises if any rank fails or the world outlives
    ``timeout``; every rank is stopped before it returns."""
    base = {**os.environ, **(env or {}), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(nproc),
            "LOCAL_WORLD_SIZE": str(nproc), "OMP_NUM_THREADS": "1"}
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) for _ in range(nproc)]
    procs = [subprocess.Popen([sys.executable, *argv], cwd=cwd, text=True, stdout=o, stderr=e,
                              env={**base, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r, (o, e) in enumerate(logs)]
    deadline, failed_at = time.monotonic() + timeout, None
    try:
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.poll() not in (None, 0) for p in procs):
                failed_at = now  # the others get a moment to report, then go
            if now > deadline or (failed_at is not None and now > failed_at + 5.0):
                break
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for p, (o, e) in zip(procs, logs):
        o.seek(0)
        e.seek(0)
        out.append(subprocess.CompletedProcess(p.args, p.returncode, o.read(), e.read()))
        o.close()
        e.close()
    if time.monotonic() > deadline and failed_at is None:
        raise TimeoutError(f"the {nproc}-rank world ran past {timeout} s:\n"
                           f"{out[0].stderr[-4000:]}")
    bad = [(r, c.returncode) for r, c in enumerate(out) if c.returncode != 0]
    if bad:
        r = bad[0][0]
        raise RuntimeError(f"rank(s) {bad} failed; rank {r}'s output:\n"
                           f"{out[r].stdout[-4000:]}\n{out[r].stderr[-6000:]}")
    return out


def main():  # pragma: no cover - launcher note
    raise SystemExit(
        "apex_tpu_torch has no launcher of its own: start one process a rank with "
        "torchrun (torchrun --nproc-per-node N -m apex_tpu_torch.pretrain_gpt ...); "
        "each calls initialize_distributed().")


if __name__ == "__main__":
    main()
