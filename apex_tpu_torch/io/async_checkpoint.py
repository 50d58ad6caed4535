"""Async (non-blocking) checkpointing (counterpart of
:mod:`apex_tpu.io.async_checkpoint`).

Snapshot the device tensors to host memory *synchronously*, then write
the file on a background thread while training continues::

    ckpt = AsyncCheckpointer()
    for step in range(...):
        loss = train_step(params, state, tokens, targets)
        if step % 1000 == 0:
            ckpt.save(f"/ckpt/step_{step:08d}.ckpt", {"params": params})
    ckpt.wait_until_finished()           # or: with AsyncCheckpointer()

Guarantees:

- ``save`` returns after a complete host copy of the tree: the device
  leaves are copied into pinned host buffers on the current stream
  (after the step that wrote them, in stream order) and the stream is
  synchronized before ``save`` returns.  A captured train step writes
  params and state back IN PLACE, so a copy still in flight when the
  next replay is enqueued would mix two steps; here none is;
- writes happen in submission order on one worker thread; the queue is
  bounded (2 pending snapshots), so a save cadence faster than the
  disk backpressures instead of growing host RAM without bound;
- write failures are collected and re-raised (all of them) from the
  next ``save``/``wait_until_finished``; a failed write unlinks its
  partial temp file and the checkpointer stays usable;
- atomic + durable publish (:func:`~apex_tpu_torch.io.checkpoint
  .save_checkpoint`).

``in_flight()`` lists the paths queued or being written, which a caller
that prunes old files must not count as missing nor delete.  ``writes``
records each finished write: its path, the worker's seconds and the
file's bytes.  :meth:`AsyncCheckpointer.save_distributed` is the
non-blocking :func:`~apex_tpu_torch.io.checkpoint.save_distributed_checkpoint`:
this rank's pieces are snapshot now and written by the worker.
"""

import os
import queue
import threading
import time
from typing import Any, List

import numpy as np
import torch

from apex_tpu_torch.io import checkpoint as _ckpt
from apex_tpu_torch.io.checkpoint import save_checkpoint
from apex_tpu_torch.optimizers.tree import tree_map

__all__ = ["AsyncCheckpointer"]

_STOP = object()


def _snapshot(tree: Any) -> Any:
    """A host copy of ``tree`` that nothing else references: device
    tensors copied into pinned buffers, then their streams synchronized;
    host tensors and arrays copied."""
    streams = set()

    def one(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.device.type == "cuda":
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x, non_blocking=True)
                streams.add(torch.cuda.current_stream(x.device))
                return h
            return x.clone()
        return np.array(x, copy=True)

    with torch.no_grad():
        host = tree_map(one, tree)
    for s in streams:
        s.synchronize()
    return host


class AsyncCheckpointer:
    """Background checkpoint writer: host snapshot now, disk later."""

    def __init__(self, max_pending: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._errors: List[BaseException] = []
        self._lock = threading.Lock()
        self._closed = False
        self.writes: List[dict] = []
        self._in_flight: List[str] = []
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="apex_tpu_torch-checkpoint")
        self._worker.start()

    # ------------------------------------------------------------- api
    def save(self, path, tree: Any) -> None:
        """Snapshot ``tree`` to host (copied) and queue the disk write.

        Blocks for the snapshot, and when ``max_pending`` snapshots are
        already waiting for the disk (backpressure)."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._reraise()
        host_tree = _snapshot(tree)
        path = str(path)

        def write():
            try:
                t0 = time.monotonic()
                save_checkpoint(path, host_tree)
                rec = {"path": path, "seconds": time.monotonic() - t0,
                       "bytes": os.path.getsize(path)}
                with self._lock:
                    self.writes.append(rec)
            finally:
                with self._lock:
                    self._in_flight.remove(path)

        with self._lock:
            self._in_flight.append(path)
        self._q.put(write)

    def save_distributed(self, dir_path, tree: Any, rank=None, world_size=None) -> None:
        """:func:`~apex_tpu_torch.io.checkpoint.save_distributed_checkpoint`
        without the wait: this rank's pieces snapshot to host now (rank 0
        publishes the index first, synchronously), the file is queued.
        Call from every rank."""
        if rank is None or world_size is None:
            import torch.distributed as dist

            rank, world_size = dist.get_rank(), dist.get_world_size()
        if rank == 0:
            _ckpt._write_index(dir_path, world_size)
        self.save(os.path.join(str(dir_path), _ckpt._shard_name(rank, world_size)),
                  _ckpt._distributed_payload(tree, rank))

    def in_flight(self) -> List[str]:
        """The paths of the saves queued or being written, oldest first."""
        with self._lock:
            return list(self._in_flight)

    def wait_until_finished(self) -> None:
        """Block until every queued save is on disk (then re-raise any
        write failures)."""
        self._q.join()
        self._reraise()

    def close(self) -> None:
        """Drain the queue, stop and join the worker thread."""
        if self._closed:
            return
        self._q.join()
        self._closed = True
        self._q.put(_STOP)
        self._worker.join()
        self._reraise()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # --------------------------------------------------------- worker
    def _reraise(self):
        with self._lock:
            if self._errors:
                errs, self._errors = self._errors, []
                msg = "; ".join(f"{type(e).__name__}: {e}" for e in errs)
                raise RuntimeError(f"async checkpoint write(s) failed: {msg}") from errs[0]

    def _run(self):
        while True:
            item = self._q.get()
            if item is _STOP:
                self._q.task_done()
                return
            try:
                item()
            except BaseException as e:  # noqa: BLE001 — collected, re-raised on the caller's thread
                with self._lock:
                    self._errors.append(e)
            finally:
                self._q.task_done()
