"""Device-side per-step training telemetry with asynchronous fetch
(counterpart of :mod:`apex_tpu.observability.stepstats`).

The blocking spelling of training telemetry — ``float(loss)`` every
step — costs a full host sync per step.  This module is the allowed
spelling:

- :class:`StepStats` is a window of 0-d device tensors: loss (last and
  window sum), the global gradient norm, the all-finite vote, the loss
  scale, and the param/update norms.  The JAX package donates a fresh
  window through its jitted step after each fetch; a captured CUDA
  graph cannot take new buffers (a
  :class:`~apex_tpu_torch.graphs.CapturedStep` holds its donated tensors
  by address), so here the window lives in FIXED buffers that the step
  updates in place with branch-free device arithmetic
  (:meth:`StepTelemetry.accumulate_`), and the fetch resets them in
  stream order (:meth:`StepTelemetry.reset`).
- :class:`AsyncFetcher` is the host half.  ``put`` copies the given
  device tensors into pinned host memory on a copy stream, ordered
  after the step by an event, and makes the compute stream wait for
  that copy before its next work: the next replay, which overwrites the
  step's outputs, and the window's reset.  ``ready`` polls the copies'
  events without blocking; ``flush`` synchronizes (end of run).  No
  ``.item()``/``float()`` of a device tensor runs in the loop.

**Capture seam** (:func:`capture`/:func:`offer`): the train step wraps
its body in ``with capture() as cap:``; the optimizer engine *offers*
interior values (the clip's global grad norm, the agreed all-finite
flag) into it while the body runs, so the stats reuse what the update
computes.  With ``clip_norm`` the grad norm is the clip's
``mt_l2norm`` result; without a clip the JAX package folds a Σg² into
the update's grad read, where the port makes one ``mt_l2norm`` pass
over the grads (:func:`offer_local_grad_norm`): an extra read of the
grads, one kernel call a step.

Stats are **observers, never participants**: nothing here feeds back
into the update, so telemetry-on and telemetry-off steps give bitwise
equal losses and params.
"""

import contextlib
import math
import threading
from collections import deque
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device

__all__ = ["AsyncFetcher", "StepStats", "StepTelemetry", "capture",
           "capturing", "offer", "offer_local_grad_norm"]


class StepStats(NamedTuple):
    """The windowed device-side accumulator (0-d tensors, updated in place)."""

    steps: torch.Tensor          # i32: steps accumulated in this window
    loss_sum: torch.Tensor       # f32: Σ loss over the window
    loss_last: torch.Tensor      # f32
    grad_norm_sum: torch.Tensor  # f32: Σ grad-norm (see module doc)
    grad_norm_last: torch.Tensor  # f32
    notfinite: torch.Tensor      # i32: non-finite (skipped) steps in window
    loss_scale: torch.Tensor     # f32: last loss scale (nan without amp)
    param_norm: torch.Tensor     # f32: last ||params||
    update_norm: torch.Tensor    # f32: last ||Δparams||


#: each field's dtype and value in a fresh window
_INIT = (
    (torch.int32, 0), (torch.float32, 0.0), (torch.float32, 0.0),
    (torch.float32, 0.0), (torch.float32, math.nan), (torch.int32, 0),
    (torch.float32, math.nan), (torch.float32, math.nan), (torch.float32, math.nan))


# ------------------------------------------------------------ capture seam
_CAPTURE: List[Dict[str, Any]] = []
#: each active capture's Σx² reduce (None: the norms are this rank's)
_REDUCE: List[Any] = []


def capturing() -> bool:
    """True while a train step's telemetry wrapper runs its body."""
    return bool(_CAPTURE)


def offer(key: str, value) -> None:
    """Expose an interior device value (``grad_norm``, ``all_finite``)
    to the innermost active :func:`capture`.  No-op — one truthiness
    check — when nothing captures."""
    if _CAPTURE:
        _CAPTURE[-1][key] = value


@contextlib.contextmanager
def capture(sumsq_reduce=None):
    """``with capture() as cap:`` around a step body; ``cap`` collects
    everything the interior :func:`offer`'d.  ``sumsq_reduce`` (a
    model-parallel step's clip reduce: per-leaf Σx² -> the global Σx²)
    makes the no-clip grad norm global too."""
    cap: Dict[str, Any] = {}
    _CAPTURE.append(cap)
    _REDUCE.append(sumsq_reduce)
    try:
        yield cap
    finally:
        _CAPTURE.pop()
        _REDUCE.pop()


def offer_local_grad_norm(tensors) -> None:
    """The no-clip grad-norm stat, in ONE place for the engine's and the
    per-leaf path: when a telemetry wrapper captures and no clip
    reduction exists to reuse, offer the L2 norm of ``tensors`` from one
    ``mt_l2norm`` pass, over the model-parallel groups when the capture
    has a Σx² reduce.  No-op when nothing captures."""
    if not _CAPTURE:
        return
    from apex_tpu_torch.ops.multi_tensor import mt_l2norm

    tensors = [t.detach() for t in tensors]
    total_sq, per = mt_l2norm(tensors)
    if _REDUCE[-1] is not None:
        total_sq = _REDUCE[-1](list(per.unbind(0)))
    offer("grad_norm", torch.sqrt(total_sq))


# ------------------------------------------------------------- device side
class StepTelemetry:
    """Build-time telemetry spec for ``make_train_step(telemetry=...)``.

    ``norms=False`` drops the param/update norm stats (two more
    ``mt_l2norm`` passes and one subtraction over the params a step);
    everything else reuses values the step already computes.
    """

    def __init__(self, norms: bool = True):
        self.norms = bool(norms)

    def init(self, device="cuda") -> StepStats:
        """A fresh window, every field its own 0-d buffer on ``device``."""
        dev = resolve_device(device)
        return StepStats(*(torch.full((), v, dtype=dt, device=dev) for dt, v in _INIT))

    @staticmethod
    def reset(stats: StepStats) -> None:
        """Put ``stats`` back to a fresh window in place, in stream order
        (what the fetch does after each window's copy is enqueued)."""
        with torch.no_grad():
            for t, (_, v) in zip(stats, _INIT):
                t.fill_(v)

    def accumulate(self, stats: StepStats, *, loss, grad_norm=None,
                   finite=None, loss_scale=None, new_params=None,
                   old_params=None, sumsq_reduce=None) -> StepStats:
        """One step's accounting as new tensors (branch-free, on the
        device).  ``grad_norm``/``finite`` come from the capture seam and
        may be absent (unguarded unscaled steps have no vote): absent
        ``finite`` counts as finite, absent ``grad_norm`` keeps the nan
        placeholder.  ``sumsq_reduce`` (per-leaf Σx² -> global) makes
        the param and update norms those of the whole model when the
        params are this rank's slices."""
        from apex_tpu_torch.ops.multi_tensor import mt_l2norm
        from apex_tpu_torch.optimizers.tree import tree_leaves

        loss = loss.detach().to(torch.float32).reshape(())
        if grad_norm is not None:
            gn = grad_norm.to(torch.float32).reshape(())
            gn_sum = stats.grad_norm_sum + gn
        else:
            gn, gn_sum = stats.grad_norm_last, stats.grad_norm_sum
        bad = (torch.zeros((), dtype=torch.int32, device=loss.device) if finite is None
               else torch.logical_not(finite.to(torch.bool)).to(torch.int32).reshape(()))
        scale = (stats.loss_scale if loss_scale is None
                 else loss_scale.to(torch.float32).reshape(()))
        pn, un = stats.param_norm, stats.update_norm
        if self.norms and new_params is not None and old_params is not None:
            new = [p.detach() for p in tree_leaves(new_params)]
            old = [p.detach() for p in tree_leaves(old_params)]
            psq, pper = mt_l2norm(new)
            usq, uper = mt_l2norm(torch._foreach_sub([n.to(torch.float32) for n in new],
                                                     [o.to(torch.float32) for o in old]))
            if sumsq_reduce is not None:
                psq = sumsq_reduce(list(pper.unbind(0)))
                usq = sumsq_reduce(list(uper.unbind(0)))
            pn, un = torch.sqrt(psq), torch.sqrt(usq)
        return StepStats(
            steps=stats.steps + 1, loss_sum=stats.loss_sum + loss, loss_last=loss,
            grad_norm_sum=gn_sum, grad_norm_last=gn, notfinite=stats.notfinite + bad,
            loss_scale=scale, param_norm=pn, update_norm=un)

    def accumulate_(self, stats: StepStats, **kw) -> None:
        """:meth:`accumulate` written into ``stats``' buffers in place —
        how the window rides a captured step."""
        new = self.accumulate(stats, **kw)
        with torch.no_grad():
            for dst, src in zip(stats, new):
                dst.copy_(src)

    # ---------------------------------------------------------- host side
    @staticmethod
    def summary(stats_np: Dict[str, Any]) -> Dict[str, float]:
        """Harvested window (a ``{field: np scalar}`` dict from
        :class:`AsyncFetcher`) → plain floats for printing/metrics."""
        n = max(int(stats_np["steps"]), 1)
        gn_last = float(stats_np["grad_norm_last"])
        # the window never received a grad norm: grad_norm_sum sat at its
        # 0.0 init — report "unavailable" (nan), never a fake 0.0 mean
        gn_mean = (float(stats_np["grad_norm_sum"]) / n
                   if np.isfinite(gn_last) else float("nan"))
        return {
            "steps": int(stats_np["steps"]),
            "loss_mean": float(stats_np["loss_sum"]) / n,
            "loss_last": float(stats_np["loss_last"]),
            "grad_norm_last": gn_last,
            "grad_norm_mean": gn_mean,
            "bad_steps": int(stats_np["notfinite"]),
            "loss_scale": float(stats_np["loss_scale"]),
            "param_norm": float(stats_np["param_norm"]),
            "update_norm": float(stats_np["update_norm"]),
        }

    @staticmethod
    def emit(registry, stats_np: Dict[str, Any],
             prefix: str = "apex_train") -> Dict[str, float]:
        """Record a harvested window onto a
        :class:`~apex_tpu_torch.observability.metrics.MetricsRegistry`
        (gauges for the point-in-time stats, counters for the cumulative
        ones); returns the summary dict."""
        s = StepTelemetry.summary(stats_np)
        registry.counter(f"{prefix}_steps_total",
                         "train steps accumulated").inc(s["steps"])
        registry.counter(f"{prefix}_bad_steps_total",
                         "non-finite (skipped) steps").inc(s["bad_steps"])
        g = registry.gauge
        # every gauge is isfinite-gated: a skipped overflow step puts inf
        # in the window's loss_sum — bad_steps_total carries that fact
        for key, gname, help_ in (
                ("loss_mean", f"{prefix}_loss", "window-mean train loss"),
                ("loss_last", f"{prefix}_loss_last", "last step's loss"),
                ("grad_norm_last", f"{prefix}_grad_norm_last", ""),
                ("grad_norm_mean", f"{prefix}_grad_norm_mean", ""),
                ("loss_scale", f"{prefix}_loss_scale", ""),
                ("param_norm", f"{prefix}_param_norm", ""),
                ("update_norm", f"{prefix}_update_norm", "")):
            if np.isfinite(s[key]):
                g(gname, help_).set(s[key])
        return s


# ------------------------------------------------------------- async fetch
def _to_np(host: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in host.items()}


class AsyncFetcher:
    """The non-blocking device→host telemetry channel.

    ``put(kind, step, tree)`` (``tree`` a ``{name: tensor}`` dict, or a
    :class:`StepStats`) enqueues the copies described in the module doc
    and queues the entry; ``ready()`` harvests — in FIFO order, so
    printed lines stay step-ordered — every entry whose copy has landed,
    WITHOUT blocking; ``flush()`` waits for the stragglers (end of run,
    preemption exit).  Harvested trees are plain numpy.

    ``put`` and ``ready`` are loop-thread-only; ``flush`` may also run
    on an exit path concurrently with the loop: it detaches the whole
    pending queue atomically under the lock, so each entry is harvested
    exactly once."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: deque = deque()
        self._streams: Dict[torch.device, Any] = {}

    def _copy_stream(self, dev):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(dev)
        return s

    def put(self, kind: str, step: int, tree) -> None:
        if isinstance(tree, StepStats):
            tree = tree._asdict()
        cuda = [v for v in tree.values() if isinstance(v, torch.Tensor) and v.is_cuda]
        done = None
        if cuda:
            dev = cuda[0].device
            cur = torch.cuda.current_stream(dev)
            copy = self._copy_stream(dev)
            copy.wait_stream(cur)
            host = {}
            with torch.cuda.stream(copy):
                for k, v in tree.items():
                    if isinstance(v, torch.Tensor) and v.is_cuda:
                        h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                        host[k] = h.copy_(v.detach(), non_blocking=True)
                    else:
                        host[k] = v.detach().clone() if isinstance(v, torch.Tensor) else v
                done = torch.cuda.Event()
                done.record(copy)
            # the step's outputs and the window may change only after
            # their copy: the next replay, and the window's reset
            cur.wait_event(done)
        else:
            host = {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
                    for k, v in tree.items()}
        with self._lock:
            self._pending.append((kind, int(step), host, done))

    def __len__(self) -> int:
        return len(self._pending)

    def ready(self) -> List[Tuple[str, int, Any]]:
        harvested = []
        while True:
            with self._lock:
                if not self._pending:
                    break
                kind, step, host, done = self._pending[0]
                if done is not None and not done.query():
                    break
                self._pending.popleft()
            harvested.append((kind, step, host))
        return [(k, s, _to_np(h)) for k, s, h in harvested]

    def flush(self) -> List[Tuple[str, int, Any]]:
        with self._lock:
            drained, self._pending = self._pending, deque()
        out = []
        for kind, step, host, done in drained:
            if done is not None:
                done.synchronize()
            out.append((kind, step, _to_np(host)))
        return out
