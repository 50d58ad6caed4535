"""Compiled steps: a step captured once as a CUDA graph over static
buffers, then replayed -- the port's counterpart of ``jax.jit(fn,
donate_argnums=...)``.

:class:`CapturedStep` wraps a step function ``fn(*args)``:

- **inputs**: each tensor argument is copied into a static buffer that
  the step owns (``copy_``, asynchronous from pinned host memory); each
  Python int is written into a 0-d int64 buffer (``fill_``).  The
  donated arguments (KV pools, params, optimizer state: trees of
  tensors) are referenced, not copied, as ``donate_argnums`` hands the
  reference its buffers: every call checks that their tensors are the
  ones captured (``data_ptr``) and raises if not.  A step never
  captures again behind its caller's back;
- **on CUDA**: the first ``warmup`` calls run ``fn`` eagerly on a side
  stream.  They are real steps and return their results.  The last of
  them then captures ``fn`` into a graph; capture runs nothing.  Every
  later call is a replay.  All steps on a device share one side stream:
  each stream that runs cuBLAS keeps a workspace of its own for the
  life of the process;
- **on the CPU**, which has no graphs, every call runs ``fn`` over the
  static buffers: the same path without capture;
- **outputs**: on CUDA, the graph's static tensors.  The next replay of
  this step overwrites them, and so may a replay of another step that
  shares its memory pool (``pool``): read or copy them out before the
  next step runs;
- **launch counts**: the kernel wrappers count launches in Python, so
  they tick at capture, when nothing runs, and not at replay.
  :func:`capture_counted` takes the counters' change over a capture and
  puts them back; each replay adds that change (:func:`add_counts`).
  Counts then equal an eager run's.

A capture or a replay that fails raises.  Nothing falls back to eager.
"""

import time

import torch

from apex_tpu_torch import ops
from apex_tpu_torch.optimizers.bucketing import Buckets

__all__ = ["CapturedStep", "add_counts", "capture_counted", "tensor_leaves"]

#: the side stream of each device's warm-ups and captures
_SIDE_STREAMS = {}


def tensor_leaves(tree):
    """The tensors of ``tree`` in order: dicts (by sorted key), lists and
    tuples (NamedTuples too) are walked, and the buffers of an
    optimizer's resident ``Buckets``; None and other leaves are
    skipped."""
    if isinstance(tree, Buckets):
        return list(tree.arrays)
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensor_leaves(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def capture_counted(capture):
    """``(capture(), delta)``: ``delta`` maps each launch counter that
    ``capture`` moved to how far, and the counters are put back as they
    were before it, since a capture launches nothing."""
    before = ops.launch_counts()
    try:
        out = capture()
        after = ops.launch_counts()
    finally:
        ops.restore_counts(before)
    return out, {k: after[k] - before[k] for k in before if after[k] != before[k]}


def add_counts(delta):
    """Add a capture's ``delta`` to the launch counters: one replay."""
    counts = ops.launch_counts()
    ops.restore_counts({k: counts[k] + d for k, d in delta.items()})


class CapturedStep:
    """``fn`` as a compiled step; see the module docstring.

    ``donate``: the positions of the arguments referenced rather than
    copied.  ``warmup``: the eager calls before the capture (at least 1
    on CUDA).  ``pool``: a memory pool
    (``torch.cuda.graph_pool_handle()``) shared with steps that never
    run at the same time as this one.  ``capture_seconds``: the host
    time the capture took (the warm-up apart), the twin of a jit's
    compile time."""

    def __init__(self, fn, donate=(), warmup=1, pool=None):
        self.fn = fn
        self.donate = frozenset(donate)
        self.warmup = warmup
        self.pool = pool
        self.calls = 0
        self.graph = None
        self.capture_seconds = 0.0
        self.device = None
        self._graphs = False
        self._static = None     # per argument: its buffer, or None if donated
        self._donated = None    # per donated position: its tensors' data_ptrs
        self._out = None
        self._delta = None

    def __call__(self, *args):
        if self._static is None:
            self._setup(args)
        elif len(args) != len(self._static):
            raise TypeError(f"the step was captured with {len(self._static)} "
                            f"arguments, got {len(args)}")
        static = self._load(args)
        self.calls += 1
        if self.graph is not None:
            self.graph.replay()
            add_counts(self._delta)
            return self._out
        if not self._graphs:
            return self.fn(*static)
        return self._warm_up(static)

    def _setup(self, args):
        leaves = [t for i in sorted(self.donate) for t in tensor_leaves(args[i])]
        leaves = leaves or [a for a in args if isinstance(a, torch.Tensor)]
        if not leaves:
            raise ValueError("a step needs a tensor argument to fix its device")
        self.device = leaves[0].device
        self._graphs = self.device.type == "cuda"
        if self._graphs and self.warmup < 1:
            raise ValueError("a captured step needs at least one eager warm-up call "
                             f"before its capture (warmup={self.warmup})")
        static = []
        with torch.inference_mode(False):
            for i, a in enumerate(args):
                if i in self.donate:
                    static.append(None)
                elif isinstance(a, torch.Tensor):
                    static.append(torch.empty(a.shape, dtype=a.dtype, device=self.device))
                elif isinstance(a, int):
                    static.append(torch.zeros((), dtype=torch.int64, device=self.device))
                else:
                    raise TypeError(f"argument {i} is a {type(a).__name__}: a step "
                                    f"takes tensors and ints, or donates a tree")
        self._donated = {i: [t.data_ptr() for t in tensor_leaves(args[i])]
                         for i in self.donate}
        self._static = static

    @torch.no_grad()
    def _load(self, args):
        """The arguments as ``fn`` sees them: the donated ones checked
        and passed through, the others written into their buffers."""
        out = []
        for i, (a, buf) in enumerate(zip(args, self._static)):
            if buf is None:
                if [t.data_ptr() for t in tensor_leaves(a)] != self._donated[i]:
                    raise ValueError(
                        f"argument {i} is not the buffers the step was built over; "
                        f"a step updates its donated pools, params and state in "
                        f"place and must be built again for others")
                out.append(a)
            elif isinstance(a, torch.Tensor):
                if a.shape != buf.shape:
                    raise ValueError(f"argument {i} has shape {tuple(a.shape)}; the "
                                     f"step's buffer is {tuple(buf.shape)}")
                out.append(buf.copy_(a, non_blocking=True))
            else:
                out.append(buf.fill_(a))
        return out

    def _warm_up(self, static):
        """An eager call on the side stream; the last one captures."""
        current = torch.cuda.current_stream(self.device)
        side = _SIDE_STREAMS.get(self.device)
        if side is None:
            side = _SIDE_STREAMS[self.device] = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn(*static)
        current.wait_stream(side)
        if self.calls == self.warmup:
            graph = torch.cuda.CUDAGraph()

            def capture():
                with torch.cuda.graph(graph, pool=self.pool, stream=side):
                    return self.fn(*static)

            t0 = time.perf_counter()
            self._out, self._delta = capture_counted(capture)
            current.wait_stream(side)
            self.graph = graph
            self.capture_seconds = time.perf_counter() - t0
        return out
