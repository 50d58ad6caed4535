"""Data-parallel gradient synchronization (counterpart of
:mod:`apex_tpu.parallel.distributed`).

Reference: ``apex/parallel/distributed.py`` — ``DistributedDataParallel``
(:131) keeps flat fp16/fp32 buckets, hooks every grad accumulator and
all-reduces each bucket on side streams.  The JAX package reduces that
to a ``psum`` over the ``dp`` axis inside the step.  Here it is one
``all_reduce`` a bucket of the port's bucket plan
(:mod:`apex_tpu_torch.optimizers.bucketing`, split at
``bucket_cap_mb``), not one a leaf, with the three numerics knobs of the
reference and the JAX package:

- ``gradient_average``: divide by the world after the sum
  (distributed.py:458-462);
- ``gradient_predivide_factor``: divide by f before, by ``world/f``
  after (distributed.py:164-177);
- ``allreduce_always_fp32``: reduce half grads in fp32
  (distributed.py:449-456).

This is the REPLICATED-state grad sync: every rank then applies the same
update.  A ZeRO optimizer (:mod:`apex_tpu_torch.contrib.optimizers`)
owns the dp sync itself through its per-bucket reduce-scatter, so a step
built with one must not also all-reduce (``train_gpt.make_train_step``
skips it).  The backward-overlapped sync (hooks on a side stream) is
not ported yet (ROADMAP.md queue 1 item 6, what it left).
"""

import contextlib

import torch

from apex_tpu_torch.optimizers import bucketing
from apex_tpu_torch.optimizers.tree import tree_leaves, tree_unflatten

__all__ = ["allreduce_gradients", "Reducer", "DistributedDataParallel", "process_group",
           "all_gather_flat", "reduce_scatter_flat"]

#: the reference's default message size, the bucket cap in MB here
DEFAULT_BUCKET_CAP_MB = 25.0


def all_gather_flat(out, x, group):
    """``out`` (world x ``x.numel()``, flat) = every rank's ``x`` in rank
    order: ``all_gather_single`` where torch has it, else its older name
    ``all_gather_into_tensor`` (the same collective)."""
    import torch.distributed as dist

    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    return fn(out, x, group=group)


def reduce_scatter_flat(out, x, group):
    """``out`` = this rank's 1/world slice of the group's sum of ``x``:
    ``reduce_scatter_single``, or its older name
    ``reduce_scatter_tensor``."""
    import torch.distributed as dist

    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    return fn(out, x, group=group)


def process_group(group=None):
    """``(torch.distributed group, size)`` of ``group``: an
    ``AxisGroup`` handle, a ProcessGroup, or None for the data-parallel
    group of :mod:`apex_tpu_torch.transformer.parallel_state`."""
    import torch.distributed as dist

    from apex_tpu_torch.transformer import parallel_state

    if group is None:
        group = parallel_state.get_data_parallel_group()
    if isinstance(group, parallel_state.AxisGroup):
        return group.group, group.size()
    return group, dist.get_world_size(group)


def allreduce_gradients(grads, group=None, gradient_average: bool = True,
                        gradient_predivide_factor: float = 1.0,
                        allreduce_always_fp32: bool = False,
                        bucket_cap_mb: float = DEFAULT_BUCKET_CAP_MB):
    """All-reduce ``grads`` (a tree of tensors) over ``group``, one
    collective a bucket; returns a new tree, each leaf in its own dtype
    (the JAX package's ``allreduce_gradients``, its elementwise ops in
    its order on the packed bucket)."""
    import torch.distributed as dist

    pg, world = process_group(group)
    leaves = tree_leaves(grads)
    with torch.no_grad():
        wire = [g.to(torch.float32) if allreduce_always_fp32 else g for g in leaves]
        plan = bucketing.plan_of(tree_unflatten(grads, wire),
                                 cap_bytes=int(bucket_cap_mb * 2 ** 20))
        out = []
        for b in plan.buckets:
            buf = bucketing.pack_bucket(b, wire, bucketing.torch_dtype(b.dtype))
            if len(b.leaves) == 1 and not b.pad:
                buf = buf.clone()  # a lone leaf packs to a view; the sum is in place
            if gradient_predivide_factor != 1.0:
                buf = buf / gradient_predivide_factor
            dist.all_reduce(buf, group=pg)
            if gradient_average:
                buf = buf / (world / gradient_predivide_factor)
            elif gradient_predivide_factor != 1.0:
                buf = buf * gradient_predivide_factor
            out.append(buf)
        new = tree_leaves(bucketing.unpack(plan, out))
        return tree_unflatten(grads, [n.to(g.dtype) for n, g in zip(new, leaves)])


class Reducer:
    """Reference distributed.py:91 — the mean of a tree over the group,
    on demand."""

    def __init__(self, group=None):
        self.group = group

    def reduce(self, tree):
        return allreduce_gradients(tree, group=self.group, gradient_average=True)


class DistributedDataParallel:
    """``ddp = DistributedDataParallel(module, ...)``; ``grads =
    ddp.sync(grads)`` in the step.  The reference's overlap-engine
    options (``message_size`` becomes the bucket cap, ``prof`` wraps the
    sync in an ``allreduce_gradients`` profiler range, the rest is
    accepted and ignored: the sync runs after the backward)."""

    def __init__(self, module=None, message_size: int = 10000000, delay_allreduce: bool = False,
                 shared_param=None, allreduce_trigger_params=None,
                 retain_allreduce_buffers: bool = False, allreduce_always_fp32: bool = False,
                 num_allreduce_streams: int = 1, allreduce_communicators=None,
                 gradient_average: bool = True, gradient_predivide_factor: float = 1.0,
                 gradient_average_split_factor=None, prof: bool = False, group=None):
        self.module = module
        self.group = group
        self.bucket_cap_mb = message_size * 4 / 2 ** 20  # fp32 elements, as the reference
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.prof = prof

    def sync(self, grads):
        ctx = contextlib.nullcontext()
        if self.prof:  # reference distributed.py:363's NVTX range
            from apex_tpu_torch.utils.profiler import nvtx_range

            ctx = nvtx_range("allreduce_gradients")
        with ctx:
            return allreduce_gradients(
                grads, group=self.group, gradient_average=self.gradient_average,
                gradient_predivide_factor=self.gradient_predivide_factor,
                allreduce_always_fp32=self.allreduce_always_fp32,
                bucket_cap_mb=self.bucket_cap_mb)

    def __call__(self, *args, **kwargs):
        if self.module is None:
            raise ValueError("no module wrapped")
        return self.module(*args, **kwargs)
