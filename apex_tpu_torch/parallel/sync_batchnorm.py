"""SyncBatchNorm: batch norm with statistics over a process group
(counterpart of :mod:`apex_tpu.parallel.sync_batchnorm`).

Reference: ``apex/parallel/optimized_sync_batchnorm.py`` and its Welford
kernels.  The JAX package sums (Σx, Σx², n) per channel in fp32 and
``psum``s them over the data-parallel axis; the port all-reduces the
same three over a ``torch.distributed`` group, in one collective, with
an autograd function whose backward all-reduces the cotangents: what
differentiating through ``psum`` gives the JAX one (the reference's
all-reduce of ``sum_dy`` / ``sum_dy_xmu``).  The count is summed too, so
ranks with uneven batches still get the global statistics.  The
variance is ``E[x²] - mean²``, as the reference computes it.

The group is where the JAX package names an axis: an ``AxisGroup`` of
:mod:`apex_tpu_torch.transformer.parallel_state` (any size; one rank
runs no collective), ``"dp"`` (:data:`DATA_AXIS`, the default, as
there) for the data-parallel group registered there, or None for local
statistics.  :func:`create_syncbn_process_group` makes the subgroups of
consecutive ranks.  The statistics are plain PyTorch ops (XLA ops in the
JAX package, which has no Pallas kernel for them).
"""

from typing import Optional

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.transformer.parallel_state import DATA_AXIS, AxisGroup

__all__ = ["SYNCBN_AXIS", "SyncBatchNorm", "convert_syncbn_model",
           "create_syncbn_process_group", "sync_batch_norm_stats"]

#: the axis name of a subgroup made by :func:`create_syncbn_process_group`
SYNCBN_AXIS = "dp_sync"


class _SumOverGroup(torch.autograd.Function):
    """``psum``: the group's sum forward, the sum of the cotangents
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group.group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        out = g.contiguous().clone()
        dist.all_reduce(out, group=ctx.group.group)
        return out, None


def _resolve(group) -> Optional[AxisGroup]:
    """The ``AxisGroup`` to sum over (None for none): ``"dp"`` is the
    registered data-parallel group."""
    if group is None or isinstance(group, AxisGroup):
        return group
    if group == DATA_AXIS:
        from apex_tpu_torch.transformer import parallel_state

        return parallel_state.get_data_parallel_group()
    raise ValueError(f"group={group!r}: pass an AxisGroup of apex_tpu_torch.transformer."
                     f"parallel_state, {DATA_AXIS!r} for the data-parallel group, or None")


def sync_batch_norm_stats(x, reduce_dims, group=None):
    """Per-channel ``(mean, var, count)`` of ``x`` over ``reduce_dims``
    (fp32), the sums taken over ``group`` (an ``AxisGroup``, ``"dp"`` or
    None).  ``var`` is the biased variance; ``count`` the global element
    count, a 0-d fp32 tensor."""
    group = _resolve(group)
    n_local = 1
    for d in reduce_dims:
        n_local *= x.shape[d]
    xf = x.to(torch.float32)
    s1 = torch.sum(xf, dim=reduce_dims)
    s2 = torch.sum(torch.square(xf), dim=reduce_dims)
    n = torch.full((1,), float(n_local), dtype=torch.float32, device=x.device)
    if group is not None and group.size() > 1:
        C = s1.shape[0]
        packed = _SumOverGroup.apply(torch.cat([s1, s2, n]), group)
        s1, s2, n = packed[:C], packed[C:2 * C], packed[2 * C:]
    n = n.reshape(())
    mean = s1 / n
    var = s2 / n - torch.square(mean)
    return mean, var, n


class SyncBatchNorm(torch.nn.Module):
    """``apex.parallel.SyncBatchNorm``: NCHW (or ``channel_last``) batch
    norm whose statistics span ``group``.  ``weight`` and ``bias`` are
    fp32 parameters (ones, zeros), ``running_mean`` and ``running_var``
    fp32 buffers (zeros, ones).  In training the batch statistics
    normalize and the running ones move by ``momentum``:
    ``(1 - m) * running + m * batch``, the variance unbiased by n / (n -
    1) with the global n, written into the buffers in place;
    ``use_running_average`` normalizes with the running ones instead.
    The math is fp32 and the output in x's dtype.  ``device``: where the
    params and buffers live (``"cuda"`` by default; raises without a
    GPU)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 affine: bool = True, track_running_stats: bool = True,
                 channel_last: bool = False, group=DATA_AXIS, device="cuda"):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.channel_last = channel_last
        self.group = group
        kw = {"dtype": torch.float32, "device": resolve_device(device)}
        if affine:
            self.weight = torch.nn.Parameter(torch.ones(num_features, **kw))
            self.bias = torch.nn.Parameter(torch.zeros(num_features, **kw))
        self.register_buffer("running_mean", torch.zeros(num_features, **kw))
        self.register_buffer("running_var", torch.ones(num_features, **kw))

    def forward(self, x, use_running_average: bool = False):
        c_dim = x.dim() - 1 if self.channel_last else 1
        reduce_dims = tuple(d for d in range(x.dim()) if d != c_dim)
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var, n = sync_batch_norm_stats(x, reduce_dims, self.group)
            if self.track_running_stats:
                with torch.no_grad():
                    m = self.momentum
                    unbiased = var * n / torch.clamp_min(n - 1, 1.0)
                    self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                    self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        shape = [1] * x.dim()
        shape[c_dim] = self.num_features
        y = (x.to(torch.float32) - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                                      + self.eps)
        if self.affine:
            y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)


def create_syncbn_process_group(group_size: int, world_size: Optional[int] = None):
    """The current rank's group of ``group_size`` consecutive ranks, an
    ``AxisGroup`` named :data:`SYNCBN_AXIS` to pass as
    ``SyncBatchNorm(group=)`` (reference: apex/parallel/__init__.py:60;
    the JAX package returns the axis name and the mesh split instead).
    Every rank calls it (the groups are made collectively).  A size that
    does not divide the world raises the JAX package's ValueError."""
    import torch.distributed as dist

    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    if group_size <= 0 or world_size % group_size != 0:
        raise ValueError(f"group_size {group_size} must evenly divide world size {world_size}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    mine = None
    for start in range(0, world_size, group_size):
        ranks = list(range(start, start + group_size))
        pg = dist.new_group(ranks) if dist.is_initialized() and group_size > 1 else None
        if rank in ranks:
            mine = AxisGroup(SYNCBN_AXIS, pg, group_size, rank - start, ranks)
    return mine


def convert_syncbn_model(module, process_group=None, channel_last: bool = False):
    """Reference: apex/parallel/__init__.py:21.  Refused as the JAX
    package refuses it: the port's models build their batch norms
    declaratively."""
    raise NotImplementedError(
        "the port's models are built declaratively: construct "
        "apex_tpu_torch.models.resnet.ResNet(sync_bn_group=...) or use "
        "apex_tpu_torch.parallel.SyncBatchNorm in the model definition")
