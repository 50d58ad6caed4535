"""Autograd-visible collectives of tensor and sequence parallelism
(counterpart of :mod:`apex_tpu.transformer.tensor_parallel.mappings`).

Reference: ``apex/transformer/tensor_parallel/mappings.py:31-302``:
seven autograd Functions, each pairing a forward collective with the
Megatron-correct backward collective.  The JAX package spells them with
``jax.custom_vjp`` over a mesh axis; here each is a
``torch.autograd.Function`` over the tensor-parallel process group
(``axis_name``: an ``AxisGroup`` of
:mod:`apex_tpu_torch.transformer.parallel_state`, by default the
tensor-parallel group), issuing ``all_reduce``, ``all_gather`` into one
tensor or ``reduce_scatter`` of one tensor: NCCL on CUDA (inside a
captured step too), gloo on the CPU.

====================================  ============  =====================
function                              forward       backward
====================================  ============  =====================
copy_to_tensor_model_parallel_region  identity      all-reduce
reduce_from_..._region                all-reduce    identity
scatter_to_..._region                 split(last)   all-gather(last)
gather_from_..._region                gather(last)  split(last)
scatter_to_sequence_parallel_region   split(first)  all-gather(first)
gather_from_sequence_parallel_region  gather(first) reduce-scatter(first)
reduce_scatter_to_sequence_..._region rs(first)     all-gather(first)
====================================  ============  =====================

Over a group of one rank every op is the identity and runs no collective.
"""

import torch

__all__ = [
    "copy_to_tensor_model_parallel_region", "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region", "gather_from_tensor_model_parallel_region",
    "scatter_to_sequence_parallel_region", "gather_from_sequence_parallel_region",
    "reduce_scatter_to_sequence_parallel_region", "all_reduce_sum", "all_gather_dim",
    "reduce_scatter_dim", "split_dim", "tp_group",
]


def tp_group(axis_name=None):
    """``axis_name`` (an ``AxisGroup``), or the registered tensor-parallel
    group when it is None."""
    from apex_tpu_torch.transformer import parallel_state

    if axis_name is None:
        return parallel_state.get_tensor_model_parallel_group()
    if not isinstance(axis_name, parallel_state.AxisGroup):
        raise ValueError(f"axis_name={axis_name!r}: pass an AxisGroup of "
                         f"apex_tpu_torch.transformer.parallel_state, or None")
    return axis_name


def _single(axis) -> bool:
    return axis.size() == 1


def all_reduce_sum(x, axis):
    """The group's sum of ``x`` (a new tensor)."""
    import torch.distributed as dist

    if _single(axis):
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, group=axis.group)
    return out


def all_gather_dim(x, axis, dim):
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    from apex_tpu_torch.parallel.distributed import all_gather_flat

    if _single(axis):
        return x
    dim = dim % x.dim()
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((axis.size() * src.shape[0],) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    all_gather_flat(out, src, axis.group)
    return out.movedim(0, dim) if dim else out


def reduce_scatter_dim(x, axis, dim):
    """This rank's 1/size slice along ``dim`` of the group's sum of ``x``."""
    from apex_tpu_torch.parallel.distributed import reduce_scatter_flat

    if _single(axis):
        return x
    dim = dim % x.dim()
    src = x.movedim(dim, 0).contiguous()
    if src.shape[0] % axis.size():
        raise ValueError(f"dim {dim} of size {src.shape[0]} does not split over "
                         f"{axis.size()} ranks")
    out = torch.empty((src.shape[0] // axis.size(),) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    reduce_scatter_flat(out, src, axis.group)
    return out.movedim(0, dim) if dim else out


def split_dim(x, axis, dim):
    """This rank's slice of ``dim`` (reference ``_split``, mappings.py:69)."""
    if _single(axis):
        return x
    size = x.shape[dim]
    if size % axis.size():
        raise ValueError(f"dim {dim} of size {size} does not split over {axis.size()} ranks")
    chunk = size // axis.size()
    return x.narrow(dim, axis.rank() * chunk, chunk).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.axis), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    """Split ``dim`` forward, all-gather it backward."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return split_dim(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.axis, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """All-gather ``dim`` forward; backward reduce-scatters it, or with
    ``reduce_grad`` False splits it."""

    @staticmethod
    def forward(ctx, x, axis, dim, reduce_grad):
        ctx.axis, ctx.dim, ctx.reduce_grad = axis, dim, reduce_grad
        return all_gather_dim(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            return reduce_scatter_dim(g, ctx.axis, ctx.dim), None, None, None
        return split_dim(g, ctx.axis, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return reduce_scatter_dim(x, axis, 0)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.axis, 0), None


def _apply(fn, x, axis_name, *args):
    axis = tp_group(axis_name)
    return x if _single(axis) else fn.apply(x, axis, *args)


def copy_to_tensor_model_parallel_region(x, axis_name=None):
    """Identity forward, all-reduce backward (mappings.py:141)."""
    return _apply(_Copy, x, axis_name)


def reduce_from_tensor_model_parallel_region(x, axis_name=None):
    """All-reduce forward, identity backward (mappings.py:158)."""
    return _apply(_Reduce, x, axis_name)


def scatter_to_tensor_model_parallel_region(x, axis_name=None):
    """Split the last dim forward, gather it backward (mappings.py:175)."""
    return _apply(_Scatter, x, axis_name, x.dim() - 1)


def gather_from_tensor_model_parallel_region(x, axis_name=None):
    """Gather the last dim forward, split it backward (mappings.py:192)."""
    return _apply(_Gather, x, axis_name, x.dim() - 1, False)


def scatter_to_sequence_parallel_region(x, axis_name=None):
    """Split dim 0 forward, gather it backward (mappings.py:213)."""
    return _apply(_Scatter, x, axis_name, 0)


def gather_from_sequence_parallel_region(x, axis_name=None, tensor_parallel_output_grad=True):
    """Gather dim 0 forward (mappings.py:230), the sequence-parallel entry
    of the tensor-parallel linears.  ``tensor_parallel_output_grad``
    (mappings.py:236-250): True when what follows gives rank-partial
    cotangents (a tensor-parallel linear), so the backward
    reduce-scatters; False when the cotangent is already whole (after
    the LM head's copy-to-region), so the backward splits."""
    return _apply(_Gather, x, axis_name, 0, bool(tensor_parallel_output_grad))


def reduce_scatter_to_sequence_parallel_region(x, axis_name=None):
    """Reduce-scatter dim 0 forward, gather it backward (mappings.py:252),
    the sequence-parallel exit of ``RowParallelLinear``."""
    return _apply(_ReduceScatter, x, axis_name)
