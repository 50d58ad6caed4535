"""Bucket plans: the layout of the multi-tensor engine (counterpart of
:mod:`apex_tpu.optimizers.bucketing`).

A plan flattens a param tree, in :func:`~apex_tpu_torch.optimizers.tree.tree_leaves`
order (the JAX order: dicts by sorted key), into a few dtype-homogeneous
1-D buckets: leaves back to back, a per-leaf offset table, the tail
padded.  It is built from shapes and dtypes alone, is hashable and is
cached, as the JAX plan is.

On the card the plan is not what makes one launch cover many tensors:
the kernels of :mod:`apex_tpu_torch.ops.multi_tensor` read each leaf
where it lies through a table of pointers, as apex's
``multi_tensor_apply`` does.  The plan gives the **resident** layout
(``opt.init(params, bucketed=True)``: state slots held as
:class:`Buckets`, whose leaves enter that table as base + offset, so no
operand is ever packed), the per-leaf offsets every norm and unpack
slices by, and the unit that the ZeRO optimizers will shard
(``shard_pad``, ``cap_bytes``).  :func:`pack` and :func:`unpack` are the
plain versions' layout and the transparent mode's on the CPU.

**Padding.** The JAX package pads a bucket to its dtype's (sublane x
128) VMEM tile, a TPU fact.  Here the unit is :data:`ALIGN_BYTES` = 16
bytes of the dtype (4 fp32, 8 bf16/fp16 elements): every bucket's tail,
and with ``shard_pad`` every shard, ends on a 16-byte vector, the width
of the kernels' vector accesses.  The ZeRO optimizers add ``block``:
each of their shards holds a whole number of quantized-wire scale blocks
(1024 elements), so an fp32 ZeRO bucket pads as the JAX package's does
(its fp32 tile is 1024 elements) and a bf16 one to half of the JAX
package's 2048.  :func:`padded_total` is the one formula, as in JAX.
"""

import dataclasses
import functools
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.optimizers import tree as _tree

__all__ = [
    "ALIGN_BYTES", "BucketLeaf", "BucketSpec", "BucketPlan", "Buckets", "plan_of",
    "plan_of_shapes", "padded_total", "pack", "pack_bucket", "unpack",
    "per_leaf_reduce", "seg_values", "seg_broadcast", "seg_ids", "buckets_by_stage",
    "dtype_name", "torch_dtype", "new_buckets", "shard_segments", "shard_views",
]

#: a bucket's tail (and each of its ``shard_pad`` shards) ends on this
ALIGN_BYTES = 16

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def dtype_name(dtype) -> str:
    """The canonical name of a torch dtype (``torch.float32`` ->
    ``"float32"``), as JAX names its dtypes."""
    return str(dtype).replace("torch.", "")


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name] if name in _DTYPES else getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class BucketLeaf:
    """One leaf's slot inside a bucket."""

    leaf_id: int          # position in tree_leaves order
    shape: Tuple[int, ...]
    offset: int           # element offset into the bucket

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One dtype-homogeneous bucket: leaves back to back, padded tail."""

    dtype: str            # canonical storage dtype name (e.g. "float32")
    leaves: Tuple[BucketLeaf, ...]
    size: int             # payload elements (sum of leaf sizes)
    total: int            # padded length (:func:`padded_total`)

    @property
    def pad(self) -> int:
        return self.total - self.size


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """The static layout: which leaf lives where.  Hashable and built
    from shapes alone; no tensor is held."""

    treedef: _tree.TreeDef
    leaf_dtypes: Tuple[str, ...]          # storage dtype per leaf
    buckets: Tuple[BucketSpec, ...]

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_dtypes)

    def __hash__(self):
        return hash((self.treedef, self.leaf_dtypes, self.buckets))


def _unit(dtype_name_: str) -> int:
    """Elements of ``dtype_name_`` in :data:`ALIGN_BYTES`."""
    itemsize = torch.empty((), dtype=torch_dtype(dtype_name_)).element_size()
    return max(1, ALIGN_BYTES // itemsize)


def padded_total(size: int, dtype_name_: str, shard_pad: int = 1, block: int = 1) -> int:
    """The bucket length for ``size`` payload elements: rounded up to
    16 bytes of the dtype (and to ``block`` elements) times
    ``shard_pad``, so every 1/shard_pad shard also ends on 16 bytes and
    holds whole blocks.  The ONE padding formula: the plan builder and a
    checkpoint resharder must agree on it."""
    unit = math.lcm(_unit(dtype_name_), max(1, int(block))) * max(1, int(shard_pad))
    return ((size + unit - 1) // unit) * unit if size else 0


@functools.lru_cache(maxsize=64)
def _plan_from_key(treedef, shapes_dtypes, cap_bytes=None, shard_pad=1,
                   block=1) -> BucketPlan:
    by_dtype: dict = {}
    order: List[str] = []  # first-appearance bucket order, deterministic
    for i, (shape, dt) in enumerate(shapes_dtypes):
        if dt not in by_dtype:
            by_dtype[dt] = []
            order.append(dt)
        by_dtype[dt].append((i, shape))
    buckets = []
    for dt in order:
        cap = None
        if cap_bytes is not None:
            # the cap in elements of THIS dtype; at least one unit so a
            # cap below the alignment still makes progress
            itemsize = torch.empty((), dtype=torch_dtype(dt)).element_size()
            cap = max(int(cap_bytes) // itemsize, _unit(dt))
        groups: List[List] = [[]]
        off = 0
        for i, shape in by_dtype[dt]:
            n = int(np.prod(shape)) if shape else 1
            # split at leaf granularity: a leaf over the cap gets a
            # bucket of its own (the offset table never spans buckets)
            if cap is not None and off and off + n > cap:
                groups.append([])
                off = 0
            groups[-1].append((i, shape, off))
            off += n
        for group in groups:
            if not group:
                continue
            leaves = tuple(BucketLeaf(leaf_id=i, shape=shape, offset=o)
                           for i, shape, o in group)
            size = sum(bl.size for bl in leaves)
            buckets.append(BucketSpec(dtype=dt, leaves=leaves, size=size,
                                      total=padded_total(size, dt, shard_pad, block)))
    return BucketPlan(treedef=treedef, leaf_dtypes=tuple(dt for _, dt in shapes_dtypes),
                      buckets=tuple(buckets))


def plan_of(tree, cap_bytes: Optional[int] = None, shard_pad: int = 1,
            block: int = 1) -> BucketPlan:
    """The bucket plan of ``tree``'s (structure, shapes, dtypes), cached,
    so every step of one model reuses one plan object.  ``cap_bytes``
    splits an oversized dtype bucket at leaf granularity (the
    reference's ``bucket_cap_mb``); ``shard_pad`` pads each bucket to
    split evenly into that many aligned shards (the ZeRO dp count), each
    of whole ``block``-element blocks."""
    leaves = _tree.tree_leaves(tree)
    key = tuple((tuple(x.shape), dtype_name(x.dtype)) for x in leaves)
    return _plan_from_key(_tree.tree_structure(tree), key, cap_bytes, shard_pad, block)


def plan_of_shapes(treedef, shapes_dtypes: Sequence[Tuple[Tuple[int, ...], str]],
                   cap_bytes: Optional[int] = None, shard_pad: int = 1,
                   block: int = 1) -> BucketPlan:
    """:func:`plan_of` from ``(shape, dtype_name)`` pairs alone."""
    return _plan_from_key(treedef, tuple((tuple(s), str(d)) for s, d in shapes_dtypes),
                          cap_bytes, shard_pad, block)


class Buckets:
    """The 1-D bucket buffers of a plan, with the plan.  A tree node
    (:func:`~apex_tpu_torch.optimizers.tree.register_node`): mapping
    over a ``Buckets`` maps over its buffers, so the ``multi_tensor_*``
    ops, ``clip_grad`` and the optimizers take bucket views with no
    special case."""

    __slots__ = ("plan", "arrays")

    def __init__(self, plan: BucketPlan, arrays: Sequence):
        self.plan = plan
        self.arrays = tuple(arrays)

    def __repr__(self):
        shapes = [tuple(getattr(a, "shape", ())) for a in self.arrays]
        return f"Buckets({[b.dtype for b in self.plan.buckets]}, {shapes})"

    def unpack(self, dtype=None):
        """Back to the per-leaf tree (storage dtypes, or ``dtype``)."""
        return unpack(self.plan, self.arrays, dtype=dtype)

    def leaf_views(self) -> List[torch.Tensor]:
        """Each leaf's flat slice of its bucket, in leaf order: views,
        no copy (what the kernels' pointer tables take)."""
        out: List[Optional[torch.Tensor]] = [None] * self.plan.n_leaves
        for b, arr in zip(self.plan.buckets, self.arrays):
            for bl in b.leaves:
                out[bl.leaf_id] = arr[bl.offset:bl.offset + bl.size]
        return out


_tree.register_node(Buckets, lambda b: b.arrays, lambda b, arrays: Buckets(b.plan, arrays))


def new_buckets(plan: BucketPlan, device=None) -> Buckets:
    """Fresh fp32 buffers of ``plan`` for a kernel to fill leaf by leaf:
    only the pads are written (zero), as :func:`pack` leaves them."""
    arrays = []
    for b in plan.buckets:
        arr = torch.empty(b.total, dtype=torch.float32, device=device)
        if b.pad:
            arr[b.size:].zero_()
        arrays.append(arr)
    return Buckets(plan, arrays)


def pack_bucket(bucket: BucketSpec, leaves: Sequence, dtype=torch.float32,
                scale=None) -> torch.Tensor:
    """ONE bucket's flat concat of ``leaves`` (tree_leaves order), cast
    to ``dtype``, an optional scalar multiply fused in, zero-padded."""
    parts = [leaves[bl.leaf_id].reshape(-1).to(dtype) for bl in bucket.leaves]
    arr = parts[0] if len(parts) == 1 else torch.cat(parts)
    if scale is not None:
        arr = arr * (scale.to(dtype) if isinstance(scale, torch.Tensor) else scale)
    if bucket.pad:
        arr = torch.cat([arr, arr.new_zeros(bucket.pad)])
    return arr


def pack(plan: BucketPlan, tree, dtype=torch.float32, scale=None) -> List[torch.Tensor]:
    """Flatten ``tree`` into ``plan``'s buckets, cast to ``dtype``, with
    an optional scalar multiply.  The pad is zero, so an all-finite vote
    or a sum of squares over a bucket equals the one over its leaves."""
    leaves = _tree.tree_leaves(tree)
    if len(leaves) != plan.n_leaves:
        raise ValueError(f"tree has {len(leaves)} leaves; plan expects {plan.n_leaves}")
    return [pack_bucket(b, leaves, dtype, scale=scale) for b in plan.buckets]


def unpack(plan: BucketPlan, arrays: Sequence, dtype=None):
    """Slice the buckets back into the per-leaf tree.  ``dtype=None``
    casts each leaf to its storage dtype from the plan; pass
    ``torch.float32`` for fp32 state slots."""
    leaves: List[Optional[torch.Tensor]] = [None] * plan.n_leaves
    for b, arr in zip(plan.buckets, arrays):
        for bl in b.leaves:
            dt = dtype if dtype is not None else torch_dtype(plan.leaf_dtypes[bl.leaf_id])
            leaves[bl.leaf_id] = arr[bl.offset:bl.offset + bl.size].reshape(bl.shape).to(dt)
    return plan.treedef.unflatten(leaves)


def per_leaf_reduce(plan: BucketPlan, arrays: Sequence, fn: Callable) -> List:
    """``fn`` over each leaf's flat slice, in tree_leaves order: how the
    per-tensor reductions (LAMB's trust ratios, NovoGrad's norms, the
    per-leaf l2) read a bucket."""
    out: List = [None] * plan.n_leaves
    for b, arr in zip(plan.buckets, arrays):
        for bl in b.leaves:
            out[bl.leaf_id] = fn(arr[bl.offset:bl.offset + bl.size])
    return out


def seg_values(bucket: BucketSpec, per_leaf: Sequence[float], device=None):
    """A per-element hyperparameter operand for one bucket: a Python
    float when every leaf agrees (no per-element traffic), else an fp32
    vector on ``device`` (pad 0).  ``per_leaf`` is indexed by
    ``leaf_id``."""
    vals = [float(per_leaf[bl.leaf_id]) for bl in bucket.leaves]
    if all(v == vals[0] for v in vals):
        return vals[0]
    return seg_broadcast(bucket, per_leaf, device=device)


def seg_ids(plan: BucketPlan, bucket: BucketSpec) -> np.ndarray:
    """The leaf id of each element of one bucket (pad: ``n_leaves``)."""
    parts = [np.full(bl.size, bl.leaf_id, np.int32) for bl in bucket.leaves]
    if bucket.pad:
        parts.append(np.full(bucket.pad, plan.n_leaves, np.int32))
    return np.concatenate(parts) if parts else np.zeros(0, np.int32)


def buckets_by_stage(plan: BucketPlan, leaf_stages: Sequence[int],
                     n_stages: int) -> List[List[int]]:
    """Bucket indices grouped by gradient-readiness stage: a bucket's
    stage is the latest of its leaves'; each stage's list keeps
    ascending bucket order."""
    out: List[List[int]] = [[] for _ in range(n_stages)]
    for bi, b in enumerate(plan.buckets):
        out[max(leaf_stages[bl.leaf_id] for bl in b.leaves)].append(bi)
    return out


def seg_broadcast(bucket: BucketSpec, per_leaf: Sequence, device=None) -> torch.Tensor:
    """Per-leaf scalars (Python floats or 0-d tensors, indexed by
    ``leaf_id``) broadcast to a per-element fp32 bucket vector (pad 0).
    A float becomes a fill and a tensor an expand: nothing is copied
    from the host, so the vector can be built inside a captured step."""
    vals = [per_leaf[bl.leaf_id] for bl in bucket.leaves]
    device = next((v.device for v in vals if isinstance(v, torch.Tensor)), device)
    parts = [v.to(torch.float32).reshape(1).expand(bl.size)
             if isinstance(v, torch.Tensor)
             else torch.full((bl.size,), float(v), dtype=torch.float32, device=device)
             for bl, v in zip(bucket.leaves, vals)]
    if bucket.pad:
        parts.append(torch.zeros(bucket.pad, dtype=torch.float32, device=device))
    return torch.cat(parts)


def shard_segments(bucket: BucketSpec, rank: int, world: int) -> List[Tuple[int, int, int]]:
    """The leaves that rank ``rank``'s 1/world shard of ``bucket``
    overlaps, as ``(leaf_id, start, stop)`` element offsets into the
    SHARD, in bucket order; the pad is in no segment.  The static
    segment map the ZeRO optimizers read per-leaf sums through (the JAX
    package's ``seg_ids`` sliced to the rank's window): a shard does not
    align to leaf boundaries."""
    shard = bucket.total // world
    lo, hi = rank * shard, (rank + 1) * shard
    out = []
    for bl in bucket.leaves:
        a, b = max(bl.offset, lo), min(bl.offset + bl.size, hi)
        if a < b:
            out.append((bl.leaf_id, a - lo, b - lo))
    return out


def shard_views(bucket: BucketSpec, flat: torch.Tensor, rank: int,
                world: int) -> torch.Tensor:
    """Rank ``rank``'s 1/world shard of one bucket's flat buffer: a
    view, no copy."""
    shard = bucket.total // world
    return flat[rank * shard:(rank + 1) * shard]
