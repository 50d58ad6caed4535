"""Topology-aware hierarchical gradient sync: the multi-hop reduce-scatter
over a ``(slow, ..., fast)`` data-parallel split (counterpart of
:mod:`apex_tpu.contrib.optimizers._hierarchical_sync`).

Ground paper: "DynamiQ: Accelerating Gradient Synchronization using
Compressed Multi-hop All-reduce" (arXiv 2602.08923).  A data-parallel
world that spans links of different speed (NVLink inside a host, the
network between hosts) pays the slow link at the full payload with a
flat collective.  The multi-hop form reduces over the fast axis first, so
each slower hop carries only the chunk the faster hops already scattered;
on a compressed wire every hop stays at the wire dtype, the partial sums
requantized against fresh shared scales, each hop's error folded into the
error-feedback residual.

The JAX package runs each hop as a collective over one named mesh axis;
here each hop is a ``torch.distributed`` collective over a nested process
group of the data-parallel group
(:func:`apex_tpu_torch.transformer.parallel_state.get_data_parallel_hop_groups`:
the fast axis's ranks consecutive, the JAX mesh's order).  The contract
is the JAX package's:

- ``hop_axes`` orders the axes SLOW to FAST: two-level ``(dp_out,
  dp_in)`` or three-level ``(dcn, dp_out, dp_in)``; every grad hop runs
  at the same wire dtype.
- **Shard ownership is the flat plan's.**  The scatter (fastest axis
  first on the whole bucket, each slower one on the shrinking chunk)
  lands flat chunk ``r = (... (i_fast * s_next + i_next) ...) * s_slow +
  i_slow`` on the rank with those indices (:meth:`HierarchicalSyncPlan
  .zero_rank`), and bucket totals use the one
  :func:`~apex_tpu_torch.optimizers.bucketing.padded_total` formula with
  ``shard_pad = prod(sizes)``, so checkpoints cross flat, two- and
  three-level worlds unchanged.
- **Param sync mirrors in reverse**: all-gather over the slowest axis
  first, finishing on the fast one.

Quantized wire (int8/fp8), per bucket and per hop ``j`` (fast first):
shared per-block scales from the amaxes of THIS hop's group (summed in
rank order, :func:`~._quantized_sync.rank_order_sum`), quantize the
current fp32 partial, reduce-scatter the payload over the hop
(:func:`~._quantized_sync.wire_reduce_scatter`); the hop's error ``cur -
deq(q_j)`` is folded into the residual at this rank's chunk of the
bucket, and the received shard, dequantized, is the next hop's input.
Summed over ranks the new residuals keep ``sum_r transmitted = sum_r h_r
- sum_r residual_r`` exactly, at any depth.
"""

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from apex_tpu_torch.contrib.optimizers import _quantized_sync as qs
from apex_tpu_torch.parallel.distributed import all_gather_flat, reduce_scatter_flat

__all__ = [
    "HierarchicalSyncPlan", "hierarchical_plan",
    "multi_hop_reduce_scatter", "multi_hop_all_gather",
    "quantized_multi_hop_reduce_scatter", "quantized_multi_hop_pmean",
    "quantized_multi_hop_pmean_bucket",
]


@dataclasses.dataclass(frozen=True)
class HierarchicalSyncPlan:
    """The ``(slow, ..., fast)`` dp split one ZeRO optimizer syncs over:
    ``hop_axes`` and the ``hop_sizes`` it was built for, the recorded
    per-hop wire dtypes (None: the bucket's default), and ``groups``, the
    hop process groups (``AxisGroup`` handles in ``hop_axes`` order; not
    part of the plan's identity)."""

    hop_axes: Tuple[str, ...]
    hop_sizes: Tuple[int, ...]
    grad_wire_dtype: Optional[str] = None
    param_wire_dtype: Optional[str] = None
    groups: Tuple = dataclasses.field(default=(), compare=False, repr=False)

    def __post_init__(self):
        axes, sizes = tuple(self.hop_axes), tuple(self.hop_sizes)
        object.__setattr__(self, "hop_axes", axes)
        object.__setattr__(self, "hop_sizes", sizes)
        object.__setattr__(self, "groups", tuple(self.groups))
        if len(set(axes)) != len(axes):
            raise ValueError(f"hierarchical dp axes must be DISTINCT mesh axes, got {axes!r}")
        if not 2 <= len(axes) <= 3 or len(sizes) != len(axes):
            raise ValueError(f"hierarchical dp takes two or three (axis, size) hops, got "
                             f"axes={axes!r} sizes={sizes!r}")
        if any(s < 1 for s in sizes):
            raise ValueError(f"axis sizes must be >= 1, got {sizes!r}")
        if self.groups:
            have = tuple(g.size() for g in self.groups)
            if have != sizes:
                raise ValueError(f"the hop groups have {have} ranks; the plan's sizes are "
                                 f"{sizes}")

    @property
    def world(self) -> int:
        w = 1
        for s in self.hop_sizes:
            w *= s
        return w

    @property
    def shard_axes(self) -> Tuple[str, ...]:
        """Fast-major ``(fast, ..., slow)``: the order in which the flat
        chunk index counts the hops (the JAX package's PartitionSpec
        order of the resident shards)."""
        return tuple(reversed(self.hop_axes))

    def _groups(self):
        if not self.groups:
            raise ValueError("this HierarchicalSyncPlan carries no hop groups: build it "
                             "with hierarchical_plan(..., groups=) to run its collectives")
        return self.groups

    def hop_ranks(self) -> Tuple[int, ...]:
        """This rank's index on each hop, ``hop_axes`` order."""
        return tuple(g.rank() for g in self._groups())

    def zero_rank(self) -> int:
        """This rank's FLAT dp rank: the index of the bucket chunk the
        multi-hop scatter lands here (fast axis most significant)."""
        return zero_rank_of(self.hop_ranks(), self.hop_sizes)


def zero_rank_of(indices: Sequence[int], sizes: Sequence[int]) -> int:
    """The flat chunk of the rank at hop ``indices`` (slow to fast) of a
    split of ``sizes``: Horner's rule from the fast axis to the slow."""
    rank = 0
    for i, s in zip(reversed(indices), reversed(sizes)):
        rank = rank * s + i
    return rank


def hierarchical_plan(dp_axes, axis_sizes, grad_wire_dtype=None, param_wire_dtype=None,
                      groups=None) -> HierarchicalSyncPlan:
    """The plan of the optimizer's ``dp_axes=(slow, ..., fast)`` from the
    ``axis_sizes`` its ``init`` takes; ``groups`` (the hop groups, in
    ``dp_axes`` order) run its collectives."""
    axes = tuple(dp_axes)
    if not (2 <= len(axes) <= 3) or not all(isinstance(a, str) for a in axes):
        raise ValueError(f"dp_axes must be two or three mesh axis names ordered slow to fast "
                         f"— (outer, inner) or (dcn, dp_out, dp_in) — got {dp_axes!r}")
    missing = [a for a in axes if a not in (axis_sizes or {})]
    if missing:
        raise ValueError(f"hierarchical dp needs axis_sizes for every dp axis; missing "
                         f"{missing} (pass axis_sizes={{axis: size, ...}} covering {axes!r} "
                         f"to init)")
    return HierarchicalSyncPlan(
        hop_axes=axes, hop_sizes=tuple(int(axis_sizes[a]) for a in axes),
        grad_wire_dtype=qs._name(grad_wire_dtype), param_wire_dtype=qs._name(param_wire_dtype),
        groups=tuple(groups or ()))


def _fast_to_slow(plan: HierarchicalSyncPlan):
    return list(reversed(plan._groups()))


# ----------------------------------------------------------- wide wire
def multi_hop_reduce_scatter(bucket, plan: HierarchicalSyncPlan):
    """The unquantized multi-hop grad sync of one bucket (in the wire
    dtype): a reduce-scatter over the fast group first, then over each
    slower one on the shrinking chunk.  Returns this rank's flat 1/dp
    chunk of the dp-wide SUM."""
    for g in _fast_to_slow(plan):
        if g.size() == 1:
            continue
        out = torch.empty(bucket.numel() // g.size(), dtype=bucket.dtype, device=bucket.device)
        reduce_scatter_flat(out, bucket, g.group)
        bucket = out
    return bucket


def multi_hop_all_gather(shard, plan: HierarchicalSyncPlan):
    """The mirrored param sync: all-gather over the slowest group first,
    finishing on the fast one, which reassembles the bucket in flat
    layout."""
    for g in plan._groups():
        if g.size() == 1:
            continue
        out = torch.empty(shard.numel() * g.size(), dtype=shard.dtype, device=shard.device)
        all_gather_flat(out, shard.contiguous(), g.group)
        shard = out
    return shard


# ------------------------------------------------------ quantized wire
def _check_hier_blocks(n: int, plan: HierarchicalSyncPlan, block: int) -> None:
    length = n
    for size in reversed(plan.hop_sizes):  # fast -> slow
        if length % (block * size):
            raise ValueError(
                f"bucket of {n} elements does not split into {block}-element scale blocks "
                f"per {plan.hop_sizes} hierarchical shard — bucket totals must be padded "
                "with bucketing.padded_total(shard_pad=prod(dp sizes))")
        length //= size


def _hop_wire(cur, g, spec: qs.QSpec, block: int):
    """One hop of the quantized wire: ``(q, scales, q_shard)``, the
    payload quantized against the hop's shared scales and this rank's
    shard of the hop's sum, in the wire dtype."""
    scales, bounds = qs.block_scales(cur, g.group, g.size(), spec, block)
    q = qs.quantize(cur, scales, bounds, spec, block)
    q_shard = qs.wire_reduce_scatter(q, g.group, g.size(), spec) if g.size() > 1 else q
    return q, scales, q_shard


def quantized_multi_hop_reduce_scatter(h, plan: HierarchicalSyncPlan, spec: qs.QSpec,
                                       block: int = qs.QBLOCK):
    """The compressed multi-hop grad sync of one bucket: ``(sum_shard_f32,
    residual_f32)``, this rank's flat 1/dp chunk of the dp SUM (to the
    wire precision of every hop) and the whole-bucket error to carry: the
    first hop's quantization error everywhere plus each slower hop's
    requantization error at this rank's chunk."""
    n = h.shape[0]
    _check_hier_blocks(n, plan, block)
    cur, length, off, residual = h, n, 0, None
    for g in _fast_to_slow(plan):
        q, scales, q_shard = _hop_wire(cur, g, spec, block)
        err = cur - qs.dequantize(q, scales, block)
        if residual is None:
            residual = err
        else:
            residual = residual.clone()
            residual[off:off + length] += err
        idx = g.rank()
        length //= g.size()
        nb = length // block
        cur = qs.dequantize(q_shard, scales[idx * nb:(idx + 1) * nb], block)
        off += idx * length
    return cur, residual


def quantized_multi_hop_pmean_bucket(h, plan: HierarchicalSyncPlan, spec: qs.QSpec,
                                     block: int = qs.QBLOCK):
    """One packed fp32 bucket's hierarchical quantized all-reduce (the
    replicated path, no residual): the multi-hop scatter, then the
    mirrored gathers of the payload in the wire dtype and of the last
    hop's fp32 scales over every faster group, dequantize, divide by the
    world."""
    _check_hier_blocks(h.shape[0], plan, block)
    groups = _fast_to_slow(plan)
    cur, length = h, h.shape[0]
    q_shard = s_last = None
    for depth, g in enumerate(groups):
        _, s_last, q_shard = _hop_wire(cur, g, spec, block)
        if depth + 1 == len(groups):
            break
        length //= g.size()
        nb = length // block
        cur = qs.dequantize(q_shard, s_last[g.rank() * nb:(g.rank() + 1) * nb], block)
    q_full = multi_hop_all_gather(q_shard.view(torch.uint8), plan).view(q_shard.dtype)
    s_full = s_last
    for g in plan._groups()[1:]:  # every group the last hop's scales differ on
        if g.size() > 1:
            out = torch.empty(s_full.numel() * g.size(), dtype=s_full.dtype,
                              device=s_full.device)
            all_gather_flat(out, s_full.contiguous(), g.group)
            s_full = out
    return qs.dequantize(q_full, s_full, block) * (1.0 / plan.world)


def quantized_multi_hop_pmean(grads, plan: HierarchicalSyncPlan, spec: qs.QSpec,
                              block: int = qs.QBLOCK):
    """The hierarchical quantized all-reduce of a grad tree, a bucket at a
    time (plan padded to whole blocks a flat shard), back in each leaf's
    dtype."""
    from apex_tpu_torch.optimizers import bucketing
    from apex_tpu_torch.optimizers.tree import tree_leaves

    tree_plan = bucketing.plan_of(grads, shard_pad=plan.world, block=block)
    leaves = tree_leaves(grads)
    out = [quantized_multi_hop_pmean_bucket(bucketing.pack_bucket(b, leaves, torch.float32),
                                            plan, spec, block) for b in tree_plan.buckets]
    return bucketing.unpack(tree_plan, out)

