"""Quantized gradient synchronization on the bucket plan: int8/fp8 wire
traffic with shared per-block scales and error-feedback residuals
(counterpart of :mod:`apex_tpu.contrib.optimizers._quantized_sync`).

Reference: ``apex/contrib/optimizers/distributed_fused_adam.py``'s fp8
gradient buffers with per-bucket amax scaling; the JAX package's scheme,
carried over value for value:

- **Shared per-block scales.**  A bucket splits into :data:`QBLOCK`-
  element blocks.  Each rank takes its amax a block; their sum over the
  group (one small fp32 collective) gives the shared scale ``s = Σ_r
  amax_r / qmax``, and each rank clips its quantized block to
  ``±qmax · amax_r / Σ amax``, so the group's sum of quantized values is
  bounded by ``qmax`` by construction: an int8 sum cannot wrap, an fp8
  sum stays finite (fp8 wires halve ``qmax`` as headroom).
- **Error-feedback residuals**: ``residual = h - dequantize(quantize(h))``
  rides the optimizer state and is added back into the next step's
  gradient before it is quantized.
- **Dequantize into fp32** on the owner shard; the optimizer math then
  runs as on a wide wire.

What the port changes is how the sums cross the group, so that the CPU
tests under gloo hold exactly what the card runs under NCCL:

- the small fp32 sums (the amaxes here, the ZeRO engine's per-leaf
  Σx²) go through :func:`rank_order_sum`: an all-gather, then a sum in
  rank order, which is the order XLA's CPU ``psum`` adds in, so the
  scales equal the JAX package's bit for bit at any world size;
- the int8 payload is a ``reduce_scatter_tensor`` in int8 (integer
  adds: exact in any order; both backends take int8);
- the fp8 payload is an ``all_to_all_single`` of its bytes (uint8: gloo's
  reduce-scatter refuses float8), then each rank sums the world's
  pieces of its shard in fp32 in rank order and rounds once to the wire
  dtype: what ``jax.lax.psum_scatter`` computes for a float8 operand
  on the CPU (a probe of the JAX package: an fp32 sum and one rounding,
  not a rounding each add).
"""

import dataclasses
from typing import Optional, Tuple

import torch

from apex_tpu_torch.optimizers import bucketing
from apex_tpu_torch.parallel.distributed import all_gather_flat, reduce_scatter_flat

__all__ = [
    "QBLOCK", "QSpec", "qspec_of", "is_quantized", "rank_order_sum", "block_scales",
    "quantize", "dequantize", "wire_reduce_scatter", "wire_reduce_scatter_start",
    "quantized_reduce_scatter", "quantized_reduce_scatter_start", "quantized_pmean",
    "quantized_pmean_bucket", "grad_sync_bytes",
]

#: elements a scale block: every ZeRO shard holds whole blocks (the
#: plan pads with ``block=QBLOCK``); 4 bytes of fp32 scale per 1024
#: payload elements, ~0.4 % of an int8 wire
QBLOCK = 1024


@dataclasses.dataclass(frozen=True)
class QSpec:
    """One quantized wire format: its dtype's name, the clip bound
    ``qmax`` (fp8 formats keep a 2x margin under their finite max) and
    whether it rounds to integers."""

    name: str
    qmax: float
    is_int: bool

    @property
    def wire_dtype(self) -> torch.dtype:
        return getattr(torch, self.name)


_QSPECS = {
    "int8": QSpec("int8", 127.0, True),
    "float8_e4m3fn": QSpec("float8_e4m3fn", 224.0, False),
    "float8_e5m2": QSpec("float8_e5m2", 28672.0, False),
}


def _name(dtype) -> Optional[str]:
    if dtype is None:
        return None
    return bucketing.dtype_name(dtype) if isinstance(dtype, torch.dtype) else str(dtype)


def qspec_of(dtype) -> Optional[QSpec]:
    """The :class:`QSpec` of a quantized wire dtype, None for a wide one."""
    return _QSPECS.get(_name(dtype))


def is_quantized(dtype) -> bool:
    return qspec_of(dtype) is not None


def rank_order_sum(x: torch.Tensor, pg, world: int) -> torch.Tensor:
    """The group's sum of ``x``, added in rank order (all-gather, then
    ``((x_0 + x_1) + x_2) + ...``): the order of XLA's CPU ``psum``, the
    same on every rank and in every run."""
    flat = x.contiguous().reshape(-1)
    parts = torch.empty(world * flat.numel(), dtype=x.dtype, device=x.device)
    all_gather_flat(parts, flat, pg)
    parts = parts.view((world,) + tuple(x.shape))
    acc = parts[0]
    for r in range(1, world):
        acc = acc + parts[r]
    return acc


def block_scales(h, pg, world: int, spec: QSpec,
                 block: int = QBLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scales, bounds)`` of one bucket, both fp32 of ``len(h)//block``:
    ``scales[b] = Σ_r amax_r[b] / qmax`` (shared), ``bounds[b] = qmax ·
    amax_r[b] / Σ amax_r[b]`` (this rank's clip).  An all-zero block
    gets scale 1 and bound 0; non-finite amaxes propagate to the
    caller's vote."""
    a_loc = torch.amax(torch.abs(h.reshape(-1, block)), dim=1)
    a_sum = rank_order_sum(a_loc, pg, world)
    pos = a_sum > 0
    denom = torch.where(pos, a_sum, torch.ones_like(a_sum))
    scales = torch.where(pos, a_sum / spec.qmax, torch.ones_like(a_sum))
    bounds = spec.qmax * (a_loc / denom)
    return scales, bounds


def quantize(h, scales, bounds, spec: QSpec, block: int = QBLOCK) -> torch.Tensor:
    """One bucket to the wire dtype: divide by the shared block scale,
    round (int wires; fp8 rounds in the cast), clip to this rank's
    bound."""
    y = h.reshape(-1, block) / scales[:, None]
    if spec.is_int:
        b = torch.floor(bounds)[:, None]
        q = torch.clamp(torch.round(y), -b, b)
    else:
        b = bounds[:, None]
        q = torch.clamp(y, -b, b)
    return q.reshape(-1).to(spec.wire_dtype)


def dequantize(q, scales, block: int = QBLOCK) -> torch.Tensor:
    """Wire values back to fp32, times their block's scale."""
    return (q.to(torch.float32).reshape(-1, block) * scales[:, None]).reshape(-1)


def _check_block(n: int, block: int, world: int) -> None:
    if n % (block * max(world, 1)):
        raise ValueError(
            f"bucket of {n} elements does not split into {block}-element scale blocks "
            f"per {world}-way shard: pad it with bucketing.padded_total(shard_pad=world, "
            f"block={block})")


def wire_reduce_scatter_start(q, pg, world: int, spec: QSpec):
    """Start :func:`wire_reduce_scatter` (the collective asynchronous);
    returns ``finish() -> shard``, which waits for it first."""
    import torch.distributed as dist

    n = q.numel() // world
    if spec.is_int:
        out = torch.empty(n, dtype=q.dtype, device=q.device)
        work = reduce_scatter_flat(out, q, pg, async_op=True)

        def finish_int():
            work.wait()
            return out

        return finish_int
    got = torch.empty(q.numel(), dtype=torch.uint8, device=q.device)
    work = dist.all_to_all_single(got, q.view(torch.uint8), group=pg, async_op=True)

    def finish_fp8():
        work.wait()
        parts = got.view(q.dtype).reshape(world, n)
        acc = parts[0].to(torch.float32)
        for r in range(1, world):
            acc = acc + parts[r].to(torch.float32)
        return acc.to(q.dtype)

    return finish_fp8


def wire_reduce_scatter(q, pg, world: int, spec: QSpec) -> torch.Tensor:
    """This rank's 1/world shard of the group's sum of ``q``, in the wire
    dtype: int8 by ``reduce_scatter_tensor``; fp8 by an all-to-all of
    its bytes and an fp32 sum in rank order rounded once."""
    return wire_reduce_scatter_start(q, pg, world, spec)()


def quantized_reduce_scatter_start(h, pg, spec: QSpec, rank: int, world: int,
                                   block: int = QBLOCK):
    """The issue half of :func:`quantized_reduce_scatter`: the shared
    block scales (a small collective, waited on), the quantize, the
    residual, and the payload's reduce-scatter started.  Returns
    ``(finish, residual_f32)``; ``finish()`` waits for the wire and
    dequantizes this rank's shard of the sum."""
    _check_block(h.shape[0], block, world)
    scales, bounds = block_scales(h, pg, world, spec, block)
    q = quantize(h, scales, bounds, spec, block)
    residual = h - dequantize(q, scales, block)
    wire = wire_reduce_scatter_start(q, pg, world, spec)
    nb = (h.shape[0] // block) // world

    def finish():
        return dequantize(wire(), scales[rank * nb:(rank + 1) * nb], block)

    return finish, residual


def quantized_reduce_scatter(h, pg, spec: QSpec, rank: int, world: int,
                             block: int = QBLOCK):
    """One bucket's quantized grad sync: ``(sum_shard_f32,
    residual_f32)``, this rank's 1/world shard of the group's sum of
    ``h`` (to the wire precision) and ``h - dequantize(quantize(h))``."""
    finish, residual = quantized_reduce_scatter_start(h, pg, spec, rank, world, block)
    return finish(), residual


def quantized_pmean_bucket(h, pg, spec: QSpec, world: int, block: int = QBLOCK):
    """One packed fp32 bucket's quantized all-reduce for the replicated
    path: the reduce-scatter above, an all-gather of the summed shard in
    the wire dtype (as bytes), dequantize, divide by the world.  No
    residual: the replicated step has no state channel."""
    _check_block(h.shape[0], block, world)
    scales, bounds = block_scales(h, pg, world, spec, block)
    q = quantize(h, scales, bounds, spec, block)
    q_shard = wire_reduce_scatter(q, pg, world, spec)
    full = torch.empty(q.numel(), dtype=torch.uint8, device=q.device)
    all_gather_flat(full, q_shard.view(torch.uint8), pg)
    return dequantize(full.view(q.dtype), scales, block) * (1.0 / world)


def quantized_pmean(grads, pg, spec: QSpec, world: int, block: int = QBLOCK):
    """The quantized all-reduce of a grad tree over the group, a bucket
    at a time (plan padded to whole blocks a shard), back in each
    leaf's dtype."""
    from apex_tpu_torch.optimizers.tree import tree_leaves

    plan = bucketing.plan_of(grads, shard_pad=world, block=block)
    leaves = tree_leaves(grads)
    out = [quantized_pmean_bucket(bucketing.pack_bucket(b, leaves, torch.float32),
                                  pg, spec, world, block) for b in plan.buckets]
    return bucketing.unpack(plan, out)


def grad_sync_bytes(total: int, sync_dtype, block: int = QBLOCK, hier=None,
                    flat_hop: str = "dp"):
    """``{hop: {"payload": bytes, "scales": bytes}}`` one bucket's grad
    sync puts on the wire a step, per rank: one hop keyed ``flat_hop`` on
    the flat plan; on a hierarchical one (``hier``, a
    :class:`~._hierarchical_sync.HierarchicalSyncPlan`) the fast hop
    carries the whole bucket and each slower hop the chunk every faster
    one scattered, all at the wire dtype.  The quantized wires' fp32
    scale vector is counted on its own, a hop at a time."""
    spec = qspec_of(sync_dtype)
    if spec is not None:
        item = torch.empty((), dtype=spec.wire_dtype).element_size()
    else:
        item = torch.empty((), dtype=bucketing.torch_dtype(_name(sync_dtype))).element_size()

    def hop(n):
        return {"payload": n * item, "scales": (n // block) * 4 if spec is not None else 0}

    if hier is None:
        return {flat_hop: hop(total)}
    out, n = {}, total
    for axis, size in zip(reversed(hier.hop_axes), reversed(hier.hop_sizes)):  # fast first
        out[axis] = hop(n)
        n //= max(size, 1)
    return out
