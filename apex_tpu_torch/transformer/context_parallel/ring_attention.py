"""Ring attention over the ``cp`` process group (see the package
docstring), the twin of ``apex_tpu/transformer/context_parallel/
ring_attention.py``.

The forward ring carries the normalized ``(out, lse)`` pair in fp32 and
merges each chunk's result by the online-softmax rule (:func:`_merge`);
the backward is its own ring, which recomputes each chunk pair's scores
from the saved ``(q, k, v, out, lse)`` and the global ``delta =
rowsum(do * out)``: no probabilities are kept across hops, so activation
memory is O(S / cp).  The pair is one ``torch.autograd.Function``
(:class:`_Ring`, the JAX package's ``custom_vjp``).

Each rank knows which chunk it holds at hop r (``src = (rank + r) %
cp``), so each chunk pair is one of three cases: fully visible (src <
rank: the chunk kernels with ``causal=False``), diagonal (src == rank:
``causal=True``) or fully masked (src > rank: no launch, no merge).  The
chunk kernels are the flash kernels' ring-chunk mode
(:mod:`apex_tpu_torch.ops.flash_attention`: bf16 q, k, v; fp32 out; an
fp32 cotangent; fp32 dq, dk, dv), so nothing crosses a hop rounded to
bf16; their plain versions are ``_attend_fwd_scan`` and
``flash_bwd_from_lse``.

Hops are ``torch.distributed`` point-to-point ops over the group, one
``batch_isend_irecv`` an exchange, every tensor to the previous rank and
as many from the next, in a fixed order (NCCL and gloo match a pair's
messages in the order they were posted, as the pipeline's exchanges
rely on).  Two schedules:

- serial (``overlap=False``): compute chunk r, then rotate k/v (every
  hop, the last one's result unused, as the JAX scan); in the backward
  k, v and the fp32 dk/dv accumulators rotate together;
- overlapped (``overlap=True``): hop r + 1's k/v exchange is posted
  before chunk r's compute and waited after it, the last forward
  rotation is skipped, and in the backward the accumulators' exchange
  is posted after each accumulate and waited before the next one.

Both consume the same values in the same merge and accumulation order,
so out, dq, dk and dv are bitwise equal.  Both run under CUDA graph
capture, as the pipeline's p2p does.
"""

from typing import Optional

import numpy as np
import torch

from apex_tpu_torch.ops.attention import _attend_fwd_scan, flash_bwd_from_lse

__all__ = ["ring_attention", "shard_sequence", "unshard_sequence"]

#: the ``impl`` choices: "pallas" the chunk kernels (their plain versions
#: for CPU tensors, as every wrapper), "scan" the plain versions, "auto"
#: the kernels for CUDA tensors and the plain versions on the CPU
IMPLS = ("auto", "pallas", "scan")


def _group(axis_name=None):
    """``axis_name`` (an ``AxisGroup``), or the registered cp group."""
    from apex_tpu_torch.transformer import parallel_state

    if axis_name is None:
        return parallel_state.get_context_parallel_group()
    if not isinstance(axis_name, parallel_state.AxisGroup):
        raise ValueError(f"axis_name={axis_name!r}: pass an AxisGroup of "
                         f"apex_tpu_torch.transformer.parallel_state, or None")
    return axis_name


def shard_sequence(x, axis_name=None, seq_axis: int = 2):
    """This rank's chunk of ``x`` along ``seq_axis`` (a view)."""
    g = _group(axis_name)
    chunk = x.shape[seq_axis] // g.size()
    return x.narrow(seq_axis, g.rank() * chunk, chunk)


def unshard_sequence(x, axis_name=None, seq_axis: int = 2):
    """Every rank's chunk concatenated along ``seq_axis`` in rank order
    (an all-gather over the group)."""
    from apex_tpu_torch.transformer.tensor_parallel.mappings import all_gather_dim

    return all_gather_dim(x, _group(axis_name), seq_axis)


def _scan_block_k(dtype) -> int:
    """The scan chunk's key block: 16 sublane tiles of the dtype, the JAX
    package's default (256 for 2-byte types, 128 for fp32)."""
    return 128 if dtype == torch.float32 else 256


def _chunk_fwd(q, k, v, scale, causal, kernel):
    """``(out fp32 (B, H, S, D), lse fp32 (B, H, S))`` of one chunk pair
    at zero offsets."""
    B, H, S, D = q.shape
    if kernel:
        from apex_tpu_torch.ops.flash_attention import flash_fwd

        out, lse = flash_fwd(q.reshape(B * H, S, D), k.reshape(B * H, -1, D),
                             v.reshape(B * H, -1, D), scale, causal, 0, 0,
                             out_dtype=torch.float32)
        return out.reshape(B, H, S, D), lse.reshape(B, H, S)
    return _attend_fwd_scan(q, k, v, scale, causal, 0, 0, _scan_block_k(q.dtype))


def _chunk_bwd(q, k, v, do, lse, delta, scale, causal, kernel):
    """fp32 ``(dq, dk, dv)`` of one chunk pair from the global lse and
    delta and the fp32 cotangent ``do``."""
    if kernel:
        from apex_tpu_torch.ops.flash_attention import flash_dkv, flash_dq

        B, H, S, D = q.shape
        args = (q.reshape(B * H, S, D), k.reshape(B * H, -1, D), v.reshape(B * H, -1, D),
                do.reshape(B * H, S, D), lse.reshape(B * H, S, 1),
                delta.reshape(B * H, S, 1), scale, causal, 0, 0)
        dq = flash_dq(*args, out_dtype=torch.float32)
        dk, dv = flash_dkv(*args, out_dtype=torch.float32)
        return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)
    return flash_bwd_from_lse(q, k, v, do, lse, delta, scale, causal)


def _merge(out, lse, out_b, lse_b):
    """Online-softmax merge of two normalized partials."""
    lse_new = torch.logaddexp(lse, lse_b)
    w_old = torch.exp(lse - lse_new)[..., None]
    w_b = torch.exp(lse_b - lse_new)[..., None]
    return out * w_old + out_b * w_b, lse_new


def _case(rank, cp, r, causal):
    """The chunk pair at hop r: "full", "diag" or "masked"."""
    src = (rank + r) % cp
    if not causal or src < rank:
        return "full"
    return "diag" if src == rank else "masked"


def _post(group, tensors):
    """Post one exchange: each of ``tensors`` to the previous rank of the
    group, as many of the same shapes from the next.  Returns the receive
    buffers and the works to wait on."""
    import torch.distributed as dist

    n, me = group.size(), group.rank()
    prv, nxt = group.ranks[(me - 1) % n], group.ranks[(me + 1) % n]
    bufs = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, prv, group.group) for t in tensors]
           + [dist.P2POp(dist.irecv, b, nxt, group.group) for b in bufs])
    return bufs, dist.batch_isend_irecv(ops)


def _wait(posted):
    bufs, works = posted
    for w in works:
        w.wait()
    return bufs


def _ring_fwd(q, k, v, group, causal, scale, kernel, overlap):
    """fp32 ``(out, lse)`` of the local queries against every chunk."""
    cp, rank = group.size(), group.rank()
    out = lse = None
    kc, vc = k, v
    for r in range(cp):
        nxt = _post(group, (kc, vc)) if overlap and r + 1 < cp else None
        case = _case(rank, cp, r, causal)
        # hop 0 holds the rank's own chunk (never masked): its result is
        # the first partial, what merging it with the empty one gives; a
        # masked chunk would merge as an exact no-op, so it is skipped
        if case != "masked":
            out_b, lse_b = _chunk_fwd(q, kc, vc, scale, case == "diag", kernel)
            out, lse = (out_b, lse_b) if out is None else _merge(out, lse, out_b, lse_b)
        if nxt is not None:
            kc, vc = _wait(nxt)
        elif not overlap and cp > 1:
            kc, vc = _wait(_post(group, (kc, vc)))
    return out, lse


def _ring_bwd(q, k, v, out, lse, g, group, causal, scale, kernel, overlap):
    """The backward ring: q, do, lse and delta stay home; k, v and the
    fp32 dk/dv accumulators travel and arrive home after cp hops with
    every rank's contribution summed."""
    cp, rank = group.size(), group.rank()
    do = g.float().contiguous()
    delta = (do * out).sum(-1)  # the global row's rowsum(do * out)
    dq = dk = dv = None
    kc, vc = k, v
    acc_hop = None
    for r in range(cp):
        nxt = _post(group, (kc, vc)) if overlap and r + 1 < cp else None
        case = _case(rank, cp, r, causal)
        if case != "masked":
            dq_b, dk_b, dv_b = _chunk_bwd(q, kc, vc, do, lse, delta, scale, case == "diag",
                                          kernel)
        if acc_hop is not None:
            dk, dv = _wait(acc_hop)
        if case != "masked":  # hop 0 (the own chunk) starts every sum
            dq = dq_b if dq is None else dq + dq_b
            dk = dk_b if dk is None else dk + dk_b
            dv = dv_b if dv is None else dv + dv_b
        if cp == 1:
            continue
        if overlap:
            acc_hop = _post(group, (dk, dv))
            if nxt is not None:
                kc, vc = _wait(nxt)
        else:
            kc, vc, dk, dv = _wait(_post(group, (kc, vc, dk, dv)))
    if acc_hop is not None:
        dk, dv = _wait(acc_hop)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Ring(torch.autograd.Function):
    """The JAX package's ``_ring`` ``custom_vjp``: ``apply(q, k, v, group,
    causal, scale, kernel, overlap) -> out`` in q's dtype; saves q, k, v
    and the fp32 out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, kernel, overlap):
        out, lse = _ring_fwd(q, k, v, group, causal, scale, kernel, overlap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (group, causal, scale, kernel, overlap)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, out, lse, g, *ctx.cfg)
        return dq, dk, dv, None, None, None, None, None


def ring_attention(q, k, v, axis_name=None, causal: bool = True,
                   softmax_scale: Optional[float] = None, impl: str = "auto",
                   interpret: bool = False, overlap: bool = False):
    """Exact attention with the sequence split over the cp group.

    q, k, v: this rank's chunks ``(B, H, S_local, D)`` (global position =
    rank * S_local + i; k/v with q's head count: grouped-query callers
    repeat first).  ``axis_name``: the cp ``AxisGroup`` (the registered
    one by default).  Differentiable: the backward is its own ring, so
    the ranks' grads of their local loss shards sum to the total loss's.

    ``impl``: "pallas" (the chunk kernels; for CPU tensors their plain
    versions, as every wrapper), "scan" (the plain versions) or "auto"
    (the kernels for CUDA tensors, the plain versions on the CPU).
    ``interpret`` is the JAX signature's and has no effect: the kernels
    have no interpret mode.  ``overlap``: the overlapped schedule (module
    docstring), bitwise the serial one."""
    del interpret
    if impl not in IMPLS:
        raise ValueError(f"impl must be 'auto', 'pallas', or 'scan'; got {impl!r}")
    group = _group(axis_name)
    kernel = impl == "pallas" or (impl == "auto" and q.device.type == "cuda")
    scale = softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(q.shape[-1])
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(), group, bool(causal),
                       float(scale), kernel, bool(overlap))
