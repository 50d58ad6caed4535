"""The forward-and-backward pipeline runtime: 1F1B and the interleaved
order (counterpart of
:mod:`apex_tpu.transformer.pipeline_parallel.schedules.tick_schedule`).

Reference: ``apex/transformer/pipeline_parallel/schedules/
fwd_bwd_pipelining_without_interleaving.py:241,344-436`` (warm-up
forwards, one forward and one backward a slot, cool-down backwards) and
``fwd_bwd_pipelining_with_interleaving.py:27`` (model chunks).  The JAX
package runs every stage in lockstep, one tick of a scanned program at
a time; here each rank runs its own units in its own order and talks to
its neighbours with :mod:`~apex_tpu_torch.transformer.pipeline_parallel.
p2p_communication`, as the reference does:

- **1F1B** (one chunk): ``min(P - 1 - rank, M)`` warm-up forwards, then
  one forward and one backward per slot, then the cool-down backwards.
  At most ``P - rank`` microbatches are in flight on a rank, whatever
  ``M`` is: the 1F1B memory property.
- **Interleaved** (``num_chunks`` = vpp > 1): rank s holds model chunks
  s, s + P, s + 2P, ...  Its k-th forward runs chunk ``(k // P) % vpp``
  on microbatch ``(k // (P·vpp))·P + k % P`` (the JAX package's
  mixed-radix slot ``u = g·V + v·P + r``, ``tick_schedule.py:132-160``),
  its k-th backward the same with the chunks reversed; the warm-up is
  ``(P - 1 - rank)·2 + (vpp - 1)·P`` forwards (all of them when M = P),
  as in the reference.  The ring's wrap (the last stage to the first) is
  the hop from chunk v to v + 1.
- **A unit** keeps its autograd graph until its backward (the layers'
  remat inside it saves only their inputs), where the JAX package
  recomputes the stage from the saved stage input: the values are the
  same.  A backward is ``torch.autograd.grad`` of the unit's output with
  the next stage's cotangent, or, on the last stage's last chunk, of
  the microbatch loss with the seed ``1 / M``, as the JAX package seeds
  its post vjp.  Each unit's parameter gradients are added into
  resident fp32 buffers in microbatch order (per chunk).
- **The loss** is the last stage's ``Σ_m loss_m / M``, summed over the
  pipeline group, so every stage returns it.

``pre_fn(shared, mb) -> x`` runs on the first stage's first chunk,
``stage_fn(chunk_params, x) -> y`` on every unit, ``post_fn(shared, y,
mb) -> loss`` on the last stage's last chunk.  ``stage_params`` leaves
are this rank's layers ``(vpp·lpc, ...)`` with chunk v at
``[v·lpc:(v+1)·lpc]`` (the stage-major layout of
:func:`apex_tpu_torch.models.gpt.params_to_vpp_layout`).  Shared grads
are returned as this rank's contributions (the embedding on the first
stage, the head on the last): the wrappers sum them over the pipeline
group.  Nothing reads a device value on the host, so a whole step
captures as one CUDA graph.
"""

from typing import Callable, List, Optional

import torch

from apex_tpu_torch.optimizers.tree import tree_leaves, tree_map, tree_unflatten
from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication as p2p

__all__ = ["pipelined_fwd_bwd", "interleaved_warmup", "chunk_and_microbatch",
           "check_interleaved_backend", "check_tp_backend"]

#: why the interleaved order is refused over NCCL
INTERLEAVED_NCCL_ITEM = ("the interleaved schedule over NCCL has not yet run to its end on "
                         "cards (ROADMAP.md section 3)")

#: why tp > 1 inside an NCCL pipeline is refused
TP_PP_NCCL_ITEM = ("tp > 1 with pp > 1 over NCCL gave NaN losses on four H100s "
                   "(ROADMAP.md section 3)")

#: groups a collective has already run over (their communicators exist)
_WARMED = set()


def _warm(group, device) -> None:
    """Run one all-reduce over the pipeline group the first time it is
    used: NCCL wants a group's first operation to involve every rank of
    it, which a stage-to-stage batch does not."""
    import torch.distributed as dist

    if group.group is None or id(group.group) in _WARMED:
        return
    dist.all_reduce(torch.zeros(1, device=device), group=group.group)
    _WARMED.add(id(group.group))


def _nccl(group) -> bool:
    import torch.distributed as dist

    return group.group is not None and dist.get_backend(group.group) == "nccl"


def check_interleaved_backend(group, vpp: int) -> None:
    """Refuse ``vpp`` > 1 over an NCCL pipeline group: its four-card runs
    stalled in the teardown (fixed by releasing the graphs first) and the
    fixed design has not yet ended a GPT-345M run on cards.  gloo runs
    it."""
    if vpp > 1 and _nccl(group):
        raise NotImplementedError(f"virtual_pipeline_size={vpp} over NCCL is refused: "
                                  f"{INTERLEAVED_NCCL_ITEM}")


def check_tp_backend(group, tp: int) -> None:
    """Refuse a pipeline over NCCL whose stages are split over ``tp`` > 1
    ranks: its only four-card run (tp 2 x pp 2, GPT-345M) trained on NaN
    from the first step.  gloo runs it."""
    if tp > 1 and _nccl(group):
        raise NotImplementedError(f"tensor_model_parallel_size={tp} inside a pipeline over "
                                  f"NCCL is refused: {TP_PP_NCCL_ITEM}")


def chunk_and_microbatch(k: int, P: int, vpp: int, forward: bool = True):
    """``(chunk, microbatch)`` of a rank's k-th forward (or backward) unit
    in the interleaved order (reference ``get_model_chunk_id``)."""
    in_group = k % (P * vpp)
    chunk = in_group // P
    if not forward:
        chunk = vpp - 1 - chunk
    return chunk, (k // (P * vpp)) * P + k % P


def interleaved_warmup(P: int, rank: int, vpp: int, M: int) -> int:
    """The interleaved schedule's warm-up forwards on ``rank`` (reference
    fwd_bwd_pipelining_with_interleaving.py: all of them when M = P)."""
    total = M * vpp
    if M == P:
        return total
    return min((P - rank - 1) * 2 + (vpp - 1) * P, total)


class _Units:
    """The forward and backward units of one rank, and what they keep."""

    def __init__(self, pre_fn, stage_fn, post_fn, shared_params, stage_params, microbatches,
                 vpp, P, rank, forward_only, log):
        self.pre_fn, self.stage_fn, self.post_fn = pre_fn, stage_fn, post_fn
        self.shared, self.stages, self.mbs = shared_params, stage_params, microbatches
        self.vpp, self.P, self.rank = vpp, P, rank
        self.forward_only = forward_only
        self.log = log
        self.M = tree_leaves(microbatches)[0].shape[0]
        self.inv_m = 1.0 / self.M
        self.shared_leaves = tree_leaves(shared_params)
        self.stage_leaves = tree_leaves(stage_params)
        n = self.stage_leaves[0].shape[0] if self.stage_leaves else 0
        if n % vpp:
            raise ValueError(f"{n} layers on this stage do not split into {vpp} chunks")
        self.lpc = n // vpp
        dev = self.shared_leaves[0].device
        self.loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        if not forward_only:
            self.g_shared = [torch.zeros_like(t, dtype=torch.float32)
                             for t in self.shared_leaves]
            self.g_stage = [torch.zeros_like(t, dtype=torch.float32)
                            for t in self.stage_leaves]
        # per chunk: the (input, output, chunk leaves) of units whose
        # backward has not run, oldest first
        self.pending: List[list] = [[] for _ in range(vpp)]
        self.live = 0

    def first(self, v):
        return self.rank == 0 and v == 0

    def last(self, v):
        return self.rank == self.P - 1 and v == self.vpp - 1

    def microbatch(self, m):
        return tree_map(lambda a: a[m], self.mbs)

    def forward(self, v: int, m: int, x_in):
        """Chunk ``v`` on microbatch ``m``: ``x_in`` is the received
        activation (None on the first chunk of the first stage).  Returns
        the activation to send on (None on the last chunk of the last
        stage, whose loss is added into the sum)."""
        if self.log is not None:
            self.log.append(("F", v, m))
        mb = self.microbatch(m)
        lo = v * self.lpc
        with torch.set_grad_enabled(not self.forward_only):
            chunk_leaves = [t[lo:lo + self.lpc] if self.vpp > 1 else t
                            for t in self.stage_leaves]
            chunk = tree_unflatten(self.stages, chunk_leaves)
            if x_in is not None and not self.forward_only:
                x_in = x_in.detach().requires_grad_(True)
            x = self.pre_fn(self.shared, mb) if self.first(v) else x_in
            y = self.stage_fn(chunk, x)
            out = self.post_fn(self.shared, y, mb) if self.last(v) else y
        if self.last(v):
            self.loss_sum = self.loss_sum + out.detach().to(torch.float32) * self.inv_m
        if not self.forward_only:
            self.pending[v].append((x_in, out, chunk_leaves))
            self.live += 1
        return None if self.last(v) else y.detach()

    def backward(self, v: int, m: int, dy):
        """The backward of chunk ``v``'s oldest pending unit (microbatch
        ``m``) with the cotangent ``dy`` (None on the last chunk of the
        last stage: the seed ``1 / M``).  Returns the input's cotangent to
        send back (None on the first chunk of the first stage)."""
        if self.log is not None:
            self.log.append(("B", v, m, self.live))
        x_in, out, chunk_leaves = self.pending[v].pop(0)
        self.live -= 1
        if dy is None:
            dy = torch.full_like(out, self.inv_m)
        inputs = ([x_in] if x_in is not None else []) + chunk_leaves + self.shared_leaves
        grads = torch.autograd.grad(out, inputs, grad_outputs=dy, allow_unused=True)
        dx = grads[0] if x_in is not None else None
        grads = grads[1:] if x_in is not None else grads
        nst = len(chunk_leaves)
        lo = v * self.lpc
        with torch.no_grad():
            for acc, g in zip(self.g_stage, grads[:nst]):
                if g is not None:
                    (acc[lo:lo + self.lpc] if self.vpp > 1 else acc).add_(g)
            for acc, g in zip(self.g_shared, grads[nst:]):
                if g is not None:
                    acc.add_(g)
        return dx


def _one_f_one_b(u: _Units, spec):
    """The 1F1B order (reference
    fwd_bwd_pipelining_without_interleaving.py:344-436)."""
    P, rank, M = u.P, u.rank, u.M
    first, last = rank == 0, rank == P - 1
    warmup = M if u.forward_only else min(P - rank - 1, M)
    remaining = M - warmup

    def recv_forward():
        return None if first else p2p.recv_forward(*spec)

    def send_forward(y):
        if not last:
            p2p.send_forward(y, spec[-1])

    for m in range(warmup):
        send_forward(u.forward(0, m, recv_forward()))
    x = recv_forward() if remaining > 0 else None
    for i in range(remaining):
        m_f, m_b = warmup + i, i
        y = u.forward(0, m_f, x)
        dy = None if last else p2p.send_forward_recv_backward(y, spec[-1])
        dx = u.backward(0, m_b, dy)
        if i == remaining - 1:
            x = None
            if not first:
                p2p.send_backward(dx, spec[-1])
        else:
            x = None if first else p2p.send_backward_recv_forward(dx, spec[-1])
    if u.forward_only:
        return
    for m_b in range(remaining, M):
        dy = None if last else p2p.recv_backward(*spec)
        dx = u.backward(0, m_b, dy)
        if not first:
            p2p.send_backward(dx, spec[-1])


def _interleaved(u: _Units, spec):
    """The interleaved order (reference
    fwd_bwd_pipelining_with_interleaving.py:27): ``spec`` is ``(shape,
    dtype, device, group)`` of a message."""
    P, rank, vpp, M = u.P, u.rank, u.vpp, u.M
    if M % P:
        raise ValueError(f"the interleaved schedule needs the microbatches ({M}) to be a "
                         f"multiple of pp ({P})")
    total = M * vpp
    warmup = total if u.forward_only else interleaved_warmup(P, rank, vpp, M)
    all_warmup = not u.forward_only and warmup == total
    remaining = total - warmup
    first_rank, last_rank = rank == 0, rank == P - 1
    shape, dtype, device, group = spec
    inputs = [[] for _ in range(vpp)]     # received activations, per chunk
    grads_in = [[] for _ in range(vpp)]   # received cotangents, per chunk

    def exchange(y, dx, recv_prev, recv_next):
        return p2p.send_forward_backward_recv_forward_backward(
            y, dx, recv_prev, recv_next, shape, dtype, device, group)

    def fwd(k):
        v, m = chunk_and_microbatch(k, P, vpp, True)
        x = None if u.first(v) else inputs[v].pop(0)
        return u.forward(v, m, x)

    def bwd(k):
        v, m = chunk_and_microbatch(k, P, vpp, False)
        dy = None if u.last(v) else grads_in[v].pop(0)
        dx = u.backward(v, m, dy)
        return None if u.first(v) else dx

    if not first_rank:
        inputs[0].append(p2p.recv_forward(shape, dtype, device, group))
    for k in range(warmup):
        y = fwd(k)
        nxt = chunk_and_microbatch(k + 1, P, vpp, True)[0]
        recv_prev = not (first_rank and nxt == 0) and k != total - 1
        if k == warmup - 1 and not u.forward_only and not all_warmup:
            x, g = exchange(y, None, recv_prev, not last_rank)
            if g is not None:
                grads_in[vpp - 1].append(g)
        else:
            x = p2p.send_forward_recv_forward(y, recv_prev, shape, dtype, device, group)
        if x is not None:
            inputs[nxt].append(x)
    for k in range(remaining):
        k_f = k + warmup
        y = fwd(k_f)
        dx = bwd(k)
        recv_prev = True
        if first_rank:
            nxt_f = chunk_and_microbatch(k_f - (P - 1), P, vpp, True)[0]
            if nxt_f == vpp - 1:
                recv_prev = False
            nxt_f += 1
        else:
            nxt_f = chunk_and_microbatch(k_f + 1, P, vpp, True)[0]
        recv_next = True
        if last_rank:
            nxt_b = chunk_and_microbatch(k - (P - 1), P, vpp, False)[0]
            if nxt_b == 0:
                recv_next = False
            nxt_b -= 1
        else:
            nxt_b = chunk_and_microbatch(k + 1, P, vpp, False)[0]
        if k == remaining - 1:
            recv_prev = False
        x, g = exchange(y, dx, recv_prev, recv_next)
        if recv_prev:
            inputs[nxt_f].append(x)
        if recv_next:
            grads_in[nxt_b].append(g)
    if u.forward_only:
        return
    if all_warmup:
        grads_in[vpp - 1].append(
            None if last_rank else p2p.recv_backward(shape, dtype, device, group))
    for k in range(remaining, total):
        dx = bwd(k)
        nxt_b = chunk_and_microbatch(k + 1, P, vpp, False)[0]
        recv_next = not (last_rank and nxt_b == vpp - 1) and k != total - 1
        g = p2p.send_backward_recv_backward(dx, recv_next, shape, dtype, device, group)
        if recv_next:
            grads_in[nxt_b].append(g)


def pipelined_fwd_bwd(pre_fn: Callable, stage_fn: Callable, post_fn: Callable, shared_params,
                      stage_params, microbatches, *, tensor_shape, dtype, num_chunks: int = 1,
                      axis_name=None, forward_only: bool = False,
                      schedule_log: Optional[list] = None):
    """One pipelined forward and backward over this rank's stage (see the
    module docstring).  ``microbatches`` is a tree whose leaves lead with
    the microbatch index ``(M, ...)``; ``tensor_shape`` and ``dtype`` are
    those of a stage's activation (what ``pre_fn`` returns).
    ``axis_name``: the pipeline's ``AxisGroup`` (by default the
    registered one).  ``schedule_log``, a list, receives ``("F", chunk, mb)`` and
    ``("B", chunk, mb, units in flight)`` in the order they ran.

    Returns ``(loss, (shared_grads, stage_grads))``: the loss on every
    rank of the group; shared grads this rank's contributions (sum them
    over the group), stage grads this rank's layers, trees shaped like
    the params.  With ``forward_only`` the grads are None."""
    group = p2p._group(axis_name)
    P, rank = group.size(), group.rank()
    vpp = int(num_chunks)
    if vpp < 1 or (vpp > 1 and P < 2):
        raise ValueError(f"num_chunks={vpp}: the interleaved schedule needs pp >= 2 "
                         f"(pp is {P})")
    check_interleaved_backend(group, vpp)
    u = _Units(pre_fn, stage_fn, post_fn, shared_params, stage_params, microbatches, vpp,
               P, rank, forward_only, schedule_log)
    device = u.loss_sum.device
    _warm(group, device)
    spec = (tuple(tensor_shape), dtype, device, group)
    if vpp == 1:
        _one_f_one_b(u, spec)
    else:
        _interleaved(u, spec)
    loss = u.loss_sum
    if P > 1:
        import torch.distributed as dist

        dist.all_reduce(loss, group=group.group)
    if forward_only:
        return loss, None
    return loss, (tree_unflatten(shared_params, u.g_shared),
                  tree_unflatten(stage_params, u.g_stage))
