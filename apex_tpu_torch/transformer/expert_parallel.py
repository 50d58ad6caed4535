"""Expert parallelism: the mixture-of-experts FFN over a process group
(counterpart of :mod:`apex_tpu.transformer.expert_parallel`).

GShard/Switch style, as the JAX package builds it:

- a top-k router with capacity-factor token dropping (slot priority is
  GShard's: every slot-0 assignment claims capacity before any slot-1
  one), every shape static;
- experts split over a process group (``ep_group``, the data-parallel
  group: "expert parallelism rides data parallelism"): tokens travel to
  their expert's rank and back with two ``all_to_all`` exchanges, and
  the experts run as batched matmuls;
- the auxiliary load-balancing loss (Switch Transformer eq. 4).

Where the JAX package dispatches and combines with one-hot ``(T, E, C)``
einsums, the port moves rows by index, which computes the same values
at a fraction of the cost (at GPT-124M, T 8192, E 8, C 2560, each
one-hot tensor is 168 M elements): dispatch copies each kept token's row
into its (expert, slot) row, exactly as the one-hot einsum does with
fp32 accumulation, and combine sums a token's k products of its weight
(rounded to the compute dtype, as ``combine.astype(cd)`` rounds it) and
its expert's output in fp32, rounded once.  Both are autograd Functions
whose writes go to unique rows -- the forward a gather through the
slot's owner, the backward a gather and a k-term sum in slot order -- so
they are deterministic and a graphed step replays bitwise.  A dropped
assignment points at one extra zero row.

Expert weights are split, not replicated, over ``ep_group``: each rank
computes whole gradients for its own experts (the exchange brings every
token routed to them), so the data-parallel grad sync must skip them
(:func:`is_expert_param`) and scale them by 1 / dp instead.
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["EXPERT_PARAM_KEYS", "is_expert_param", "moe_init", "moe_ffn",
           "load_balancing_loss", "moe_param_specs"]

#: the leaves split over the expert group (the router is replicated)
EXPERT_PARAM_KEYS = ("w1", "b1", "w2", "b2")

#: ``all_to_all`` exchanges issued (forward and backward), counted where
#: they are issued; a captured step adds its capture's count a replay
A2A_LAUNCHES = 0


def moe_init(generator: torch.Generator, hidden_size: int, ffn_size: int, num_experts: int,
             layers: Optional[int] = None, std: float = 0.02):
    """Router and expert FFN params (fp32, on ``generator``'s device), the
    JAX ``moe_init``'s tree and scales (``w2`` divided by sqrt 2), drawn
    from ``generator``; with ``layers`` a leading L dim."""
    ld = () if layers is None else (layers,)
    dev = generator.device

    def init(*s):
        return torch.randn(ld + s, generator=generator, dtype=torch.float32, device=dev) * std

    return {
        "router": init(hidden_size, num_experts),
        "w1": init(num_experts, ffn_size, hidden_size),
        "b1": torch.zeros(ld + (num_experts, ffn_size), device=dev),
        "w2": init(num_experts, hidden_size, ffn_size) / np.sqrt(2.0),
        "b2": torch.zeros(ld + (num_experts, hidden_size), device=dev),
    }


def is_expert_param(path_keys) -> bool:
    """True for a leaf split over the expert group: a path (its keys, as
    strings) through ``moe`` (or ``experts``) to one of
    :data:`EXPERT_PARAM_KEYS`."""
    names = [str(getattr(p, "key", p)) for p in path_keys]
    return any(n in EXPERT_PARAM_KEYS for n in names) and any(
        n in ("moe", "experts") for n in names)


def moe_param_specs(layers: bool = True):
    """Each leaf's split, as the JAX ``moe_param_specs`` with the expert
    axis named ``"ep"``: the experts' dim split over ``"ep"``, the router
    replicated (the entries of ``models.gpt.PartitionSpec``, as tuples)."""
    ld = (None,) if layers else ()
    return {"router": ld + (None, None), "w1": ld + ("ep", None, None), "b1": ld + ("ep", None),
            "w2": ld + ("ep", None, None), "b2": ld + ("ep", None)}


class _Route:
    """A static-shape top-k routing of T tokens over E experts of C slots:
    ``expert`` / ``pos`` / ``keep`` (K, T) of each (slot, token)
    assignment, ``dest`` its row of the (E·C) dispatch buffer (E·C when
    dropped: the extra zero row), ``owner`` (E·C) the assignment ``k·T +
    t`` holding each row (K·T when empty) and ``src`` its token (T when
    empty), ``weights`` (K, T) the gate weights of every assignment
    (dropped ones included: they stay in top-k's normaliser) and ``mask1``
    (T, E) the top-1 one-hot."""

    def __init__(self, probs, top_k: int, capacity: int):
        T, E = probs.shape
        K, C, N = top_k, capacity, E * capacity
        experts_ids = torch.arange(E, device=probs.device)
        p = probs
        experts, masks = [], []
        for _ in range(K):
            idx = torch.argmax(p, dim=-1)
            m = (idx[:, None] == experts_ids).to(probs.dtype)  # one-hot, no host check
            experts.append(idx)
            masks.append(m)
            p = p * (1.0 - m)  # knock out the chosen expert for the next slot
        self.expert = torch.stack(experts)  # (K, T)
        # slot-major capacity count, one row an expert: the scan runs along
        # the last (contiguous) dim, a parallel scan on the card
        flat = self.expert.reshape(1, -1)
        onehot = (experts_ids[:, None] == flat).to(torch.int32)  # (E, K·T)
        ahead = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot  # ahead of mine
        self.pos = ahead.gather(0, flat).reshape(K, T).long()
        self.keep = self.pos < C
        self.dest = torch.where(self.keep, self.expert * C + self.pos, N)
        owner = torch.full((N + 1,), K * T, dtype=torch.long, device=probs.device)
        owner.scatter_(0, self.dest.reshape(-1),
                       torch.arange(K * T, device=probs.device))
        self.owner = owner[:N]  # row N (every dropped one's) is thrown away
        self.src = torch.where(self.owner < K * T, self.owner % T, T)
        gate = probs.gather(1, self.expert.T).T  # (K, T): the chosen probs
        if K == 1:
            # Switch Transformer: the raw router prob, which carries the
            # router's gradient through the output path
            self.weights = gate
        else:
            # GShard: renormalised over the chosen experts
            total = gate[0]
            for k in range(1, K):
                total = total + gate[k]
            self.weights = gate / torch.clamp_min(total, 1e-9)
        self.mask1 = masks[0]
        self.T, self.E, self.C, self.K = T, E, C, K


def _top_k_mask(probs, top_k: int, capacity: int):
    """The JAX ``_top_k_mask`` in its dense form: ``(dispatch (T, E, C)
    one-hot, combine (T, E, C) gate-weighted, mask1 (T, E))``, built from
    the index routing the layer uses (for tests and inspection; the layer
    itself never builds the (T, E, C) tensors)."""
    r = _Route(probs, top_k, capacity)
    T, E, C, K = r.T, r.E, r.C, r.K
    flat = torch.zeros(T, E * C + 1, dtype=probs.dtype, device=probs.device)
    tok = torch.arange(T, device=probs.device)
    weights = torch.zeros(T, E * C + 1, dtype=probs.dtype, device=probs.device)
    for k in range(K):
        flat[tok, r.dest[k]] = 1.0
        weights[tok, r.dest[k]] = r.weights[k]
    dispatch = flat[:, :E * C].reshape(T, E, C)
    combine = dispatch * weights[:, :E * C].reshape(T, E, C)
    return dispatch, combine, r.mask1


def load_balancing_loss(probs, mask1):
    """Switch Transformer's aux loss: E · Σ_e f_e · P_e (eq. 4), f the
    fraction of tokens whose top-1 is e, P the mean router prob."""
    E = probs.shape[-1]
    f = mask1.mean(dim=0)
    P = probs.mean(dim=0)
    return E * torch.sum(f * P)


def _rows(t, index, valid):
    """``t``'s rows at ``index`` (any shape), zero where not ``valid``
    (an index past ``t``'s rows: an empty slot or a dropped assignment):
    one gather and one fill in place, no padded copy of ``t``."""
    out = t.index_select(0, index.reshape(-1).clamp(max=t.shape[0] - 1))
    out.masked_fill_(~valid.reshape(-1, 1), 0)
    return out.reshape(tuple(index.shape) + tuple(t.shape[1:]))


class _Dispatch(torch.autograd.Function):
    """x (T, H) -> the dispatch buffer (E·C, H): row s is x[src[s]] (a
    zero row when empty).  Backward: dx[t] = the sum over slots k of the
    buffer's cotangent at dest[k, t] (zero when dropped), in fp32 in slot
    order, rounded once."""

    @staticmethod
    def forward(ctx, x, src, dest):
        ctx.save_for_backward(dest)
        return _rows(x, src, src < x.shape[0])

    @staticmethod
    def backward(ctx, g):
        (dest,) = ctx.saved_tensors
        rows = _rows(g, dest, dest < g.shape[0])  # (K, T, H)
        if rows.shape[0] == 1:
            return rows[0], None, None
        return rows.sum(0, dtype=torch.float32).to(g.dtype), None, None


class _Combine(torch.autograd.Function):
    """The expert outputs y (E·C, H) and the rounded weights w (K, T) ->
    out (T, H): out[t] = Σ_k w[k, t] · y[dest[k, t]] in fp32 (a dropped
    assignment reads a zero row), rounded once to y's dtype.
    Backward: dy[s] = w · dout of the row's owner (zero when empty), dw[k,
    t] = <dout[t], y[dest[k, t]]>, each rounded once to its dtype."""

    @staticmethod
    def forward(ctx, y, w, dest, owner, src):
        ctx.save_for_backward(y, w, dest, owner, src)
        rows = _rows(y, dest, dest < y.shape[0])  # (K, T, H)
        return (rows.float() * w.float()[..., None]).sum(0).to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        y, w, dest, owner, src = ctx.saved_tensors
        owned = src < g.shape[0]
        w_own = _rows(w.reshape(-1, 1), owner, owned)  # (E·C, 1)
        dy = (_rows(g, src, owned).float() * w_own.float()).to(y.dtype)
        rows = _rows(y, dest, dest < y.shape[0])  # (K, T, H)
        dw = (rows.float() * g.float()).sum(-1).to(w.dtype)
        return dy, dw, None, None, None


def _all_to_all(t, group):
    """One ``all_to_all_single`` of ``t`` (split on dim 0 into one block a
    rank) over ``group``: block i of the result came from rank i."""
    import torch.distributed as dist

    global A2A_LAUNCHES
    t = t.contiguous()
    out = torch.empty_like(t)
    A2A_LAUNCHES += 1
    dist.all_to_all_single(out, t, group=group.group)
    return out


def _to_experts(x, group):
    """(E, C, H) -> (E / ep, ep·C, H): expert-major blocks go to their
    owners, the received capacity blocks stack source-major (the JAX
    ``all_to_all(split_axis=0, concat_axis=1, tiled=True)``)."""
    ep = group.size()
    E, C, H = x.shape
    got = _all_to_all(x, group).reshape(ep, E // ep, C, H)
    return got.transpose(0, 1).reshape(E // ep, ep * C, H)


def _from_experts(y, group):
    """(E / ep, ep·C, H) -> (E, C, H): the exact inverse of
    :func:`_to_experts`."""
    ep = group.size()
    El, epC, H = y.shape
    blocks = y.reshape(El, ep, epC // ep, H).transpose(0, 1)
    return _all_to_all(blocks, group).reshape(ep * El, epC // ep, H)


class _Exchange(torch.autograd.Function):
    """:func:`_to_experts` (``to_experts``) or :func:`_from_experts`, the
    other one its backward."""

    @staticmethod
    def forward(ctx, x, group, to_experts):
        ctx.group, ctx.to_experts = group, to_experts
        return (_to_experts if to_experts else _from_experts)(x, group)

    @staticmethod
    def backward(ctx, g):
        return (_from_experts if ctx.to_experts else _to_experts)(g, ctx.group), None, None


def capacity_of(tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots an expert takes: ``ceil(top_k · capacity_factor · T / E)``,
    at least one (the JAX package's expression)."""
    return max(1, int(np.ceil(top_k * capacity_factor * tokens / num_experts)))


def moe_ffn(x, params, *, top_k: int = 2, capacity_factor: float = 1.25, ep_group=None):
    """The MoE FFN on ``x`` (..., H), its leading dims flattened to tokens:
    the JAX ``moe_ffn``.  Returns ``(out, aux_loss)`` (out in x's dtype,
    aux fp32).

    The router's logits and softmax run in fp32, the experts in x's
    dtype (weights cast at use).  With ``ep_group`` (an ``AxisGroup`` of
    more than one rank) ``params`` hold this rank's E / ep experts and
    the tokens exchange over the group; the capacity is computed from
    the local T.  The experts' activation is the tanh GELU."""
    if ep_group is not None and ep_group.size() == 1:
        ep_group = None
    shape = x.shape
    H = shape[-1]
    xf = x.reshape(-1, H)
    T = xf.shape[0]
    ep = 1 if ep_group is None else ep_group.size()
    E = params["w1"].shape[0] * ep

    logits = torch.matmul(xf.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    route = _Route(probs, top_k, capacity_of(T, E, top_k, capacity_factor))
    aux = load_balancing_loss(probs, route.mask1)

    cd = x.dtype
    expert_in = _Dispatch.apply(xf, route.src, route.dest).reshape(E, route.C, H)
    if ep_group is not None:
        expert_in = _Exchange.apply(expert_in, ep_group, True)
    h = torch.matmul(expert_in, params["w1"].transpose(-1, -2).to(cd))
    h = F.gelu(h + params["b1"].to(cd)[:, None, :], approximate="tanh")
    y = torch.matmul(h, params["w2"].transpose(-1, -2).to(cd))
    y = y + params["b2"].to(cd)[:, None, :]
    if ep_group is not None:
        y = _Exchange.apply(y, ep_group, False)
    w = (route.weights * route.keep).to(cd)
    out = _Combine.apply(y.reshape(E * route.C, H), w, route.dest, route.owner, route.src)
    return out.reshape(shape), aux.float()
