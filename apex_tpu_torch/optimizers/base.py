"""Shared machinery for the fused optimizers (counterpart of
:mod:`apex_tpu.optimizers.base`).

Each optimizer is a pure function over a tree of tensors (nested dicts,
lists or tuples; :mod:`apex_tpu_torch.optimizers.tree`), as in the JAX
package: ``init`` builds the state and ``update(grads, state, params)``
returns new params and a new state, modifying nothing it was given.
``update(..., inplace=True)`` (and ``update_scaled``) is the donated
form the train step uses, the counterpart of ``jax.jit(...,
donate_argnums=...)``: the new values are written into the params and
state tensors given, which are returned.  FusedAdam's engine path has
its kernel write them directly (``mt_adam`` reads each element before
it writes it, so its outputs may alias its inputs); every other path
computes as before and copies the results in (:func:`write_into`).
The math is fp32 whatever the storage dtype, with an optional fp32
master copy (``master_weights``), and the commit can be predicated on a
device-resident ``grads_finite`` flag (the capturable noop-flag design):
nothing is read back to the host, so a step can be captured as a CUDA
graph.

**Two paths, chosen by ``use_buckets`` and the state alone.**
``use_buckets=True`` (the default, as in the JAX package) runs the
multi-tensor engine: :meth:`OptimizerBase._dispatch` makes one prepare
pass (:func:`prepare_grads_bucketed`: the loss-scale unscale, the
finite vote and the clip's global norm, through the ``mt_scale`` and
``mt_l2norm`` kernels) and hands it to ``_bucket_update``.
FusedAdam's update is the ``mt_adam`` kernel, which reads every leaf
where it lies; the other optimizers evaluate the JAX package's bucket
expressions as PyTorch ops over the bucket buffers
(:mod:`~apex_tpu_torch.optimizers.bucketing`), their per-leaf norms on
``mt_l2norm``.  State given as :class:`~bucketing.Buckets`
(``init(params, bucketed=True)``) always takes the engine.
``use_buckets=False`` runs the per-leaf path: one elementwise expression
a leaf in plain tensor ops, the numerics specification.  In fp32 the
two agree bitwise wherever the JAX package pins it (Adam, SGD, Adagrad).

The port routes straight to one path or the other and never degrades
from the engine to the per-leaf path: the JAX package's
``resilience.fallback`` registry has no counterpart here.  Both paths
offer the step's grad norm to the telemetry seam
(:mod:`apex_tpu_torch.observability.stepstats`): the clip's global norm
when there is a clip, else one ``mt_l2norm`` pass over the grads, only
while a telemetry wrapper captures.
"""

from typing import Any, NamedTuple, Optional

import torch

from apex_tpu_torch.observability import stepstats as _stepstats
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers import bucketing
from apex_tpu_torch.optimizers.tree import leaves_with_path, tree_leaves, tree_map, tree_unflatten

Tree = Any

__all__ = [
    "tree_map", "tree_leaves", "tree_unflatten", "make_master", "math_params",
    "emit_params", "predicate_step", "select", "bias_corrections", "HyperLeaf",
    "leaf_hypers", "leaf_lr", "PreparedGrads", "prepare_grads_bucketed", "OptimizerBase",
    "bucket_select", "write_into",
]


def write_into(dst, src):
    """Copy every tensor of the tree ``src`` into the same-placed tensor
    of ``dst`` (``graphs.tensor_leaves`` order; a tensor that is already
    the destination is skipped) and return ``dst``: the in-place commit
    of a path that computed new tensors."""
    from apex_tpu_torch.graphs import tensor_leaves

    with torch.no_grad():
        for d, s in zip(tensor_leaves(dst), tensor_leaves(src), strict=True):
            if d is not s:
                d.copy_(s)
    return dst


def make_master(params: Tree, master_weights: bool) -> Optional[Tree]:
    """fp32 master COPY of the params (never aliasing an fp32 param)."""
    if not master_weights:
        return None
    return tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)


def math_params(params: Tree, master: Optional[Tree]) -> Tree:
    """The tree the optimizer math reads (the master if present)."""
    return master if master is not None else params


def emit_params(new_math_params: Tree, params: Tree, master: Optional[Tree]):
    """Return ``(new params in their storage dtype, new master)``."""
    new_params = tree_map(lambda n, p: n.to(p.dtype), new_math_params, params)
    return new_params, (None if master is None else new_math_params)


def _pred_tensor(grads_finite, device) -> torch.Tensor:
    return torch.as_tensor(grads_finite, device=device).to(torch.bool).reshape(())


def predicate_step(grads_finite, step: torch.Tensor) -> torch.Tensor:
    """The step advances only on finite grads."""
    if grads_finite is None:
        return step + 1
    return step + _pred_tensor(grads_finite, step.device).to(step.dtype)


def select(grads_finite, new: Tree, old: Tree) -> Tree:
    """Predicated commit: keep the old values on overflow."""
    if grads_finite is None:
        return new
    return tree_map(lambda n, o: torch.where(_pred_tensor(grads_finite, n.device), n,
                                             o.to(n.dtype)), new, old)


def bias_corrections(step, bias_correction: bool, beta1, beta2):
    """Adam-family ``(1 - beta1**t, 1 - beta2**t)`` in fp32, on the
    step's device."""
    if not bias_correction:
        one = torch.ones((), dtype=torch.float32, device=step.device)
        return one, one
    t = step.to(torch.float32)
    return 1.0 - torch.pow(beta1, t), 1.0 - torch.pow(beta2, t)


class HyperLeaf(dict):
    """A dict of per-leaf overrides that trees treat as a leaf."""

    tree_leaf = True


#: override keys every optimizer understands
_BASE_HYPER_KEYS = frozenset({"lr", "lr_scale", "weight_decay"})


def leaf_hypers(params: Tree, param_group_fn, group_hypers, extra_keys=()) -> Tree:
    """Per-leaf hyperparameter overrides, the functional form of torch
    ``param_groups``: ``param_group_fn(path, leaf) -> group name`` (the
    path as ``jax.tree_util.keystr`` writes it), ``group_hypers[name]``
    a dict of overrides (``lr`` absolute, ``lr_scale`` a factor on the
    runtime lr, ``weight_decay``, and the optimizer's ``extra_keys``).
    Returns a tree of :class:`HyperLeaf` shaped like ``params`` (empty
    ones without grouping).  Raises on an override key the optimizer
    does not read, on ``group_hypers`` without ``param_group_fn``, and
    on a group no param maps to."""
    allowed = _BASE_HYPER_KEYS | set(extra_keys)
    for gname, overrides in (group_hypers or {}).items():
        unknown = set(overrides) - allowed
        if unknown:
            raise ValueError(
                f"group_hypers[{gname!r}] has unknown override keys "
                f"{sorted(unknown)}; this optimizer supports {sorted(allowed)}")
    if param_group_fn is None:
        if group_hypers:
            raise ValueError(
                "group_hypers given without param_group_fn — no param can "
                "map to any group, so the overrides would be silently ignored")
        return tree_map(lambda _: HyperLeaf(), params)
    group_hypers = group_hypers or {}
    seen = set()
    out = []
    for path, leaf in leaves_with_path(params):
        g = param_group_fn(path, leaf)
        seen.add(g)
        out.append(HyperLeaf(group_hypers.get(g, {})))
    unused = set(group_hypers) - seen
    if unused:
        raise ValueError(f"group_hypers keys {sorted(unused)} match no param group "
                         f"(param_group_fn produced {sorted(seen)})")
    return tree_unflatten(params, out)


def leaf_lr(h: dict, lr):
    """A leaf's lr: the absolute ``lr`` override, else the runtime lr
    times ``lr_scale``."""
    if "lr" in h:
        return h["lr"]
    return lr * h.get("lr_scale", 1.0)


class PreparedGrads(NamedTuple):
    """The grads after the prepare pass.  ``leaves``: what the kernels
    read, in leaf order (the grads as given, or views of ``g`` when the
    pass wrote fp32 buckets); ``g``: those fp32 buckets, or None;
    ``finite``: the (synced) all-finite vote or None; ``coef``: the
    clip coefficient (a 0-d fp32 tensor) not yet applied, or None."""

    plan: Any
    leaves: tuple
    g: Optional[tuple]
    finite: Optional[torch.Tensor]
    coef: Optional[torch.Tensor]

    def buckets(self):
        """The grads as fp32 buckets of ``plan`` with the clip applied
        (the JAX package's ``PreparedGrads.g``), for the optimizers whose
        bucket math is tensor ops."""
        g = self.g if self.g is not None else bucketing.pack(
            self.plan, self.plan.treedef.unflatten(self.leaves))
        return tuple(g) if self.coef is None else tuple(a * self.coef for a in g)


def _clip_coef(total_norm, clip_norm):
    """torch ``clip_grad_norm_`` semantics: ``min(clip_norm /
    (total_norm + 1e-6), 1)``, in fp32 on the device."""
    max_t = torch.full((), float(clip_norm), dtype=torch.float32, device=total_norm.device)
    return torch.clamp(torch.div(max_t, total_norm + 1e-6), max=1.0)


def _mult(scale, prescale):
    """The grad multiplier ``1/scale * prescale`` (None for none): a
    Python product in double, or a device tensor."""
    mult = None
    if scale is not None:
        mult = (torch.div(torch.ones((), dtype=torch.float32, device=scale.device), scale)
                if isinstance(scale, torch.Tensor) else 1.0 / scale)
    if prescale is not None:
        mult = prescale if mult is None else mult * prescale
    return mult


def prepare_grads_bucketed(params, grads, scale=None, clip_norm=None, finite_sync=None,
                           want_finite=False, prescale=None, sumsq_reduce=None) -> PreparedGrads:
    """The engine's prepare pass: one read of the grads gives the
    unscaled (``1/scale``, times ``prescale``) fp32 grad buckets and the
    all-finite vote over them (``mt_scale``), skipped when there is
    nothing to scale or vote; then the clip's global norm (``mt_l2norm``
    over the per-leaf grads; ``sumsq_reduce(per_leaf_sumsq)`` overrides
    the plain sum) and its coefficient, which the update multiplies in.
    ``finite_sync`` agrees the vote (a model-parallel reduction)."""
    plan = bucketing.plan_of(params)
    leaves = tree_leaves(grads)
    if len(leaves) != plan.n_leaves:
        raise ValueError(f"grads have {len(leaves)} leaves; the params {plan.n_leaves}")
    mult = _mult(scale, prescale)
    finite = None
    g = None
    if want_finite or not (mult is None or (isinstance(mult, float) and mult == 1.0)):
        out = bucketing.new_buckets(plan, leaves[0].device)
        views = out.leaf_views()
        found = mt.mt_scale(leaves, views, 1.0 if mult is None else mult)
        leaves, g = views, out.arrays
        if want_finite:
            finite = torch.logical_not(found)
            if finite_sync is not None:
                finite = finite_sync(finite)
    coef = None
    if clip_norm is not None:
        total_sq, per = mt.mt_l2norm(leaves)
        if sumsq_reduce is not None:
            total_sq = sumsq_reduce(list(per.unbind(0)))
        # the telemetry seam reuses the clip's (agreed) norm
        _stepstats.offer("grad_norm", torch.sqrt(total_sq))
        coef = _clip_coef(torch.sqrt(total_sq), clip_norm)
    else:
        _stepstats.offer_local_grad_norm(leaves)
    return PreparedGrads(plan=plan, leaves=tuple(leaves), g=g, finite=finite, coef=coef)


class OptimizerBase:
    """Constructor plumbing and the dispatch.  Subclasses implement
    ``init``, ``_leaf_update`` (the per-leaf numerics specification) and
    ``_bucket_update`` (the engine)."""

    #: state field holding the slot that is a :class:`bucketing.Buckets`
    #: when the state is bucket-resident (subclasses override)
    _BUCKET_SLOT: Optional[str] = None

    #: True when :meth:`update_scaled` covers the optimizer's whole step
    supports_update_scaled: bool = True
    #: ``update(..., inplace=True)`` writes into the given params and state
    supports_inplace: bool = True
    #: ``_bucket_update`` takes ``inplace`` and writes the outputs itself
    _NATIVE_INPLACE: bool = False

    def __init__(self, lr: float, weight_decay: float = 0.0,
                 master_weights: bool = False, use_buckets: bool = True):
        self.lr = lr
        self.weight_decay = weight_decay
        self.master_weights = master_weights
        self.use_buckets = use_buckets

    # ------------------------------------------------------------ engine
    def _state_is_bucketed(self, state) -> bool:
        if self._BUCKET_SLOT is None:
            return False
        return isinstance(getattr(state, self._BUCKET_SLOT, None), bucketing.Buckets)

    def _leaf_update(self, grads, state, params, grads_finite=None,
                     lr=None, **kw):  # pragma: no cover - abstract
        raise NotImplementedError

    def _bucket_update(self, prep: PreparedGrads, state, params, pred,
                       lr=None, **kw):  # pragma: no cover - abstract
        raise NotImplementedError

    def _dispatch(self, grads, state, params, grads_finite=None, lr=None, scale=None,
                  clip_norm=None, finite_sync=None, want_finite=False, prescale=None,
                  sumsq_reduce=None, inplace=False, **kw):
        """Route one step: bucket-resident state or ``use_buckets`` to
        the engine, else the per-leaf path.  Returns ``(new_params,
        new_state, finite)``; with ``inplace`` the given ``params`` and
        ``state``, written over."""
        with torch.no_grad():
            if self._state_is_bucketed(state) or (self.use_buckets
                                                  and self._BUCKET_SLOT is not None):
                prep = prepare_grads_bucketed(
                    params, grads, scale=scale, clip_norm=clip_norm,
                    finite_sync=finite_sync, want_finite=want_finite, prescale=prescale,
                    sumsq_reduce=sumsq_reduce)
                pred = prep.finite if want_finite else grads_finite
                if inplace and self._NATIVE_INPLACE:
                    kw["inplace"] = True
                p, s = self._bucket_update(prep, state, params, pred, lr=lr, **kw)
            else:
                p, s, pred = self._leaf_path(grads, state, params, grads_finite, lr, scale,
                                             clip_norm, finite_sync, want_finite, prescale,
                                             sumsq_reduce, **kw)
            if inplace:
                p, s = write_into(params, p), write_into(state, s)
            return p, s, pred

    def _leaf_path(self, grads, state, params, grads_finite, lr, scale, clip_norm,
                   finite_sync, want_finite, prescale, sumsq_reduce, **kw):
        """The per-leaf path with the same prepare steps as plain ops."""
        g, finite = grads, grads_finite
        mult = _mult(scale, prescale)
        if mult is not None:
            g = tree_map(lambda x: x.to(torch.float32) * mult, g)
        if want_finite:
            finite = mt.all_finite(g)
            if finite_sync is not None:
                finite = finite_sync(finite)
        if clip_norm is not None:
            sq = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(g)]
            total_sq = torch.stack(sq).sum() if sumsq_reduce is None else sumsq_reduce(sq)
            _stepstats.offer("grad_norm", torch.sqrt(total_sq))
            coef = _clip_coef(torch.sqrt(total_sq), clip_norm)
            g = tree_map(lambda x: x.to(torch.float32) * coef, g)
        else:
            _stepstats.offer_local_grad_norm(tree_leaves(g))
        p, s = self._leaf_update(g, state, params, grads_finite=finite, lr=lr, **kw)
        return p, s, finite

    def _init_bucket_slots(self, params, n_slots):
        """The resident state: ``n_slots`` zeroed fp32 bucket slots of
        ``params``' plan, and the packed fp32 master with
        ``master_weights``."""
        plan = bucketing.plan_of(params)
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        slots = [bucketing.Buckets(plan, [torch.zeros(b.total, dtype=torch.float32, device=dev)
                                          for b in plan.buckets])
                 for _ in range(n_slots)]
        master = (bucketing.Buckets(plan, bucketing.pack(plan, params))
                  if self.master_weights else None)
        return slots, master

    def _bias_corrections(self, step):
        return bias_corrections(step, self.bias_correction, self.beta1, self.beta2)

    # --------------------------------------------------------- public API
    def init(self, params, bucketed: bool = False):  # pragma: no cover
        raise NotImplementedError

    def update(self, grads, state, params, grads_finite=None, lr=None, clip_norm=None,
               sumsq_reduce=None, **kw):
        """One optimizer step (optax-style); returns ``(new_params,
        new_state)``.  ``grads_finite`` predicates the whole commit on
        the device; ``clip_norm`` folds a global-L2 grad clip (torch
        ``clip_grad_norm_`` semantics) into the step, ``sumsq_reduce``
        agreeing the Σx² across ranks; ``inplace=True`` writes the new
        values into ``params`` and ``state`` and returns them."""
        p, s, _ = self._dispatch(grads, state, params, grads_finite=grads_finite, lr=lr,
                                 clip_norm=clip_norm, sumsq_reduce=sumsq_reduce, **kw)
        return p, s

    def update_scaled(self, grads, state, params, scale=None, clip_norm=None,
                      finite_sync=None, lr=None, sumsq_reduce=None, **kw):
        """The fused amp step: unscale by ``1/scale``, clip to
        ``clip_norm``, vote all-finite (agreed by ``finite_sync``) and
        commit predicated on the vote, in one pass over the grads.
        Returns ``(new_params, new_state, all_finite)``; ``scale=None``
        skips the unscale and still votes."""
        return self._dispatch(grads, state, params, lr=lr, scale=scale, clip_norm=clip_norm,
                              finite_sync=finite_sync, want_finite=True,
                              sumsq_reduce=sumsq_reduce, **kw)

    def step(self, grads, state, params, **kw):
        """Alias matching the reference's ``optimizer.step()`` naming."""
        return self.update(grads, state, params, **kw)

    # ------------------------------------------------- bucket-side helpers
    @staticmethod
    def _hyper_leaves(hypers):
        """The per-leaf override dicts in leaf order."""
        return tree_leaves(hypers)

    @staticmethod
    def _bucket_lr(bucket, hyper_leaves, lr, device=None):
        """The lr operand of one bucket: the runtime lr when no group
        overrides it, else a per-element vector (:func:`leaf_lr`)."""
        if not any(("lr" in h or "lr_scale" in h) for h in hyper_leaves):
            return lr
        per = [leaf_lr(h, lr) for h in hyper_leaves]
        return bucketing.seg_broadcast(bucket, per, device=device)

    @staticmethod
    def _slot_buckets(plan, slot):
        """A state slot as bucket arrays: the buffers when resident,
        packed (fp32) when tree-shaped."""
        if isinstance(slot, bucketing.Buckets):
            return slot.arrays, True
        return tuple(bucketing.pack(plan, slot)), False

    @staticmethod
    def _emit_slot(plan, arrays, resident):
        """A new state slot: flat when resident, else the fp32 tree."""
        if resident:
            return bucketing.Buckets(plan, arrays)
        return bucketing.unpack(plan, arrays, dtype=torch.float32)


def bucket_select(pred, new_arrays, old_arrays):
    """Predicated commit on bucket buffers."""
    if pred is None:
        return list(new_arrays)
    return [torch.where(_pred_tensor(pred, n.device), n, o)
            for n, o in zip(new_arrays, old_arrays)]
