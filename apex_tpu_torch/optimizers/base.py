"""Shared machinery for the fused optimizers (counterpart of
:mod:`apex_tpu.optimizers.base`).

Each optimizer is a pure function over a tree of tensors (nested dicts,
lists or tuples with tensor leaves), as in the JAX package: ``init``
builds the state and ``update(grads, state, params)`` returns new params
and a new state, nothing in place.  The math is fp32 whatever the
storage dtype, with an optional fp32 master copy (``master_weights``),
and the commit can be predicated on a ``grads_finite`` flag.

Only the per-leaf path (the JAX package's numerics specification) is
ported: one elementwise expression per leaf, written as plain tensor
ops, which is a fair port of a step that XLA, not a Pallas kernel,
fuses there.  The bucketed multi-tensor engine, per-group
hyperparameters (``param_group_fn``/``group_hypers``) and
``update_scaled`` raise ``NotImplementedError``.
"""

from typing import Any, Optional

import torch

Tree = Any


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure; dicts (walked in sorted key order,
    as JAX walks them), lists and tuples are nodes, anything else is a
    leaf."""
    if isinstance(tree, dict):
        if any(set(r) != set(tree) for r in rest):
            raise ValueError("trees differ in their keys")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("trees differ in their lengths")
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of ``tree`` in :func:`tree_map` order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


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


def predicate_step(grads_finite, step: torch.Tensor) -> torch.Tensor:
    """The step advances only on finite grads."""
    if grads_finite is None:
        return step + 1
    return step + torch.as_tensor(grads_finite, device=step.device).to(step.dtype)


def select(grads_finite, new: Tree, old: Tree) -> Tree:
    """Predicated commit: keep the old values on overflow."""
    if grads_finite is None:
        return new
    return tree_map(lambda n, o: torch.where(
        torch.as_tensor(grads_finite, device=n.device), n, o.to(n.dtype)), new, old)


def bias_corrections(step, bias_correction: bool, beta1, beta2):
    """Adam-family ``(1 - beta1**t, 1 - beta2**t)`` in fp32."""
    if not bias_correction:
        one = torch.ones((), dtype=torch.float32, device=step.device)
        return one, one
    t = step.to(torch.float32)
    return 1.0 - torch.pow(beta1, t), 1.0 - torch.pow(beta2, t)


class OptimizerBase:
    """Constructor plumbing and the per-leaf dispatch.  Subclasses
    implement ``init`` and ``_leaf_update``."""

    def __init__(self, lr: float, weight_decay: float = 0.0,
                 master_weights: bool = False, use_buckets: bool = False):
        if use_buckets:
            raise NotImplementedError(
                "the bucketed multi-tensor engine (use_buckets=True) is not "
                "ported yet; the per-leaf path is")
        self.lr = lr
        self.weight_decay = weight_decay
        self.master_weights = master_weights
        self.use_buckets = use_buckets

    def _leaf_update(self, grads, state, params, grads_finite=None,
                     lr=None):  # pragma: no cover - abstract
        raise NotImplementedError

    def _bias_corrections(self, step):
        return bias_corrections(step, self.bias_correction, self.beta1, self.beta2)

    def init(self, params, bucketed: bool = False):  # pragma: no cover
        raise NotImplementedError

    def update(self, grads, state, params, grads_finite=None, lr=None,
               clip_norm=None, sumsq_reduce=None):
        """One optimizer step (optax-style signature); returns
        ``(new_params, new_state)``.  ``grads_finite`` predicates the
        whole commit.  The folded grad clip is not ported."""
        if clip_norm is not None or sumsq_reduce is not None:
            raise NotImplementedError(
                "update(clip_norm=...) (the grad clip folded into the step) is "
                "not ported yet")
        with torch.no_grad():
            return self._leaf_update(grads, state, params,
                                     grads_finite=grads_finite, lr=lr)

    def update_scaled(self, *args, **kwargs):
        raise NotImplementedError(
            "update_scaled (unscale, clip and finite vote folded into the "
            "step) is not ported yet")
