"""FusedAdam: Adam/AdamW with the JAX package's numerics (counterpart
of :mod:`apex_tpu.optimizers.fused_adam`).

Per element, in fp32:

- L2 mode (``adam_w_mode=False``): ``g += wd * p`` before the moments;
- AdamW mode (default): ``update = m_hat / (sqrt(v_hat) + eps) + wd * p``;
- ``m = b1 * m + (1 - b1) * g``, ``v = b2 * v + (1 - b2) * (g * g)``
  (that association, pinned for bit-exact parity), ``m_hat = m / bc1``,
  ``v_hat = v / bc2`` with ``bc = 1 - beta**t`` when ``bias_correction``;
- ``p = p - lr * update``.

The update runs on the multi-tensor engine by default
(``use_buckets=True``, as in the JAX package): the ``mt_adam`` kernel
(:func:`~apex_tpu_torch.ops.multi_tensor.mt_adam`) does the whole step
in one pass, reading g, p (or the fp32 master), m and v where they lie
and writing p in its storage dtype, m and v.  It is the twin of both of
the JAX package's bucket paths: the pack-free emit (AdamW without a
master: each param leaf emitted from its slice of the update) and the
packed path with a master; on the card neither packs anything, and the
kernel's plain version (the CPU's path) is the packed expression.
``init(params, bucketed=True)`` keeps m, v and the master as flat
bucket buffers (:class:`~apex_tpu_torch.optimizers.bucketing.Buckets`).
``use_buckets=False`` runs the per-leaf path.  All of them agree with
the JAX package to the last fp32 ulp.
"""

from typing import Any, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.ops.multi_tensor import adam_core, adam_math  # noqa: F401  (the API)
from apex_tpu_torch.optimizers import base, bucketing


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    exp_avg: Any  # m, fp32 (tree or Buckets)
    exp_avg_sq: Any  # v, fp32 (tree or Buckets)
    master: Optional[Any] = None  # fp32 master params (if enabled)


def _leaf_views(slot):
    """A state slot's per-leaf tensors: slices of its buckets when
    resident, else its leaves."""
    if isinstance(slot, bucketing.Buckets):
        return slot.leaf_views()
    return base.tree_leaves(slot)


class FusedAdam(base.OptimizerBase):
    """``FusedAdam(lr, bias_correction, betas, eps, adam_w_mode,
    weight_decay, amsgrad, master_weights, param_group_fn, group_hypers,
    use_buckets)`` as in the JAX package.  ``param_group_fn(path, leaf)
    -> group`` with ``group_hypers={group: {"lr" | "lr_scale" |
    "weight_decay": ...}}`` is the functional form of torch's
    ``param_groups``."""

    _BUCKET_SLOT = "exp_avg"
    _NATIVE_INPLACE = True

    def __init__(
        self,
        lr: float = 1e-3,
        bias_correction: bool = True,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        adam_w_mode: bool = True,
        weight_decay: float = 0.0,
        amsgrad: bool = False,
        master_weights: bool = False,
        param_group_fn=None,
        group_hypers=None,
        use_buckets: bool = True,
    ):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad variant.")
        super().__init__(lr, weight_decay, master_weights, use_buckets=use_buckets)
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.param_group_fn = param_group_fn
        self.group_hypers = group_hypers

    def init(self, params, bucketed: bool = False) -> AdamState:
        leaves = base.tree_leaves(params)
        device = leaves[0].device if leaves else None
        step = torch.zeros((), dtype=torch.int32, device=device)
        if bucketed:
            (m, v), master = self._init_bucket_slots(params, 2)
            return AdamState(step, m, v, master)

        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamState(step=step, exp_avg=base.tree_map(zeros, params),
                         exp_avg_sq=base.tree_map(zeros, params),
                         master=base.make_master(params, self.master_weights))

    def _hypers(self, params):
        return self._hyper_leaves(
            base.leaf_hypers(params, self.param_group_fn, self.group_hypers))

    # ------------------------------------------------------- per-leaf path
    def _leaf_update(self, grads, state: AdamState, params, grads_finite=None, lr=None):
        lr = self.lr if lr is None else lr
        wd = self.weight_decay
        step = base.predicate_step(grads_finite, state.step)
        bc1, bc2 = self._bias_corrections(step)
        p_math = base.math_params(params, state.master)
        hl = self._hypers(params)

        def one(g, p, m, v, h):
            return adam_math(g.to(torch.float32), p.detach().to(torch.float32), m, v,
                             h.get("weight_decay", wd), base.leaf_lr(h, lr), bc1, bc2,
                             beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                             adam_w_mode=self.adam_w_mode)

        trees = (grads, p_math, state.exp_avg, state.exp_avg_sq)
        base.tree_map(lambda *_: None, *trees)  # the four trees share grads' structure
        outs = [one(*leaf, h) for leaf, h in zip(zip(*map(base.tree_leaves, trees)), hl)]

        def pick(i):
            return base.tree_unflatten(grads, [o[i] for o in outs])

        p_new = base.select(grads_finite, pick(0), p_math)
        m_new = base.select(grads_finite, pick(1), state.exp_avg)
        v_new = base.select(grads_finite, pick(2), state.exp_avg_sq)
        new_params, new_master = base.emit_params(p_new, params, state.master)
        return new_params, AdamState(step, m_new, v_new, new_master)

    # --------------------------------------------------------- bucket path
    def _bucket_update(self, prep: base.PreparedGrads, state: AdamState, params, pred,
                       lr=None, inplace=False):
        """One ``mt_adam`` call over every leaf: g from the prepare pass
        (the grads where they lie, or the unscaled fp32 buckets), the
        clip coefficient multiplied in by the kernel, m, v and the
        master read and written as per-leaf tensors or as slices of
        resident buckets, the params emitted in their storage dtype.
        ``inplace``: the kernel writes the params, m, v and the master
        over the ones it reads (element by element, each read before it
        is written), and the given params and state come back."""
        lr = self.lr if lr is None else lr
        wd = self.weight_decay
        plan = prep.plan
        leaves = base.tree_leaves(params)
        dev = leaves[0].device
        step = base.predicate_step(pred, state.step)
        bc1, bc2 = self._bias_corrections(step)
        hl = self._hypers(params)
        resident = isinstance(state.exp_avg, bucketing.Buckets)
        has_master = state.master is not None
        p_src = _leaf_views(state.master) if has_master else [p.detach() for p in leaves]
        if inplace and all(p.is_contiguous() for p in leaves):
            mt.mt_adam(
                list(prep.leaves), p_src, _leaf_views(state.exp_avg),
                _leaf_views(state.exp_avg_sq), [p.detach() for p in leaves],
                _leaf_views(state.exp_avg), _leaf_views(state.exp_avg_sq),
                _leaf_views(state.master) if has_master else None, lr=lr,
                wd=[h.get("weight_decay", wd) for h in hl],
                lr_abs=[h.get("lr") for h in hl], lr_scale=[h.get("lr_scale", 1.0) for h in hl],
                bc1=bc1, bc2=bc2, beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                adam_w_mode=self.adam_w_mode,
                pred=None if pred is None else base._pred_tensor(pred, dev), coef=prep.coef)
            state.step.copy_(step)
            return params, state
        if resident:
            new_m, new_v = bucketing.new_buckets(plan, dev), bucketing.new_buckets(plan, dev)
            m_out, v_out = new_m.leaf_views(), new_v.leaf_views()
        else:
            m_out = [torch.empty(p.shape, dtype=torch.float32, device=dev) for p in leaves]
            v_out = [torch.empty(p.shape, dtype=torch.float32, device=dev) for p in leaves]
        new_master = master_out = None
        if has_master:
            if isinstance(state.master, bucketing.Buckets):
                new_master = bucketing.new_buckets(plan, dev)
                master_out = new_master.leaf_views()
            else:
                master_out = [torch.empty(p.shape, dtype=torch.float32, device=dev)
                              for p in leaves]
        p_out = [torch.empty_like(p, memory_format=torch.contiguous_format) for p in leaves]
        mt.mt_adam(
            list(prep.leaves), p_src, _leaf_views(state.exp_avg), _leaf_views(state.exp_avg_sq),
            p_out, m_out, v_out, master_out, lr=lr,
            wd=[h.get("weight_decay", wd) for h in hl],
            lr_abs=[h.get("lr") for h in hl], lr_scale=[h.get("lr_scale", 1.0) for h in hl],
            bc1=bc1, bc2=bc2, beta1=self.beta1, beta2=self.beta2, eps=self.eps,
            adam_w_mode=self.adam_w_mode,
            pred=None if pred is None else base._pred_tensor(pred, dev), coef=prep.coef)
        new_params = plan.treedef.unflatten(p_out)
        if resident:
            m_state, v_state = new_m, new_v
        else:
            m_state = plan.treedef.unflatten(m_out)
            v_state = plan.treedef.unflatten(v_out)
        if has_master and new_master is None:
            new_master = plan.treedef.unflatten(master_out)
        return new_params, AdamState(step, m_state, v_state, new_master)
