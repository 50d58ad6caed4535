"""FusedLAMB: the layer-wise adaptive large-batch optimizer (counterpart
of :mod:`apex_tpu.optimizers.fused_lamb`).

1. Global grad-norm clip: every grad is divided by ``gn / max_grad_norm``
   when the global norm ``gn`` exceeds ``max_grad_norm``.
2. Stage 1 per element: Adam-style moments on the clipped grad
   (``m = b1 * m + b3 * g``, ``b3 = 1 - b1`` with ``grad_averaging``),
   ``u = m_hat / (sqrt(v_hat) + eps) (+ wd * p)`` (L2 mode adds wd to g
   instead).
3. Stage 2 per tensor: the trust ratio ``||p|| / ||u||`` where
   ``use_nvlamb`` or ``wd != 0`` and both norms are nonzero;
   ``p -= lr * ratio * u``.

The engine's path (``use_buckets=True``, the default): stage 1 is
PyTorch ops over the fp32 buckets; the global grad norm and the
per-tensor norms of p and u are the ``mt_l2norm`` kernel over each
leaf's slice of the buckets.  Its sums run in another order than the
per-leaf path's, so the two agree to a few fp32 ulps, not bitwise (the
JAX package's two paths neither).
"""

from typing import Any, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers import base, bucketing


class LambState(NamedTuple):
    step: torch.Tensor
    exp_avg: Any
    exp_avg_sq: Any
    master: Optional[Any] = None


def lamb_stage1_math(g, p32, m, v, wd_i, bc1, bc2, *, beta1, beta2, eps, adam_w_mode,
                     grad_averaging):
    """Stage-1 LAMB per element (LAMBStage1Functor)."""
    b3 = (1.0 - beta1) if grad_averaging else 1.0
    if not adam_w_mode:
        g = g + wd_i * p32
    m_new = beta1 * m + b3 * g
    v_new = beta2 * v + (1.0 - beta2) * (g * g)
    u = (m_new / bc1) / (mt.sqrt_rn(v_new / bc2) + eps)
    if adam_w_mode:
        u = u + wd_i * p32
    return u, m_new, v_new


def _lr_tensor(lr_i, device):
    """``lr_i`` as a 0-d fp32 tensor on ``device``, a Python number
    written by a fill (no host-to-device copy, so a captured step can
    take it)."""
    if isinstance(lr_i, torch.Tensor):
        return lr_i.to(device=device, dtype=torch.float32)
    return torch.full((), lr_i, dtype=torch.float32, device=device)


def lamb_trust_ratio(lr_i, p_norm, u_norm, *, apply_ratio):
    """Stage-2 per-tensor ratio (multi_tensor_lamb.cu:255-262)."""
    if apply_ratio:
        return torch.where((p_norm != 0.0) & (u_norm != 0.0), lr_i * (p_norm / u_norm),
                           _lr_tensor(lr_i, p_norm.device))
    return _lr_tensor(lr_i, p_norm.device)


def lamb_grad_clip(global_grad_norm, max_grad_norm):
    """The divisor of every grad when the global norm exceeds the max."""
    return torch.where(global_grad_norm > max_grad_norm, global_grad_norm / max_grad_norm,
                       torch.ones((), dtype=torch.float32, device=global_grad_norm.device))


class FusedLAMB(base.OptimizerBase):

    #: group-override keys beyond the base lr/lr_scale/weight_decay set
    _HYPER_KEYS = ("use_trust_ratio",)

    _BUCKET_SLOT = "exp_avg"

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, amsgrad: bool = False, adam_w_mode: bool = True,
                 grad_averaging: bool = True, max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False, master_weights: bool = False,
                 param_group_fn=None, group_hypers=None, use_buckets: bool = True):
        """``param_group_fn``/``group_hypers`` as FusedAdam's; LAMB also
        reads the group key ``use_trust_ratio`` (False: a plain lr step,
        BERT's exclusion of norms and biases)."""
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad variant.")
        super().__init__(lr, weight_decay, master_weights, use_buckets=use_buckets)
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.grad_averaging = grad_averaging
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self.param_group_fn = param_group_fn
        self.group_hypers = group_hypers

    def init(self, params, bucketed: bool = False) -> LambState:
        leaves = base.tree_leaves(params)
        step = torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)
        if bucketed:
            (m, v), master = self._init_bucket_slots(params, 2)
            return LambState(step, m, v, master)

        def zeros(t):
            return base.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), t)

        return LambState(step=step, exp_avg=zeros(params), exp_avg_sq=zeros(params),
                         master=base.make_master(params, self.master_weights))

    def _stage1_math(self, g, p32, m, v, wd_i, bc1, bc2):
        return lamb_stage1_math(g, p32, m, v, wd_i, bc1, bc2, beta1=self.beta1,
                                beta2=self.beta2, eps=self.eps, adam_w_mode=self.adam_w_mode,
                                grad_averaging=self.grad_averaging)

    def _trust_ratio(self, h, wd_i, lr_i, p_norm, u_norm):
        apply = h.get("use_trust_ratio", True) and (self.use_nvlamb or wd_i != 0.0)
        return lamb_trust_ratio(lr_i, p_norm, u_norm, apply_ratio=apply)

    def _hypers(self, params):
        return self._hyper_leaves(base.leaf_hypers(
            params, self.param_group_fn, self.group_hypers, extra_keys=self._HYPER_KEYS))

    # ------------------------------------------------------- per-leaf path
    def _leaf_update(self, grads, state: LambState, params, grads_finite=None, lr=None):
        lr = self.lr if lr is None else lr
        wd = self.weight_decay
        step = base.predicate_step(grads_finite, state.step)
        bc1, bc2 = self._bias_corrections(step)
        g32 = [g.to(torch.float32) for g in base.tree_leaves(grads)]
        sq = [torch.sum(torch.square(g)) for g in g32]
        clip = lamb_grad_clip(torch.sqrt(torch.stack(sq).sum()), self.max_grad_norm)
        p_math = base.math_params(params, state.master)
        hl = self._hypers(params)
        p_leaves = [p.detach().to(torch.float32) for p in base.tree_leaves(p_math)]
        outs = [self._stage1_math(g / clip, p32, m, v, h.get("weight_decay", wd), bc1, bc2)
                for g, p32, m, v, h in zip(g32, p_leaves, base.tree_leaves(state.exp_avg),
                                           base.tree_leaves(state.exp_avg_sq), hl)]
        p_new = []
        for p32, (u, _, _), h in zip(p_leaves, outs, hl):
            ratio = self._trust_ratio(h, h.get("weight_decay", wd), base.leaf_lr(h, lr),
                                      torch.sqrt(torch.sum(torch.square(p32))),
                                      torch.sqrt(torch.sum(torch.square(u))))
            p_new.append(p32 - ratio * u)
        p_new = base.select(grads_finite, base.tree_unflatten(grads, p_new), p_math)
        m_new = base.select(grads_finite, base.tree_unflatten(grads, [o[1] for o in outs]),
                            state.exp_avg)
        v_new = base.select(grads_finite, base.tree_unflatten(grads, [o[2] for o in outs]),
                            state.exp_avg_sq)
        new_params, new_master = base.emit_params(p_new, params, state.master)
        return new_params, LambState(step, m_new, v_new, new_master)

    # --------------------------------------------------------- bucket path
    def _bucket_update(self, prep: base.PreparedGrads, state: LambState, params, pred,
                       lr=None):
        lr = self.lr if lr is None else lr
        wd = self.weight_decay
        plan = prep.plan
        dev = state.step.device
        step = base.predicate_step(pred, state.step)
        bc1, bc2 = self._bias_corrections(step)
        g_b = prep.buckets()
        # the global grad norm: mt_l2norm over each leaf's slice
        total_sq, _ = mt.mt_l2norm(bucketing.Buckets(plan, g_b).leaf_views())
        clip = lamb_grad_clip(torch.sqrt(total_sq), self.max_grad_norm)
        m_b, resident = self._slot_buckets(plan, state.exp_avg)
        v_b, _ = self._slot_buckets(plan, state.exp_avg_sq)
        has_master = state.master is not None
        p_b = (self._slot_buckets(plan, state.master)[0] if has_master
               else bucketing.pack(plan, params))
        hl = self._hypers(params)
        wd_leaf = [h.get("weight_decay", wd) for h in hl]

        u_b, new_m, new_v = [], [], []
        for bi, b in enumerate(plan.buckets):
            u, m_out, v_out = self._stage1_math(
                g_b[bi] / clip, p_b[bi], m_b[bi], v_b[bi],
                bucketing.seg_values(b, wd_leaf, device=dev), bc1, bc2)
            u_b.append(u)
            new_m.append(m_out)
            new_v.append(v_out)

        # stage 2: the per-tensor norms of p and u on mt_l2norm
        _, p_sq = mt.mt_l2norm(bucketing.Buckets(plan, p_b).leaf_views())
        _, u_sq = mt.mt_l2norm(bucketing.Buckets(plan, u_b).leaf_views())
        p_n, u_n = torch.sqrt(p_sq), torch.sqrt(u_sq)
        ratios = [self._trust_ratio(h, h.get("weight_decay", wd), base.leaf_lr(h, lr),
                                    p_n[i], u_n[i]) for i, h in enumerate(hl)]
        new_p = [p_b[bi] - bucketing.seg_broadcast(b, ratios, device=dev) * u_b[bi]
                 for bi, b in enumerate(plan.buckets)]

        new_p = base.bucket_select(pred, new_p, p_b)
        new_m = base.bucket_select(pred, new_m, m_b)
        new_v = base.bucket_select(pred, new_v, v_b)
        new_params = bucketing.unpack(plan, new_p)
        new_master = self._emit_slot(plan, new_p, resident) if has_master else None
        return new_params, LambState(step, self._emit_slot(plan, new_m, resident),
                                     self._emit_slot(plan, new_v, resident), new_master)
