"""FusedNovoGrad: NovoGrad with per-tensor second moments (counterpart
of :mod:`apex_tpu.optimizers.fused_novograd`).

The second moment is one scalar a tensor, a blended norm
``gn = sqrt(b2 * gn**2 + (1 - b2) * ||g||**2)`` (L2, ``norm_type=2``) or
``gn = b2 * gn + (1 - b2) * max|g|`` (L-inf, ``norm_type=0``); it starts
at zero (``init_zero``) or at the first grad's norm.  Elementwise, with
``denom = gn / sqrt(1 - b2**t) + eps``: ``reg_inside_moment``
``m = b1 * m + b3 * (g / denom + wd * p)``, ``p -= lr * m_hat``; default
``m = b1 * m + b3 * g``, ``p -= lr * (m_hat / denom + wd * p)``.

The engine's path (``use_buckets=True``, the default) takes the fresh L2
norms from the ``mt_l2norm`` kernel over each leaf's slice of the grad
buckets (another summation order than the per-leaf path's: a few fp32
ulps) and the elementwise tail as PyTorch ops over the buckets;
``exp_avg_sq`` stays a tree of per-leaf scalars in both layouts.
"""

from typing import Any, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers import base, bucketing


class NovoGradState(NamedTuple):
    step: torch.Tensor
    exp_avg: Any
    exp_avg_sq: Any  # a tree of scalar norms, one a leaf
    master: Optional[Any] = None


class FusedNovoGrad(base.OptimizerBase):

    _BUCKET_SLOT = "exp_avg"

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, amsgrad: bool = False,
                 reg_inside_moment: bool = False, grad_averaging: bool = True,
                 norm_type: int = 2, init_zero: bool = False, master_weights: bool = False,
                 use_buckets: bool = True):
        if amsgrad:
            raise RuntimeError("FusedNovoGrad does not support the AMSGrad variant.")
        if norm_type not in (0, 2):
            raise RuntimeError("FusedNovoGrad only supports l2/inf norm.")
        super().__init__(lr, weight_decay, master_weights, use_buckets=use_buckets)
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.moment_mode = 0 if reg_inside_moment else 1
        self.grad_averaging = grad_averaging
        self.norm_type = norm_type
        self.init_zero = init_zero

    def init(self, params, bucketed: bool = False) -> NovoGradState:
        # -1: not yet set; the first grad norm replaces it unless init_zero
        gn0 = base.tree_map(lambda p: torch.full(
            (), 0.0 if self.init_zero else -1.0, dtype=torch.float32, device=p.device), params)
        leaves = base.tree_leaves(params)
        step = torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)
        if bucketed:
            (m,), master = self._init_bucket_slots(params, 1)
            return NovoGradState(step, m, gn0, master)
        return NovoGradState(step=step, exp_avg=base.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
            exp_avg_sq=gn0, master=base.make_master(params, self.master_weights))

    def _norm(self, g32):
        if self.norm_type == 2:
            return torch.sqrt(torch.sum(torch.square(g32)))
        return torch.max(torch.abs(g32))

    def _blend(self, gn, fresh):
        """The norm blend with the -1 sentinel resolved."""
        gn0 = torch.where(gn < 0, fresh, gn)
        if self.norm_type == 2:
            return torch.sqrt(self.beta2 * torch.square(gn0)
                              + (1.0 - self.beta2) * torch.square(fresh))
        return self.beta2 * gn0 + (1.0 - self.beta2) * fresh

    def _bias_corrections(self, step):
        t = step.to(torch.float32)
        if self.bias_correction:
            return (1.0 - torch.pow(self.beta1, t),
                    torch.sqrt(1.0 - torch.pow(self.beta2, t)))
        one = torch.ones((), dtype=torch.float32, device=step.device)
        return one, one

    def _moment_math(self, g, p32, m, denom, lr, bc1):
        """The elementwise tail (per-leaf == bucket)."""
        b1, wd = self.beta1, self.weight_decay
        b3 = (1.0 - b1) if self.grad_averaging else 1.0
        if self.moment_mode == 0:
            gp = g / denom + wd * p32
            m_new = b1 * m + b3 * gp
            p_out = p32 - lr * (m_new / bc1)
        else:
            m_new = b1 * m + b3 * g
            p_out = p32 - lr * ((m_new / bc1) / denom + wd * p32)
        return p_out, m_new

    # ------------------------------------------------------- per-leaf path
    def _leaf_update(self, grads, state: NovoGradState, params, grads_finite=None, lr=None):
        lr = self.lr if lr is None else lr
        step = base.predicate_step(grads_finite, state.step)
        bc1, bc2 = self._bias_corrections(step)
        p_math = base.math_params(params, state.master)
        outs = []
        for g, p, m, gn in zip(base.tree_leaves(grads), base.tree_leaves(p_math),
                               base.tree_leaves(state.exp_avg),
                               base.tree_leaves(state.exp_avg_sq)):
            g = g.to(torch.float32)
            gn_new = self._blend(gn, self._norm(g))
            p_out, m_new = self._moment_math(g, p.detach().to(torch.float32), m,
                                             gn_new / bc2 + self.eps, lr, bc1)
            outs.append((p_out, m_new, gn_new))
        p_new = base.select(grads_finite, base.tree_unflatten(grads, [o[0] for o in outs]),
                            p_math)
        m_new = base.select(grads_finite, base.tree_unflatten(grads, [o[1] for o in outs]),
                            state.exp_avg)
        gn_new = base.select(grads_finite, base.tree_unflatten(grads, [o[2] for o in outs]),
                             state.exp_avg_sq)
        new_params, new_master = base.emit_params(p_new, params, state.master)
        return new_params, NovoGradState(step, m_new, gn_new, new_master)

    # --------------------------------------------------------- bucket path
    def _bucket_update(self, prep: base.PreparedGrads, state: NovoGradState, params, pred,
                       lr=None):
        lr = self.lr if lr is None else lr
        plan = prep.plan
        dev = state.step.device
        step = base.predicate_step(pred, state.step)
        bc1, bc2 = self._bias_corrections(step)
        m_b, resident = self._slot_buckets(plan, state.exp_avg)
        has_master = state.master is not None
        p_b = (self._slot_buckets(plan, state.master)[0] if has_master
               else bucketing.pack(plan, params))
        g_b = prep.buckets()
        views = bucketing.Buckets(plan, g_b).leaf_views()
        if self.norm_type == 2:
            fresh = list(torch.sqrt(mt.mt_l2norm(views)[1]).unbind(0))
        else:
            fresh = [self._norm(x) for x in views]
        gn_leaves = base.tree_leaves(state.exp_avg_sq)
        gn_new_leaves = [self._blend(gn, f) for gn, f in zip(gn_leaves, fresh)]
        denoms = [gn / bc2 + self.eps for gn in gn_new_leaves]

        new_p, new_m = [], []
        for bi, b in enumerate(plan.buckets):
            denom = bucketing.seg_broadcast(b, denoms, device=dev)
            # the pad would divide by its 0 denominator: mask by POSITION
            # (a real leaf may have denom 0 and must keep its NaN)
            if b.pad:
                is_pad = torch.arange(b.total, device=denom.device) >= b.size
                denom = torch.where(is_pad, torch.ones((), device=denom.device), denom)
            p_out, m_out = self._moment_math(g_b[bi], p_b[bi], m_b[bi], denom, lr, bc1)
            new_p.append(p_out)
            new_m.append(m_out)

        new_p = base.bucket_select(pred, new_p, p_b)
        new_m = base.bucket_select(pred, new_m, m_b)
        if pred is not None:
            w = base._pred_tensor(pred, dev)
            gn_new_leaves = [torch.where(w, n, o) for n, o in zip(gn_new_leaves, gn_leaves)]
        gn_new = base.tree_unflatten(state.exp_avg_sq, gn_new_leaves)
        new_params = bucketing.unpack(plan, new_p)
        new_master = self._emit_slot(plan, new_p, resident) if has_master else None
        return new_params, NovoGradState(step, self._emit_slot(plan, new_m, resident),
                                         gn_new, new_master)
