"""FusedAdagrad (counterpart of :mod:`apex_tpu.optimizers.fused_adagrad`).

Elementwise (fp32):

- L2 mode (default): ``g += wd * p``; ``h += g * g``;
  ``p -= lr * g / (sqrt(h) + eps)``;
- adagrad_w mode: ``h += g * g``; ``p -= lr * (g / (sqrt(h) + eps) + wd * p)``.

The engine's path (``use_buckets=True``, the default) evaluates the
same expression as PyTorch ops over the fp32 buckets.
"""

from typing import Any, NamedTuple, Optional

import torch

from apex_tpu_torch.optimizers import base, bucketing


class AdagradState(NamedTuple):
    step: torch.Tensor
    sum: Any  # h accumulator, fp32 (tree or Buckets)
    master: Optional[Any] = None


class FusedAdagrad(base.OptimizerBase):

    _BUCKET_SLOT = "sum"

    def __init__(self, lr: float = 1e-2, eps: float = 1e-10, weight_decay: float = 0.0,
                 adagrad_w_mode: bool = False, master_weights: bool = False,
                 param_group_fn=None, group_hypers=None, use_buckets: bool = True):
        super().__init__(lr, weight_decay, master_weights, use_buckets=use_buckets)
        self.eps = eps
        self.adagrad_w_mode = adagrad_w_mode
        self.param_group_fn = param_group_fn
        self.group_hypers = group_hypers

    def init(self, params, bucketed: bool = False) -> AdagradState:
        leaves = base.tree_leaves(params)
        step = torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)
        if bucketed:
            (h,), master = self._init_bucket_slots(params, 1)
            return AdagradState(step, h, master)
        return AdagradState(step=step, sum=base.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
            master=base.make_master(params, self.master_weights))

    def _adagrad_math(self, g, p32, h, wd_i, lr_i):
        """The one Adagrad expression (per-leaf == bucket)."""
        eps = self.eps
        if not self.adagrad_w_mode:
            g = g + wd_i * p32
            h_new = h + g * g
            p_out = p32 - lr_i * (g / (torch.sqrt(h_new) + eps))
        else:
            h_new = h + g * g
            p_out = p32 - lr_i * (g / (torch.sqrt(h_new) + eps) + wd_i * p32)
        return p_out, h_new

    def _hypers(self, params):
        return self._hyper_leaves(
            base.leaf_hypers(params, self.param_group_fn, self.group_hypers))

    # ------------------------------------------------------- per-leaf path
    def _leaf_update(self, grads, state: AdagradState, params, grads_finite=None, lr=None):
        lr = self.lr if lr is None else lr
        wd = self.weight_decay
        step = base.predicate_step(grads_finite, state.step)
        p_math = base.math_params(params, state.master)
        hl = self._hypers(params)
        outs = [self._adagrad_math(g.to(torch.float32), p.detach().to(torch.float32), h,
                                   hyp.get("weight_decay", wd), base.leaf_lr(hyp, lr))
                for g, p, h, hyp in zip(base.tree_leaves(grads), base.tree_leaves(p_math),
                                        base.tree_leaves(state.sum), hl)]
        p_new = base.tree_unflatten(grads, [o[0] for o in outs])
        h_new = base.tree_unflatten(grads, [o[1] for o in outs])
        p_new = base.select(grads_finite, p_new, p_math)
        h_new = base.select(grads_finite, h_new, state.sum)
        new_params, new_master = base.emit_params(p_new, params, state.master)
        return new_params, AdagradState(step, h_new, new_master)

    # --------------------------------------------------------- bucket path
    def _bucket_update(self, prep: base.PreparedGrads, state: AdagradState, params, pred,
                       lr=None):
        lr = self.lr if lr is None else lr
        wd = self.weight_decay
        plan = prep.plan
        dev = state.step.device
        step = base.predicate_step(pred, state.step)
        h_b, resident = self._slot_buckets(plan, state.sum)
        has_master = state.master is not None
        p_b = (self._slot_buckets(plan, state.master)[0] if has_master
               else bucketing.pack(plan, params))
        g_b = prep.buckets()
        hl = self._hypers(params)
        wd_leaf = [h.get("weight_decay", wd) for h in hl]
        new_p, new_h = [], []
        for bi, b in enumerate(plan.buckets):
            p_out, h_out = self._adagrad_math(
                g_b[bi], p_b[bi], h_b[bi], bucketing.seg_values(b, wd_leaf, device=dev),
                self._bucket_lr(b, hl, lr, device=dev))
            new_p.append(p_out)
            new_h.append(h_out)
        new_p = base.bucket_select(pred, new_p, p_b)
        new_h = base.bucket_select(pred, new_h, h_b)
        new_params = bucketing.unpack(plan, new_p)
        new_master = self._emit_slot(plan, new_p, resident) if has_master else None
        return new_params, AdagradState(step, self._emit_slot(plan, new_h, resident),
                                        new_master)
