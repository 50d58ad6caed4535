"""FusedSGD: SGD with momentum, nesterov and dampening (counterpart of
:mod:`apex_tpu.optimizers.fused_sgd`).

Per element (fp32): an optional grad prescale (``1/scale``);
``wd_after_momentum=False`` (default) adds ``wd * p`` before the
momentum; the first step sets the buffer to ``g``, later ones
``buf = mu * buf + (1 - dampening) * g``; nesterov ``g += mu * buf``,
else ``g = buf``; ``wd_after_momentum=True`` adds ``wd * p`` here;
``p -= lr * g``.  The first step is told apart by the device step
counter, with no host read.

The engine's path (``use_buckets=True``, the default) evaluates the JAX
package's bucket expressions as PyTorch ops over the fp32 buckets; a
per-group ``momentum`` becomes a per-element select, as there.
"""

from typing import Any, NamedTuple, Optional

import torch

from apex_tpu_torch.optimizers import base, bucketing


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum_buffer: Any
    master: Optional[Any] = None


class FusedSGD(base.OptimizerBase):

    #: group-override keys beyond the base lr/lr_scale/weight_decay set
    _HYPER_KEYS = ("momentum",)

    _BUCKET_SLOT = "momentum_buffer"

    def __init__(self, lr: float, momentum: float = 0.0, dampening: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False,
                 wd_after_momentum: bool = False, master_weights: bool = False,
                 param_group_fn=None, group_hypers=None, use_buckets: bool = True):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and zero dampening")
        super().__init__(lr, weight_decay, master_weights, use_buckets=use_buckets)
        self.momentum = momentum
        self.dampening = dampening
        self.nesterov = nesterov
        self.wd_after_momentum = wd_after_momentum
        self.param_group_fn = param_group_fn
        self.group_hypers = group_hypers

    def init(self, params, bucketed: bool = False) -> SGDState:
        leaves = base.tree_leaves(params)
        step = torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)
        if bucketed:
            (buf,), master = self._init_bucket_slots(params, 1)
            return SGDState(step, buf, master)
        return SGDState(step=step, momentum_buffer=base.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
            master=base.make_master(params, self.master_weights))

    def update(self, grads, state, params, grads_finite=None, lr=None, scale=1.0,
               clip_norm=None, sumsq_reduce=None, **kw):
        """``scale``: the reference's ``1/most_recent_scale`` grad
        prescale, folded into the one grad read."""
        p, s, _ = self._dispatch(grads, state, params, grads_finite=grads_finite, lr=lr,
                                 clip_norm=clip_norm, sumsq_reduce=sumsq_reduce,
                                 prescale=1.0 / scale, **kw)
        return p, s

    def _hypers(self, params):
        return self._hyper_leaves(base.leaf_hypers(
            params, self.param_group_fn, self.group_hypers, extra_keys=self._HYPER_KEYS))

    # ------------------------------------------------------- per-leaf path
    def _leaf_update(self, grads, state: SGDState, params, grads_finite=None, lr=None):
        lr = self.lr if lr is None else lr
        wd, mu, damp = self.weight_decay, self.momentum, self.dampening
        first_run = state.step == 0
        step = base.predicate_step(grads_finite, state.step)
        p_math = base.math_params(params, state.master)
        hl = self._hypers(params)

        def one(g, p, buf, h):
            wd_i = h.get("weight_decay", wd)
            lr_i = base.leaf_lr(h, lr)
            mu_i = h.get("momentum", mu)
            g = g.to(torch.float32)
            p32 = p.detach().to(torch.float32)
            if not self.wd_after_momentum and wd_i != 0.0:
                g = g + wd_i * p32
            if mu_i != 0.0:
                steady = mu_i * buf + (1.0 - damp) * g
                buf_new = torch.where(first_run, g, steady)
                g = g + mu_i * buf_new if self.nesterov else buf_new
            else:
                buf_new = buf
            if self.wd_after_momentum and wd_i != 0.0:
                g = g + wd_i * p32
            return p32 - lr_i * g, buf_new

        outs = [one(g, p, b, h) for g, p, b, h in zip(
            base.tree_leaves(grads), base.tree_leaves(p_math),
            base.tree_leaves(state.momentum_buffer), hl)]
        p_new = base.tree_unflatten(grads, [o[0] for o in outs])
        buf_new = base.tree_unflatten(grads, [o[1] for o in outs])
        p_new = base.select(grads_finite, p_new, p_math)
        buf_new = base.select(grads_finite, buf_new, state.momentum_buffer)
        new_params, new_master = base.emit_params(p_new, params, state.master)
        return new_params, SGDState(step, buf_new, new_master)

    # --------------------------------------------------------- bucket path
    def _bucket_update(self, prep: base.PreparedGrads, state: SGDState, params, pred,
                       lr=None):
        lr = self.lr if lr is None else lr
        wd, mu, damp = self.weight_decay, self.momentum, self.dampening
        plan = prep.plan
        first_run = state.step == 0
        dev = state.step.device
        step = base.predicate_step(pred, state.step)
        buf_b, resident = self._slot_buckets(plan, state.momentum_buffer)
        has_master = state.master is not None
        p_b = (self._slot_buckets(plan, state.master)[0] if has_master
               else bucketing.pack(plan, params))
        g_b = prep.buckets()
        hl = self._hypers(params)
        wd_leaf = [h.get("weight_decay", wd) for h in hl]
        mu_leaf = [h.get("momentum", mu) for h in hl]

        new_p, new_buf = [], []
        for bi, b in enumerate(plan.buckets):
            g, p32, buf = g_b[bi], p_b[bi], buf_b[bi]
            wd_i = bucketing.seg_values(b, wd_leaf, device=dev)
            mu_i = bucketing.seg_values(b, mu_leaf, device=dev)
            lr_i = self._bucket_lr(b, hl, lr, device=dev)
            mu_scalar = isinstance(mu_i, float)
            wd_scalar = isinstance(wd_i, float)
            if not self.wd_after_momentum and not (wd_scalar and wd_i == 0.0):
                g = g + wd_i * p32
            if mu_scalar and mu_i == 0.0:
                buf_new = buf
            else:
                steady = mu_i * buf + (1.0 - damp) * g
                mom_buf = torch.where(first_run, g, steady)
                g_mom = g + mu_i * mom_buf if self.nesterov else mom_buf
                if mu_scalar:
                    buf_new, g = mom_buf, g_mom
                else:
                    # a group without momentum keeps its buffer and steps
                    # on the raw grad, as the per-leaf path does
                    live = mu_i != 0.0
                    buf_new = torch.where(live, mom_buf, buf)
                    g = torch.where(live, g_mom, g)
            if self.wd_after_momentum and not (wd_scalar and wd_i == 0.0):
                g = g + wd_i * p32
            new_p.append(p32 - lr_i * g)
            new_buf.append(buf_new)

        new_p = base.bucket_select(pred, new_p, p_b)
        new_buf = base.bucket_select(pred, new_buf, buf_b)
        new_params = bucketing.unpack(plan, new_p)
        new_master = self._emit_slot(plan, new_p, resident) if has_master else None
        return new_params, SGDState(step, self._emit_slot(plan, new_buf, resident), new_master)
