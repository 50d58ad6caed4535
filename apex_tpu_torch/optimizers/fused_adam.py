"""FusedAdam: Adam/AdamW with the JAX package's numerics (counterpart
of :mod:`apex_tpu.optimizers.fused_adam`, per-leaf path).

Per element, in fp32:

- L2 mode (``adam_w_mode=False``): ``g += wd * p`` before the moments;
- AdamW mode (default): ``update = m_hat / (sqrt(v_hat) + eps) + wd * p``;
- ``m = b1 * m + (1 - b1) * g``, ``v = b2 * v + (1 - b2) * (g * g)``
  (that association, pinned for bit-exact parity), ``m_hat = m / bc1``,
  ``v_hat = v / bc2`` with ``bc = 1 - beta**t`` when ``bias_correction``;
- ``p = p - lr * update``.

The expressions are the JAX package's ``adam_core``/``adam_math``
verbatim, so the two agree to the last fp32 ulp.
"""

from typing import Any, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.optimizers import base


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    exp_avg: Any  # m, fp32 tree
    exp_avg_sq: Any  # v, fp32 tree
    master: Optional[Any] = None  # fp32 master params (if enabled)


def adam_core(g, m, v, bc1, bc2, *, beta1, beta2, eps):
    """New moments and the core update ``m_hat / (sqrt(v_hat) + eps)``."""
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * (g * g)
    core = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    return core, m_new, v_new


def adam_math(g, p32, m, v, wd_i, lr_i, bc1, bc2, *, beta1, beta2, eps, adam_w_mode):
    """One Adam step per element (AdamW / L2 mode)."""
    if not adam_w_mode:
        g = g + wd_i * p32
    core, m_new, v_new = adam_core(g, m, v, bc1, bc2, beta1=beta1, beta2=beta2, eps=eps)
    update = core + wd_i * p32 if adam_w_mode else core
    return p32 - lr_i * update, m_new, v_new


class FusedAdam(base.OptimizerBase):
    """``FusedAdam(lr, bias_correction, betas, eps, adam_w_mode,
    weight_decay, amsgrad, master_weights)`` as in the JAX package.
    ``use_buckets`` defaults to False here (the per-leaf path; the
    bucketed engine, which the JAX package holds bit-exact with it, is
    not ported and raises), as do ``param_group_fn``/``group_hypers``."""

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
        use_buckets: bool = False,
    ):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad variant.")
        if param_group_fn is not None or group_hypers is not None:
            raise NotImplementedError(
                "FusedAdam(param_group_fn=..., group_hypers=...) (per-group "
                "hyperparameters) is not ported yet")
        super().__init__(lr, weight_decay, master_weights, use_buckets=use_buckets)
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode

    def init(self, params, bucketed: bool = False) -> AdamState:
        if bucketed:
            raise NotImplementedError(
                "FusedAdam.init(bucketed=True) (bucket-resident state) is not "
                "ported yet")
        leaves = base.tree_leaves(params)
        device = leaves[0].device if leaves else None

        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            exp_avg=base.tree_map(zeros, params),
            exp_avg_sq=base.tree_map(zeros, params),
            master=base.make_master(params, self.master_weights),
        )

    def _leaf_update(self, grads, state: AdamState, params, grads_finite=None, lr=None):
        lr = self.lr if lr is None else lr
        wd = self.weight_decay
        step = base.predicate_step(grads_finite, state.step)
        bc1, bc2 = self._bias_corrections(step)
        p_math = base.math_params(params, state.master)

        def one(g, p, m, v):
            return adam_math(g.to(torch.float32), p.detach().to(torch.float32), m, v,
                             wd, lr, bc1, bc2, beta1=self.beta1, beta2=self.beta2,
                             eps=self.eps, adam_w_mode=self.adam_w_mode)

        trees = (grads, p_math, state.exp_avg, state.exp_avg_sq)
        base.tree_map(lambda *_: None, *trees)  # the four trees share grads' structure
        outs = [one(*leaf) for leaf in zip(*map(base.tree_leaves, trees))]

        def pick(i):
            return base.tree_unflatten(grads, [o[i] for o in outs])

        p_new = base.select(grads_finite, pick(0), p_math)
        m_new = base.select(grads_finite, pick(1), state.exp_avg)
        v_new = base.select(grads_finite, pick(2), state.exp_avg_sq)
        new_params, new_master = base.emit_params(p_new, params, state.master)
        return new_params, AdamState(step, m_new, v_new, new_master)
