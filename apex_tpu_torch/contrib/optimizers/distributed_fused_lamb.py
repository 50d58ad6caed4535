"""DistributedFusedLAMB — ZeRO-sharded LAMB (counterpart of
:mod:`apex_tpu.contrib.optimizers.distributed_fused_lamb`).

Reference: ``apex/contrib/optimizers/distributed_fused_lamb.py:1061``.
LAMB's trust ratio is per TENSOR, so the shard math reads tensor
boundaries through the plan's static segment map: per-leaf Σp² and Σu²
of this rank's shards (the engine's ``_per_leaf_sumsq``), summed over
the group in rank order, give the global per-leaf norms (with
model-parallel params also summed over the model groups, each leaf
divided by its replication factor first); the ratios broadcast back
onto the shard, and the all-gather stays a pure param sync.  Stage 1 and stage 2 are the per-leaf FusedLAMB's expressions
(:mod:`apex_tpu_torch.optimizers.fused_lamb`) as PyTorch ops over the
shard buffers, as the port's FusedLAMB runs them.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.contrib.optimizers import _quantized_sync as qs
from apex_tpu_torch.contrib.optimizers._zero_engine import ZeroOptimizerBase
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers import bucketing
from apex_tpu_torch.optimizers.base import write_into
from apex_tpu_torch.optimizers.fused_lamb import (
    lamb_grad_clip,
    lamb_stage1_math,
    lamb_trust_ratio,
)
from apex_tpu_torch.transformer.parallel_state import DATA_AXIS

__all__ = ["DistributedFusedLAMB", "DistributedFusedLAMBState"]


class DistributedFusedLAMBState(NamedTuple):
    step: torch.Tensor
    exp_avg: Tuple[torch.Tensor, ...]
    exp_avg_sq: Tuple[torch.Tensor, ...]
    master_shard: Tuple[torch.Tensor, ...]
    residual: Tuple[torch.Tensor, ...] = ()


class DistributedFusedLAMB(ZeroOptimizerBase):

    _STATE_CLS = DistributedFusedLAMBState

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                 adam_w_mode: bool = True, grad_averaging: bool = True,
                 use_nvlamb: bool = False, axis_name: str = DATA_AXIS,
                 overlap_grad_sync: bool = True, overlap_param_sync: bool = False,
                 bucket_cap_mb: float = 100.0, grad_sync_dtype=None, param_sync_dtype=None,
                 dp_axes=None, process_group=None, **parity_kwargs):
        super().__init__(
            lr, weight_decay, axis_name=axis_name, grad_average=grad_averaging,
            overlap_grad_sync=overlap_grad_sync, overlap_param_sync=overlap_param_sync,
            bucket_cap_mb=bucket_cap_mb, grad_sync_dtype=grad_sync_dtype,
            param_sync_dtype=param_sync_dtype, dp_axes=dp_axes, process_group=process_group)
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.max_grad_norm = max_grad_norm
        self.adam_w_mode = adam_w_mode
        self.grad_averaging = grad_averaging
        self.use_nvlamb = use_nvlamb

    def init(self, params, world_size: Optional[int] = None, param_specs=None,
             axis_sizes=None) -> DistributedFusedLAMBState:
        """This rank's state (see :meth:`DistributedFusedAdam.init`)."""
        self._init_plan(params, world_size, param_specs, axis_sizes)
        return DistributedFusedLAMBState(
            step=torch.zeros((), dtype=torch.int32, device=self._device),
            exp_avg=self._zero_slot(), exp_avg_sq=self._zero_slot(),
            master_shard=self._master_slot(params), residual=self._residual_slot())

    def _global_leaf_sumsq(self, plan, shards) -> torch.Tensor:
        """Global per-leaf Σx² from the shards: segment sums, summed over
        the group in rank order (the shards are disjoint); with
        model-parallel params then divided by each leaf's replication
        factor and summed over the model groups, so a leaf every model
        rank holds whole counts once."""
        leaf_sq = qs.rank_order_sum(self._per_leaf_sumsq(plan, shards), self._pg, self._world)
        if self._model_axes:
            leaf_sq = self._model_sum(leaf_sq / self._repl_vector(leaf_sq.device))
        return leaf_sq

    def _repl_vector(self, dev) -> torch.Tensor:
        """The leaves' replication factors on ``dev`` (made once, on the
        first, eager call)."""
        cache = self.__dict__.setdefault("_dev_cache", {})
        key = ("repl", dev)
        if key not in cache:
            cache[key] = torch.tensor(self._leaf_repl, dtype=torch.float32, device=dev)
        return cache[key]

    def _zero_step(self, grads, state: DistributedFusedLAMBState, params, grads_finite=None,
                   lr=None, scale=None, clip_norm=None, finite_sync=None, sumsq_reduce=None,
                   want_finite=False, presynced=None, inplace=False):
        lr = self.lr if lr is None else lr
        wd = self.weight_decay
        with torch.no_grad():
            plan, g_shards, res_new, pred, step = self._run_step(
                grads, state, params, grads_finite, scale, clip_norm, finite_sync,
                sumsq_reduce, want_finite, presynced)
            # LAMB's own global grad-norm clip on the dp-averaged grad
            gn_sq = torch.sum(self._global_leaf_sumsq(plan, g_shards))
            clip = lamb_grad_clip(mt.sqrt_rn(gn_sq), self.max_grad_norm)
            master = list(state.master_shard)
            bc1, bc2 = self._bias_corrections(step)
            u_b, new_m, new_v = [], [], []
            for bi in range(len(plan.buckets)):
                u, m_out, v_out = lamb_stage1_math(
                    g_shards[bi] / clip, master[bi], state.exp_avg[bi], state.exp_avg_sq[bi],
                    wd, bc1, bc2, beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                    adam_w_mode=self.adam_w_mode, grad_averaging=self.grad_averaging)
                u_b.append(u)
                new_m.append(m_out)
                new_v.append(v_out)
            if self.use_nvlamb or wd != 0.0:
                p_sq = self._global_leaf_sumsq(plan, master)
                u_sq = self._global_leaf_sumsq(plan, u_b)
                ratios = list(lamb_trust_ratio(lr, mt.sqrt_rn(p_sq), mt.sqrt_rn(u_sq),
                                               apply_ratio=True).unbind(0))
            else:
                ratios = [float(lr)] * plan.n_leaves
            new_p = []
            for bi, b in enumerate(plan.buckets):
                ratio_b = bucketing.seg_broadcast(b, ratios, device=master[bi].device)
                new_p.append(master[bi] - self._shard_of(b, ratio_b) * u_b[bi])
            new_m = self._select(pred, new_m, state.exp_avg)
            new_v = self._select(pred, new_v, state.exp_avg_sq)
            master_committed = self._select(pred, new_p, master)
            new_state = DistributedFusedLAMBState(
                step, tuple(new_m), tuple(new_v), tuple(master_committed),
                self._commit_residuals(res_new, state.residual, pred))
            if inplace:
                # every norm is taken: the new values overwrite the old
                new_params = self._emit_params(plan, master_committed, params, None, True)
                return new_params, write_into(state, new_state), pred
            new_params = self._emit_params(plan, master_committed, params, None)
        return new_params, new_state, pred
