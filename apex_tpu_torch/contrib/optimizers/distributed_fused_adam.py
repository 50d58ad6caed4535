"""DistributedFusedAdam — ZeRO optimizer-state sharding over the
data-parallel group (counterpart of
:mod:`apex_tpu.contrib.optimizers.distributed_fused_adam`).

Reference: ``apex/contrib/optimizers/distributed_fused_adam.py:266``.
On :mod:`._zero_engine`: m, v and the fp32 master (or, with
``store_param_remainders``, the uint16 remainders) live as this rank's
1/world shard of each bucket; grads reduce-scatter a bucket at a time,
the shards update in ONE kernel launch (``mt_adam`` over every bucket's
shard, or ``mt_adam_remainder``), and the new params all-gather a bucket
at a time.  The kernel commits (the finite vote read on the device)
before the gather, so ``overlap_param_sync`` is recorded and gathers
the committed shard.  The shard update is :func:`~apex_tpu_torch.ops.multi_tensor
.adam_math`, the per-leaf FusedAdam's numerics, so the fp32
trajectories are bit-exact with FusedAdam's where the sync adds no
rounding (world 1; exactly representable grads at any world).

``store_param_remainders`` keeps the JAX package's truncation
convention (:func:`~apex_tpu_torch.ops.multi_tensor.split_master`): the
bf16 param is the master's high half, so it can differ by 1 ulp toward
zero from the fp32-master mode's round-to-nearest; the master itself is
exact either way.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.contrib.optimizers._zero_engine import ZeroOptimizerBase, local_leaf_info
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.ops.multi_tensor import master_from_remainder as _master_from_remainder  # noqa: F401
from apex_tpu_torch.ops.multi_tensor import split_master as _split_master  # noqa: F401
from apex_tpu_torch.transformer.parallel_state import DATA_AXIS

__all__ = ["DistributedFusedAdam", "DistributedFusedAdamState", "local_total_and_axes"]


class DistributedFusedAdamState(NamedTuple):
    step: torch.Tensor                    # int32 scalar
    exp_avg: Tuple[torch.Tensor, ...]     # per-bucket fp32 shards
    exp_avg_sq: Tuple[torch.Tensor, ...]  # per-bucket fp32 shards
    # fp32 master shards, or with store_param_remainders the uint16 low
    # halves the bf16 params lack
    master_shard: Tuple[torch.Tensor, ...]
    # quantized grad sync only: the full-bucket error-feedback residuals
    # in the bucket's dtype; () on wide wires
    residual: Tuple[torch.Tensor, ...] = ()


def local_total_and_axes(params, param_specs, axis_sizes, zero_axis):
    """``(local_total_numel, model_axes, leaf_repl)``: the flat summary of
    :func:`~apex_tpu_torch.contrib.optimizers._zero_engine.local_leaf_info`
    on the whole params (the JAX package's helper of the same name)."""
    shapes, model_axes, repl = local_leaf_info(params, param_specs, axis_sizes, zero_axis)
    total = sum(int(np.prod(s)) if s else 1 for s in shapes)
    return total, model_axes, repl


class DistributedFusedAdam(ZeroOptimizerBase):
    """ZeRO AdamW with the reference's constructor vocabulary."""

    _STATE_CLS = DistributedFusedAdamState

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 adam_w_mode: bool = True, weight_decay: float = 0.0,
                 axis_name: str = DATA_AXIS, grad_average: bool = True,
                 overlap_grad_sync: bool = True, overlap_param_sync: bool = False,
                 bucket_cap_mb: float = 100.0, dtype=torch.float32, grad_sync_dtype=None,
                 param_sync_dtype=None, process_group=None, distributed_process_group=None,
                 redundant_process_group=None, store_param_remainders: bool = False,
                 dp_axes=None):
        super().__init__(
            lr, weight_decay, axis_name=axis_name, grad_average=grad_average,
            overlap_grad_sync=overlap_grad_sync, overlap_param_sync=overlap_param_sync,
            bucket_cap_mb=bucket_cap_mb, grad_sync_dtype=grad_sync_dtype,
            param_sync_dtype=param_sync_dtype, store_param_remainders=store_param_remainders,
            dtype=dtype, dp_axes=dp_axes, process_group=process_group,
            distributed_process_group=distributed_process_group,
            redundant_process_group=redundant_process_group)
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode

    def init(self, params, world_size: Optional[int] = None, param_specs=None,
             axis_sizes=None) -> DistributedFusedAdamState:
        """This rank's state: zero m and v shards, the fp32 master shard
        packed from ``params`` (or zero remainders, which rebuild exactly
        the bf16 params' fp32 extension), zero residuals on a quantized
        wire.  ``world_size``, when given, must be the group's.

        Composition with model parallelism: ``params`` are this rank's
        shard of params split over model axes (what the step holds),
        ``param_specs`` their specs and ``axis_sizes`` the axes' sizes
        (``{"tp": N, "pp": M}``); the plan is that of the local leaves,
        and the state the dp shard of this rank's model segment.  With
        ``dp_axes``, ``axis_sizes`` also gives each dp hop's size."""
        self._init_plan(params, world_size, param_specs, axis_sizes)
        return DistributedFusedAdamState(
            step=torch.zeros((), dtype=torch.int32, device=self._device),
            exp_avg=self._zero_slot(), exp_avg_sq=self._zero_slot(),
            master_shard=self._master_slot(params), residual=self._residual_slot())

    def _zero_step(self, grads, state: DistributedFusedAdamState, params, grads_finite=None,
                   lr=None, scale=None, clip_norm=None, finite_sync=None, sumsq_reduce=None,
                   want_finite=False, presynced=None, inplace=False):
        lr = self.lr if lr is None else lr
        with torch.no_grad():
            plan, g_shards, res_new, pred, step = self._run_step(
                grads, state, params, grads_finite, scale, clip_norm, finite_sync,
                sumsq_reduce, want_finite, presynced)
            bc1, bc2 = self._bias_corrections(step)
            kw = dict(lr=lr, wd=[self.weight_decay] * len(g_shards), bc1=bc1, bc2=bc2,
                      beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                      adam_w_mode=self.adam_w_mode, pred=pred)

            # in place, the kernel writes m, v and the master over the
            # shards it reads (each element read before it is written)
            def out_like(slot):
                return list(slot) if inplace else [torch.empty_like(a) for a in slot]

            new_m, new_v = out_like(state.exp_avg), out_like(state.exp_avg_sq)
            if self.store_param_remainders:
                p_owned = self._owned_param_shards(plan, params)
                p_out = [torch.empty_like(p) for p in p_owned]
                rem_out = out_like(state.master_shard)
                mt.mt_adam_remainder(g_shards, p_owned, list(state.master_shard),
                                     list(state.exp_avg), list(state.exp_avg_sq), p_out,
                                     rem_out, new_m, new_v, **kw)
                master_out, gather_src = rem_out, p_out
            else:
                # the gathered shard in the param-sync dtype and the fp32
                # master, written by one pass (one buffer when every
                # bucket syncs in fp32)
                master_out = out_like(state.master_shard)
                sync = [self._param_dtype(b) for b in plan.buckets]
                if all(dt == torch.float32 for dt in sync):
                    gather_src, extra = master_out, None
                else:
                    gather_src = [torch.empty_like(m, dtype=dt) for m, dt in zip(master_out, sync)]
                    extra = master_out
                mt.mt_adam(g_shards, list(state.master_shard), list(state.exp_avg),
                           list(state.exp_avg_sq), gather_src, new_m, new_v, extra, **kw)
            res_committed = self._commit_residuals(res_new, state.residual, pred, inplace)
            new_params = self._emit_params(plan, gather_src, params, None, inplace)
            if inplace:
                state.step.copy_(step)
                return params, state, pred
        return new_params, DistributedFusedAdamState(
            step, tuple(new_m), tuple(new_v), tuple(master_out), res_committed), pred
