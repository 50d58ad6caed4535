"""The ZeRO bucket engine: optimizer state sharded over the data-parallel
group on the bucket plan (counterpart of
:mod:`apex_tpu.contrib.optimizers._zero_engine`).

Reference: ``apex/contrib/optimizers/distributed_fused_adam.py`` —
fixed-size buckets, reduce-scatter grad sync, all-gather param sync,
optimizer state sharded over the process group.  The JAX package runs
it as one SPMD program (``shard_map`` over the ``dp`` axis,
``psum_scatter`` / ``all_gather`` inside ``jax.jit``); here each rank is
a process and the collectives are ``torch.distributed``'s over the
data-parallel process group
(:func:`apex_tpu_torch.transformer.parallel_state.get_data_parallel_group`):
NCCL on the card, gloo on the CPU.  Everything else is the JAX engine's:

- **the bucket plan is the fragment map**: params flatten in tree order
  into dtype buckets split at ``bucket_cap_mb``, each padded so it cuts
  into ``world`` shards of whole :data:`~._quantized_sync.QBLOCK`-element
  blocks (``bucketing.plan_of(shard_pad=world, block=QBLOCK)``);
- **each process holds its 1/world shard of every bucket** of m, v and
  the fp32 master (or, with ``store_param_remainders``, the uint16 low
  halves the bf16 params lack), and on a quantized wire its full-bucket
  error-feedback residual;
- **grad sync is one reduce-scatter a bucket** in ``grad_sync_dtype``
  (the bucket's dtype for half buckets by default), or the int8/fp8
  quantized wire of :mod:`._quantized_sync`;
- **param sync is one all-gather a bucket** in ``param_sync_dtype``,
  sliced back into the leaves through the plan's offsets.

The update of the shards is one kernel launch: the ``mt_adam`` kernel
over every bucket's shard (fp32 master), or ``mt_adam_remainder``
(remainder mode), with the clip coefficient and the finite vote read on
the device.  Small fp32 sums over the group (per-leaf Σx² for the clip
and LAMB's trust ratios) are added in rank order
(:func:`._quantized_sync.rank_order_sum`), as XLA's CPU ``psum`` adds.
Nothing reads a device value on the host, so the step captures as one
CUDA graph with its collectives.  A collective that fails raises;
nothing falls back.

Not ported yet, each raising with its ROADMAP.md item: ``dp_axes``
(the hierarchical sync), ``param_specs`` (ZeRO composed with tensor
parallelism), and the backward-overlapped sync (``make_train_step(
overlap_grad_sync=True)``).
"""

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.contrib.optimizers import _quantized_sync as qs
from apex_tpu_torch.observability import stepstats as _stepstats
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers import bucketing
from apex_tpu_torch.optimizers.base import _clip_coef, _mult, bias_corrections
from apex_tpu_torch.optimizers.tree import tree_leaves, tree_unflatten
from apex_tpu_torch.parallel.distributed import all_gather_flat, reduce_scatter_flat
from apex_tpu_torch.transformer.parallel_state import DATA_AXIS

__all__ = ["ZeroOptimizerBase", "resolve_sync_dtype", "HIER_ITEM", "OVERLAP_ITEM"]

#: wide sync dtypes: the wire carries the values themselves
_SUPPORTED_SYNC = ("float32", "bfloat16", "float16")
#: quantized wire dtypes (grad sync only)
_QUANTIZED_GRAD_SYNC = ("int8", "float8_e4m3fn", "float8_e5m2")

#: what brings the parts of the JAX engine not ported yet
HIER_ITEM = "the hierarchical dp sync, ROADMAP.md queue 1 item 6 (what it left)"
OVERLAP_ITEM = "the backward-overlapped grad sync, ROADMAP.md queue 1 item 6 (what it left)"
TP_ITEM = "ZeRO composed with tensor and pipeline parallelism, ROADMAP.md queue 1 item 12"


def resolve_sync_dtype(value, knob: str) -> Optional[torch.dtype]:
    """Validate a ``grad_sync_dtype`` / ``param_sync_dtype`` knob (a
    torch dtype or its name); None means the per-bucket default.
    ``grad_sync_dtype`` alone takes the quantized wires."""
    if value is None:
        return None
    name = bucketing.dtype_name(value) if isinstance(value, torch.dtype) else str(value)
    if name in _SUPPORTED_SYNC:
        return bucketing.torch_dtype(name)
    if name in _QUANTIZED_GRAD_SYNC:
        if knob == "grad_sync_dtype":
            return getattr(torch, name)
        raise ValueError(
            f"{knob}={name!r}: quantized sync is gradient-only — a param all-gather has "
            f"no error-feedback channel; pass one of {_SUPPORTED_SYNC} or None")
    raise ValueError(
        f"{knob}={name!r} is not supported: pass one of {_SUPPORTED_SYNC}, None (the "
        f"bucket's dtype for bf16/fp16 buckets, float32 otherwise), or for "
        f"grad_sync_dtype a quantized wire dtype {_QUANTIZED_GRAD_SYNC}")


def _py(v):
    """A checkpoint's scalar or string leaf as a Python value."""
    if isinstance(v, torch.Tensor):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.item()
    return v


def _t(a) -> torch.Tensor:
    """A saved piece as a flat CPU tensor: a tensor, or a numpy array
    (the JAX package's, bf16 as ``ml_dtypes`` words included)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().reshape(-1)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).reshape(-1)
    return torch.from_numpy(a.copy()).reshape(-1)


class ZeroOptimizerBase:
    """Constructor plumbing and the shard machinery of the ZeRO
    optimizers; subclasses hold the state class and ``_zero_step``."""

    #: ``update_scaled`` covers the whole step (unscale, vote, clip)
    supports_update_scaled = True
    #: the state NamedTuple class (subclasses set it)
    _STATE_CLS = None
    #: the JAX package's shard format; v2 files load into wide wires only
    SHARD_FORMAT = "apex_tpu_zero2_v3"
    _READ_FORMATS = ("apex_tpu_zero2_v2", "apex_tpu_zero2_v3")

    def __init__(self, lr: float, weight_decay: float, axis_name: str = DATA_AXIS,
                 grad_average: bool = True, overlap_grad_sync: bool = True,
                 overlap_param_sync: bool = False, bucket_cap_mb: float = 100.0,
                 grad_sync_dtype=None, param_sync_dtype=None,
                 store_param_remainders: bool = False, dtype=torch.float32,
                 dp_axes: Optional[Sequence[str]] = None, process_group=None,
                 distributed_process_group=None, redundant_process_group=None):
        if dp_axes is not None or distributed_process_group is not None \
                or redundant_process_group is not None:
            raise NotImplementedError(
                f"dp_axes={dp_axes!r} (a hierarchical data-parallel split) is not ported "
                f"yet: it comes with {HIER_ITEM}")
        self.lr = lr
        self.weight_decay = weight_decay
        self.axis_name = axis_name
        self.grad_average = grad_average
        # the reference's knob for its side-stream engine, recorded; the
        # backward-overlapped sync is make_train_step(overlap_grad_sync=)
        self.overlap_grad_sync = overlap_grad_sync
        self.overlap_param_sync = overlap_param_sync
        if bucket_cap_mb is not None and bucket_cap_mb <= 0:
            raise ValueError(f"bucket_cap_mb must be positive, got {bucket_cap_mb}")
        self.bucket_cap_mb = bucket_cap_mb
        self._cap_bytes = None if bucket_cap_mb is None else int(bucket_cap_mb * 2 ** 20)
        self.grad_sync_dtype = resolve_sync_dtype(grad_sync_dtype, "grad_sync_dtype")
        self.param_sync_dtype = resolve_sync_dtype(param_sync_dtype, "param_sync_dtype")
        self.store_param_remainders = store_param_remainders
        if store_param_remainders and self.param_sync_dtype not in (None, torch.bfloat16):
            raise ValueError(
                "store_param_remainders gathers the master's bf16 high half; "
                f"param_sync_dtype must be None or bfloat16, got {self.param_sync_dtype}")
        self.process_group = process_group
        self._plan = None

    # -------------------------------------------------------------- group
    def _resolve_group(self):
        """``(ProcessGroup, world, rank)`` of the data-parallel group:
        ``process_group`` when given (an ``AxisGroup`` or a
        ProcessGroup), else ``parallel_state``'s."""
        import torch.distributed as dist

        from apex_tpu_torch.transformer import parallel_state

        g = self.process_group
        if g is None:
            if self.axis_name != DATA_AXIS:
                raise ValueError(f"axis_name={self.axis_name!r}: the port's ZeRO optimizers "
                                 f"shard over the {DATA_AXIS!r} group")
            g = parallel_state.get_data_parallel_group()
        if isinstance(g, parallel_state.AxisGroup):
            return g.group, g.size(), g.rank()
        return g, dist.get_world_size(g), dist.get_rank(g)

    # --------------------------------------------------------------- plan
    def _init_plan(self, params, world_size, param_specs, axis_sizes):
        if param_specs is not None or axis_sizes is not None:
            raise NotImplementedError(f"param_specs is not ported yet: it comes with {TP_ITEM}")
        self._pg, world, self._rank = self._resolve_group()
        if world_size is not None and int(world_size) != world:
            raise ValueError(f"world_size={world_size} but the data-parallel group has "
                             f"{world} ranks")
        self._world = world
        leaves = tree_leaves(params)
        if self.store_param_remainders:
            bad = [l.dtype for l in leaves if l.dtype != torch.bfloat16]
            if bad:
                raise ValueError(f"store_param_remainders requires bf16 params (got "
                                 f"{bad[:3]}): the master's high 16 bits must BE the param")
        self._plan = bucketing.plan_of(params, cap_bytes=self._cap_bytes, shard_pad=world,
                                       block=qs.QBLOCK)
        self._device = leaves[0].device
        self._segs = [bucketing.shard_segments(b, self._rank, world) for b in self._plan.buckets]
        # the CPU path's per-leaf sums (the JAX package's segment_sum)
        self._seg_ids = [torch.from_numpy(self._shard_of(b, bucketing.seg_ids(self._plan, b)))
                         .to(torch.int64) for b in self._plan.buckets]
        # record-only uniformity seam: the bucket plan is the step's
        # collective schedule (a reduce-scatter and an all-gather a
        # bucket), so a rank with another plan wedges every rank;
        # check_uniform() names this tag instead
        from apex_tpu_torch.resilience.uniformity import assert_uniform

        assert_uniform("zero.bucket_plan", self.plan_fingerprint())
        return self._plan

    def _require_plan(self) -> bucketing.BucketPlan:
        if self._plan is None:
            raise ValueError("call init() first: the shard layout (bucket plan / "
                             "total_numel) lives on the optimizer")
        return self._plan

    @property
    def world_size(self) -> Optional[int]:
        """The dp world this optimizer's plan and state were built for
        (None before ``init``)."""
        return getattr(self, "_world", None)

    @property
    def rank(self) -> Optional[int]:
        return getattr(self, "_rank", None)

    def plan_fingerprint(self) -> dict:
        """Every input that shapes the collective schedule."""
        plan = self._require_plan()
        return {"world": self._world, "cap_bytes": self._cap_bytes, "model_mult": 1,
                "hier": None, "buckets": [[b.dtype, b.size, b.total, len(b.leaves)]
                                          for b in plan.buckets]}

    def _grad_dtype(self, b) -> torch.dtype:
        if self.grad_sync_dtype is not None:
            return self.grad_sync_dtype
        dt = bucketing.torch_dtype(b.dtype)
        return dt if dt in (torch.bfloat16, torch.float16) else torch.float32

    def _param_dtype(self, b) -> torch.dtype:
        return self.param_sync_dtype or bucketing.torch_dtype(b.dtype)

    @property
    def _quantized(self) -> bool:
        return qs.is_quantized(self.grad_sync_dtype)

    # --------------------------------------------------------------- init
    def _shard_of(self, b, flat):
        return bucketing.shard_views(b, flat, self._rank, self._world)

    def _zero_slot(self, dtype=torch.float32):
        return tuple(torch.zeros(b.total // self._world, dtype=dtype, device=self._device)
                     for b in self._plan.buckets)

    def _residual_slot(self):
        if not self._quantized:
            return ()
        return tuple(torch.zeros(b.total, dtype=bucketing.torch_dtype(b.dtype),
                                 device=self._device) for b in self._plan.buckets)

    def _master_slot(self, params):
        if self.store_param_remainders:
            return self._zero_slot(torch.uint16)
        leaves = [p.detach() for p in tree_leaves(params)]
        return tuple(self._shard_of(b, bucketing.pack_bucket(b, leaves, torch.float32)).clone()
                     for b in self._plan.buckets)

    # ------------------------------------------------------------- checks
    def _check_state_shards(self, plan, slot, name):
        if len(slot) != len(plan.buckets):
            raise ValueError(
                f"optimizer state has {len(slot)} {name} buckets but the param tree plans "
                f"{len(plan.buckets)} (bucket_cap_mb or the param tree changed since this "
                "state was created — reshard it with load_sharded_state_dicts)")
        for arr, b in zip(slot, plan.buckets):
            if arr.shape[0] != b.total // self._world:
                raise ValueError(
                    f"{name} bucket shard has {arr.shape[0]} elements; the plan expects "
                    f"{b.total // self._world} (= {b.total}/dp={self._world}) — state saved "
                    "at a different dp world size must be resharded with "
                    "load_sharded_state_dicts")

    def _check_master_precision(self, master_slot):
        want = torch.uint16 if self.store_param_remainders else torch.float32
        for arr in master_slot:
            if arr.dtype != want:
                have = "remainder_u16" if arr.dtype == torch.uint16 else str(arr.dtype)
                raise ValueError(
                    f"master-precision mismatch: optimizer state holds {have} master shards "
                    f"but this optimizer runs with store_param_remainders="
                    f"{self.store_param_remainders} (expects {want}); a checkpoint saved in "
                    "the other master precision cannot be value-converted silently")

    def _check_residual_state(self, plan, residuals) -> None:
        n = len(residuals) if residuals is not None else 0
        if not self._quantized:
            if n:
                raise ValueError(
                    "optimizer state carries error-feedback residual buckets but this "
                    f"optimizer's grad_sync_dtype={self.grad_sync_dtype} is not quantized: a "
                    "compressed (int8/fp8) checkpoint cannot be value-converted silently — "
                    "construct the optimizer with the matching grad_sync_dtype")
            return
        if n != len(plan.buckets):
            raise ValueError(
                f"grad_sync_dtype={self.grad_sync_dtype} needs one error-feedback residual "
                f"per bucket ({len(plan.buckets)}), state has {n}: this state was saved by "
                "an uncompressed run (or a different bucket layout) — resume with the "
                "matching grad_sync_dtype or reshard with load_sharded_state_dicts")
        for arr, b in zip(residuals, plan.buckets):
            if arr.shape[0] != b.total:
                raise ValueError(f"residual bucket holds {arr.shape[0]} elements; each rank "
                                 f"resides its FULL local bucket ({b.total})")
            if arr.dtype != bucketing.torch_dtype(b.dtype):
                raise ValueError(f"residual bucket dtype {arr.dtype} must match the bucket "
                                 f"storage dtype {b.dtype}")

    # -------------------------------------------------------------- grads
    def bucket_grad_wire(self, bi, leaves, scale=None, residual=None):
        """ONE bucket's gradient wire: ``(g32_shard, new_residual,
        pre_wire)`` — the fp32 1/world shard of the synced grad, and on a
        quantized wire the uncommitted residual and the fp32
        pre-quantization bucket for the finite vote (both None on wide
        wires)."""
        b = self._plan.buckets[bi]
        pg, world, rank = self._pg, self._world, self._rank
        sdt = self._grad_dtype(b)
        spec = qs.qspec_of(sdt)
        inv = _mult(scale, None)  # 1/scale, a device tensor or a float
        if spec is not None:
            if residual is None:
                raise ValueError("bucket_grad_wire on a quantized wire needs this bucket's "
                                 "error-feedback residual (state.residual[bi])")
            h = bucketing.pack_bucket(b, leaves, torch.float32, scale=inv)
            h = h + residual.to(torch.float32)
            g_sum, res_new = qs.quantized_reduce_scatter(h, pg, spec, rank, world)
            g32 = g_sum / world if self.grad_average else g_sum
            return g32, res_new.to(bucketing.torch_dtype(b.dtype)), h
        # fp16 sync pre-divides (a world-sized fp16 sum would overflow);
        # fp32/bf16 divide after, in fp32
        predivide = self.grad_average and sdt == torch.float16
        bucket = bucketing.pack_bucket(b, leaves, sdt, scale=(1.0 / world) if predivide else None)
        g_loc = torch.empty(b.total // world, dtype=sdt, device=bucket.device)
        reduce_scatter_flat(g_loc, bucket, pg)
        g32 = g_loc.to(torch.float32)
        if self.grad_average and not predivide and world != 1:
            g32 = g32 / world
        if inv is not None:
            g32 = g32 * inv
        return g32, None, None

    def _prepare_grads(self, plan, grads, scale, clip_norm, finite_sync, want_finite,
                       grads_finite, sumsq_reduce, residuals=None):
        """The sharded grad read: every bucket's wire, then the finite
        vote (agreed over the group by a MAX all-reduce, then
        ``finite_sync`` for the model-parallel groups), then the
        global-L2 clip from per-leaf Σx² of the shards.  Returns
        ``(g32_shards, new_residuals, pred)``; the residuals are
        uncommitted."""
        from apex_tpu_torch.transformer.amp.grad_scaler import sync_found_inf

        self._check_residual_state(plan, residuals)
        leaves = [g.detach() for g in tree_leaves(grads)]
        if len(leaves) != plan.n_leaves:
            raise ValueError(f"grad tree has {len(leaves)} leaves; plan expects "
                             f"{plan.n_leaves}")
        g_shards, new_residuals, pre_wire = [], [], []
        for bi in range(len(plan.buckets)):
            g32, res_new, h = self.bucket_grad_wire(
                bi, leaves, scale=scale, residual=residuals[bi] if self._quantized else None)
            g_shards.append(g32)
            if res_new is not None:
                new_residuals.append(res_new)
                # a non-finite grad can quantize to finite garbage: vote
                # on the pre-quantization values too
                pre_wire.append(h)

        pred = grads_finite
        if want_finite:
            finite = mt.all_finite(list(g_shards) + pre_wire)
            finite = sync_found_inf(finite, (self._pg,))
            if finite_sync is not None:
                finite = finite_sync(finite)
            pred = finite

        if clip_norm is not None:
            leaf_sq = qs.rank_order_sum(self._per_leaf_sumsq(plan, g_shards), self._pg,
                                        self._world)
            total_sq = (sumsq_reduce(list(leaf_sq.unbind(0))) if sumsq_reduce is not None
                        else torch.sum(leaf_sq))
            norm = mt.sqrt_rn(total_sq)
            _stepstats.offer("grad_norm", norm)
            coef = _clip_coef(norm, clip_norm)
            g_shards = [g * coef for g in g_shards]
        elif _stepstats.capturing():
            # the telemetry's grad norm: Σx² of the shards, summed over
            # the group (only while a telemetry wrapper captures)
            total_sq, _ = mt.mt_l2norm(g_shards)
            _stepstats.offer("grad_norm", torch.sqrt(
                qs.rank_order_sum(total_sq.reshape(1), self._pg, self._world)[0]))
        return g_shards, tuple(new_residuals), pred

    def _per_leaf_sumsq(self, plan, shards) -> torch.Tensor:
        """Per-ORIGINAL-leaf Σx² of this rank's shards (fp32, length
        ``n_leaves``), through the static segment map: on the CPU the JAX
        package's ``segment_sum`` (a serial add in element order); on the
        card one ``mt_l2norm`` launch over the segments (a fixed order)."""
        dev = shards[0].device
        out = torch.zeros(plan.n_leaves, dtype=torch.float32, device=dev)
        if dev.type == "cpu":
            for ids, s in zip(self._seg_ids, shards):
                seg = torch.zeros(plan.n_leaves + 1, dtype=torch.float32)
                seg.index_add_(0, ids, torch.square(s))
                out = out + seg[:plan.n_leaves]
            return out
        views, ids = [], []
        for segs, s in zip(self._segs, shards):
            for leaf_id, a, b in segs:
                views.append(s[a:b])
                ids.append(leaf_id)
        if views:
            _, per = mt.mt_l2norm(views)
            out = out.scatter(0, self._seg_index(ids, dev), per)
        return out

    def _seg_index(self, ids, dev):
        """The device index of the card path's segments (built once, on
        the first, eager call)."""
        key = ("seg_index", dev)
        cache = self.__dict__.setdefault("_dev_cache", {})
        if key not in cache:
            cache[key] = torch.tensor(ids, dtype=torch.int64, device=dev)
        return cache[key]

    def _owned_param_shards(self, plan, params):
        """The rank's bf16 param shard of each bucket (remainder mode)."""
        leaves = [p.detach() for p in tree_leaves(params)]
        return [self._shard_of(b, bucketing.pack_bucket(b, leaves, torch.bfloat16))
                for b in plan.buckets]

    # --------------------------------------------------------------- emit
    def _emit_params(self, plan, shard_out, params, pred):
        """ZeRO param sync: one all-gather a bucket in
        ``param_sync_dtype``, sliced back into the leaves; with ``pred``
        (``overlap_param_sync``) each leaf is selected against the old
        params."""
        leaves = tree_leaves(params)
        new_leaves: List[Optional[torch.Tensor]] = [None] * plan.n_leaves
        for b, shard in zip(plan.buckets, shard_out):
            shard = shard.to(self._param_dtype(b))
            full = torch.empty(b.total, dtype=shard.dtype, device=shard.device)
            all_gather_flat(full, shard, self._pg)
            for bl in b.leaves:
                old = leaves[bl.leaf_id]
                leaf = full[bl.offset:bl.offset + bl.size].view(bl.shape).to(old.dtype)
                if pred is not None:
                    leaf = torch.where(pred, leaf, old.detach())
                new_leaves[bl.leaf_id] = leaf
        return tree_unflatten(params, new_leaves)

    @staticmethod
    def _select(pred, new, old):
        if pred is None:
            return list(new)
        return [torch.where(pred, n, o) for n, o in zip(new, old)]

    def _commit_residuals(self, new_residuals, old_residuals, pred):
        if not self._quantized:
            return ()
        return tuple(self._select(pred, list(new_residuals), list(old_residuals)))

    def _bias_corrections(self, step):
        return bias_corrections(step, self.bias_correction, self.beta1, self.beta2)

    # ---------------------------------------------------------- public API
    def update(self, grads, state, params, grads_finite=None, lr=None, clip_norm=None,
               sumsq_reduce=None):
        """One ZeRO step: ``grads`` are this rank's LOCAL grads (the
        reduce-scatter is the dp sync); ``grads_finite`` predicates the
        commit; ``clip_norm`` folds a global-L2 clip into the sharded
        grad read.  Returns ``(new_params, new_state)``."""
        p, s, _ = self._zero_step(grads, state, params, grads_finite=grads_finite, lr=lr,
                                  clip_norm=clip_norm, sumsq_reduce=sumsq_reduce,
                                  want_finite=False)
        return p, s

    def update_scaled(self, grads, state, params, scale=None, clip_norm=None,
                      finite_sync=None, lr=None, sumsq_reduce=None):
        """The fused amp step on the sharded grad read: reduce-scatter,
        fp32 unscale of the shard, the all-finite vote over the group,
        the optional clip, the predicated commit.  Returns
        ``(new_params, new_state, all_finite)``."""
        return self._zero_step(grads, state, params, scale=scale, clip_norm=clip_norm,
                               finite_sync=finite_sync, lr=lr, sumsq_reduce=sumsq_reduce,
                               want_finite=True)

    def step(self, grads, state, params, **kw):
        return self.update(grads, state, params, **kw)

    def _zero_step(self, grads, state, params, **kw):  # pragma: no cover - abstract
        raise NotImplementedError

    def _run_step(self, grads, state, params, grads_finite, scale, clip_norm, finite_sync,
                  sumsq_reduce, want_finite):
        """The common head of a step: the plan, the checks, the synced
        grad shards, the predicate and the new step counter."""
        from apex_tpu_torch.optimizers.base import predicate_step

        plan = self._require_plan()
        self._check_master_precision(state.master_shard)
        g_shards, res_new, pred = self._prepare_grads(
            plan, grads, scale, clip_norm, finite_sync, want_finite, grads_finite,
            sumsq_reduce, residuals=state.residual)
        self._check_state_shards(plan, state.exp_avg, "exp_avg")
        if pred is not None:
            pred = torch.as_tensor(pred, device=g_shards[0].device).to(torch.bool).reshape(())
        return plan, g_shards, res_new, pred, predicate_step(pred, state.step)

    # ------------------------------------------------------- wire bytes
    def wire_bytes_per_step(self) -> Dict[str, Any]:
        """Static per-step wire accounting off the bucket plan (what the
        ``zero_gpt124`` bench reports): ``grad_payload``, ``grad_scales``,
        ``grad_sync``, ``param_sync``, ``total`` and ``hops`` (one, the
        flat dp group)."""
        plan = self._require_plan()
        d = {"grad_payload": 0, "grad_scales": 0, "param_sync": 0}
        for b in plan.buckets:
            hb = qs.grad_sync_bytes(b.total, self._grad_dtype(b), flat_hop=self.axis_name)
            d["grad_payload"] += hb[self.axis_name]["payload"]
            d["grad_scales"] += hb[self.axis_name]["scales"]
            d["param_sync"] += b.total * torch.empty(
                (), dtype=self._param_dtype(b)).element_size()
        d["grad_sync"] = d["grad_payload"] + d["grad_scales"]
        d["total"] = d["grad_sync"] + d["param_sync"]
        out = {k: d[k] for k in ("grad_payload", "grad_scales", "grad_sync", "param_sync",
                                  "total")}
        out["hops"] = {self.axis_name: dict(d)}
        return out

    def sync_plan_hops(self):
        """One wire record a bucket (the trace's sync-plan markers)."""
        plan = self._require_plan()
        out = []
        for i, b in enumerate(plan.buckets):
            hb = qs.grad_sync_bytes(b.total, self._grad_dtype(b), flat_hop=self.axis_name)
            for hop, v in hb.items():
                out.append({"bucket": i, "hop": hop, "bucket_dtype": b.dtype,
                            "wire_dtype": bucketing.dtype_name(self._grad_dtype(b)),
                            "payload_bytes": int(v["payload"]),
                            "scale_bytes": int(v["scales"])})
        return out

    # ------------------------------------------------------- state dicts
    @property
    def _master_kind(self) -> str:
        return "remainder_u16" if self.store_param_remainders else "fp32"

    @property
    def _residual_kind(self) -> str:
        return "ef" if self._quantized else "none"

    def _check_residual_kind(self, d) -> None:
        kind = _py(d.get("residual_kind")) or "none"
        if kind != self._residual_kind:
            have = ("a compressed (error-feedback) checkpoint" if kind == "ef"
                    else "an uncompressed checkpoint")
            raise ValueError(
                f"checkpoint residual_kind {kind!r} does not match this optimizer's "
                f"({self._residual_kind!r}): {have} cannot restore into an optimizer whose "
                f"grad_sync_dtype={self.grad_sync_dtype} — construct the optimizer with the "
                "matching grad_sync_dtype (quantized <-> not is a state-layout change, like "
                "store_param_remainders)")

    def _check_master_kind(self, d) -> None:
        kind = _py(d.get("master_kind")) or "fp32"
        if kind != self._master_kind:
            raise ValueError(f"checkpoint master_kind {kind!r} does not match this "
                             f"optimizer's ({self._master_kind!r}): set "
                             f"store_param_remainders={kind == 'remainder_u16'}")

    def _bucket_meta(self):
        return [{"dtype": b.dtype, "size": b.size, "total": b.total}
                for b in self._require_plan().buckets]

    def _state_arrays(self, state) -> Dict[str, Sequence]:
        return {f: getattr(state, f) for f in state._fields if f != "step"}

    def state_dict(self, state):
        """The whole state (the reference's ``gather_on_root=True``):
        every rank's shards all-gathered into full per-bucket CPU
        tensors, the residuals as ``(world, total)``.  A collective:
        every rank calls it."""
        d = {"format": self.SHARD_FORMAT, "step": int(state.step),
             "master_kind": self._master_kind, "residual_kind": self._residual_kind,
             "buckets": self._bucket_meta()}
        for name, slot in self._state_arrays(state).items():
            pieces = []
            for arr in slot:
                src = arr.contiguous()
                if src.dtype == torch.uint16:
                    src = src.view(torch.int16)
                full = torch.empty(self._world * src.numel(), dtype=src.dtype,
                                   device=src.device)
                all_gather_flat(full, src, self._pg)
                a = full.view(arr.dtype).cpu()
                pieces.append(a.view(self._world, -1) if name == "residual" else a)
            d[name] = pieces
        return d

    def load_state_dict(self, d):
        """This rank's state from :meth:`state_dict`'s whole arrays."""
        fmt = _py(d.get("format"))
        if fmt not in self._READ_FORMATS:
            raise ValueError(f"unrecognized state_dict format {fmt!r}: this optimizer reads "
                             f"{self._READ_FORMATS} (per-bucket arrays); pre-bucket-plan "
                             "(flat v1) checkpoints cannot be loaded")
        self._check_master_kind(d)
        self._check_residual_kind(d)
        plan = self._require_plan()
        fields = {"step": torch.tensor(int(_py(d["step"])), dtype=torch.int32,
                                       device=self._device)}
        for f in [f for f in self._STATE_CLS._fields if f != "step"]:
            src = d.get(f, ()) if f == "residual" else d[f]
            out = []
            for a, b in zip(src, plan.buckets):
                a = _t(a)
                a = a.view(-1, b.total)[self._rank] if f == "residual" else self._shard_of(b, a)
                out.append(a.clone().to(self._device))
            fields[f] = tuple(out)
        return self._STATE_CLS(**fields)

    def sharded_state_dict(self, state, rank: Optional[int] = None,
                           world_size: Optional[int] = None):
        """This rank's shard of the state with the layout metadata that a
        reshard needs (the reference's ``state_dict(gather_on_root=
        False)``), in the JAX package's format: each bucket's piece is
        ``(model_mult, shard)`` numpy, a residual ``(model_mult,
        total)``: views of the live state, not copies (a checkpointer's
        snapshot copies them to host once; copy them before the next step
        otherwise).  A process holds only its own shard, so ``rank`` and
        ``world_size`` must be its own."""
        plan = self._require_plan()
        rank = self._rank if rank is None else int(rank)
        world_size = self._world if world_size is None else int(world_size)
        if world_size != self._world:
            raise ValueError(f"state was built for dp={self._world}; sharded_state_dict "
                             f"slices that layout (got world_size={world_size})")
        if rank != self._rank:
            raise ValueError(f"this process holds rank {self._rank}'s shard, not rank {rank}'s")
        d = {"format": self.SHARD_FORMAT, "master_kind": self._master_kind,
             "residual_kind": self._residual_kind, "rank": rank, "world_size": world_size,
             "model_mult": 1, "step": int(state.step), "buckets": self._bucket_meta(),
             "total_numel": int(sum(b.size for b in plan.buckets))}
        for name, slot in self._state_arrays(state).items():
            d[name] = [arr.detach().reshape(1, -1) for arr in slot]
        return d

    #: "caller did not say" (None is a meaningful grad_sync_dtype)
    _UNSPECIFIED = object()

    @classmethod
    def load_sharded_state_dicts(cls, shards, world_size: int, rank: int = 0,
                                 store_param_remainders: Optional[bool] = None,
                                 grad_sync_dtype=_UNSPECIFIED, device="cpu"):
        """Rank ``rank``'s state for a world of ``world_size`` from every
        saved rank's shard dict (which may come from another world, or
        from the JAX package, whose buckets pad otherwise): per bucket,
        concat the saved slices, trim to the payload, re-pad with this
        package's ZeRO formula, cut this rank's shard.  Residuals: the
        saved per-rank buckets at the same world, else their sum on rank
        0 (zeros elsewhere): what the trajectory sees is ``Σ_r (g_r +
        residual_r)``.  ``grad_sync_dtype`` / ``store_param_remainders``
        refuse a checkpoint of the other kind up front."""
        skip = set(cls._STATE_CLS._fields) | {"buckets"}
        shards = [{k: (v if k in skip else _py(v)) for k, v in d.items()} for d in shards]
        for d in shards:
            d["buckets"] = [{k: _py(v) for k, v in bm.items()} for bm in d["buckets"]]
        shards = sorted(shards, key=lambda d: d["rank"])
        if not shards:
            raise ValueError("no shards given")
        meta = shards[0]
        if meta.get("format") not in cls._READ_FORMATS:
            raise ValueError(f"unrecognized shard format {meta.get('format')!r} (pre-bucket-"
                             "plan checkpoints cannot be resharded by this version)")
        saved_world = meta["world_size"]
        if [d["rank"] for d in shards] != list(range(saved_world)):
            raise ValueError(f"incomplete shard set: got ranks {[d['rank'] for d in shards]}, "
                             f"saved world size is {saved_world}")
        for d in shards:
            for key in ("model_mult", "total_numel", "step", "world_size"):
                if d[key] != meta[key]:
                    raise ValueError(f"shard {d['rank']} disagrees on {key}")
            for kind_key, default in (("master_kind", "fp32"), ("residual_kind", "none")):
                if d.get(kind_key, default) != meta.get(kind_key, default):
                    raise ValueError(f"shard {d['rank']} disagrees on {kind_key}")
        if meta["model_mult"] != 1:
            raise NotImplementedError(f"a state saved with model-parallel shards "
                                      f"(model_mult={meta['model_mult']}): {TP_ITEM}")
        if store_param_remainders is not None:
            want = "remainder_u16" if store_param_remainders else "fp32"
            got = meta.get("master_kind", "fp32")
            if got != want:
                raise ValueError(f"checkpoint master_kind {got!r} does not match "
                                 f"store_param_remainders={store_param_remainders}")
        res_kind = meta.get("residual_kind", "none")
        if grad_sync_dtype is not cls._UNSPECIFIED:
            resolved = resolve_sync_dtype(grad_sync_dtype, "grad_sync_dtype")
            want_kind = "ef" if qs.is_quantized(resolved) else "none"
            if res_kind != want_kind:
                raise ValueError(
                    f"checkpoint residual_kind {res_kind!r} does not match grad_sync_dtype="
                    f"{resolved}: compressed (error-feedback) and uncompressed states "
                    "cannot be value-converted silently")

        dev = torch.device(device)
        fields = {"step": torch.tensor(int(meta["step"]), dtype=torch.int32, device=dev)}
        for name in [f for f in cls._STATE_CLS._fields if f != "step"]:
            if name == "residual":
                fields[name] = cls._reshard_residuals(shards, meta, world_size, rank, dev) \
                    if res_kind == "ef" else ()
                continue
            out = []
            for bi, bm in enumerate(meta["buckets"]):
                full = torch.cat([_t(d[name][bi]) for d in shards])
                new_total = bucketing.padded_total(bm["size"], bm["dtype"], world_size,
                                                   qs.QBLOCK)
                padded = torch.zeros(new_total, dtype=full.dtype)
                padded[:bm["size"]] = full[:bm["size"]]
                shard = new_total // world_size
                out.append(padded[rank * shard:(rank + 1) * shard].clone().to(dev))
            fields[name] = tuple(out)
        return cls._STATE_CLS(**fields)

    @classmethod
    def _reshard_residuals(cls, shards, meta, world_size: int, rank: int, dev):
        saved_world = meta["world_size"]
        out = []
        for bi, bm in enumerate(meta["buckets"]):
            pieces = [_t(d["residual"][bi]) for d in shards]
            new_total = bucketing.padded_total(bm["size"], bm["dtype"], world_size, qs.QBLOCK)
            new = torch.zeros(new_total, dtype=pieces[0].dtype)
            if world_size == saved_world:
                new[:bm["size"]] = pieces[rank][:bm["size"]]
            elif rank == 0:
                summed = pieces[0][:bm["size"]].to(torch.float32)
                for p in pieces[1:]:
                    summed = summed + p[:bm["size"]].to(torch.float32)
                new[:bm["size"]] = summed.to(pieces[0].dtype)
            out.append(new.to(dev))
        return tuple(out)
