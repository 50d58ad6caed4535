"""GPT: the forward, the training loss (on one device or split over a
tensor-parallel group), and the paged-KV decode forward.

Counterpart of :mod:`apex_tpu.models.gpt`, with the same layouts: activations ``(seq, batch, hidden)``, attention heads
``(batch, heads, seq, head_dim)``, the same parameter tree (names and
shapes of ``init_params`` there, layers stacked on a leading axis), and
the same expression for each op, so the JAX package's weights load
through :func:`params_from_numpy` and the two agree, gradients included.

Every matmul casts its weight and bias to the activation's dtype at use
(``w.T.to(x.dtype)``), as the JAX package spells it.  For serving,
:func:`params_from_numpy` casts the matmul leaves to ``compute_dtype``
once at load (the same rounding, and the cast at use is then a no-op);
for training it keeps them fp32 (``keep_fp32=True``), so the optimizer
updates fp32 weights and autograd returns fp32 gradients through the
cast, as JAX's ``astype`` transpose does.

The training path is :func:`gpt_loss`: flash attention
(``use_flash_attention``, the flash kernels) or the einsum core, layer
remat (``checkpoint_layers``, policy ``"full"``), and the LM head with
its cross entropy: the dense fp32 head, or with ``fused_ce`` the fused
LM-head CE kernels (:mod:`apex_tpu_torch.ops.fused_ce`).

Tensor and sequence parallelism: :func:`gpt_forward`, :func:`gpt_loss`
and :func:`lm_head_loss` take ``axis_name``, the tensor-parallel group
(an ``AxisGroup`` of :mod:`apex_tpu_torch.transformer.parallel_state`),
where the JAX package runs the same functions inside ``shard_map`` with
the ``tp`` axis name.  Each rank then holds the slices of
:func:`param_specs` (:func:`shard_params` cuts them from the JAX
package's tree, the slice ``shard_map`` gives the same device): q, k, v
and fc1 split over their output rows (column-parallel), wo and fc2 over
their input columns (row-parallel), the tied embedding over the vocab;
the local heads are ``num_attention_heads / tp`` (and ``kv_heads / tp``
with GQA).  The embedding is vocab-parallel, the head the vocab-parallel
cross entropy (dense) or the fused CE kernels on the vocab shard with
the reference's combine.  With ``config.sequence_parallel`` the layers
see ``S / tp`` rows: the embedding's output is split over the sequence,
each column linear all-gathers it and each row linear reduce-scatters,
and the final LayerNorm runs after a gather.  The grads of the LN
scales and biases and of the row linears' biases then need the sum over
the group (:func:`sp_grad_sync`).  A group of one rank computes the
single-device model.  :func:`forward_decode` takes the same group: the
rank's pools then hold its local kv heads.

Mixture of experts (``config.moe_num_experts`` > 0): each layer's FFN is
:func:`~apex_tpu_torch.transformer.expert_parallel.moe_ffn` (params
``layers.moe.{router, w1, b1, w2, b2}`` in place of ``fc*``), its
load-balancing aux summed over the layers (``gpt_forward(return_aux=
True)``) and added to the loss times ``moe_aux_coef`` (:func:`gpt_loss`).
``ep_axis`` (the data-parallel group: EP rides DP) splits the experts,
each rank holding ``E / ep`` of them (``param_specs(config, ep=True)``,
the ``"ep"`` dim); tensor-parallel ranks compute the layer replicated.
As in the JAX package, MoE refuses sequence parallelism (ValueError) and
decoding (NotImplementedError).

Context parallelism: :func:`gpt_forward`, :func:`gpt_loss`,
``train_gpt.make_train_step`` (``cp_group``) and
:func:`make_pp_train_step` take ``cp_axis``, the context-parallel group,
where the JAX package passes the ``cp`` axis name.  ``tokens`` are then
this rank's sequence chunk (rank r holds positions ``r·S .. (r+1)·S``):
the learned positions are sliced there and RoPE rotates by those global
positions, attention is :func:`~apex_tpu_torch.transformer.
context_parallel.ring_attention` over the group (k/v heads repeated
first under GQA; ``config.cp_overlap`` picks the overlapped hop
schedule), and the loss is the mean over the local chunk.  Unlike a
one-rank tp group, a one-rank cp group still runs the ring (one chunk,
the diagonal one).  It refuses sequence parallelism, which splits the
sequence too, as the JAX package does.

The forward is three segments, the JAX package's seam for the
backward-overlapped grad sync (``train_gpt.make_train_step(
overlap_grad_sync=True)``): :func:`_embed_segment`,
:func:`_layers_segment` and :func:`_head_segment`, which
:func:`gpt_forward` composes, so the segmented loss and the monolithic
one are the same functions.  :data:`_OVERLAP_STAGES` gives each param
group's gradient-readiness stage under the segmented backward.
"""

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models._remat import remat_layer, validate_policy
from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.decode_attention import paged_decode_attention
from apex_tpu_torch.ops.fused_ce import check_impl, fused_lm_head_ce
from apex_tpu_torch.ops.rope import rope_cos_sin, rotate
from apex_tpu_torch.transformer.functional import scaled_upper_triang_masked_softmax
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    row_parallel_linear,
    vocab_parallel_embedding,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
)

#: the stacked per-layer leaves cast to ``compute_dtype`` at load for
#: serving
MATMUL_KEYS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo",
               "fc1", "fc1_b", "fc2", "fc2_b")

#: the leaves whose grads a sequence-parallel step sums over tp: used in
#: the sequence-split region, each rank sees only its own tokens
SP_KEYS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "bo", "fc2_b")

#: the MoE leaves cast to ``compute_dtype`` at load for serving (the
#: router stays fp32: its logits are fp32)
MOE_MATMUL_KEYS = ("w1", "b1", "w2", "b2")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The fields of the JAX package's ``GPTConfig``.  ``checkpoint_layers``
    and ``remat_policy`` act when a gradient is taken; ``fused_ce`` and
    ``fused_ce_chunk`` act on the loss path, and ``fused_ce_impl`` must be
    None (the kernels are the one implementation); ``moe_*`` make each
    FFN a mixture of experts.  The options the port cannot run raise at
    construction."""

    vocab_size: int = 50304
    hidden_size: int = 1024
    num_layers: int = 24
    num_attention_heads: int = 16
    max_seq_len: int = 1024
    ffn_hidden_size: Optional[int] = None
    num_query_groups: Optional[int] = None
    position_embedding_type: str = "learned"
    rope_theta: float = 10000.0
    layernorm_eps: float = 1e-5
    compute_dtype: Any = torch.bfloat16
    checkpoint_layers: bool = True
    remat_policy: str = "full"
    sequence_parallel: bool = False
    use_flash_attention: bool = False
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    fused_ce: bool = False
    fused_ce_chunk: int = 128
    fused_ce_impl: Optional[str] = None
    cp_overlap: bool = False

    def __post_init__(self):
        if self.position_embedding_type not in ("learned", "rope"):
            raise ValueError(
                f"position_embedding_type must be 'learned' or 'rope' "
                f"(got {self.position_embedding_type!r})")
        validate_policy(self.remat_policy)
        check_impl(self.fused_ce_impl)
        if self.compute_dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise ValueError(
                f"compute_dtype must be torch.float32, torch.bfloat16 or torch.float16 "
                f"(got {self.compute_dtype})")
        if self.fused_ce and self.compute_dtype == torch.float16:
            raise NotImplementedError(
                "fused_ce with compute_dtype torch.float16 is not ported: the fused-CE "
                "kernels take float32 or bfloat16 x only; use the dense head "
                "(fused_ce=False) for fp16 training")
        if self.num_attention_heads % self.kv_heads != 0:
            raise ValueError(
                f"num_attention_heads ({self.num_attention_heads}) must be "
                f"divisible by num_query_groups ({self.kv_heads})")

    @property
    def ffn(self):
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def moe(self):
        return self.moe_num_experts > 0

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self):
        if self.num_query_groups is None:
            return self.num_attention_heads
        if self.num_query_groups < 1:
            raise ValueError(
                f"num_query_groups must be >= 1 (got {self.num_query_groups}); "
                "use None for standard multi-head attention")
        return self.num_query_groups


def _init_numpy(config: GPTConfig, seed: int) -> Dict[str, Any]:
    """fp32 numpy params with the JAX package's tree, names and shapes
    (normal(0, 0.02) matrices, output projections scaled by
    1/sqrt(2L), ones/zeros for LayerNorm and biases; with MoE the
    ``moe`` subtree of ``moe_init``, its ``w2`` scaled by 1/sqrt(2), in
    place of ``fc*``), drawn from a numpy generator seeded with
    ``seed``."""
    H, Fh, L, V = config.hidden_size, config.ffn, config.num_layers, config.vocab_size
    KV = config.kv_heads * config.head_dim
    rng = np.random.default_rng(seed)

    def init(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    scale = np.float32(1.0 / np.sqrt(2 * L))
    params = {
        "embed": init(V, H),
        "layers": {
            "ln1_scale": ones(L, H), "ln1_bias": zeros(L, H),
            "wq": init(L, H, H), "wk": init(L, KV, H), "wv": init(L, KV, H),
            "bq": zeros(L, H), "bk": zeros(L, KV), "bv": zeros(L, KV),
            "wo": init(L, H, H) * scale, "bo": zeros(L, H),
            "ln2_scale": ones(L, H), "ln2_bias": zeros(L, H),
        },
        "final_ln_scale": ones(H),
        "final_ln_bias": zeros(H),
    }
    if config.moe:
        E = config.moe_num_experts
        params["layers"]["moe"] = {
            "router": init(L, H, E), "w1": init(L, E, Fh, H), "b1": zeros(L, E, Fh),
            "w2": init(L, E, H, Fh) * np.float32(1.0 / np.sqrt(2.0)), "b2": zeros(L, E, H)}
    else:
        params["layers"].update({
            "fc1": init(L, Fh, H), "fc1_b": zeros(L, Fh),
            "fc2": init(L, H, Fh) * scale, "fc2_b": zeros(L, H)})
    if config.position_embedding_type == "learned":
        params["pos_embed"] = init(config.max_seq_len, H)
    return params


def params_from_numpy(tree, config: GPTConfig, device="cuda",
                      keep_fp32: bool = False) -> Dict[str, Any]:
    """The JAX package's GPT params (a tree of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's: torch tensors
    on ``device``.  For serving the :data:`MATMUL_KEYS` leaves (and the
    MoE experts', :data:`MOE_MATMUL_KEYS`) are cast to
    ``config.compute_dtype`` once here; with ``keep_fp32`` (training)
    every leaf stays fp32, the tree JAX trains.  The rest is fp32."""
    dev = resolve_device(device)
    cast = torch.float32 if keep_fp32 else config.compute_dtype

    def to(a, dtype):
        return torch.tensor(np.asarray(a, np.float32)).to(device=dev, dtype=dtype)

    out = {k: to(v, torch.float32) for k, v in tree.items() if k != "layers"}
    out["layers"] = {
        k: to(v, cast if k in MATMUL_KEYS else torch.float32)
        for k, v in tree["layers"].items() if k != "moe"}
    if "moe" in tree["layers"]:
        out["layers"]["moe"] = {
            k: to(v, cast if k in MOE_MATMUL_KEYS else torch.float32)
            for k, v in tree["layers"]["moe"].items()}
    return out


def _field(node, name: str, index: int):
    """A NamedTuple's field (the JAX ``AdamState`` or the port's), or a
    dict's key."""
    return node[name] if isinstance(node, dict) else node[index]


def _host_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def train_state_from_numpy(tree, config: GPTConfig, device="cuda", loss_scaler=None,
                           axis_name=None, pp_group=None, ep_group=None):
    """The JAX trainer's checkpoint tree as the port's train state.

    ``tree`` is what ``examples/gpt/pretrain_gpt.py`` saves (``ckpt_tree``)
    read back as numpy arrays or CPU tensors: ``{"params", "state":
    AdamState(step, exp_avg, exp_avg_sq, master), "step", "scaler"}``,
    every tree per leaf in the JAX layout.  Returns ``(params, state,
    scaler_state, step)``: the fp32 params on ``device`` (the tree JAX
    trains, :func:`params_from_numpy` with ``keep_fp32``), a FusedAdam
    ``AdamState`` holding the moments and master in the same layout, the
    scaler's state through ``loss_scaler.load_state_dict`` (None without
    a ``loss_scaler``; raises if the tree has none to load), and the
    step count as an int.  With ``axis_name`` (the tensor-parallel group),
    ``pp_group`` (the pipeline group) and ``ep_group`` (the expert group)
    the params and every params-shaped state tree are this rank's shard
    (:func:`shard_params`)."""
    from apex_tpu_torch.optimizers.fused_adam import AdamState
    from apex_tpu_torch.optimizers.tree import tree_map

    dev = resolve_device(device)
    def like_params(t):
        return None if t is None else shard_params(tree_map(_host_f32, t), config, axis_name,
                                                   dev, keep_fp32=True, pp_group=pp_group,
                                                   ep_group=ep_group)

    params = like_params(tree["params"])

    st = tree["state"]
    state = AdamState(
        step=torch.as_tensor(np.asarray(_field(st, "step", 0)), device=dev).to(torch.int32),
        exp_avg=like_params(_field(st, "exp_avg", 1)),
        exp_avg_sq=like_params(_field(st, "exp_avg_sq", 2)),
        master=like_params(_field(st, "master", 3)))
    scaler_state = None
    if loss_scaler is not None:
        if tree.get("scaler") is None:
            raise ValueError("the checkpoint has no loss-scaler state (saved by a run "
                             "without --fp16)")
        scaler_state = loss_scaler.load_state_dict(
            {k: np.asarray(v).item() for k, v in tree["scaler"].items()}, dev)
    return params, state, scaler_state, int(np.asarray(tree["step"]))


def init_params(config: GPTConfig, seed: int = 0, device="cuda",
                keep_fp32: bool = False) -> Dict[str, Any]:
    """Random params from a numpy seed, loaded as :func:`params_from_numpy`
    loads the JAX package's."""
    dev = resolve_device(device)
    return params_from_numpy(_init_numpy(config, seed), config, dev, keep_fp32)


class PartitionSpec:
    """A param's split over the mesh axes, one entry a dim (an axis name
    or None), as ``jax.sharding.PartitionSpec``; a leaf of the trees
    :func:`param_specs` builds."""

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __eq__(self, other):
        return tuple(self) == tuple(other)

    def __hash__(self):
        return hash(self.axes)

    def __repr__(self):
        return f"PartitionSpec{self.axes!r}"

    @property
    def tp_dim(self) -> Optional[int]:
        """The dim split over ``"tp"``, or None for a replicated leaf."""
        return self.axes.index("tp") if "tp" in self.axes else None

    @property
    def pp_dim(self) -> Optional[int]:
        """The dim split over ``"pp"`` (the stacked layers' under a
        pipeline), or None."""
        return self.axes.index("pp") if "pp" in self.axes else None

    @property
    def ep_dim(self) -> Optional[int]:
        """The dim split over ``"ep"`` (the MoE experts'), or None."""
        return self.axes.index("ep") if "ep" in self.axes else None


def param_specs(config: GPTConfig, pp: bool = False, ep: bool = False) -> Dict[str, Any]:
    """The split of each param over the ``"tp"`` axis, the JAX package's
    ``param_specs`` (apex_tpu/models/gpt.py:187-231) leaf for leaf:
    column-parallel weights and biases split their output rows,
    row-parallel weights their input columns, the embedding its vocab;
    the rest is replicated.  With ``pp`` the stacked layers also split
    their layer axis over ``"pp"`` (``P("pp", ...)``, each stage its L /
    pp layers, as ``make_pp_train_step`` shards them there); the
    embedding, position table and final LayerNorm stay replicated over
    the stages.  With MoE the ``moe`` subtree is the JAX
    ``moe_param_specs``: with ``ep`` (the JAX ``ep_axis`` given) the
    experts' dim split over ``"ep"``, else replicated; the router always
    replicated."""
    from apex_tpu_torch.transformer.expert_parallel import moe_param_specs

    P = PartitionSpec
    col, colb, row, rep2 = P(None, "tp", None), P(None, "tp"), P(None, None, "tp"), P(None, None)
    layers = {"ln1_scale": rep2, "ln1_bias": rep2, "wq": col, "wk": col, "wv": col,
              "bq": colb, "bk": colb, "bv": colb, "wo": row, "bo": rep2,
              "ln2_scale": rep2, "ln2_bias": rep2}
    if config.moe:
        layers["moe"] = {k: P(*(a if ep else None if a == "ep" else a for a in v))
                         for k, v in moe_param_specs().items()}
    else:
        layers.update({"fc1": col, "fc1_b": colb, "fc2": row, "fc2_b": rep2})
    specs = {
        "embed": P("tp", None),
        "layers": layers,
        "final_ln_scale": P(None),
        "final_ln_bias": P(None),
    }
    if config.position_embedding_type == "learned":
        specs["pos_embed"] = P(None, None)
    if pp:
        specs["layers"] = _map_layers(lambda v: P("pp", *tuple(v)[1:]), specs["layers"])
    return specs


def _map_layers(fn, layers):
    """``fn`` over the stacked per-layer leaves (the ``moe`` subtree's
    too)."""
    return {k: _map_layers(fn, v) if isinstance(v, dict) else fn(v) for k, v in layers.items()}


def check_pp(config: GPTConfig, pp: int, vpp: int = 1) -> None:
    """Raise unless the layers split into ``pp`` x ``vpp`` equal chunks
    (the JAX package's rule, apex_tpu/models/gpt.py:1941-1947)."""
    if config.num_layers % (pp * vpp):
        raise ValueError(f"num_layers ({config.num_layers}) must divide into pp ({pp}) x "
                         f"vpp ({vpp}) chunks")


def check_tp(config: GPTConfig, tp: int) -> None:
    """Raise unless ``config`` splits over ``tp`` ranks: the vocab, the
    heads, the kv heads (GQA: tp above the kv-head count is refused, as
    the JAX package refuses it) and the FFN width (dense: MoE experts are
    replicated over tp) must divide."""
    if config.kv_heads % tp:
        raise ValueError(
            f"num_query_groups ({config.kv_heads}) must be divisible by the "
            f"tensor-parallel size ({tp}): kv heads shard over tp")
    for name, n in (("vocab_size", config.vocab_size),
                    ("num_attention_heads", config.num_attention_heads),
                    ("ffn width", 0 if config.moe else config.ffn)):
        if n % tp:
            raise ValueError(f"{name} ({n}) must be divisible by the tensor-parallel "
                             f"size ({tp})")


def map_specs(fn, tree, config: GPTConfig, pp: bool = False, ep: bool = False):
    """``fn(leaf, spec)`` over a params-shaped tree (nested dicts) with
    each leaf's :func:`param_specs` entry (``pp``: the pipeline's; ``ep``:
    the experts split)."""
    def walk(node, specs):
        if isinstance(node, dict):
            return {k: walk(v, specs[k]) for k, v in node.items()}
        return fn(node, specs)

    return walk(tree, param_specs(config, pp, ep))


def check_ep(config: GPTConfig, ep: int, axis: str = "dp") -> None:
    """The JAX step's rule: the experts split evenly over the ``axis``
    group of ``ep`` ranks (EP rides DP)."""
    if config.moe and config.moe_num_experts % ep:
        raise ValueError(
            f"moe_num_experts ({config.moe_num_experts}) must be divisible by the '{axis}' "
            f"mesh axis size ({ep}): experts shard over dp (EP rides DP)")


def _narrow(a, d, rank, size):
    """The ``rank``-th of ``size`` equal pieces of ``a`` along ``d``."""
    n = a.shape[d] // size
    if isinstance(a, torch.Tensor):
        return a.narrow(d, rank * n, n).contiguous()
    return np.ascontiguousarray(np.take(a, np.arange(rank * n, (rank + 1) * n), axis=d))


def shard_tree(tree, config: GPTConfig, rank: int, size: int, pp_rank: int = 0,
               pp_size: int = 1, ep_rank: int = 0, ep_size: int = 1):
    """This rank's slice of each leaf of a params-shaped tree (numpy
    arrays or tensors): along the leaf's ``"tp"`` dim of
    :func:`param_specs`, the ``rank``-th of ``size`` equal pieces -- the
    block ``shard_map`` gives the device at that tp index -- and with
    ``pp_size`` above 1 along the stacked layers, stage ``pp_rank``'s L /
    pp layers (``P("pp", ...)``; for the interleaved schedule the tree
    is in :func:`params_to_vpp_layout`'s order); with ``ep_size`` above 1
    the MoE experts' ``ep_rank``-th E / ep."""
    check_tp(config, size)
    check_pp(config, pp_size)
    check_ep(config, ep_size)

    def one(a, spec):
        if spec.tp_dim is not None and size > 1:
            a = _narrow(a, spec.tp_dim, rank, size)
        if spec.pp_dim is not None and pp_size > 1:
            a = _narrow(a, spec.pp_dim, pp_rank, pp_size)
        if spec.ep_dim is not None and ep_size > 1:
            a = _narrow(a, spec.ep_dim, ep_rank, ep_size)
        return a

    return map_specs(one, tree, config, pp=True, ep=True)


def _coords(group):
    """``(rank, size)`` of an ``AxisGroup``, ``(0, 1)`` for None."""
    return (0, 1) if group is None else (group.rank(), group.size())


def shard_params(tree, config: GPTConfig, axis_name, device="cuda",
                 keep_fp32: bool = False, pp_group=None, ep_group=None) -> Dict[str, Any]:
    """The JAX package's params (numpy) as this rank's shard on
    ``device``: :func:`shard_tree` at ``axis_name``'s rank and size (an
    ``AxisGroup``; None is the whole tree), at ``pp_group``'s stage and
    at ``ep_group``'s expert block, then :func:`params_from_numpy`."""
    return params_from_numpy(
        shard_tree(tree, config, *_coords(axis_name), *_coords(pp_group), *_coords(ep_group)),
        config, device, keep_fp32)


def gather_params(tree, config: GPTConfig, axis_name, pp_group=None, ep_group=None):
    """The opposite of :func:`shard_tree` on the device: every rank's
    slices of a params-shaped tree of tensors, all-gathered over
    ``axis_name`` along each leaf's ``"tp"`` dim, over ``pp_group`` along
    the stacked layers and over ``ep_group`` along the MoE experts, into
    the whole tree (collectives: every rank of the groups calls it).
    Under the interleaved schedule the result is in the vpp layout
    (:func:`params_from_vpp_layout` undoes it)."""
    from apex_tpu_torch.transformer.tensor_parallel.mappings import all_gather_dim

    tp = axis_name is not None and axis_name.size() > 1
    pp = pp_group is not None and pp_group.size() > 1
    ep = ep_group is not None and ep_group.size() > 1

    def one(a, spec):
        a = a.detach()
        if tp and spec.tp_dim is not None:
            a = all_gather_dim(a, axis_name, spec.tp_dim)
        if pp and spec.pp_dim is not None:
            a = all_gather_dim(a, pp_group, spec.pp_dim)
        if ep and spec.ep_dim is not None:
            a = all_gather_dim(a, ep_group, spec.ep_dim)
        return a

    return tree if not (tp or pp or ep) else map_specs(one, tree, config, pp=True, ep=True)


def _vpp_perm(a, pp: int, vpp: int, inverse: bool):
    """The layer axis of ``a`` reordered between execution order (global
    block ``j = v·pp + s``) and the stage-major order (``[s][v]``)."""
    L = a.shape[0]
    lpc = L // (pp * vpp)
    first, second = (pp, vpp) if inverse else (vpp, pp)
    shape = (first, second, lpc) + tuple(a.shape[1:])
    if isinstance(a, torch.Tensor):
        return a.reshape(shape).transpose(0, 1).reshape(a.shape).contiguous()
    return np.ascontiguousarray(np.swapaxes(np.reshape(a, shape), 0, 1).reshape(a.shape))


def params_to_vpp_layout(params, pp: int, vpp: int):
    """Reorder the stacked layers from execution order to the stage-major
    layout the interleaved schedule shards (the JAX package's
    ``params_to_vpp_layout``, apex_tpu/models/gpt.py:1812): stage s holds
    chunks s, s + pp, ... back to back, ``out[(s·vpp + v)·lpc + i] =
    in[(v·pp + s)·lpc + i]``.  Numpy arrays or tensors; the other leaves
    pass through.  Inverse: :func:`params_from_vpp_layout`."""
    out = dict(params)
    out["layers"] = _map_layers(lambda v: _vpp_perm(v, pp, vpp, False), params["layers"])
    return out


def params_from_vpp_layout(params, pp: int, vpp: int):
    """The inverse of :func:`params_to_vpp_layout`."""
    out = dict(params)
    out["layers"] = _map_layers(lambda v: _vpp_perm(v, pp, vpp, True), params["layers"])
    return out


def _layer_list(layers):
    """The stacked per-layer leaves as one dict of views per layer (the
    ``moe`` subtree a dict of its own)."""
    names = list(layers)
    per = [_layer_list(layers[k]) if isinstance(layers[k], dict) else layers[k].unbind(0)
           for k in names]
    return [dict(zip(names, vals)) for vals in zip(*per)]


def _cp(cp_axis):
    """The context-parallel group (``cp_axis``, an ``AxisGroup`` of any
    size: one rank still runs the ring), or None."""
    if cp_axis is None:
        return None
    from apex_tpu_torch.transformer import parallel_state

    if not isinstance(cp_axis, parallel_state.AxisGroup):
        raise ValueError(f"cp_axis={cp_axis!r}: pass the context-parallel AxisGroup of "
                         f"apex_tpu_torch.transformer.parallel_state, or None")
    return cp_axis


def _check_cp(config: GPTConfig, cp) -> None:
    """The JAX package's refusal: sequence parallelism and cp both split
    the sequence."""
    if cp is not None and config.sequence_parallel:
        raise ValueError("sequence_parallel (tp) and context parallelism both shard "
                         "the sequence; enable one")


def _tp(axis_name):
    """The group the model splits over (``axis_name``, an ``AxisGroup``),
    or None: a group of one rank computes the single-device model."""
    if axis_name is None:
        return None
    from apex_tpu_torch.transformer.tensor_parallel.mappings import tp_group

    axis_name = tp_group(axis_name)
    return axis_name if axis_name.size() > 1 else None


def _proj(x, w, b):
    """``x @ w.T + b`` with the weight and bias cast to x's dtype at use:
    two roundings, the JAX package's expression."""
    return torch.matmul(x, w.T.to(x.dtype)) + b.to(x.dtype)


def _col_in(x, axis_name, sp):
    """The input of the column-parallel projections that read ``x``: the
    sequence all-gather under sequence parallelism, else the
    copy-to-region (whose backward sums the ranks' dx) -- one collective
    for all the projections of one input, as Megatron's fused QKV
    linear does.  Without a group, ``x``."""
    if axis_name is None:
        return x
    if sp:
        return gather_from_sequence_parallel_region(x, axis_name)
    return copy_to_tensor_model_parallel_region(x, axis_name)


def _row_proj(x, w, b, axis_name, sp):
    """The row-parallel projection (the dense one without a group)."""
    if axis_name is None:
        return _proj(x, w, b)
    return row_parallel_linear(x, w, b, input_is_parallel=True, sequence_parallel_enabled=sp,
                               axis_name=axis_name)


def _mlp(x, p, axis_name=None, sp=False):
    h = _proj(_col_in(x, axis_name, sp), p["fc1"], p["fc1_b"])
    h = F.gelu(h, approximate="tanh")
    return _row_proj(h, p["fc2"], p["fc2_b"], axis_name, sp)


def _attention(x, p, config: GPTConfig, rope, axis_name=None, cp=None):
    """Causal self attention on (S, B, H) (S / tp rows under sequence
    parallelism).  With ``cp`` (the context-parallel group; x this rank's
    sequence chunk) ring attention over it, kv heads repeated first; else
    with ``use_flash_attention`` the flash kernels (GQA read in place);
    otherwise the einsum path: scores in the compute dtype divided by
    sqrt(head_dim), causal fill, fp32 softmax, probabilities cast to v's
    dtype.  Under tensor parallelism q, k and v are this rank's heads.
    Returns ``(out, (k, v))`` with the post-RoPE k/v (B, kv_heads, S,
    head_dim) before any GQA repeat."""
    tp = 1 if axis_name is None else axis_name.size()
    sp = config.sequence_parallel and axis_name is not None
    S, B = x.shape[0] * (tp if sp else 1), x.shape[1]
    nh, nkv, hd = config.num_attention_heads // tp, config.kv_heads // tp, config.head_dim

    def heads(t, n):
        return t.reshape(S, B, n, hd).permute(1, 2, 0, 3)

    xin = _col_in(x, axis_name, sp)
    q = heads(_proj(xin, p["wq"], p["bq"]), nh)
    k = heads(_proj(xin, p["wk"], p["bk"]), nkv)
    v = heads(_proj(xin, p["wv"], p["bv"]), nkv)
    if rope is not None:
        q, k = rotate(q, *rope), rotate(k, *rope)
    kv = (k, v)
    if cp is not None:
        from apex_tpu_torch.ops.attention import repeat_kv_heads
        from apex_tpu_torch.transformer.context_parallel import ring_attention

        # the ring walks matched head counts; GQA repeats before it
        k, v = repeat_kv_heads(q, k, v)
        ctx = ring_attention(q, k, v, cp, causal=True, overlap=config.cp_overlap).to(v.dtype)
    elif config.use_flash_attention:
        ctx = flash_attention(q, k, v, causal=True)
    else:
        if nkv != nh:
            k = k.repeat_interleave(nh // nkv, dim=1)
            v = v.repeat_interleave(nh // nkv, dim=1)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        probs = scaled_upper_triang_masked_softmax(scores, 1.0)
        ctx = torch.matmul(probs.to(v.dtype), v)
    ctx = ctx.permute(2, 0, 1, 3).reshape(S, B, nh * hd)
    return _row_proj(ctx, p["wo"], p["bo"], axis_name, sp), kv


def _moe_mlp(x, p, config: GPTConfig, ep=None):
    """The expert-parallel FFN on (S, B, H), the JAX package's
    ``_moe_mlp``: the experts split over ``ep`` (the data-parallel group),
    tensor-parallel ranks computing it replicated.  Returns ``(out,
    aux)``."""
    from apex_tpu_torch.transformer.expert_parallel import moe_ffn

    return moe_ffn(x, p["moe"], top_k=config.moe_top_k,
                   capacity_factor=config.moe_capacity_factor, ep_group=ep)


def _layer(x, p, config: GPTConfig, rope, axis_name=None, cp=None, ep=None):
    """One transformer block on (S, B, H); returns ``(x, (k, v), aux)``,
    aux the MoE load-balancing loss (None when the FFN is dense)."""
    H, eps, cd = config.hidden_size, config.layernorm_eps, config.compute_dtype
    sp = config.sequence_parallel and axis_name is not None
    ln1 = fused_layer_norm_affine(x, p["ln1_scale"], p["ln1_bias"], (H,), eps)
    attn, kv = _attention(ln1.to(cd), p, config, rope, axis_name, cp)
    x = x + attn
    ln2 = fused_layer_norm_affine(x, p["ln2_scale"], p["ln2_bias"], (H,), eps)
    if config.moe:
        h, aux = _moe_mlp(ln2.to(cd), p, config, ep)
        return x + h, kv, aux
    return x + _mlp(ln2.to(cd), p, axis_name, sp), kv, None


def _embed_segment(embed_w, pos_w, tokens, config: GPTConfig, axis_name=None, cp=None):
    """Forward segment 1, the JAX package's ``_embed_segment``: tokens
    (B, S) -> the first layer's input (S, B, H) in the compute dtype,
    split over the sequence under sequence parallelism (S / tp rows):
    the embedding (vocab-parallel with a group) plus the learned
    positions ``pos_w`` (None with rope), under context parallelism
    (``cp``; tokens this rank's chunk) the table's rows ``rank·S ..``
    (``_add_pos_embed``).  A pipeline's first stage runs it
    (``pre_fn``)."""
    sp = config.sequence_parallel and axis_name is not None
    tokens = torch.as_tensor(tokens, device=embed_w.device).long()
    S = tokens.shape[1]
    if axis_name is None:
        x = embed_w[tokens]  # (B, S, H) fp32
    else:
        x = vocab_parallel_embedding(tokens, embed_w, axis_name=axis_name)
    x = x.transpose(0, 1)  # (S, B, H)
    if config.position_embedding_type == "learned":
        start = 0 if cp is None else cp.rank() * S
        x = x + pos_w[start:start + S][:, None, :]
    x = x.to(config.compute_dtype).contiguous()
    if sp:
        x = scatter_to_sequence_parallel_region(x, axis_name)
    return x


def _rope(config: GPTConfig, S: int, device, start: int = 0):
    """RoPE's (cos, sin) at positions start..start+S-1 (a cp rank's
    chunk starts at rank·S), or None."""
    if config.position_embedding_type != "rope":
        return None
    return rope_cos_sin(start + torch.arange(S, device=device), config.head_dim,
                        config.rope_theta)


def _layers(layers, x, config: GPTConfig, axis_name=None, return_kv: bool = False, cp=None,
            ep=None):
    """The stacked ``layers`` over ``x`` (S or S / tp, B, H): the
    transformer blocks, under :func:`~apex_tpu_torch.models._remat.
    remat_layer` when a gradient is recorded and ``config.
    checkpoint_layers`` is set; with ``cp`` x is this rank's sequence
    chunk (RoPE at its global positions, ring attention); ``ep`` the MoE
    experts' group.  Returns ``(x, ks, vs, aux)``: the lists of every
    layer's post-RoPE k/v with ``return_kv``, and with MoE the layers'
    load-balancing losses summed (None when dense)."""
    sp = config.sequence_parallel and axis_name is not None
    S = x.shape[0] * (axis_name.size() if sp else 1)
    rope = _rope(config, S, x.device, 0 if cp is None else cp.rank() * S)
    remat = config.checkpoint_layers and torch.is_grad_enabled() and not return_kv
    ks, vs, auxes = [], [], []
    for p in _layer_list(layers):
        if remat and config.moe:
            x, aux = remat_layer(lambda x_, p=p: _layer(x_, p, config, rope, axis_name, cp,
                                                        ep)[0::2], config.remat_policy)(x)
            auxes.append(aux)
            continue
        if remat:
            x = remat_layer(lambda x_, p=p: _layer(x_, p, config, rope, axis_name, cp)[0],
                            config.remat_policy)(x)
            continue
        x, (k, v), aux = _layer(x, p, config, rope, axis_name, cp, ep)
        auxes.append(aux)
        if return_kv:
            ks.append(k)
            vs.append(v)
    aux = torch.stack(auxes).sum() if config.moe else None
    return x, ks, vs, aux


def _layers_segment(layers_p, x, config: GPTConfig, axis_name=None, cp=None, ep=None):
    """Forward segment 2, the JAX package's ``_layers_segment``: the
    stacked layers over ``x`` (:func:`_layers`, remat per layer as
    configured); returns ``(x, aux)``, aux the layers' summed MoE
    load-balancing loss (None when dense).  The layer leaves are
    stacked, so every ``layers.*`` gradient is complete only when the
    whole segment's backward is: one readiness stage, not L of them.  A
    pipeline stage runs it on its layers (``stage_fn``), ``cp`` the
    context-parallel group, ``ep`` the experts'."""
    x, _, _, aux = _layers(layers_p, x, config, axis_name, cp=cp, ep=ep)
    return x, aux


def _head_segment(x, ln_scale, ln_bias, config: GPTConfig, axis_name=None):
    """Forward segment 3, the JAX package's ``_head_segment``: the last
    layer's output -> the head's input (S, B, H): the sequence gathered
    under sequence parallelism, the final LayerNorm, and with a group the
    copy-to-region (whose backward sums the head's dx over it).  A
    pipeline's last stage runs it (``post_fn``)."""
    if config.sequence_parallel and axis_name is not None:
        # the head's dx is summed by the copy-to-region below, so this
        # backward splits (tensor_parallel_output_grad=False)
        x = gather_from_sequence_parallel_region(x, axis_name, False)
    x = fused_layer_norm_affine(x, ln_scale, ln_bias, (config.hidden_size,),
                                config.layernorm_eps)
    if axis_name is not None:
        x = copy_to_tensor_model_parallel_region(x, axis_name)
    return x


#: the gradient-readiness stage of each top-level param group under the
#: segmented (overlapped) backward: the head's backward (stage 0) gives
#: the final LayerNorm's grads, the layers' backward (stage 1) every
#: stacked ``layers.*`` leaf at once, the embedding's backward (stage 2)
#: the positions and the tied embedding's lookup half (its head half
#: comes at stage 0, but the leaf is whole only after stage 2)
_OVERLAP_STAGES = {"final_ln_scale": 0, "final_ln_bias": 0, "layers": 1,
                   "embed": 2, "pos_embed": 2}


def _check_moe(config: GPTConfig) -> None:
    """The JAX package's refusal: MoE beside sequence parallelism."""
    if config.moe and config.sequence_parallel:
        raise ValueError("MoE with Megatron sequence parallelism is not supported: "
                         "expert grads would need an extra tp-psum; use cp instead")


def _ep(ep_axis):
    """The experts' group (``ep_axis``, an ``AxisGroup``), or None for
    none or a group of one rank (every expert local)."""
    if ep_axis is None:
        return None
    from apex_tpu_torch.transformer import parallel_state

    if not isinstance(ep_axis, parallel_state.AxisGroup):
        raise ValueError(f"ep_axis={ep_axis!r}: pass the data-parallel AxisGroup of "
                         f"apex_tpu_torch.transformer.parallel_state, or None")
    return ep_axis if ep_axis.size() > 1 else None


def gpt_forward(params, tokens, config: GPTConfig, return_hidden: bool = False,
                return_kv: bool = False, axis_name=None, cp_axis=None, ep_axis=None,
                return_aux: bool = False):
    """tokens (B, S) -> logits (S, B, V) fp32, or with ``return_hidden``
    the pre-head activations (S, B, H) after the final LayerNorm.  With
    ``return_kv`` a trailing ``(k, v)`` pair is appended, each (L, B,
    kv_heads, S, head_dim): every layer's post-RoPE keys/values, the
    prefill capture the paged cache stores.  When a gradient is being
    recorded and ``config.checkpoint_layers`` is set, each layer runs
    under :func:`~apex_tpu_torch.models._remat.remat_layer` (the JAX
    package's remat of ``_layers_segment``).

    With ``axis_name`` (the tensor-parallel group; ``params`` this rank's
    shard) the logits are the vocab-local (S, B, V / tp), and the hidden
    states (after the copy-to-region, whose backward sums the head's dx
    over the group) are whole on every rank; the ``return_kv`` pair holds
    the rank's kv_heads / tp heads.

    With MoE, ``ep_axis`` (the data-parallel group: EP rides DP) splits
    the experts, ``params`` holding this rank's; ``return_aux`` puts the
    layers' summed load-balancing loss (fp32, 0 when dense) after the
    output, before the kv pair.  MoE with ``config.sequence_parallel``
    raises ValueError, as in the JAX package.

    With ``cp_axis`` (the context-parallel group) ``tokens`` are this
    rank's sequence chunk, positions are global and attention is the
    ring over the group (module docstring); with
    ``config.sequence_parallel`` it raises ValueError, as the JAX
    package does."""
    cp = _cp(cp_axis)
    _check_cp(config, cp)
    _check_moe(config)
    axis_name = _tp(axis_name)
    if axis_name is not None:
        check_tp(config, axis_name.size())
    x = _embed_segment(params["embed"], params.get("pos_embed"), tokens, config, axis_name, cp)
    x, ks, vs, aux = _layers(params["layers"], x, config, axis_name, return_kv, cp,
                             _ep(ep_axis))
    x = _head_segment(x, params["final_ln_scale"], params["final_ln_bias"], config, axis_name)
    out = (x if return_hidden else torch.matmul(x.float(), params["embed"].float().T),)
    if return_aux:
        out += (aux if aux is not None else torch.zeros((), device=x.device),)
    if return_kv:
        out += ((torch.stack(ks), torch.stack(vs)),)
    return out if len(out) > 1 else out[0]


def lm_head_loss(x, embed, targets, config: GPTConfig, axis_name=None):
    """Per-token CE (S, B) of the tied LM head on the pre-head
    activations ``x`` (S, B, H), the JAX package's ``lm_head_loss``: with
    ``config.fused_ce`` and S divisible by ``config.fused_ce_chunk``,
    :func:`~apex_tpu_torch.ops.fused_ce.fused_lm_head_ce` (the CE
    kernels); otherwise the dense head -- fp32 logits ``x @ embed.T``,
    then on one device ``logsumexp`` minus the target logit with targets
    clamped into ``[0, V-1]``, and under tensor parallelism (``embed``
    the vocab shard, global targets) the vocab-parallel cross entropy."""
    axis_name = _tp(axis_name)
    if config.fused_ce and targets.shape[0] % config.fused_ce_chunk == 0:
        return fused_lm_head_ce(x, embed, targets, config.fused_ce_chunk, axis_name)
    logits = torch.matmul(x.float(), embed.float().T)
    if axis_name is not None:
        return vocab_parallel_cross_entropy(logits, targets, 0.0, axis_name)
    lse = torch.logsumexp(logits, dim=-1)
    t_cl = targets.long().clamp(0, logits.shape[-1] - 1)
    return lse - logits.gather(-1, t_cl[..., None])[..., 0]


def gpt_loss(params, tokens, targets, config: GPTConfig, axis_name=None, cp_axis=None,
             ep_axis=None):
    """Mean causal-LM cross entropy of ``tokens`` (B, S) against
    ``targets`` (B, S), plus ``moe_aux_coef`` times the MoE
    load-balancing loss when the FFNs are experts: the JAX package's
    ``gpt_loss``, over the tensor-parallel group ``axis_name`` when given
    (``params`` this rank's shard; the loss is the same on every rank).
    With ``cp_axis`` (the context-parallel group) tokens and targets are
    this rank's sequence chunk and the mean is over the local chunk: the
    ranks' means average to the global one (the data-axis gradient
    calculus).  ``ep_axis``: the experts' group (:func:`gpt_forward`)."""
    dev = params["embed"].device
    t = torch.as_tensor(targets, device=dev).transpose(0, 1)  # (S, B)
    out = gpt_forward(params, tokens, config, return_hidden=True, axis_name=axis_name,
                      cp_axis=cp_axis, ep_axis=ep_axis, return_aux=config.moe)
    hidden, aux = out if config.moe else (out, None)
    loss = lm_head_loss(hidden, params["embed"], t, config, axis_name).mean()
    if aux is not None:
        loss = loss + config.moe_aux_coef * aux
    return loss


def sp_grad_sync(grads, axis_name):
    """The sequence-parallel grad sum: the leaves of :data:`SP_KEYS` (used
    in the sequence-split region, so each rank's grad covers its own
    tokens) summed over ``axis_name``, the JAX package's ``sp_grad_sync``
    (apex_tpu/models/gpt.py:768), in one all-reduce of their
    concatenation."""
    from apex_tpu_torch.transformer.layers.layer_norm import (
        allreduce_sequence_parallel_grads,
    )

    axis_name = _tp(axis_name)
    if axis_name is None:
        return grads
    mask = {k: ({n: n in SP_KEYS for n in v} if k == "layers" else False)
            for k, v in grads.items()}
    return allreduce_sequence_parallel_grads(grads, mask, axis_name)


def clip_sumsq_reduce(config: GPTConfig, axis_name, pp_group=None, ep_group=None):
    """The global Σx² of a grad clip over a model-parallel step, the JAX
    package's ``clip_sumsq_reduce`` (apex_tpu/models/gpt.py:781-829) on
    :func:`param_specs`: a split leaf holds only its slice, so its Σx²
    is summed over the groups it is split over (``axis_name``, the
    tensor-parallel group, for the tp-split leaves; ``pp_group``, the
    pipeline, for the stacked layers of a pipelined step; ``ep_group``,
    the experts' group, for the MoE experts, split over it when it is
    given, as the JAX step's ``ep_axis`` splits them); a replicated
    leaf is whole on every rank and is not (the embedding, positions and
    final LayerNorm count once, though every stage holds them).  Returns
    ``reduce(per_leaf_sumsq) -> total`` for the optimizers' ``sumsq_
    reduce=`` hook, the leaves in the params' tree order.  As in the JAX
    package the leaves are grouped by the axes they are split over, each
    group summed locally and then over its axes (in rank order, XLA's
    CPU ``psum`` order; tp before pp), the groups added in the order of
    their sorted axis names: replicated, ep, ep+pp, pp, pp+tp, tp (the
    JAX package's ``dp`` sorts where ``ep`` does)."""
    from apex_tpu_torch.contrib.optimizers._quantized_sync import rank_order_sum
    from apex_tpu_torch.optimizers.tree import tree_leaves

    pp = pp_group is not None
    specs = tree_leaves(param_specs(config, pp, ep=config.moe and ep_group is not None))
    axes = [tuple(sorted(a for a in spec if a is not None)) for spec in specs]
    order = sorted(set(axes))
    groups = {"tp": axis_name, "pp": pp_group, "ep": ep_group}

    def reduce(sq):
        if len(sq) != len(specs):
            raise ValueError(f"clip_sumsq_reduce built for {len(specs)} param leaves got "
                             f"{len(sq)} sumsq values")
        total = torch.zeros((), dtype=sq[0].dtype, device=sq[0].device)
        for key in order:
            part = torch.stack([q for q, a in zip(sq, axes) if a == key]).sum()
            for ax in sorted(key, reverse=True):  # tp, then pp, then ep
                g = groups[ax]
                if g is not None and g.size() > 1:
                    part = rank_order_sum(part, g.group, g.size())
            total = total + part
        return total

    return reduce


def forward_decode(params, tokens, positions, active, kv_pools, page_tables,
                   config: GPTConfig, verify_width: int = 1, write_mask=None, axis_name=None):
    """Decode forward over the paged KV cache.

    ``tokens``/``positions``/``active``: (B,) current token ids, their
    0-based positions, and slot liveness.  ``kv_pools``: the ``{"k",
    "v"}`` pools of :func:`apex_tpu_torch.inference.kv_cache.alloc_pools`,
    (L, num_pages, page_size, kv_heads, head_dim) each.  ``page_tables``:
    (B // verify_width, P) int32.  Each layer first writes the rows'
    post-RoPE k/v into their pages — IN PLACE (``index_put_``), where
    the JAX package donates the pools and rebinds them; masked rows
    write the reserved garbage page — and then attends over the pages
    with :func:`~apex_tpu_torch.ops.decode_attention.paged_decode_attention`.

    ``verify_width`` W > 1 is the multi-position layout (speculative
    verification, a prefill chunk): rows come in groups of W consecutive
    positions of one sequence sharing a page-table row.  Since each
    layer writes all rows before it attends, row j of a group sees the
    k/v rows 0..j wrote this very step: the group is a causal block over
    the paged cache.  ``write_mask`` (default ``active``) narrows which
    rows write their k/v; attention liveness stays ``active``, so a chunk
    can recompute a shared-prefix position without rewriting the shared
    page.

    With ``axis_name`` (the tensor-parallel group; ``params`` this rank's
    shard) the projections run column- and row-parallel as in training:
    the vocab-parallel embedding, q, k and v on the rank's heads, the
    pools holding its kv_heads / tp heads (the JAX package's pool spec
    splits the head dim over tp), wo and fc2 row-parallel, and the final
    LayerNorm followed by the copy-to-region.

    Returns ``(hidden, kv_pools)``: hidden (B, H) after the final
    LayerNorm (the caller owns the head), and the same pools dict.
    MoE raises NotImplementedError and sequence parallelism ValueError,
    as in the JAX package.
    """
    from apex_tpu_torch.inference.kv_cache import decode_write_index

    if config.moe:
        raise NotImplementedError(
            "MoE decode is not wired (expert routing at batch 1 needs "
            "its own capacity plan); see ROADMAP follow-ons")
    if config.sequence_parallel:
        raise ValueError(
            "sequence_parallel shards the sequence axis; a decode step "
            "is one token — build the decode config without it")
    axis_name = _tp(axis_name)
    tp = 1 if axis_name is None else axis_name.size()
    if config.kv_heads % tp != 0:
        raise ValueError(
            f"num_query_groups ({config.kv_heads}) must be divisible by "
            f"the tensor-parallel size ({tp}): kv heads (and the KV page "
            "pools) shard over tp")
    B = tokens.shape[0]
    H, eps, cd = config.hidden_size, config.layernorm_eps, config.compute_dtype
    nh, nkv, hd = config.num_attention_heads // tp, config.kv_heads // tp, config.head_dim
    positions = positions.long()
    lengths = torch.where(active, positions + 1, 0).to(torch.int32)
    if axis_name is None:
        x = params["embed"][tokens.long()][None]  # (1, B, H) fp32
    else:
        x = vocab_parallel_embedding(tokens.long()[:, None], params["embed"],
                                     axis_name=axis_name)[:, 0][None]
    if config.position_embedding_type == "learned":
        pos = params["pos_embed"][positions.clamp(0, config.max_seq_len - 1)]
        x = x + pos[None]
    x = x.to(cd)
    rope = None
    if config.position_embedding_type == "rope":
        cos, sin = rope_cos_sin(positions, hd, config.rope_theta)
        rope = (cos[:, None, :], sin[:, None, :])
    k_pools, v_pools = kv_pools["k"], kv_pools["v"]
    if B % verify_width:
        raise ValueError(f"batch ({B}) must be a multiple of verify_width "
                         f"({verify_width})")
    # attention folds row r onto table row r // W; the writes want a
    # table row per position
    write_tables = (page_tables.repeat_interleave(verify_width, dim=0)
                    if verify_width > 1 else page_tables)
    dest, slot = decode_write_index(write_tables, positions,
                                    active if write_mask is None else write_mask,
                                    k_pools.shape[1], k_pools.shape[2])
    for li, p in enumerate(_layer_list(params["layers"])):
        ln1 = fused_layer_norm_affine(x, p["ln1_scale"], p["ln1_bias"], (H,), eps)
        h = _col_in(ln1.to(cd), axis_name, False)
        q = _proj(h, p["wq"], p["bq"])[0].reshape(B, nh, hd)
        k = _proj(h, p["wk"], p["bk"])[0].reshape(B, nkv, hd)
        v = _proj(h, p["wv"], p["bv"])[0].reshape(B, nkv, hd)
        if rope is not None:
            q, k = rotate(q, *rope), rotate(k, *rope)
        k_pool, v_pool = k_pools[li], v_pools[li]
        k_pool.index_put_((dest, slot), k.to(k_pool.dtype))
        v_pool.index_put_((dest, slot), v.to(v_pool.dtype))
        ctx = paged_decode_attention(q, k_pool, v_pool, page_tables, lengths,
                                     width=verify_width)
        ctx = ctx.to(cd).reshape(1, B, nh * hd)
        x = x + _row_proj(ctx, p["wo"], p["bo"], axis_name, False)
        ln2 = fused_layer_norm_affine(x, p["ln2_scale"], p["ln2_bias"], (H,), eps)
        x = x + _mlp(ln2.to(cd), p, axis_name)
    x = fused_layer_norm_affine(x, params["final_ln_scale"], params["final_ln_bias"],
                                (H,), eps)
    if axis_name is not None:
        x = copy_to_tensor_model_parallel_region(x, axis_name)
    return x[0], kv_pools


def make_pp_train_step(config: GPTConfig, optimizer, num_microbatches: int,
                       virtual_pipeline_size: int = 1, *, loss_scaler=None, step_guard=None,
                       clip_grad_norm=None, graphs=None, warmup: int = 1, telemetry=None,
                       dp_group=None, tp_group=None, pp_group=None, cp_axis=None, chaos=None):
    """The pipelined (pp x tp x dp) train step, the twin of the JAX
    package's ``make_pp_train_step`` (apex_tpu/models/gpt.py:1854):
    ``step(params, state, [scaler_state], [guard_state], [stats], tokens,
    targets) -> loss`` with the variants of
    :func:`apex_tpu_torch.train_gpt.make_train_step`.

    ``params`` (and the optimizer state) are this rank's: its stage's L /
    pp stacked layers (``param_specs(config, pp=True)``, cut by
    :func:`shard_params` with ``pp_group``; for ``virtual_pipeline_size``
    vpp > 1 from a tree in :func:`params_to_vpp_layout`'s order), its tp
    slices, and the embedding, positions and final LayerNorm, which every
    stage holds.  ``tokens`` / ``targets`` (B, S) are this dp rank's rows,
    the same on every stage; they split into ``num_microbatches`` M
    microbatches of B / M rows (microbatch m = rows ``[m·B/M,
    (m+1)·B/M)``, the JAX step's reshape).  The JAX step's pre / stage /
    post split (:1973-2017): the first stage embeds, every stage runs its
    layers (remat as configured), the last applies the final LayerNorm
    and the loss head (the dense head or the fused CE kernels); the
    1F1B schedule, or the interleaved one with vpp > 1 (the layers
    divisible by pp x vpp and M by pp), runs them
    (:mod:`apex_tpu_torch.transformer.pipeline_parallel`).  The loss is
    the mean over microbatches of each one's mean loss, on every stage;
    the shared params' grads are summed over the pipeline, the
    sequence-parallel LN and bias grads over tp, and all of them averaged
    over ``dp_group`` (the DDP all-reduce) before the update, or with a
    ZeRO optimizer by its reduce-scatter (its state the dp shard of this
    rank's (pp, tp) segment: ``init(params, param_specs=param_specs(
    config, pp=True), axis_sizes={"tp": N, "pp": M})``).  The finite
    vote of ``loss_scaler`` / ``step_guard`` is agreed over (pp, tp), and
    by a ZeRO optimizer over dp as well, so every stage skips a step
    together; the clip's Σx² and the
    telemetry's norms sum the stage leaves over pp (and tp where split)
    and count the replicated leaves once (:func:`clip_sumsq_reduce`).
    ``chaos`` (with ``step_guard``) scales every microbatch loss by its
    planned fault before the loss scale, so a planned NaN seeds every
    stage's backward and the vote skips the step everywhere (the JAX
    step's ``_scaled_fns``).

    ``dp_group`` / ``tp_group``: ``AxisGroup`` handles of
    :mod:`~apex_tpu_torch.transformer.parallel_state`; ``pp_group``: the
    pipeline group (default the registered one).  ``cp_axis``: the
    context-parallel group, cp inside every stage (the JAX step's): the
    microbatches' tokens and targets are this rank's sequence chunk, each
    stage's layers run ring attention over the group, and the loss and
    grads are averaged over it after the schedule, before the dp sync
    (ValueError with sequence parallelism).  Compiled unless
    ``graphs=False``: the whole step, the stage-to-stage messages with it,
    is one CUDA graph after the eager warm-up (which makes every NCCL
    channel before the capture).

    MoE composes, as in the JAX step: the experts split over
    ``dp_group`` inside every stage (``params`` this rank's E / dp,
    ``shard_params(..., ep_group=dp_group)``), each stage's layers return
    the pre-weighted ``moe_aux_coef · Σ aux``, which the schedule adds to
    the loss once per (stage, microbatch) unit and seeds with 1 / M into
    that unit's backward (``stage_has_aux``; a loss scale or chaos fault
    scales it with the loss), the expert grads skip the dp all-reduce and
    are scaled by 1 / dp, and dp joins the finite vote.  MoE without a
    ``dp_group`` raises ValueError, and with a ZeRO optimizer
    NotImplementedError, as a hierarchical ``dp_group`` does, as in the
    JAX package."""
    from apex_tpu_torch.optimizers.tree import tree_leaves
    from apex_tpu_torch.train_gpt import _check_zero_axis, _make_step
    from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication as p2p
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        forward_backward_pipelining_with_interleaving,
        forward_backward_pipelining_without_interleaving,
    )

    if isinstance(dp_group, (tuple, list)):
        raise NotImplementedError("the pipeline step's dp sync is flat: a hierarchical dp "
                                  "split runs through make_train_step, as in the JAX package")
    if config.moe and dp_group is None:
        raise ValueError("MoE in the pipeline step needs a dp axis (EP rides DP)")
    cp = _cp(cp_axis)
    _check_cp(config, cp)
    _check_moe(config)
    if config.moe and hasattr(optimizer, "sharded_state_dict"):
        raise NotImplementedError("ZeRO + MoE expert sharding both claim the dp axis; not wired")
    _check_zero_axis(optimizer, dp_group)
    group = p2p._group(pp_group)
    P = group.size()
    vpp = int(virtual_pipeline_size)
    M = int(num_microbatches)
    check_pp(config, P, vpp)
    if vpp > 1 and M % P:
        raise ValueError(f"num_microbatches ({M}) must be a multiple of pp ({P}) when "
                         f"virtual_pipeline_size > 1")
    tp = _tp(tp_group)
    if tp is not None:
        check_tp(config, tp.size())
    sp = config.sequence_parallel and tp is not None
    pipe = group if P > 1 else None
    ep_group = dp_group if config.moe else None
    if ep_group is not None:
        check_ep(config, ep_group.size(), str(ep_group))
    ep = _ep(ep_group)
    reduce = (clip_sumsq_reduce(config, tp, pipe, ep_group)
              if (tp is not None or pipe is not None or ep is not None) else None)

    def pre_fn(shared, mb):
        return _embed_segment(shared["embed"], shared.get("pos_embed"), mb["tokens"], config,
                              tp, cp)

    def stage_fn(layers, x):
        y, aux = _layers_segment(layers, x, config, tp, cp, ep)
        # the pre-weighted load-balancing aux rides the schedule's aux
        # channel
        return y if aux is None else (y, config.moe_aux_coef * aux)

    def post_fn(shared, y, mb):
        h = _head_segment(y, shared["final_ln_scale"], shared["final_ln_bias"], config, tp)
        return lm_head_loss(h, shared["embed"], mb["targets"].transpose(0, 1), config,
                            tp).mean()

    def grads_fn(params, tokens, targets, post):
        for leaf in tree_leaves(params):
            if not leaf.requires_grad:
                leaf.requires_grad_(True)
        B, S = tokens.shape
        if B % M:
            raise ValueError(f"the batch's {B} rows do not split into {M} microbatches")
        mbs = {"tokens": tokens.reshape(M, B // M, S), "targets": targets.reshape(M, B // M, S)}
        post_ = post_fn if post is None else (lambda sh, y, mb: post(post_fn(sh, y, mb)))
        stage_ = stage_fn
        if post is not None and config.moe:
            # the loss scale and chaos fault are linear: the aux enters the
            # loss inside the schedule and rides the same scaled backward
            def stage_(layers, x):
                y, aux = stage_fn(layers, x)
                return y, post(aux)
        shared = {k: v for k, v in params.items() if k != "layers"}
        shape = (S // tp.size() if sp else S, B // M, config.hidden_size)
        kw = dict(tensor_shape=shape, dtype=config.compute_dtype, axis_name=group,
                  stage_has_aux=config.moe)
        if vpp > 1:
            loss, (g_sh, g_st) = forward_backward_pipelining_with_interleaving(
                pre_fn, stage_, post_, shared, params["layers"], mbs,
                virtual_pipeline_model_parallel_size=vpp, **kw)
        else:
            loss, (g_sh, g_st) = forward_backward_pipelining_without_interleaving(
                pre_fn, stage_, post_, shared, params["layers"], mbs, **kw)
        return loss.detach(), {**g_sh, "layers": g_st}

    # stage-split, tp-split and (MoE) dp-split expert grads can overflow on
    # one rank only: each such group joins the finite vote
    sync = tuple(g for g in (pipe, tp, ep) if g is not None)
    return _make_step(optimizer, config, grads_fn, loss_scaler=loss_scaler,
                      step_guard=step_guard, clip_grad_norm=clip_grad_norm, graphs=graphs,
                      warmup=warmup, telemetry=telemetry, dp_group=dp_group, tp_group=tp,
                      sync_groups=sync,
                      clip_sumsq=reduce if clip_grad_norm is not None else None,
                      norm_sumsq=reduce, chaos=chaos, cp_group=cp,
                      expert_grads=config.moe)
