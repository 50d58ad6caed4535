"""BERT: the bidirectional encoder and its masked-LM loss, on one device
or split over a tensor-parallel group (the FusedLAMB pretraining
workload).

Counterpart of :mod:`apex_tpu.models.bert`, in the style of
:mod:`apex_tpu_torch.models.gpt`: functional over a params dict with the
JAX package's names and shapes (the layer leaves stacked ``(L, ...)``),
activations ``(seq, batch, hidden)``, and the same expression for each
op, so the JAX package's params load through :func:`params_from_numpy`
and the two agree, gradients included.

- The embedding sum is fp32 (the table, ``pos_embed[:S]`` and the type
  embedding), its LayerNorm runs on that fp32 sum (the LN kernel's fp32
  instantiation on the card), and only then is x cast to
  ``compute_dtype``.  Every LayerNorm takes ``layernorm_eps`` (1e-12).
- Each layer is post-LN: ``LN(x + attn(x))``, then ``LN(x + mlp(x))``,
  the residual adds in the compute dtype.  Attention is
  :func:`~apex_tpu_torch.ops.attention.flash_attention` with
  ``causal=False`` and the key-padding mask (the flash kernels with
  their per-key bias on the card), GELU the tanh form.
- The MLM head runs in fp32: dense, GELU, LN, then the tied decoder,
  through :func:`apex_tpu_torch.models.gpt.lm_head_loss` (the dense fp32
  head, or with ``fused_ce`` the fused LM-head CE kernels).

Tensor parallelism: ``axis_name`` is the tensor-parallel group (an
``AxisGroup`` of :mod:`apex_tpu_torch.transformer.parallel_state`),
where the JAX package runs the same functions inside ``shard_map``
with the ``tp`` axis.  Each rank holds the slices of
:func:`param_specs` (:func:`shard_params` cuts them from the JAX tree):
q, k, v and fc1 column-parallel on the rank's heads and FFN columns, wo
and fc2 row-parallel, the tied embedding vocab-parallel; the head runs
after ``copy_to_tensor_model_parallel_region`` on the vocab shard.  A
group of one rank computes the single-device model.

:func:`make_train_step` is the jitted, donated step of bench.py's
``bert_base_lamb`` section: the MLM loss, its gradients and the
optimizer's in-place update, captured as one CUDA graph unless
``graphs=False``.
"""

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models import gpt as _gpt
from apex_tpu_torch.models._remat import remat_layer, validate_policy
from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.fused_ce import check_impl
from apex_tpu_torch.transformer.tensor_parallel.layers import vocab_parallel_embedding
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
)

__all__ = ["BertConfig", "init_params", "params_from_numpy", "param_specs", "shard_params",
           "gather_params", "bert_forward", "bert_mlm_loss", "make_train_step"]

@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The fields of the JAX package's ``BertConfig``; ``fused_ce_impl``
    must be None (the kernels are the one implementation)."""

    vocab_size: int = 30528
    hidden_size: int = 1024
    num_layers: int = 24
    num_attention_heads: int = 16
    max_seq_len: int = 512
    type_vocab_size: int = 2
    ffn_hidden_size: Optional[int] = None
    layernorm_eps: float = 1e-12
    compute_dtype: Any = torch.bfloat16
    checkpoint_layers: bool = True
    remat_policy: str = "full"
    fused_ce: bool = False
    fused_ce_chunk: int = 128
    fused_ce_impl: Optional[str] = None

    def __post_init__(self):
        validate_policy(self.remat_policy)
        check_impl(self.fused_ce_impl)

    @property
    def ffn(self):
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def _init_numpy(config: BertConfig, generator: torch.Generator) -> Dict[str, Any]:
    """fp32 params with the JAX package's tree, names and shapes
    (normal(0, 0.02) matrices, wo and fc2 scaled by 1/sqrt(2L), ones and
    zeros for LayerNorm and biases), drawn on the CPU from
    ``generator``."""
    H, Fh, L, V = config.hidden_size, config.ffn, config.num_layers, config.vocab_size

    def init(*shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32) * 0.02).numpy()

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    scale = np.float32(1.0 / np.sqrt(2 * L))
    return {
        "embed": init(V, H),
        "pos_embed": init(config.max_seq_len, H),
        "type_embed": init(config.type_vocab_size, H),
        "embed_ln_scale": ones(H),
        "embed_ln_bias": zeros(H),
        "layers": {
            "wq": init(L, H, H), "wk": init(L, H, H), "wv": init(L, H, H),
            "bq": zeros(L, H), "bk": zeros(L, H), "bv": zeros(L, H),
            "wo": init(L, H, H) * scale, "bo": zeros(L, H),
            "ln1_scale": ones(L, H), "ln1_bias": zeros(L, H),
            "fc1": init(L, Fh, H), "fc1_b": zeros(L, Fh),
            "fc2": init(L, H, Fh) * scale, "fc2_b": zeros(L, H),
            "ln2_scale": ones(L, H), "ln2_bias": zeros(L, H),
        },
        "mlm_dense": init(H, H),
        "mlm_dense_b": zeros(H),
        "mlm_ln_scale": ones(H),
        "mlm_ln_bias": zeros(H),
    }


def params_from_numpy(tree, config: BertConfig, device="cuda") -> Dict[str, Any]:
    """The JAX package's BERT params (a tree of numpy arrays) as the
    port's: fp32 tensors on ``device`` (the tree JAX trains; the matmuls
    cast their weights to ``config.compute_dtype`` at use), the layer
    leaves stacked."""
    del config
    dev = resolve_device(device)

    def to(a):
        return torch.tensor(np.asarray(a, np.float32)).to(dev)

    out = {k: to(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: to(v) for k, v in tree["layers"].items()}
    return out


def init_params(config: BertConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, Any]:
    """Random params drawn from ``generator`` (a CPU ``torch.Generator``;
    one seeded 0 by default), loaded as :func:`params_from_numpy` loads
    the JAX package's."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return params_from_numpy(_init_numpy(config, generator), config, dev)


def param_specs(config: BertConfig) -> Dict[str, Any]:
    """The split of each param over ``"tp"``, the JAX package's
    ``param_specs`` leaf for leaf."""
    P = _gpt.PartitionSpec
    col, colb, row, rep2 = P(None, "tp", None), P(None, "tp"), P(None, None, "tp"), P(None, None)
    return {
        "embed": P("tp", None),
        "pos_embed": P(None, None),
        "type_embed": P(None, None),
        "embed_ln_scale": P(None),
        "embed_ln_bias": P(None),
        "layers": {
            "wq": col, "wk": col, "wv": col,
            "bq": colb, "bk": colb, "bv": colb,
            "wo": row, "bo": rep2,
            "ln1_scale": rep2, "ln1_bias": rep2,
            "fc1": col, "fc1_b": colb,
            "fc2": row, "fc2_b": rep2,
            "ln2_scale": rep2, "ln2_bias": rep2,
        },
        "mlm_dense": P(None, None),
        "mlm_dense_b": P(None),
        "mlm_ln_scale": P(None),
        "mlm_ln_bias": P(None),
    }


def check_tp(config: BertConfig, tp: int) -> None:
    """Raise unless the vocab, the heads and the FFN width split over
    ``tp`` ranks."""
    for name, n in (("vocab_size", config.vocab_size),
                    ("num_attention_heads", config.num_attention_heads),
                    ("ffn width", config.ffn)):
        if n % tp:
            raise ValueError(f"{name} ({n}) must be divisible by the tensor-parallel "
                             f"size ({tp})")


def _map_specs(fn, tree, config):
    def walk(node, specs):
        if isinstance(node, dict):
            return {k: walk(v, specs[k]) for k, v in node.items()}
        return fn(node, specs)

    return walk(tree, param_specs(config))


def shard_tree(tree, config: BertConfig, rank: int, size: int):
    """This rank's slice of each leaf of a params-shaped tree (numpy
    arrays or tensors) along its ``"tp"`` dim: the ``rank``-th of
    ``size`` equal pieces, the block ``shard_map`` gives that device."""
    check_tp(config, size)
    if size == 1:
        return tree
    return _map_specs(lambda a, spec: a if spec.tp_dim is None
                      else _gpt._narrow(a, spec.tp_dim, rank, size), tree, config)


def shard_params(tree, config: BertConfig, axis_name, device="cuda") -> Dict[str, Any]:
    """The JAX package's params (numpy) as this rank's shard on
    ``device`` (``axis_name`` an ``AxisGroup``, or None for the whole
    tree)."""
    return params_from_numpy(shard_tree(tree, config, *_gpt._coords(axis_name)), config,
                             device)


def gather_params(tree, config: BertConfig, axis_name):
    """Every rank's slices of a params-shaped tree of tensors all-gathered
    over ``axis_name`` along each leaf's ``"tp"`` dim: the whole tree (a
    collective: every rank of the group calls it)."""
    from apex_tpu_torch.transformer.tensor_parallel.mappings import all_gather_dim

    if axis_name is None or axis_name.size() == 1:
        return tree
    return _map_specs(lambda a, spec: a.detach() if spec.tp_dim is None
                      else all_gather_dim(a.detach(), axis_name, spec.tp_dim), tree, config)


def _attention(x, p, pad_mask, config: BertConfig, axis_name, n_local_heads):
    """Bidirectional self attention on (S, B, H): q, k and v (this rank's
    heads under tp, one copy-to-region for the three), the flash kernels
    with ``causal=False`` and the key-padding mask, then wo."""
    S, B = x.shape[0], x.shape[1]
    hd = config.head_dim
    xin = _gpt._col_in(x, axis_name, False)

    def heads(t):
        return t.reshape(S, B, n_local_heads, hd).permute(1, 2, 0, 3)

    q, k, v = (heads(_gpt._proj(xin, p[f"w{n}"], p[f"b{n}"])) for n in "qkv")
    ctx = flash_attention(q, k, v, causal=False, kv_mask=pad_mask)
    ctx = ctx.permute(2, 0, 1, 3).reshape(S, B, n_local_heads * hd)
    return _gpt._row_proj(ctx, p["wo"], p["bo"], axis_name, False)


def _layer(x, p, pad_mask, config: BertConfig, axis_name, n_local_heads):
    """One post-LN block."""
    H, eps, cd = config.hidden_size, config.layernorm_eps, config.compute_dtype
    a = _attention(x, p, pad_mask, config, axis_name, n_local_heads)
    x = fused_layer_norm_affine(x + a, p["ln1_scale"], p["ln1_bias"], (H,), eps)
    m = _gpt._mlp(x.to(cd), p, axis_name)
    x = fused_layer_norm_affine(x + m, p["ln2_scale"], p["ln2_bias"], (H,), eps)
    return x.to(cd)


def bert_forward(params, tokens, token_types=None, pad_mask=None,
                 config: BertConfig = None, axis_name=None, return_hidden: bool = False):
    """tokens (B, S) -> MLM logits (S, B, V), or (S, B, V / tp) under
    tensor parallelism, fp32; with ``return_hidden`` the pre-decoder
    (S, B, H) MLM-head activations instead.  ``token_types`` (B, S) adds
    the type embedding; ``pad_mask`` (B, S) bool, True = valid, masks the
    padded keys.  When a gradient is recorded and
    ``config.checkpoint_layers`` is set each layer runs under
    :func:`~apex_tpu_torch.models._remat.remat_layer`."""
    axis_name = _gpt._tp(axis_name)
    tp = 1 if axis_name is None else axis_name.size()
    if axis_name is not None:
        check_tp(config, tp)
    n_local_heads = config.num_attention_heads // tp
    H, eps = config.hidden_size, config.layernorm_eps
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    S = tokens.shape[1]
    if pad_mask is not None:
        pad_mask = torch.as_tensor(pad_mask, device=dev).bool()

    if axis_name is None:
        emb = params["embed"][tokens]
    else:
        emb = vocab_parallel_embedding(tokens, params["embed"], axis_name=axis_name)
    x = emb.transpose(0, 1) + params["pos_embed"][:S][:, None, :]
    if token_types is not None:
        types = torch.as_tensor(token_types, device=dev).long()
        x = x + params["type_embed"][types].transpose(0, 1)
    x = fused_layer_norm_affine(x.contiguous(), params["embed_ln_scale"],
                                params["embed_ln_bias"], (H,), eps)
    x = x.to(config.compute_dtype)

    remat = config.checkpoint_layers and torch.is_grad_enabled()
    for p in _gpt._layer_list(params["layers"]):
        if remat:
            x = remat_layer(lambda x_, p=p: _layer(x_, p, pad_mask, config, axis_name,
                                                   n_local_heads), config.remat_policy)(x)
        else:
            x = _layer(x, p, pad_mask, config, axis_name, n_local_heads)

    # the MLM head: dense + gelu + LN + the tied decoder, in fp32
    h = torch.matmul(x.float(), params["mlm_dense"].T) + params["mlm_dense_b"]
    h = F.gelu(h, approximate="tanh")
    h = fused_layer_norm_affine(h, params["mlm_ln_scale"], params["mlm_ln_bias"], (H,), eps)
    if axis_name is not None:
        h = copy_to_tensor_model_parallel_region(h, axis_name)
    if return_hidden:
        return h
    return torch.matmul(h, params["embed"].float().T)


def bert_mlm_loss(params, tokens, targets, loss_mask, config: BertConfig, axis_name=None,
                  pad_mask=None):
    """Mean MLM cross entropy over the predicted positions (``loss_mask``
    (B, S), 1 = predict): ``Σ(loss · mask) / max(Σ mask, 1)``, the
    per-token loss from :func:`apex_tpu_torch.models.gpt.lm_head_loss`
    (the fused CE kernels with ``config.fused_ce``, else the dense fp32
    head)."""
    dev = params["embed"].device
    h = bert_forward(params, tokens, pad_mask=pad_mask, config=config, axis_name=axis_name,
                     return_hidden=True)
    t = torch.as_tensor(targets, device=dev).transpose(0, 1)
    lm = torch.as_tensor(loss_mask, device=dev).transpose(0, 1).float()
    loss = _gpt.lm_head_loss(h, params["embed"], t, config, axis_name)
    return torch.sum(loss * lm) / torch.clamp_min(torch.sum(lm), 1.0)


def make_train_step(opt, config: BertConfig, graphs=None, axis_name=None):
    """``step(params, state, tokens, targets, loss_mask, pad_mask) ->
    loss``: :func:`bert_mlm_loss` and its gradients, then
    ``opt.update(..., inplace=True)`` writing the new params and state
    into the given ones (the donated step of bench.py's
    ``bert_base_lamb``; ``opt`` one of the port's engine optimizers).
    Compiled unless ``graphs=False``: a
    :class:`~apex_tpu_torch.graphs.CapturedStep` that runs one eager
    step, captures the step as one CUDA graph and replays it (on
    the CPU it runs the static buffers without capture).  ``axis_name``:
    the tensor-parallel group, ``params`` and ``state`` this rank's
    shard; the replicated leaves' grads are whole on every rank (the
    copy-to-region backwards sum the partial dx), so the step adds no
    sync.  ``params`` must require gradients."""
    from apex_tpu_torch.graphs import CapturedStep
    from apex_tpu_torch.optimizers.tree import tree_leaves, tree_unflatten

    def step(params, state, tokens, targets, loss_mask, pad_mask):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            loss = bert_mlm_loss(params, tokens, targets, loss_mask, config, axis_name,
                                 pad_mask)
            # the type embedding has no use in the MLM loss: its grad is zeros, as
            # jax.grad gives it
            grads = tree_unflatten(params, list(torch.autograd.grad(
                loss, leaves, materialize_grads=True)))
        opt.update(grads, state, params, inplace=True)
        return loss.detach()

    if graphs is False:
        return step
    return CapturedStep(step, donate=(0, 1))
