"""T5: the encoder-decoder transformer behind the reference's
``ModelType.encoder_and_decoder`` pipeline path, on one device, over a
tensor-parallel group, or pipelined across the split rank.

Counterpart of :mod:`apex_tpu.models.t5`, in the style of
:mod:`apex_tpu_torch.models.bert`: functional over a params dict with the
JAX package's names and shapes (the encoder's and decoder's layer leaves
stacked ``(L, ...)``), activations ``(seq, batch, hidden)``, and the same
expression for each op, so the JAX package's params load through
:func:`params_from_numpy` and the two agree, gradients included.

- Pre-norm residual blocks with T5's scale-only RMSNorm
  (:func:`~apex_tpu_torch.normalization.fused_rms_norm_affine`, eps 1e-6:
  the LayerNorm kernels' RMS-affine mode on the card), bias-free
  projections, a ReLU FFN and the tied source/target embedding reused as
  the LM head.
- Learned absolute positions per side (``pos_enc``, ``pos_dec``) in
  place of T5's relative position bias, and each decoder layer RMS-norms
  the encoder's raw final output with its own ``lnm_scale`` (no shared
  final encoder norm): the JAX module's choices, so that every parameter
  is either a layer chunk's or shared by the pipeline.
- Attention is the einsum path, as in the JAX package: ``q @ kᵀ`` and
  then ``/ sqrt(hd)``, both rounded to the compute dtype; the decoder's
  causal self-attention goes through
  :func:`~apex_tpu_torch.transformer.functional.fused_softmax.scaled_upper_triang_masked_softmax`
  (its probabilities rounded to the compute dtype), the encoder's and the
  cross-attention through an fp32 softmax; the probabilities are cast to
  v's dtype before ``@ v``.
- The head: the final RMS norm, then
  :func:`apex_tpu_torch.models.gpt.lm_head_loss` (the dense fp32 head, or
  with ``fused_ce`` the fused LM-head CE kernels).

Tensor parallelism: ``axis_name`` is the tensor-parallel group (an
``AxisGroup``), where the JAX package runs the same functions inside
``shard_map`` with the ``tp`` axis.  Each rank holds the slices of
:func:`param_specs` (:func:`shard_params` cuts them from the JAX tree):
q, k, v and fc1 column-parallel on the rank's heads and FFN columns, the
output projections and fc2 row-parallel, the tied embedding
vocab-parallel.

Pipeline parallelism (:func:`make_pp_train_step`) runs the
encoder/decoder 1F1B schedule
(:mod:`~apex_tpu_torch.transformer.pipeline_parallel.schedules.tick_schedule_encdec`)
over the layers in :func:`params_to_pp_layout`'s padded layout.
"""

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models import gpt as _gpt
from apex_tpu_torch.models._remat import remat_layer, validate_policy
from apex_tpu_torch.normalization import fused_rms_norm_affine
from apex_tpu_torch.ops.fused_ce import check_impl
from apex_tpu_torch.transformer.functional.fused_softmax import (
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    column_parallel_linear,
    row_parallel_linear,
    vocab_parallel_embedding,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
)

__all__ = ["T5Config", "init_params", "params_from_numpy", "param_specs", "check_tp",
           "shard_tree", "shard_params", "gather_params", "t5_forward", "t5_loss",
           "make_train_step", "make_pp_train_step", "params_to_pp_layout"]

#: the non-layer leaves: every pipeline stage holds them
SHARED_KEYS = ("embed", "pos_enc", "pos_dec", "lnf_scale")


@dataclasses.dataclass(frozen=True)
class T5Config:
    """The fields of the JAX package's ``T5Config`` (T5-small's widths by
    default); ``fused_ce_impl`` must be None (the kernels are the one
    implementation).  fp16 with ``fused_ce`` raises, as ``GPTConfig``
    does: the CE kernels take fp32 or bf16 x."""

    vocab_size: int = 32128
    hidden_size: int = 512
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    num_attention_heads: int = 8
    max_src_len: int = 512
    max_tgt_len: int = 512
    ffn_hidden_size: Optional[int] = None
    layernorm_eps: float = 1e-6
    compute_dtype: Any = torch.bfloat16
    checkpoint_layers: bool = True
    remat_policy: str = "full"
    fused_ce: bool = False
    fused_ce_chunk: int = 128
    fused_ce_impl: Optional[str] = None

    def __post_init__(self):
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

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size


def _init_numpy(config: T5Config, generator: torch.Generator) -> Dict[str, Any]:
    """fp32 params with the JAX package's tree, names and shapes (normal
    matrices scaled by 1 / sqrt(fan-in), the embedding and position
    tables by 0.02, ones for the norm scales), drawn on the CPU from
    ``generator``."""
    H, F, V = config.hidden_size, config.ffn, config.vocab_size

    def w(*shape, scale=None):
        scale = 1.0 / np.sqrt(shape[-1]) if scale is None else scale
        return (torch.randn(shape, generator=generator, dtype=torch.float32)
                * np.float32(scale)).numpy()

    def ones(*shape):
        return np.ones(shape, np.float32)

    Le, Ld = config.num_encoder_layers, config.num_decoder_layers
    return {
        "embed": w(V, H, scale=0.02),
        "pos_enc": w(config.max_src_len, H, scale=0.02),
        "pos_dec": w(config.max_tgt_len, H, scale=0.02),
        "enc_layers": {
            "ln1_scale": ones(Le, H),
            "wq": w(Le, H, H), "wk": w(Le, H, H), "wv": w(Le, H, H), "wo": w(Le, H, H),
            "ln2_scale": ones(Le, H),
            "fc1": w(Le, F, H), "fc2": w(Le, H, F),
        },
        "dec_layers": {
            "ln1_scale": ones(Ld, H),
            "wq": w(Ld, H, H), "wk": w(Ld, H, H), "wv": w(Ld, H, H), "wo": w(Ld, H, H),
            "lnx_scale": ones(Ld, H),
            "lnm_scale": ones(Ld, H),
            "cq": w(Ld, H, H), "ck": w(Ld, H, H), "cv": w(Ld, H, H), "co": w(Ld, H, H),
            "ln3_scale": ones(Ld, H),
            "fc1": w(Ld, F, H), "fc2": w(Ld, H, F),
        },
        "lnf_scale": ones(H),
    }


def params_from_numpy(tree, config: T5Config, device="cuda") -> Dict[str, Any]:
    """The JAX package's T5 params (a tree of numpy arrays) as the port's:
    fp32 tensors on ``device`` (the matmuls cast their weights to
    ``config.compute_dtype`` at use), the layer leaves stacked."""
    del config
    dev = resolve_device(device)

    def to(a):
        return torch.tensor(np.asarray(a, np.float32)).to(dev)

    return {k: ({n: to(a) for n, a in v.items()} if isinstance(v, dict) else to(v))
            for k, v in tree.items()}


def init_params(config: T5Config, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, Any]:
    """Random params drawn from ``generator`` (a CPU ``torch.Generator``;
    one seeded 0 by default), loaded as :func:`params_from_numpy` loads
    the JAX package's."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return params_from_numpy(_init_numpy(config, generator), config, dev)


def param_specs(config: T5Config, pp: bool = False) -> Dict[str, Any]:
    """The split of each param over ``"tp"``, the JAX package's
    ``param_specs`` leaf for leaf: column-parallel weights split their
    output rows, row-parallel ones their input columns, the embedding its
    vocab.  With ``pp`` the stacked layers also split their layer axis over
    ``"pp"`` (each stage its chunks of :func:`params_to_pp_layout`'s
    layout, the JAX step's ``P(pp_axis, ...)``)."""
    P = _gpt.PartitionSpec
    col, row, rep = P(None, "tp", None), P(None, None, "tp"), P(None, None)
    enc = {"ln1_scale": rep, "wq": col, "wk": col, "wv": col, "wo": row,
           "ln2_scale": rep, "fc1": col, "fc2": row}
    dec = {"ln1_scale": rep, "wq": col, "wk": col, "wv": col, "wo": row,
           "lnx_scale": rep, "lnm_scale": rep, "cq": col, "ck": col, "cv": col, "co": row,
           "ln3_scale": rep, "fc1": col, "fc2": row}
    if pp:
        enc, dec = ({k: P("pp", *tuple(v)[1:]) for k, v in side.items()} for side in (enc, dec))
    return {"embed": P("tp", None), "pos_enc": P(None, None), "pos_dec": P(None, None),
            "enc_layers": enc, "dec_layers": dec, "lnf_scale": P(None)}


def check_tp(config: T5Config, tp: int) -> None:
    """Raise unless the vocab, the heads and the FFN width split over
    ``tp`` ranks."""
    for name, n in (("vocab_size", config.vocab_size),
                    ("num_attention_heads", config.num_attention_heads),
                    ("ffn width", config.ffn)):
        if n % tp:
            raise ValueError(f"{name} ({n}) must be divisible by the tensor-parallel "
                             f"size ({tp})")


def _map_specs(fn, tree, config, pp=False):
    def walk(node, specs):
        if isinstance(node, dict):
            return {k: walk(v, specs[k]) for k, v in node.items()}
        return fn(node, specs)

    return walk(tree, param_specs(config, pp))


def shard_tree(tree, config: T5Config, rank: int, size: int, pp_rank: int = 0,
               pp_size: int = 1):
    """This rank's slice of each leaf of a params-shaped tree (numpy arrays
    or tensors): along its ``"tp"`` dim the ``rank``-th of ``size`` equal
    pieces, the block ``shard_map`` gives that device; with ``pp_size``
    above 1 (the tree in :func:`params_to_pp_layout`'s layout) stage
    ``pp_rank``'s rows of the stacked layers, ``enc[r·lpc_e:(r+1)·lpc_e]``
    and ``dec[r·lpc_d:(r+1)·lpc_d]``; the shared leaves whole."""
    check_tp(config, size)

    def one(a, spec):
        if spec.tp_dim is not None and size > 1:
            a = _gpt._narrow(a, spec.tp_dim, rank, size)
        if spec.pp_dim is not None and pp_size > 1:
            a = _gpt._narrow(a, spec.pp_dim, pp_rank, pp_size)
        return a

    return _map_specs(one, tree, config, pp=True)


def shard_params(tree, config: T5Config, axis_name, device="cuda",
                 pp_group=None) -> Dict[str, Any]:
    """The JAX package's params (numpy) as this rank's shard on
    ``device``: :func:`shard_tree` at ``axis_name``'s rank and size (an
    ``AxisGroup``, or None for the whole tree) and at ``pp_group``'s stage
    (the tree then in :func:`params_to_pp_layout`'s layout)."""
    return params_from_numpy(
        shard_tree(tree, config, *_gpt._coords(axis_name), *_gpt._coords(pp_group)), config,
        device)


def gather_params(tree, config: T5Config, axis_name, pp_group=None):
    """Every rank's slices of a params-shaped tree of tensors, all-gathered
    over ``axis_name`` along each leaf's ``"tp"`` dim and over ``pp_group``
    along the stacked layers: the whole tree (in the padded layout under a
    pipeline; collectives: every rank of the groups calls it)."""
    from apex_tpu_torch.transformer.tensor_parallel.mappings import all_gather_dim

    tp = axis_name is not None and axis_name.size() > 1
    pp = pp_group is not None and pp_group.size() > 1

    def one(a, spec):
        a = a.detach()
        if tp and spec.tp_dim is not None:
            a = all_gather_dim(a, axis_name, spec.tp_dim)
        if pp and spec.pp_dim is not None:
            a = all_gather_dim(a, pp_group, spec.pp_dim)
        return a

    return tree if not (tp or pp) else _map_specs(one, tree, config, pp=True)


def params_to_pp_layout(params, pp: int, split: int):
    """The encoder's and decoder's stacked layers in the padded per-stage
    layout (:func:`~apex_tpu_torch.transformer.pipeline_parallel.schedules.
    tick_schedule_encdec.pad_stage_layout_encdec`): encoder chunks on
    stages < split, decoder chunks on stages >= split, zeros elsewhere.
    Numpy arrays or tensors; cut it over pp with :func:`shard_params`."""
    from apex_tpu_torch.transformer.pipeline_parallel.schedules.tick_schedule_encdec import (
        pad_stage_layout_encdec,
    )

    enc_p, dec_p = pad_stage_layout_encdec(params["enc_layers"], params["dec_layers"], pp, split)
    return {**params, "enc_layers": enc_p, "dec_layers": dec_p}


# ------------------------------------------------------------------ layers
def _rms(x, scale, config: T5Config):
    """T5's norm: the RMS-affine LayerNorm kernels, the output in x's
    dtype."""
    return fused_rms_norm_affine(x, scale, (config.hidden_size,), config.layernorm_eps)


def _heads(t, B, S, nh, hd):
    return t.reshape(S, B, nh, hd).permute(1, 2, 0, 3)  # (B, nh, S, hd)


def _attn_core(q, k, v, causal: bool, hd: int):
    """The einsum attention: scores ``q @ kᵀ`` then ``/ sqrt(hd)``, each in
    the compute dtype; the causal softmax (probabilities in the compute
    dtype) or an fp32 one; the probabilities in v's dtype times v."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        probs = scaled_upper_triang_masked_softmax(scores, 1.0)
    else:
        probs = torch.softmax(scores.float(), dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def _col(x, w, tp):
    if tp is None:
        return torch.matmul(x, w.T.to(x.dtype))
    return column_parallel_linear(x, w, None, gather_output=False, axis_name=tp)


def _row(x, w, tp):
    if tp is None:
        return torch.matmul(x, w.T.to(x.dtype))
    return row_parallel_linear(x, w, None, input_is_parallel=True, axis_name=tp)


def _mha(x_q, x_kv, p, names, config: T5Config, tp, causal: bool):
    """Multi-head attention on (S, B, H): q from ``x_q``, k and v from
    ``x_kv`` (None: self-attention); column-parallel projections on this
    rank's heads, the row-parallel output."""
    if x_kv is None:
        x_kv = x_q
    Sq, B = x_q.shape[0], x_q.shape[1]
    Skv = x_kv.shape[0]
    hd = config.head_dim
    nl = config.num_attention_heads // (1 if tp is None else tp.size())
    nq, nk, nv, no = names
    q = _heads(_col(x_q, p[nq], tp), B, Sq, nl, hd)
    k = _heads(_col(x_kv, p[nk], tp), B, Skv, nl, hd)
    v = _heads(_col(x_kv, p[nv], tp), B, Skv, nl, hd)
    ctx = _attn_core(q, k, v, causal, hd)
    ctx = ctx.permute(2, 0, 1, 3).reshape(Sq, B, nl * hd)
    return _row(ctx, p[no], tp)


def _ffn(x, p, tp):
    return _row(torch.relu(_col(x, p["fc1"], tp)), p["fc2"], tp)


def encoder_layer(x, p, config: T5Config, tp=None):
    cd = config.compute_dtype
    x = x + _mha(_rms(x, p["ln1_scale"], config).to(cd), None, p, ("wq", "wk", "wv", "wo"),
                 config, tp, causal=False)
    return x + _ffn(_rms(x, p["ln2_scale"], config).to(cd), p, tp)


def decoder_layer(x, enc_out, p, config: T5Config, tp=None):
    """Causal self-attention, cross-attention on the encoder memory
    (RMS-normed by this layer's ``lnm_scale``; ``lnx_scale`` norms its
    query), the FFN."""
    cd = config.compute_dtype
    x = x + _mha(_rms(x, p["ln1_scale"], config).to(cd), None, p, ("wq", "wk", "wv", "wo"),
                 config, tp, causal=True)
    mem = _rms(enc_out, p["lnm_scale"], config).to(cd)
    xq = _rms(x, p["lnx_scale"], config).to(cd)
    x = x + _mha(xq, mem, p, ("cq", "ck", "cv", "co"), config, tp, causal=False)
    return x + _ffn(_rms(x, p["ln3_scale"], config).to(cd), p, tp)


def _encoder(layers, x, config: T5Config, tp):
    """The encoder layers of ``layers`` (stacked) on x, each under remat
    when a gradient is recorded and ``checkpoint_layers`` is set."""
    remat = config.checkpoint_layers and torch.is_grad_enabled()
    for p in _gpt._layer_list(layers):
        if remat:
            x = remat_layer(lambda x_, p=p: encoder_layer(x_, p, config, tp),
                            config.remat_policy)(x)
        else:
            x = encoder_layer(x, p, config, tp)
    return x


def _decoder(layers, y, enc_out, config: T5Config, tp):
    """The decoder layers of ``layers`` on y, each attending to
    ``enc_out``, under remat as :func:`_encoder`."""
    remat = config.checkpoint_layers and torch.is_grad_enabled()
    for p in _gpt._layer_list(layers):
        if remat:
            y = remat_layer(lambda y_, m_, p=p: decoder_layer(y_, m_, p, config, tp),
                            config.remat_policy)(y, enc_out)
        else:
            y = decoder_layer(y, enc_out, p, config, tp)
    return y


def _tokens(tokens, params):
    return torch.as_tensor(tokens, device=params["embed"].device).long()


def _embed(tokens, params, pos_key: str, config: T5Config, tp):
    """(B, S) ids -> (S, B, H) in the compute dtype: the fp32 table (the
    vocab-parallel embedding under tp) plus ``pos[:S]``."""
    tokens = _tokens(tokens, params)
    if tp is None:
        emb = params["embed"][tokens]
    else:
        emb = vocab_parallel_embedding(tokens, params["embed"], axis_name=tp)
    S = tokens.shape[1]
    x = emb.transpose(0, 1) + params[pos_key][:S][:, None, :]
    return x.to(config.compute_dtype)


def _pre_head(x, params, config: T5Config, tp):
    """The final RMS norm, then the tp copy-to-region: what the tied head
    takes."""
    x = _rms(x, params["lnf_scale"], config)
    if tp is not None:
        x = copy_to_tensor_model_parallel_region(x, tp)
    return x


def _lm_head(x, params, config: T5Config, tp):
    """Tied head: (S_tgt, B, H) -> fp32 logits, vocab-parallel under tp."""
    x = _pre_head(x, params, config, tp)
    return torch.matmul(x.float(), params["embed"].float().T)


def _head_loss(y, params, targets, config: T5Config, tp):
    """The decoder's output -> mean CE through
    :func:`apex_tpu_torch.models.gpt.lm_head_loss` (the fused CE kernels
    with ``config.fused_ce``, else the dense fp32 head)."""
    x = _pre_head(y, params, config, tp)
    t = _tokens(targets, params).transpose(0, 1)
    return _gpt.lm_head_loss(x, params["embed"], t, config, tp).mean()


def t5_forward(params, src, dec_in, config: T5Config, axis_name=None,
               return_hidden: bool = False):
    """(B, S_src) and (B, S_tgt) token ids -> (S_tgt, B, V) fp32 logits, or
    (S_tgt, B, V / tp) under tensor parallelism; with ``return_hidden``
    the pre-head (S_tgt, B, H) decoder stream instead.  The encoder's raw
    final hidden state is every decoder layer's memory."""
    tp = _gpt._tp(axis_name)
    if tp is not None:
        check_tp(config, tp.size())
    x = _encoder(params["enc_layers"], _embed(src, params, "pos_enc", config, tp), config, tp)
    y = _decoder(params["dec_layers"], _embed(dec_in, params, "pos_dec", config, tp), x,
                 config, tp)
    return y if return_hidden else _lm_head(y, params, config, tp)


def t5_loss(params, src, dec_in, targets, config: T5Config, axis_name=None):
    """Mean cross entropy of the decoder's predictions against ``targets``
    (B, S_tgt), over the tensor-parallel group ``axis_name`` when given
    (``params`` this rank's shard; the loss is the same on every rank)."""
    y = t5_forward(params, src, dec_in, config, axis_name, return_hidden=True)
    return _head_loss(y, params, targets, config, _gpt._tp(axis_name))


def _check_replicated(optimizer) -> None:
    """The T5 steps take replicated optimizer state (the JAX steps'
    ``AdamState`` spec: every dp rank holds the state of its params)."""
    if hasattr(optimizer, "sharded_state_dict"):
        raise ValueError("the T5 train steps take replicated optimizer state (an engine "
                         "optimizer such as FusedAdam); a ZeRO optimizer shards it over dp, "
                         "which the T5 steps do not wire")


def _requires_grad(params):
    from apex_tpu_torch.optimizers.tree import tree_leaves

    leaves = tree_leaves(params)
    for leaf in leaves:
        if not leaf.requires_grad:
            leaf.requires_grad_(True)
    return leaves


def make_train_step(config: T5Config, optimizer, *, tp_group=None, dp_group=None, graphs=None):
    """The (tp × dp) train step without a pipeline, the JAX package's
    ``make_train_step``: ``step(params, state, src, dec_in, targets) ->
    loss``.  :func:`t5_loss` and its grads over ``tp_group`` (``params``
    and ``state`` this rank's shard; the replicated leaves' grads are
    whole on every rank, the copy-to-region backwards summing the partial
    dx), both averaged over ``dp_group`` (the DDP all-reduce; ``src``,
    ``dec_in`` and ``targets`` this dp rank's rows), then the optimizer's
    update, in place.  ``optimizer``: a replicated engine optimizer; a
    ZeRO optimizer raises.  Built on
    :func:`apex_tpu_torch.train_gpt._make_step`: compiled (one CUDA graph
    after an eager warm-up) unless ``graphs=False``."""
    from apex_tpu_torch.optimizers.tree import tree_unflatten
    from apex_tpu_torch.train_gpt import _make_step

    _check_replicated(optimizer)
    tp = _gpt._tp(tp_group)
    if tp is not None:
        check_tp(config, tp.size())

    def grads_fn(params, src, dec_in, targets, post):
        leaves = _requires_grad(params)
        loss = t5_loss(params, src, dec_in, targets, config, tp)
        if post is not None:
            loss = post(loss)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(params, grads)

    return _make_step(optimizer, config, grads_fn, graphs=graphs, dp_group=dp_group,
                      tp_group=tp)


def make_pp_train_step(config: T5Config, optimizer, num_microbatches: int,
                       split: Optional[int] = None, *, loss_scaler=None, graphs=None,
                       dp_group=None, tp_group=None, pp_group=None):
    """The encoder/decoder pipeline train step (tp × pp × dp) over the
    dual-stream 1F1B schedule, the JAX package's ``make_pp_train_step``:
    ``step(params, state, src, dec_in, targets) -> loss``, or with
    ``loss_scaler`` ``step(params, state, scaler_state, src, dec_in,
    targets) -> loss``.

    ``split`` (the first decoder stage) defaults to
    ``parallel_state.get_pipeline_model_parallel_split_rank()``.
    ``params`` (and the optimizer state) are this rank's: its stage's
    chunks of :func:`params_to_pp_layout`'s layout (cut by
    :func:`shard_params` with ``pp_group``), its tp slices, and the
    shared leaves (embedding, both position tables, the final norm).
    ``src``, ``dec_in`` and ``targets`` (B, S) are this dp rank's rows,
    the same on every stage; they split into ``num_microbatches`` M
    microbatches of rows ``[m·B/M, (m+1)·B/M)`` (the JAX step's reshape).
    Rank 0 embeds the source, rank ``split`` the target, the ranks run
    their encoder or decoder chunk (remat as configured), the last
    applies the head; the loss is the mean over microbatches on every
    stage; the shared grads are summed over the pipeline, then every grad
    and the loss averaged over ``dp_group`` (the DDP all-reduce) before
    the update.  ``loss_scaler`` scales the head's output, so both
    streams' cotangents, and its finite vote is agreed over (pp, tp), so
    that every stage skips a step together.  The zero chunks' grads are
    zero, so the optimizer keeps them at zero.  ``optimizer``: a
    replicated engine optimizer; a ZeRO optimizer raises.  Compiled unless
    ``graphs=False``: the whole step, both streams' messages with it, is
    one CUDA graph after the eager warm-up (which starts every NCCL
    channel before the capture)."""
    from apex_tpu_torch.train_gpt import _make_step
    from apex_tpu_torch.transformer import parallel_state
    from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication as p2p
    from apex_tpu_torch.transformer.pipeline_parallel.schedules.tick_schedule_encdec import (
        forward_backward_pipelining_encdec,
    )

    _check_replicated(optimizer)
    if split is None:
        try:
            split = parallel_state.get_pipeline_model_parallel_split_rank()
        except RuntimeError:
            split = None  # parallel_state not initialized: require split=
    if split is None:
        raise ValueError(
            "pass split= or initialize_model_parallel(..., "
            "pipeline_model_parallel_split_rank_=...) — an encoder-decoder "
            "pipeline needs the split rank (reference common.py:90)")
    group = p2p._group(pp_group)
    P = group.size()
    if not (0 < split < P):
        raise ValueError(f"split must be in (0, {P}); got {split}")
    tp = _gpt._tp(tp_group)
    if tp is not None:
        check_tp(config, tp.size())
    M = int(num_microbatches)
    cd = config.compute_dtype

    def pre_enc_fn(shared, mb):
        return _embed(mb["src"], shared, "pos_enc", config, tp)

    def pre_dec_fn(shared, mb):
        return _embed(mb["dec_in"], shared, "pos_dec", config, tp)

    def enc_stage_fn(chunk, x):
        return _encoder(chunk, x, config, tp)

    def dec_stage_fn(chunk, x, enc_out):
        return _decoder(chunk, x, enc_out, config, tp)

    def grads_fn(params, src, dec_in, targets, post):
        _requires_grad(params)
        B = src.shape[0]
        if B % M:
            raise ValueError(f"the batch's {B} rows do not split into {M} microbatches")
        mbs = {"src": src.reshape(M, B // M, -1), "dec_in": dec_in.reshape(M, B // M, -1),
               "targets": targets.reshape(M, B // M, -1)}

        def post_fn(shared, y, mb):
            loss = _head_loss(y, shared, mb["targets"], config, tp)
            # the schedule seeds the backward from post_fn's output: a loss
            # scale here scales every cotangent of both streams
            return loss if post is None else post(loss)

        shared = {k: params[k] for k in SHARED_KEYS}
        b = B // M
        shapes = ((src.shape[1], b, config.hidden_size), (dec_in.shape[1], b, config.hidden_size))
        loss, (g_sh, g_enc, g_dec) = forward_backward_pipelining_encdec(
            pre_enc_fn, pre_dec_fn, enc_stage_fn, dec_stage_fn, post_fn, shared,
            params["enc_layers"], params["dec_layers"], mbs, split=split,
            tensor_shapes=shapes, dtype=cd, axis_name=group)
        return loss.detach(), {**g_sh, "enc_layers": g_enc, "dec_layers": g_dec}

    # stage-split and tp-split grads can overflow on one rank only: both
    # groups join the finite vote
    sync = tuple(g for g in (group if P > 1 else None, tp) if g is not None)
    return _make_step(optimizer, config, grads_fn, loss_scaler=loss_scaler, graphs=graphs,
                      dp_group=dp_group, tp_group=tp, sync_groups=sync)
