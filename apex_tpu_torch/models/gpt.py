"""GPT on one device: the forward, the training loss, and the paged-KV
decode forward.

Counterpart of :mod:`apex_tpu.models.gpt` at ``axis_name=None``, with
the same layouts: activations ``(seq, batch, hidden)``, attention heads
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
LM-head CE kernels (:mod:`apex_tpu_torch.ops.fused_ce`).  Not in this
port yet (they raise): tensor/sequence/context parallelism, MoE and the
``"dots"`` remat policy.
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

#: the stacked per-layer leaves cast to ``compute_dtype`` at load for
#: serving
MATMUL_KEYS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo",
               "fc1", "fc1_b", "fc2", "fc2_b")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The fields of the JAX package's ``GPTConfig``.  ``checkpoint_layers``
    and ``remat_policy`` act when a gradient is taken; ``fused_ce`` and
    ``fused_ce_chunk`` act on the loss path, and ``fused_ce_impl`` must be
    None (the kernels are the one implementation).  The options the port
    cannot run raise at construction."""

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
        for name, unsupported in (
                ("moe_num_experts", self.moe_num_experts > 0),
                ("sequence_parallel", self.sequence_parallel),
                ("cp_overlap", self.cp_overlap)):
            if unsupported:
                raise NotImplementedError(
                    f"GPTConfig.{name} is not ported yet (MoE, sequence and "
                    f"context parallelism come in later slices)")
        validate_policy(self.remat_policy)
        check_impl(self.fused_ce_impl)
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"compute_dtype must be torch.float32 or torch.bfloat16 "
                f"(got {self.compute_dtype})")
        if self.num_attention_heads % self.kv_heads != 0:
            raise ValueError(
                f"num_attention_heads ({self.num_attention_heads}) must be "
                f"divisible by num_query_groups ({self.kv_heads})")

    @property
    def ffn(self):
        return self.ffn_hidden_size or 4 * self.hidden_size

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
    1/sqrt(2L), ones/zeros for LayerNorm and biases), drawn from a
    numpy generator seeded with ``seed``."""
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
            "fc1": init(L, Fh, H), "fc1_b": zeros(L, Fh),
            "fc2": init(L, H, Fh) * scale, "fc2_b": zeros(L, H),
        },
        "final_ln_scale": ones(H),
        "final_ln_bias": zeros(H),
    }
    if config.position_embedding_type == "learned":
        params["pos_embed"] = init(config.max_seq_len, H)
    return params


def params_from_numpy(tree, config: GPTConfig, device="cuda",
                      keep_fp32: bool = False) -> Dict[str, Any]:
    """The JAX package's GPT params (a tree of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's: torch tensors
    on ``device``.  For serving the :data:`MATMUL_KEYS` leaves are cast
    to ``config.compute_dtype`` once here; with ``keep_fp32`` (training)
    every leaf stays fp32, the tree JAX trains.  The rest is fp32."""
    dev = resolve_device(device)
    cast = torch.float32 if keep_fp32 else config.compute_dtype

    def to(a, dtype):
        return torch.tensor(np.asarray(a, np.float32)).to(device=dev, dtype=dtype)

    out = {k: to(v, torch.float32) for k, v in tree.items() if k != "layers"}
    out["layers"] = {
        k: to(v, cast if k in MATMUL_KEYS else torch.float32)
        for k, v in tree["layers"].items()}
    return out


def init_params(config: GPTConfig, seed: int = 0, device="cuda",
                keep_fp32: bool = False) -> Dict[str, Any]:
    """Random params from a numpy seed, loaded as :func:`params_from_numpy`
    loads the JAX package's."""
    dev = resolve_device(device)
    return params_from_numpy(_init_numpy(config, seed), config, dev, keep_fp32)


def _layer_list(layers):
    """The stacked per-layer leaves as one dict of views per layer."""
    names = list(layers)
    return [dict(zip(names, vals)) for vals in zip(*(layers[k].unbind(0) for k in names))]


def _proj(x, w, b):
    """``x @ w.T + b`` with the weight and bias cast to x's dtype at use:
    two roundings, the JAX package's expression."""
    return torch.matmul(x, w.T.to(x.dtype)) + b.to(x.dtype)


def _mlp(x, p):
    h = _proj(x, p["fc1"], p["fc1_b"])
    h = F.gelu(h, approximate="tanh")
    return _proj(h, p["fc2"], p["fc2_b"])


def _attention(x, p, config: GPTConfig, rope):
    """Causal self attention on (S, B, H).  With ``use_flash_attention``
    the flash kernels (GQA read in place); otherwise the einsum path:
    scores in the compute dtype divided by sqrt(head_dim), causal fill,
    fp32 softmax, probabilities cast to v's dtype.  Returns ``(out, (k,
    v))`` with the post-RoPE k/v (B, kv_heads, S, head_dim) before any
    GQA repeat."""
    S, B, _ = x.shape
    nh, nkv, hd = config.num_attention_heads, config.kv_heads, config.head_dim

    def heads(t, n):
        return t.reshape(S, B, n, hd).permute(1, 2, 0, 3)

    q = heads(_proj(x, p["wq"], p["bq"]), nh)
    k = heads(_proj(x, p["wk"], p["bk"]), nkv)
    v = heads(_proj(x, p["wv"], p["bv"]), nkv)
    if rope is not None:
        q, k = rotate(q, *rope), rotate(k, *rope)
    kv = (k, v)
    if config.use_flash_attention:
        ctx = flash_attention(q, k, v, causal=True)
    else:
        if nkv != nh:
            k = k.repeat_interleave(nh // nkv, dim=1)
            v = v.repeat_interleave(nh // nkv, dim=1)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        probs = scaled_upper_triang_masked_softmax(scores, 1.0)
        ctx = torch.matmul(probs.to(v.dtype), v)
    ctx = ctx.permute(2, 0, 1, 3).reshape(S, B, nh * hd)
    return _proj(ctx, p["wo"], p["bo"]), kv


def _layer(x, p, config: GPTConfig, rope):
    """One transformer block on (S, B, H); returns ``(x, (k, v))``."""
    H, eps, cd = config.hidden_size, config.layernorm_eps, config.compute_dtype
    ln1 = fused_layer_norm_affine(x, p["ln1_scale"], p["ln1_bias"], (H,), eps)
    attn, kv = _attention(ln1.to(cd), p, config, rope)
    x = x + attn
    ln2 = fused_layer_norm_affine(x, p["ln2_scale"], p["ln2_bias"], (H,), eps)
    return x + _mlp(ln2.to(cd), p), kv


def gpt_forward(params, tokens, config: GPTConfig, return_hidden: bool = False,
                return_kv: bool = False):
    """tokens (B, S) -> logits (S, B, V) fp32, or with ``return_hidden``
    the pre-head activations (S, B, H) after the final LayerNorm.  With
    ``return_kv`` a trailing ``(k, v)`` pair is appended, each (L, B,
    kv_heads, S, head_dim): every layer's post-RoPE keys/values, the
    prefill capture the paged cache stores.  When a gradient is being
    recorded and ``config.checkpoint_layers`` is set, each layer runs
    under :func:`~apex_tpu_torch.models._remat.remat_layer` (the JAX
    package's remat of ``_layers_segment``)."""
    H = config.hidden_size
    eps = config.layernorm_eps
    cd = config.compute_dtype
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    S = tokens.shape[1]
    x = params["embed"][tokens].transpose(0, 1)  # (S, B, H) fp32
    if config.position_embedding_type == "learned":
        x = x + params["pos_embed"][:S][:, None, :]
    x = x.to(cd).contiguous()
    rope = None
    if config.position_embedding_type == "rope":
        rope = rope_cos_sin(torch.arange(S, device=x.device), config.head_dim,
                            config.rope_theta)
    remat = config.checkpoint_layers and torch.is_grad_enabled() and not return_kv
    ks, vs = [], []
    for p in _layer_list(params["layers"]):
        if remat:
            x = remat_layer(lambda x_, p=p: _layer(x_, p, config, rope)[0],
                            config.remat_policy)(x)
            continue
        x, (k, v) = _layer(x, p, config, rope)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = fused_layer_norm_affine(x, params["final_ln_scale"], params["final_ln_bias"],
                                (H,), eps)
    out = x if return_hidden else torch.matmul(x.float(), params["embed"].float().T)
    if return_kv:
        return out, (torch.stack(ks), torch.stack(vs))
    return out


def lm_head_loss(x, embed, targets, config: GPTConfig):
    """Per-token CE (S, B) of the tied LM head on the pre-head
    activations ``x`` (S, B, H), the JAX package's ``lm_head_loss`` at
    ``axis_name=None``: with ``config.fused_ce`` and S divisible by
    ``config.fused_ce_chunk``, :func:`~apex_tpu_torch.ops.fused_ce.
    fused_lm_head_ce` (the CE kernels); otherwise the dense head -- fp32 logits
    ``x @ embed.T``, ``logsumexp`` minus the target logit, targets
    clamped into ``[0, V-1]``."""
    if config.fused_ce and targets.shape[0] % config.fused_ce_chunk == 0:
        return fused_lm_head_ce(x, embed, targets, config.fused_ce_chunk)
    logits = torch.matmul(x.float(), embed.float().T)
    lse = torch.logsumexp(logits, dim=-1)
    t_cl = targets.long().clamp(0, logits.shape[-1] - 1)
    return lse - logits.gather(-1, t_cl[..., None])[..., 0]


def gpt_loss(params, tokens, targets, config: GPTConfig):
    """Mean causal-LM cross entropy of ``tokens`` (B, S) against
    ``targets`` (B, S): the JAX package's ``gpt_loss`` on one device."""
    dev = params["embed"].device
    t = torch.as_tensor(targets, device=dev).transpose(0, 1)  # (S, B)
    hidden = gpt_forward(params, tokens, config, return_hidden=True)
    return lm_head_loss(hidden, params["embed"], t, config).mean()


def forward_decode(params, tokens, positions, active, kv_pools, page_tables,
                   config: GPTConfig):
    """Single-token decode forward over the paged KV cache.

    ``tokens``/``positions``/``active``: (B,) current token ids, their
    0-based positions, and slot liveness.  ``kv_pools``: the ``{"k",
    "v"}`` pools of :func:`apex_tpu_torch.inference.kv_cache.alloc_pools`,
    (L, num_pages, page_size, kv_heads, head_dim) each.  ``page_tables``:
    (B, P) int32.  Each layer first writes the tokens' post-RoPE k/v
    into their pages — IN PLACE (``index_put_``), where the JAX package
    donates the pools and rebinds them; inactive slots write the
    reserved garbage page — and then attends over the pages with
    :func:`~apex_tpu_torch.ops.decode_attention.paged_decode_attention`.

    Returns ``(hidden, kv_pools)``: hidden (B, H) after the final
    LayerNorm (the caller owns the head), and the same pools dict.
    """
    from apex_tpu_torch.inference.kv_cache import decode_write_index

    B = tokens.shape[0]
    H, eps, cd = config.hidden_size, config.layernorm_eps, config.compute_dtype
    nh, nkv, hd = config.num_attention_heads, config.kv_heads, config.head_dim
    positions = positions.long()
    lengths = torch.where(active, positions + 1, 0).to(torch.int32)
    x = params["embed"][tokens.long()][None]  # (1, B, H) fp32
    if config.position_embedding_type == "learned":
        pos = params["pos_embed"][positions.clamp(0, config.max_seq_len - 1)]
        x = x + pos[None]
    x = x.to(cd)
    rope = None
    if config.position_embedding_type == "rope":
        cos, sin = rope_cos_sin(positions, hd, config.rope_theta)
        rope = (cos[:, None, :], sin[:, None, :])
    k_pools, v_pools = kv_pools["k"], kv_pools["v"]
    dest, slot = decode_write_index(page_tables, positions, active,
                                    k_pools.shape[1], k_pools.shape[2])
    for li, p in enumerate(_layer_list(params["layers"])):
        ln1 = fused_layer_norm_affine(x, p["ln1_scale"], p["ln1_bias"], (H,), eps)
        h = ln1.to(cd)
        q = _proj(h, p["wq"], p["bq"])[0].reshape(B, nh, hd)
        k = _proj(h, p["wk"], p["bk"])[0].reshape(B, nkv, hd)
        v = _proj(h, p["wv"], p["bv"])[0].reshape(B, nkv, hd)
        if rope is not None:
            q, k = rotate(q, *rope), rotate(k, *rope)
        k_pool, v_pool = k_pools[li], v_pools[li]
        k_pool.index_put_((dest, slot), k.to(k_pool.dtype))
        v_pool.index_put_((dest, slot), v.to(v_pool.dtype))
        ctx = paged_decode_attention(q, k_pool, v_pool, page_tables, lengths)
        ctx = ctx.to(cd).reshape(1, B, nh * hd)
        x = x + _proj(ctx, p["wo"], p["bo"])
        ln2 = fused_layer_norm_affine(x, p["ln2_scale"], p["ln2_bias"], (H,), eps)
        x = x + _mlp(ln2.to(cd), p)
    x = fused_layer_norm_affine(x, params["final_ln_scale"], params["final_ln_bias"],
                                (H,), eps)
    return x[0], kv_pools
