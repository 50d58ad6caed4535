"""Fast multihead attention modules (counterpart of
:mod:`apex_tpu.contrib.multihead_attn.self_multihead_attn`; reference
``apex/contrib/multihead_attn``: ``SelfMultiheadAttn`` and
``EncdecMultiheadAttn`` with the fused QKV GEMM, softmax, dropout and
output projection, and the optional pre-LN + residual add of
``fast_*_norm_add_func.py``).

Layout as the reference: inputs ``(seq, batch, hidden)``.  The
projections are cuBLAS GEMMs in the input's dtype; the attention core is
the flash kernels (:func:`apex_tpu_torch.ops.attention.flash_attention`)
with ``kv_mask = ~key_padding_mask``, since a key padding mask here
follows the torch convention (True / 1 = PAD, reference
``self_multihead_attn.py:144``); ``include_norm_add`` runs the LayerNorm
kernels (:func:`~apex_tpu_torch.normalization.fused_layer_norm_affine`,
eps 1e-5) on the query and adds the residual after the output
projection.  The parameters carry the flax module's names (``input_weights``
(3H, H), ``output_weights``, ``lyr_nrm_gamma_weights``, ...), and
:meth:`params_from_numpy` loads the JAX module's tree.  Dropout on the
attention output draws from the ``generator=`` given to ``forward``, the
twin of flax's ``dropout`` rng; training with dropout raises without one.
"""

from typing import Optional

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.contrib.multihead_attn.mask_softmax_dropout_func import dropout
from apex_tpu_torch.models.resnet import _lecun_normal_
from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.ops.attention import flash_attention

__all__ = ["SelfMultiheadAttn", "EncdecMultiheadAttn"]


def _lecun_normal(shape, generator, dtype, device):
    """Flax's ``lecun_normal`` for a 2D kernel, whose fan-in axis is -2
    (shape[0])."""
    w = _lecun_normal_(torch.empty(shape, dtype=torch.float32), shape[0], generator)
    return torch.nn.Parameter(w.to(device=device, dtype=dtype))


class _AttnBase(torch.nn.Module):
    """The parameter bookkeeping the two modules share."""

    def _init_params(self, shapes, hidden, use_bias, include_norm_add, param_dtype,
                     device, generator):
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if include_norm_add:
            self.lyr_nrm_gamma_weights = torch.nn.Parameter(
                torch.ones(hidden, dtype=torch.float32, device=dev))
            self.lyr_nrm_beta_weights = torch.nn.Parameter(
                torch.zeros(hidden, dtype=torch.float32, device=dev))
        for name, rows in shapes:
            self.register_parameter(f"{name}_weights",
                                    _lecun_normal((rows, hidden), generator, param_dtype, dev))
            if use_bias:
                self.register_parameter(f"{name}_biases", torch.nn.Parameter(
                    torch.zeros(rows, dtype=param_dtype, device=dev)))

    def params_from_numpy(self, tree):
        """Copy the JAX module's params (numpy arrays by flax name,
        optionally under a ``"params"`` key) into this module; returns it."""
        tree = tree.get("params", tree)
        own = dict(self.named_parameters())
        if sorted(tree) != sorted(own):
            raise ValueError(f"expected params {sorted(own)}, got {sorted(tree)}")
        with torch.no_grad():
            for name, p in own.items():
                src = torch.tensor(np.asarray(tree[name], np.float32))
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(p.shape)}")
                p.copy_(src)
        return self

    def _norm(self, query):
        if not self.include_norm_add:
            return query
        return fused_layer_norm_affine(query, self.lyr_nrm_gamma_weights,
                                       self.lyr_nrm_beta_weights, (self.hidden_size,), 1e-5)

    def _project(self, x, name):
        y = torch.matmul(x, getattr(self, f"{name}_weights").t().to(x.dtype))
        b = getattr(self, f"{name}_biases", None)
        return y if b is None else y + b.to(y.dtype)

    def _attend(self, q, k, v, key_padding_mask, causal, train, generator):
        """(S, B, H) projections -> the (Sq, B, H) context, dropped out
        in training."""
        nh = self.num_heads
        hd = self.hidden_size // nh

        def heads(t):  # (S, B, H) -> (B, nh, S, hd)
            return t.reshape(t.shape[0], t.shape[1], nh, hd).permute(1, 2, 0, 3)

        kv_mask = None if key_padding_mask is None else ~key_padding_mask.to(torch.bool)
        ctx = flash_attention(heads(q), heads(k), heads(v), causal=causal, kv_mask=kv_mask)
        S, B = q.shape[:2]
        ctx = ctx.permute(2, 0, 1, 3).reshape(S, B, self.hidden_size)
        if self.training if train is None else train:
            if self.dropout > 0:
                if generator is None:
                    raise ValueError(f"{type(self).__name__}: training dropout needs "
                                     f"generator=")
                ctx = dropout(ctx, self.dropout, generator)
        return ctx

    def _finish(self, ctx, residual):
        out = self._project(ctx, "output")
        if self.include_norm_add:
            out = out + residual.to(out.dtype)
        return out


class SelfMultiheadAttn(_AttnBase):
    """``SelfMultiheadAttn(hidden_size, num_heads, dropout, use_bias,
    include_norm_add, impl)`` on ``device`` (default ``"cuda"``, which
    raises without a GPU), its weights drawn from ``generator`` (a CPU
    ``torch.Generator``, seeded 0 by default)."""

    def __init__(self, hidden_size: int, num_heads: int, dropout: float = 0.0,
                 use_bias: bool = True, include_norm_add: bool = False, impl: str = "fast",
                 param_dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size, self.num_heads, self.dropout = hidden_size, num_heads, dropout
        self.use_bias, self.include_norm_add, self.impl = use_bias, include_norm_add, impl
        self._init_params((("input", 3 * hidden_size), ("output", hidden_size)), hidden_size,
                          use_bias, include_norm_add, param_dtype, device, generator)

    def forward(self, query, key_padding_mask=None, *, causal: bool = False,
                train: Optional[bool] = None, generator: Optional[torch.Generator] = None):
        """``query`` (S, B, H); ``key_padding_mask`` (B, S), True / 1 =
        PAD.  ``train`` defaults to ``self.training``."""
        x = self._norm(query)
        q, k, v = torch.chunk(self._project(x, "input"), 3, dim=-1)
        ctx = self._attend(q, k, v, key_padding_mask, causal, train, generator)
        return self._finish(ctx, query)


class EncdecMultiheadAttn(_AttnBase):
    """Cross attention, q from the decoder, k and v from the encoder
    (reference ``encdec_multihead_attn.py:27-63``, with ``bias`` and the
    pre-LN + residual add); the same construction arguments as
    :class:`SelfMultiheadAttn`, ``use_bias`` False by default."""

    def __init__(self, hidden_size: int, num_heads: int, dropout: float = 0.0,
                 use_bias: bool = False, include_norm_add: bool = False,
                 param_dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size, self.num_heads, self.dropout = hidden_size, num_heads, dropout
        self.use_bias, self.include_norm_add = use_bias, include_norm_add
        self._init_params((("q", hidden_size), ("kv", 2 * hidden_size),
                           ("output", hidden_size)), hidden_size, use_bias,
                          include_norm_add, param_dtype, device, generator)

    def forward(self, query, key, key_padding_mask=None, *, train: Optional[bool] = None,
                generator: Optional[torch.Generator] = None):
        """``query`` (Sq, B, H), ``key`` (Sk, B, H) (the encoder's
        output, giving k and v); ``key_padding_mask`` (B, Sk), True / 1 =
        PAD.  Non-causal."""
        q = self._project(self._norm(query), "q")
        k, v = torch.chunk(self._project(key, "kv"), 2, dim=-1)
        ctx = self._attend(q, k, v, key_padding_mask, False, train, generator)
        return self._finish(ctx, query)
