"""OpenFold's MHA core: attention with a mask and a trained pair bias
(counterpart of :mod:`apex_tpu.contrib.openfold_triton.mha`; reference
``apex/contrib/openfold_triton/mha.py``: ``FusedAttenionCoreFunc`` (:133)
over the Triton kernels ``_attention_bias`` / ``_attention_no_bias``,
the ``CanSchTriMHA`` shape gate (:36) and the enable switches (:20-33)).

:func:`attention_core` runs no hand-written kernel.  It builds the fp32
pair bias plus a ``-inf``-valued mask bias (``-inf`` is the ``inf``
argument, 1e9 by default) and calls
:func:`apex_tpu_torch.ops.attention.flash_attention` with ``attn_bias=``,
which takes the scan path (:class:`~apex_tpu_torch.ops.attention.ScanAttention`,
the blockwise online softmax in fp32), as the JAX package does: a dense
score bias never reaches the flash kernels there either.  The bias is
differentiable (OpenFold trains it; it comes from the pair
representation): its gradient is dS summed over the dims it was
broadcast along.  :func:`AttnBiasJIT` is the reference's
``torch.compile``-d composite written as plain PyTorch ops (nothing
compiled).  The shape gate reduces to the enable switch.
"""

from typing import Optional

import torch

from apex_tpu_torch.ops.attention import flash_attention

__all__ = ["attention_core", "AttnTri", "AttnBiasJIT", "AttnNoBiasJIT", "CanSchTriMHA",
           "enable", "disable", "is_enabled"]

_enabled = True


def is_enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def CanSchTriMHA(in_shape, has_bias=True, inf=1e9, training=True) -> bool:
    """Reference :36 gates on Triton tile shapes; the scan path takes
    any shape, so the gate is the enable switch."""
    return _enabled


def attention_core(q, k, v, mask: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None, inf: float = 1e9):
    """(..., H, S, D) attention with an optional mask and pair bias.
    ``mask`` broadcastable to the (..., H, Sq, Sk) scores, nonzero /
    True = keep, 0 / False = masked with ``-inf``; ``bias`` an additive
    score bias broadcastable the same way (trained).  Leading dims are
    flattened into the batch."""
    lead = q.shape[:-3]
    B = 1
    for d in lead:
        B *= d
    H, Sq, D = q.shape[-3:]
    Sk = k.shape[-2]
    q4, k4, v4 = q.reshape(B, H, Sq, D), k.reshape(B, H, Sk, D), v.reshape(B, H, Sk, D)

    def to4(t):
        return t.expand(*lead, H, Sq, Sk).reshape(B, H, Sq, Sk)

    attn_bias = None
    if bias is not None:
        attn_bias = to4(bias.to(torch.float32))
    if mask is not None:
        mask_bias = to4(torch.where(mask.to(torch.bool), 0.0, -float(inf)).to(torch.float32))
        attn_bias = mask_bias if attn_bias is None else attn_bias + mask_bias
    out = flash_attention(q4, k4, v4, causal=False, attn_bias=attn_bias)
    return out.reshape(*lead, H, Sq, D)


def AttnTri(q, k, v, mask=None, bias=None, inf=1e9):
    """Reference ``AttnTri = FusedAttenionCoreFunc.apply`` (mha.py:397):
    the positional alias of :func:`attention_core`."""
    return attention_core(q, k, v, mask=mask, bias=bias, inf=inf)


def AttnBiasJIT(query, key, value, mask, bias, inf):
    """Reference ``torch.compile(_attention_bias)`` (mha.py:472) as plain
    ops: scaled scores, ``(mask - 1) * inf`` (the OpenFold logit mask),
    the bias, a softmax in fp32 cast back to the query's dtype."""
    scaling = 1.0 / (query.shape[-1] ** 0.5)
    a = torch.matmul(query * scaling, key.transpose(-2, -1))
    a = a + (mask.to(a.dtype) - 1.0) * inf
    if bias is not None:
        a = a + bias.to(a.dtype)
    a = torch.softmax(a.to(torch.float32), dim=-1).to(query.dtype)
    return torch.matmul(a, value)


def AttnNoBiasJIT(query, key, value, mask, inf):
    """Reference ``torch.compile(_attention_no_bias)`` (mha.py:473)."""
    return AttnBiasJIT(query, key, value, mask, None, inf)
