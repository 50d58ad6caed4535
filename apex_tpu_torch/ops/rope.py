"""Rotary position embeddings (RoPE), GPT-NeoX half rotation.

Counterpart of :mod:`apex_tpu.ops.rope`, with the same angle
arithmetic: positions split into base-2**16 digits
``pos = a * 2**32 + b * 2**16 + c``, each exact in fp32, against the
per-frequency constants ``(2**k * inv_freq) mod 2*pi`` computed in
float64 and rounded to fp32.  Plain PyTorch; the rotation is a few
elementwise ops around the projections.

:func:`rope_cos_sin` computes the rotation once for a set of positions,
so a forward that rotates q and k in every layer at the same positions
pays for the angles once (:func:`rotate`); :func:`apply_rope` and
:func:`apply_rope_at` are the JAX package's entry points built on them.
"""

import functools

import numpy as np
import torch

_TWO_PI = 2.0 * np.pi


@functools.lru_cache(maxsize=16)
def _freq_consts(head_dim: int, theta: float, device: torch.device):
    d2 = head_dim // 2
    inv_freq64 = theta ** (-np.arange(0, d2, dtype=np.float64) / d2)
    consts = [inv_freq64,
              np.mod(65536.0 * inv_freq64, _TWO_PI),
              np.mod(65536.0 * 65536.0 * inv_freq64, _TWO_PI)]
    return tuple(torch.as_tensor(c.astype(np.float32)).to(device) for c in consts)


def rope_angles(positions, head_dim: int, theta: float = 10000.0):
    """(S,) integer positions -> (S, head_dim / 2) fp32 angles."""
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head_dim (got {head_dim})")
    pos = torch.as_tensor(positions).long()
    f_lo, f_mid, f_hi = _freq_consts(head_dim, float(theta), pos.device)
    a = (pos >> 32).float()
    b = ((pos >> 16) & 0xFFFF).float()
    c = (pos & 0xFFFF).float()
    ang = (a[:, None] * f_hi[None, :] + b[:, None] * f_mid[None, :]
           + c[:, None] * f_lo[None, :])
    return torch.remainder(ang, _TWO_PI)


def rope_cos_sin(positions, head_dim: int, theta: float = 10000.0):
    """``(cos, sin)`` of :func:`rope_angles`, each (S, head_dim / 2)."""
    ang = rope_angles(positions, head_dim, theta)
    return torch.cos(ang), torch.sin(ang)


def rotate(x, cos, sin):
    """Rotate ``x`` (..., D) by ``cos``/``sin`` (..., D / 2) that
    broadcast against it; math in fp32, result in x's dtype."""
    d2 = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :d2], xf[..., d2:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotate ``x`` (..., S, D) by its positions (S,)."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta)
    return rotate(x, cos, sin)


def apply_rope_at(x, positions, theta: float = 10000.0):
    """Rotate single-token heads ``x`` (B, nh, D), one position per row
    (``positions`` (B,)) — the decode-step shape."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta)
    return rotate(x, cos[:, None, :], sin[:, None, :])
