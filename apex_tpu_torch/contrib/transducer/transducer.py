"""RNN-T transducer joint and loss (counterpart of
:mod:`apex_tpu.contrib.transducer.transducer`; reference
``apex/contrib/transducer/transducer.py:5,68``: ``TransducerJoint``, the
fused broadcast add of encoder and predictor features, and
``TransducerLoss``, the fused alpha/beta recursion).

The joint is a broadcast add with the optional ReLU, dropout (drawn from
an explicit ``generator=``, the twin of the JAX joint's ``key=``) and
``pack_output``'s zero-masking of the entries past ``f_len`` / ``g_len``.

The loss runs the JAX package's alpha recursion in log space, in fp32,
``NEG_INF = -1e30``, with autograd for the gradient:
``alpha(0, 0) = 0``, ``alpha(t, 0) = alpha(t-1, 0) + blank(t-1, 0)``,
``alpha(0, u) = alpha(0, u-1) + label(0, u-1)`` and otherwise
``alpha(t, u) = logaddexp(alpha(t-1, u) + blank(t-1, u), alpha(t, u-1) +
label(t, u-1))``.  A cell needs only the cells of the anti-diagonal
``t + u - 1`` before it, so the recursion walks the ``T + U - 1``
anti-diagonals, each one vectorised over the batch and the diagonal:
every alpha is still the same one ``logaddexp`` of the same two terms,
where a loop over the ``T x U`` cells would launch ``T U`` steps.
"""

from typing import Optional

import torch

from apex_tpu_torch.contrib.multihead_attn.mask_softmax_dropout_func import dropout

__all__ = ["NEG_INF", "TransducerJoint", "transducer_loss", "TransducerLoss"]

NEG_INF = -1e30


class TransducerJoint:
    """``f`` (B, T, H) + ``g`` (B, U, H) -> (B, T, U, H) (reference
    transducer.py:5).  ``pack_output`` with ``f_len`` / ``g_len`` zeroes
    the entries with t >= f_len or u >= g_len in place of the
    reference's ragged packing, as the JAX package does."""

    def __init__(self, pack_output: bool = False, relu: bool = False, dropout: bool = False,
                 dropout_prob: float = 0.0, **_opt_knobs):
        self.pack_output = pack_output
        self.relu = relu
        self.dropout = dropout
        self.dropout_prob = dropout_prob

    def __call__(self, f, g, f_len=None, g_len=None, generator: Optional[torch.Generator] = None):
        out = f[:, :, None, :] + g[:, None, :, :]
        if self.relu:
            out = torch.relu(out)
        if self.dropout and self.dropout_prob > 0.0:
            if generator is None:
                raise ValueError("dropout=True needs generator= (an explicit RNG)")
            out = dropout(out, self.dropout_prob, generator)
        if self.pack_output and (f_len is not None or g_len is not None):
            B, T, U, _ = out.shape
            valid = torch.ones((B, T, U), dtype=torch.bool, device=out.device)
            if f_len is not None:
                valid &= (torch.arange(T, device=out.device)[None, :, None]
                          < f_len.to(out.device)[:, None, None])
            if g_len is not None:
                valid &= (torch.arange(U, device=out.device)[None, None, :]
                          < g_len.to(out.device)[:, None, None])
            out = torch.where(valid[..., None], out, 0.0)
        return out


def _diagonals(x, T, U):
    """(B, T, U) -> (T + U - 1, B, T): anti-diagonal d holds ``x[:, t,
    d - t]`` at index t, and 0 where ``d - t`` falls outside [0, U)."""
    dev = x.device
    t = torch.arange(T, device=dev)
    d = torch.arange(T + U - 1, device=dev)
    u = d[:, None] - t[None, :]                                  # (D, T)
    inside = (u >= 0) & (u < U)
    flat = x.reshape(x.shape[0], T * U)
    idx = (t[None, :] * U + u.clamp(0, U - 1)).reshape(-1)
    vals = flat[:, idx].reshape(x.shape[0], T + U - 1, T).transpose(0, 1)
    return torch.where(inside[:, None, :], vals, 0.0), u, inside


def transducer_loss(logits, targets, f_len, y_len, blank_idx: int = 0):
    """RNN-T negative log likelihood, (B,) fp32.  ``logits`` (B, T, U, V)
    with U = max target length + 1; ``targets`` (B, U - 1); ``f_len``
    (B,) valid time steps; ``y_len`` (B,) target lengths."""
    B, T, U, V = logits.shape
    dev = logits.device
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    blank_lp = logp[..., blank_idx]                                          # (B, T, U)
    tgt = torch.nn.functional.pad(targets.to(dev).long(), (0, 1), value=0)   # (B, U)
    label_lp = torch.gather(logp, 3, tgt[:, None, :, None].expand(B, T, U, 1))[..., 0]

    blank_d, u_of, inside = _diagonals(blank_lp, T, U)
    label_d = _diagonals(label_lp, T, U)[0]
    t = torch.arange(T, device=dev)
    neg = torch.full((B, 1), NEG_INF, dtype=torch.float32, device=dev)
    # diagonal 0: alpha(0, 0) = 0, the rest outside the grid
    alpha = torch.where(t == 0, 0.0, NEG_INF).to(torch.float32).expand(B, T)
    diags = [alpha]
    for d in range(1, T + U - 1):
        # from the top: alpha(t-1, u) + blank(t-1, u), index t-1 of diagonal d-1
        top = torch.cat([neg, alpha[:, :-1] + blank_d[d - 1, :, :-1]], dim=1)
        # from the left: alpha(t, u-1) + label(t, u-1), index t of diagonal d-1
        left = alpha + label_d[d - 1]
        u = u_of[d]
        new = torch.where(t == 0, left, torch.where(u == 0, top, torch.logaddexp(top, left)))
        alpha = torch.where(inside[d], new, NEG_INF)
        diags.append(alpha)
    alphas = torch.stack(diags)                                              # (D, B, T)

    # alpha(f_len - 1, y_len) + blank(f_len - 1, y_len)
    t_idx = (f_len.to(dev).long() - 1).clamp(0, T - 1)
    u_idx = y_len.to(dev).long().clamp(0, U - 1)
    b_idx = torch.arange(B, device=dev)
    final_alpha = alphas[t_idx + u_idx, b_idx, t_idx]
    final_blank = blank_lp[b_idx, t_idx, u_idx]
    return -(final_alpha + final_blank)


class TransducerLoss:
    """Callable form of :func:`transducer_loss` (reference
    transducer.py:68); the reference's fusion knobs are accepted."""

    def __init__(self, fuse_softmax_backward: bool = True, packed_input: bool = False):
        pass

    def __call__(self, logits, targets, f_len, y_len, blank_idx: int = 0, **kw):
        return transducer_loss(logits, targets, f_len, y_len, blank_idx)
