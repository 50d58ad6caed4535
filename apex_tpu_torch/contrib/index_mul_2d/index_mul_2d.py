"""Indexed multiply, an OpenFold hot op (counterpart of
:mod:`apex_tpu.contrib.index_mul_2d`; reference
``apex/contrib/index_mul_2d``: ``out = in1[idx] * in2`` with fused
forward and backward kernels).  A gather and a multiply; autograd gives
the backward, whose gradient of ``in1`` is an index-add over ``idx``
(with repeated indices its order of additions is not fixed on CUDA).
"""

import torch

__all__ = ["index_mul_2d"]


def index_mul_2d(in1, in2, idx):
    """``in1`` (N, D), ``idx`` (K,), ``in2`` (K, D) -> (K, D) =
    ``in1[idx] * in2``."""
    return torch.index_select(in1, 0, idx.to(device=in1.device, dtype=torch.long)) * in2
