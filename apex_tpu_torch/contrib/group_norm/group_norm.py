"""NHWC GroupNorm with an optional fused SiLU (counterpart of
:mod:`apex_tpu.contrib.group_norm.group_norm`; reference
``apex/contrib/group_norm/group_norm.py:44-127``, NHWC one- and two-pass
CUDA kernels for diffusion models).  PyTorch ops, as it is an XLA
composite in the JAX package: statistics in fp32 with the centred
variance, the affine and SiLU in fp32, the output in the input's dtype.
"""

import torch

from apex_tpu_torch._device import resolve_device

__all__ = ["group_norm_nhwc", "cuda_group_norm_nhwc_forward", "GroupNorm"]


def group_norm_nhwc(x, num_groups: int, weight=None, bias=None, eps: float = 1e-5,
                    act: str = ""):
    """``x`` (N, H, W, C), groups over C; ``act`` in {"", "silu"}."""
    N, H, W, C = x.shape
    G = num_groups
    xf = x.to(torch.float32).reshape(N, H, W, G, C // G)
    mean = torch.mean(xf, dim=(1, 2, 4), keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=(1, 2, 4), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(N, H, W, C)
    if weight is not None:
        y = y * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


#: the reference extension's entry point name
cuda_group_norm_nhwc_forward = group_norm_nhwc


class GroupNorm(torch.nn.Module):
    """``apex.contrib.group_norm.GroupNorm(num_groups, num_channels, eps,
    affine, act)`` on NHWC input, fp32 ``weight`` (ones) and ``bias``
    (zeros) on ``device`` (default ``"cuda"``, which raises without a
    GPU)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 affine: bool = True, act: str = "", device="cuda"):
        super().__init__()
        self.num_groups, self.num_channels, self.eps = num_groups, num_channels, eps
        self.affine, self.act = affine, act
        dev = resolve_device(device)
        self.weight = self.bias = None
        if affine:
            self.weight = torch.nn.Parameter(
                torch.ones(num_channels, dtype=torch.float32, device=dev))
            self.bias = torch.nn.Parameter(
                torch.zeros(num_channels, dtype=torch.float32, device=dev))

    def forward(self, x):
        return group_norm_nhwc(x, self.num_groups, self.weight, self.bias, self.eps, self.act)
