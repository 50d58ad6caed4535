"""ResNet-50: the canonical amp-O2 workload (counterpart of
:mod:`apex_tpu.models.resnet`).

Reference: ``examples/imagenet/main_amp.py`` trains torchvision
ResNet-50 under ``amp.initialize(O2)`` with apex DDP and SyncBN.  The
JAX package's flax modules are mirrored module for module:
:class:`Bottleneck`, :class:`ResNet`, :func:`ResNet50` and
:func:`ResNet18ish`, with ``sync_bn_group`` (a process group, see
:class:`~apex_tpu_torch.parallel.SyncBatchNorm`) where they take
``sync_bn_axis``.

- The input is NHWC, as there.  Inside, activations are NCHW shapes in
  ``torch.channels_last`` memory (an NHWC tensor permuted), the layout
  cuDNN runs fastest for bf16.
- The convolutions run in ``dtype`` (bf16) whatever the params' dtype
  (cuDNN, as XLA convolutions in the reference); every batch norm runs
  in fp32 and returns its input's dtype; the residual is cast to the
  block's dtype before the add; the spatial mean rounds to the
  activations' dtype (``jnp.mean`` of bf16) and the ``Dense`` head runs
  in fp32, so the logits are fp32.
- Flax's ``"SAME"`` padding is asymmetric: ``total = max((out - 1) *
  stride + k - in, 0)``, ``total // 2`` before and the rest after (the
  7x7 stride-2 stem at 224 pads (2, 3), a 3x3 stride-2 conv at 56 pads
  (0, 1)).  PyTorch's ``padding=`` is symmetric, so every convolution and
  the max-pool pad explicitly (:func:`same_pads`; -inf for the pool) and
  run unpadded.

The params and the running statistics are flat dicts keyed by module
path (``blocks.3.conv2.weight``, ``blocks.3.bn2.running_mean``); every
batch-norm leaf's path holds ``bn`` and no other leaf's does, so amp
O2's path rule (:mod:`apex_tpu_torch.amp.policy`) keeps exactly the
batch-norm params fp32, as it does the JAX package's
``SyncBatchNorm_0`` leaves.  :meth:`ResNet.apply` is the functional call
``(params, batch_stats, x, train) -> (logits, new_batch_stats)`` the
train step and the tree optimizers take (``torch.func.functional_call``);
:func:`variables_from_flax` loads the JAX package's variables.
"""

import math
import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

__all__ = ["Bottleneck", "ResNet", "ResNet50", "ResNet18ish", "same_pads",
           "variables_from_flax"]


def same_pads(size: int, k: int, stride: int):
    """Flax's ``"SAME"`` padding of one spatial dim: ``(before, after)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, stride: int, value: float = 0.0):
    """``x`` (N, C, H, W) padded as flax pads it for a k x k window at
    ``stride`` (no copy when nothing pads)."""
    ph = same_pads(x.shape[2], k, stride)
    pw = same_pads(x.shape[3], k, stride)
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def _lecun_normal_(w, fan_in: int, generator):
    """Flax's default kernel init: a normal of variance 1 / fan_in
    truncated at two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(std)
    return w


class Conv(torch.nn.Module):
    """``nn.Conv(features, (k, k), strides, use_bias=False, dtype)`` with
    fp32 params: OIHW ``weight``, the input and weight cast to ``dtype``
    at use, ``"SAME"`` padding."""

    def __init__(self, in_features: int, features: int, k: int, stride: int = 1,
                 dtype=torch.bfloat16, device="cuda", generator=None):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        w = torch.empty(features, in_features, k, k, dtype=torch.float32)
        self.weight = torch.nn.Parameter(_lecun_normal_(w, in_features * k * k, generator)
                                         .to(resolve_device(device)))

    def forward(self, x):
        x = _pad_same(x.to(self.dtype), self.k, self.stride)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride)


class Bottleneck(torch.nn.Module):
    """The flax ``Bottleneck``: 1x1, 3x3 (at ``strides``), 1x1 x4, each
    followed by a batch norm (ReLU after the first two), and with
    ``projection`` a strided 1x1 conv and batch norm on the residual."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 projection: bool = False, sync_bn_group=None, dtype=torch.bfloat16,
                 device="cuda", generator=None):
        super().__init__()
        conv = dict(dtype=dtype, device=device, generator=generator)
        bn = dict(momentum=0.1, channel_last=False, group=sync_bn_group, device=device)
        self.conv1 = Conv(in_features, features, 1, **conv)
        self.bn1 = SyncBatchNorm(features, **bn)
        self.conv2 = Conv(features, features, 3, strides, **conv)
        self.bn2 = SyncBatchNorm(features, **bn)
        self.conv3 = Conv(features, features * 4, 1, **conv)
        self.bn3 = SyncBatchNorm(features * 4, **bn)
        self.projection = projection
        if projection:
            self.proj_conv = Conv(in_features, features * 4, 1, strides, **conv)
            self.proj_bn = SyncBatchNorm(features * 4, **bn)

    def forward(self, x, train: bool = True):
        run = not train
        y = F.relu(self.bn1(self.conv1(x), use_running_average=run))
        y = F.relu(self.bn2(self.conv2(y), use_running_average=run))
        y = self.bn3(self.conv3(y), use_running_average=run)
        residual = x
        if self.projection:
            residual = self.proj_bn(self.proj_conv(x), use_running_average=run)
        return F.relu(y + residual.to(y.dtype))


class ResNet(torch.nn.Module):
    """The flax ``ResNet``: the 7x7 stride-2 stem, batch norm, ReLU, the
    3x3 stride-2 max-pool, ``stage_sizes`` stages of bottlenecks (the
    first of each a projection, strided after the first stage), the
    spatial mean and the fp32 ``Dense`` head.  ``sync_bn_group``: the
    batch norms' group (``SyncBatchNorm(group=)``; None for local
    statistics).  Params are initialized as flax initializes them
    (truncated LeCun-normal kernels, zero bias, BN ones and zeros) from
    ``generator``, a CPU ``torch.Generator`` (one seeded 0 by
    default)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000, width: int = 64,
                 dtype=torch.bfloat16, sync_bn_group=None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.stem_conv = Conv(3, width, 7, 2, dtype=dtype, device=dev, generator=generator)
        self.stem_bn = SyncBatchNorm(width, momentum=0.1, group=sync_bn_group, device=dev)
        blocks, cin = [], width
        for i, count in enumerate(stage_sizes):
            for b in range(count):
                feats = width * 2 ** i
                blocks.append(Bottleneck(cin, feats, 2 if i > 0 and b == 0 else 1, b == 0,
                                         sync_bn_group, dtype, dev, generator))
                cin = feats * 4
        self.blocks = torch.nn.ModuleList(blocks)
        w = _lecun_normal_(torch.empty(num_classes, cin), cin, generator)
        self.fc_weight = torch.nn.Parameter(w.to(dev))
        self.fc_bias = torch.nn.Parameter(torch.zeros(num_classes, device=dev))

    def forward(self, x, train: bool = True):
        """x (N, H, W, 3) -> fp32 logits (N, num_classes)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW shape, channels_last memory
        x = F.relu(self.stem_bn(self.stem_conv(x), use_running_average=not train))
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        for block in self.blocks:
            x = block(x, train)
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype)
        return F.linear(x.float(), self.fc_weight.float(), self.fc_bias.float())

    def variables(self):
        """``{"params", "batch_stats"}``: the module's own tensors as flat
        dicts (sharing their storage)."""
        return {"params": {k: v.detach() for k, v in self.named_parameters()},
                "batch_stats": {k: v for k, v in self.named_buffers()}}

    def apply(self, params: Dict[str, torch.Tensor], batch_stats: Dict[str, torch.Tensor], x,
              train: bool = True, inplace: bool = False):
        """``(logits, new_batch_stats)`` of ``x`` under ``params`` and
        ``batch_stats`` (flax's ``apply(..., mutable=["batch_stats"])``).
        In training the new running statistics are fresh tensors, or with
        ``inplace`` written into ``batch_stats`` itself (the donated form
        a captured step needs); in eval they are ``batch_stats``."""
        from torch.func import functional_call

        stats = batch_stats if inplace or not train else {
            k: v.clone() for k, v in batch_stats.items()}
        logits = functional_call(self, {**params, **stats}, (x,), {"train": train},
                                 strict=True)
        return logits, stats


def ResNet50(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], **kw)


def ResNet18ish(**kw) -> ResNet:
    """Small variant for tests."""
    return ResNet(stage_sizes=[1, 1], width=16, **kw)


_FLAX_CONV = {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3", "Conv_3": "proj_conv"}
_FLAX_BN = {"_N_0": "bn1", "_N_1": "bn2", "_N_2": "bn3", "_N_3": "proj_bn"}
_FLAX_LEAF = {"kernel": "weight", "weight": "weight", "bias": "bias",
              "running_mean": "running_mean", "running_var": "running_var"}


def flax_name(path: Sequence[str]) -> str:
    """The port's name of the flax leaf at ``path`` (its keys below
    ``params`` or ``batch_stats``)."""
    keys = [k for k in path if k != "SyncBatchNorm_0"]
    *mods, leaf = keys
    if mods == ["Dense_0"]:
        return f"fc_{_FLAX_LEAF[leaf]}"
    if mods == ["Conv_0"]:
        return "stem_conv.weight"
    if mods == ["_N_0"]:
        return f"stem_bn.{_FLAX_LEAF[leaf]}"
    m = re.fullmatch(r"Bottleneck_(\d+)", mods[0])
    if m is None or len(mods) != 2:
        raise KeyError(f"no port name for the flax leaf {'/'.join(path)}")
    sub = _FLAX_CONV.get(mods[1]) or _FLAX_BN[mods[1]]
    return f"blocks.{m.group(1)}.{sub}.{_FLAX_LEAF[leaf]}"


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _from_flax_leaf(name: str, a) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if a.ndim == 4:  # HWIO -> OIHW
        a = a.transpose(3, 2, 0, 1)
    elif name == "fc_weight":  # (in, out) -> (out, in)
        a = a.T
    return torch.tensor(np.ascontiguousarray(a))


def variables_from_flax(variables, device="cuda"):
    """The JAX package's flax variables (``{"params", "batch_stats"}`` as
    numpy) as the port's ``{"params", "batch_stats"}`` flat dicts on
    ``device``, fp32: conv kernels HWIO -> OIHW, the ``Dense`` kernel (in,
    out) -> (out, in), the flax module names onto the port's."""
    dev = resolve_device(device)
    return {col: {flax_name(path): _from_flax_leaf(flax_name(path), a).to(dev)
                  for path, a in _flat(variables[col])}
            for col in ("params", "batch_stats")}
