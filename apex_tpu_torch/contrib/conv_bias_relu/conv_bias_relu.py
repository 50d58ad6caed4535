"""Conv + bias (+ mask) + ReLU (counterpart of
:mod:`apex_tpu.contrib.conv_bias_relu.conv_bias_relu`; reference
``apex/contrib/conv_bias_relu/conv_bias_relu.py:12-78``, cuDNN-frontend
fused graphs).

The JAX functions' layouts and padding: ``x`` NHWC, ``weight`` HWIO
(KH, KW, Cin, Cout), ``padding`` ``"SAME"`` or ``"VALID"`` (or explicit
``((lo, hi), (lo, hi))`` pairs, as ``lax.conv_general_dilated`` takes).
Inside, the input is an NCHW view of the NHWC tensor
(``torch.channels_last`` memory) and the kernel an OIHW view; the
convolution is cuDNN's, as the JAX package's is XLA's.  ``"SAME"``
pads as JAX does, ``total // 2`` before and the rest after, by an
explicit ``F.pad`` (PyTorch's ``padding="same"`` refuses a stride above
1 and pads the other way round).  The frozen form detaches scale and
bias, as the reference's backward returns no gradient for them.
"""

import torch
import torch.nn.functional as F

from apex_tpu_torch.models.resnet import same_pads

__all__ = ["ConvBias", "ConvBiasReLU", "ConvBiasMaskReLU", "ConvFrozenScaleBiasReLU",
           "conv_nhwc"]


def conv_nhwc(x, w, stride: int = 1, padding="SAME"):
    """``lax.conv_general_dilated(x, w, (stride, stride), padding,
    ("NHWC", "HWIO", "NHWC"))``: NHWC in, NHWC out."""
    kh, kw = w.shape[0], w.shape[1]
    xc = x.permute(0, 3, 1, 2)  # NCHW shape over the NHWC memory
    if isinstance(padding, str):
        if padding == "SAME":
            (ph, pw) = same_pads(xc.shape[2], kh, stride), same_pads(xc.shape[3], kw, stride)
        elif padding == "VALID":
            ph = pw = (0, 0)
        else:
            raise ValueError(f"padding must be 'SAME', 'VALID' or pairs, got {padding!r}")
    else:
        ph, pw = (tuple(p) for p in padding)
    if any(ph + pw):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def ConvBias(x, weight, bias, stride: int = 1, padding="SAME"):
    return conv_nhwc(x, weight, stride, padding) + bias


def ConvBiasReLU(x, weight, bias, stride: int = 1, padding="SAME"):
    return torch.relu(ConvBias(x, weight, bias, stride, padding))


def ConvBiasMaskReLU(x, weight, bias, mask, stride: int = 1, padding="SAME"):
    return torch.relu(ConvBias(x, weight, bias, stride, padding) * mask)


def ConvFrozenScaleBiasReLU(x, weight, scale, bias, stride: int = 1, padding="SAME"):
    """``relu(conv(x, w) * scale + bias)`` with scale and bias frozen
    (no gradient; reference conv_bias_relu.py:96): the folded batch norm
    of inference."""
    return torch.relu(conv_nhwc(x, weight, stride, padding) * scale.detach() + bias.detach())
