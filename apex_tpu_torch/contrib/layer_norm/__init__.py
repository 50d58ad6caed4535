"""Fast LayerNorm (counterpart of :mod:`apex_tpu.contrib.layer_norm`;
reference ``apex/contrib/layer_norm/layer_norm.py:8``, tuned persistent
kernels for some hidden sizes).  The port's fused LayerNorm kernel
covers every size; re-exported under the contrib names."""

from apex_tpu_torch.normalization import FusedLayerNorm as FastLayerNorm
from apex_tpu_torch.normalization import fused_layer_norm_affine as fast_layer_norm

__all__ = ["FastLayerNorm", "fast_layer_norm"]
