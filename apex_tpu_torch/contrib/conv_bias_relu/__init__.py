from apex_tpu_torch.contrib.conv_bias_relu.conv_bias_relu import (
    ConvBias,
    ConvBiasMaskReLU,
    ConvBiasReLU,
    ConvFrozenScaleBiasReLU,
)

__all__ = ["ConvBiasReLU", "ConvBias", "ConvBiasMaskReLU", "ConvFrozenScaleBiasReLU"]
