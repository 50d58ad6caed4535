from apex_tpu_torch.contrib.xentropy.softmax_xentropy import (
    SoftmaxCrossEntropyLoss,
    softmax_xentropy,
)

__all__ = ["SoftmaxCrossEntropyLoss", "softmax_xentropy"]
