from apex_tpu_torch.contrib.multihead_attn.mask_softmax_dropout_func import (
    fast_mask_softmax_dropout_func,
)
from apex_tpu_torch.contrib.multihead_attn.self_multihead_attn import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
)

__all__ = [
    "SelfMultiheadAttn",
    "EncdecMultiheadAttn",
    "fast_mask_softmax_dropout_func",
]
