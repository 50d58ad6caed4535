from apex_tpu_torch.transformer.functional.fused_softmax import (
    MASK_FILL_VALUE, scaled_upper_triang_masked_softmax,
)

__all__ = ["MASK_FILL_VALUE", "scaled_upper_triang_masked_softmax"]
