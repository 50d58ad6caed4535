from apex_tpu_torch.contrib.group_norm.group_norm import (
    GroupNorm,
    cuda_group_norm_nhwc_forward,
    group_norm_nhwc,
)

__all__ = ["GroupNorm", "cuda_group_norm_nhwc_forward", "group_norm_nhwc"]
