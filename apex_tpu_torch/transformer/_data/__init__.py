from apex_tpu_torch.transformer._data._batchsampler import (
    MegatronPretrainingRandomSampler,
    MegatronPretrainingSampler,
)

__all__ = ["MegatronPretrainingSampler", "MegatronPretrainingRandomSampler"]
