from apex_tpu_torch.contrib.fmha.fmha import fmha, fmha_varlen

__all__ = ["fmha", "fmha_varlen"]
