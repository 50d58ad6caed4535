from apex_tpu_torch.contrib.clip_grad.clip_grad import clip_grad_norm_

__all__ = ["clip_grad_norm_"]
