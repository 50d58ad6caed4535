from apex_tpu_torch.contrib.focal_loss.focal_loss import focal_loss

__all__ = ["focal_loss"]
