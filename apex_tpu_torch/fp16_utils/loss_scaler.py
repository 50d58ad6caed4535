"""Loss scalers under the fp16_utils names (counterpart of
:mod:`apex_tpu.fp16_utils.loss_scaler`; reference
``apex/fp16_utils/loss_scaler.py``: ``LossScaler`` (:10, static) and
``DynamicLossScaler`` (:49, halve on overflow, double after 1000 clean
steps)): the amp scalers with the reference's old defaults."""

from apex_tpu_torch.amp.scaler import DynamicLossScaler as _Dynamic
from apex_tpu_torch.amp.scaler import StaticLossScaler as _Static


class LossScaler(_Static):
    def __init__(self, scale=1.0):
        super().__init__(scale)


class DynamicLossScaler(_Dynamic):
    def __init__(self, init_scale=2.0 ** 32, scale_factor=2.0, scale_window=1000):
        super().__init__(init_scale=init_scale, growth_factor=scale_factor,
                         backoff_factor=1.0 / scale_factor, growth_interval=scale_window)
