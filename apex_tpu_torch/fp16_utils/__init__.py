"""Manual mixed precision (counterpart of :mod:`apex_tpu.fp16_utils`;
reference ``apex/fp16_utils``): the API from before amp, with explicit
half conversion, master-weight bookkeeping and the wrapping
``FP16_Optimizer``, over the port's optimizers and amp scalers."""

from apex_tpu_torch.fp16_utils.fp16util import (
    BN_convert_float,
    FP16Model,
    convert_network,
    master_params_to_model_params,
    model_grads_to_master_grads,
    network_to_half,
    prep_param_lists,
    tofp16,
)
from apex_tpu_torch.fp16_utils.fp16_optimizer import FP16_Optimizer
from apex_tpu_torch.fp16_utils.loss_scaler import DynamicLossScaler, LossScaler

__all__ = [
    "BN_convert_float",
    "FP16Model",
    "network_to_half",
    "convert_network",
    "tofp16",
    "prep_param_lists",
    "model_grads_to_master_grads",
    "master_params_to_model_params",
    "FP16_Optimizer",
    "LossScaler",
    "DynamicLossScaler",
]
