"""Mixed precision (counterpart of :mod:`apex_tpu.amp`; reference
``apex/amp``).

The O0–O3 opt levels are dtype policies (:mod:`~apex_tpu_torch.amp.policy`)
and dynamic loss scaling runs on the device
(:mod:`~apex_tpu_torch.amp.scaler`): the design of the reference's
capturable optimizers and ``csrc/update_scale_hysteresis.cu``, so a
train step with the scaler in it captures as one CUDA graph.  The
exports are ``apex/amp/__init__.py``'s, as the JAX package gives them:
the decorator and registry API (``amp.py``), ``scale_loss`` and
``disable_casts`` (``handle.py``), ``initialize``, ``state_dict``,
``load_state_dict`` and ``master_params`` (``frontend.py``).
"""

from apex_tpu_torch.amp.amp import (
    float_function,
    half_function,
    init,
    promote_function,
    register_float_function,
    register_half_function,
    register_promote_function,
    set_half_dtype,
)
from apex_tpu_torch.amp.frontend import (
    Amp,
    initialize,
    load_state_dict,
    master_params,
    state_dict,
    value_and_grad,
)
from apex_tpu_torch.amp.handle import disable_casts, scale_loss
from apex_tpu_torch.amp.policy import Policy, get_policy
from apex_tpu_torch.amp.scaler import (
    DynamicLossScaler,
    ScalerState,
    StaticLossScaler,
    all_finite,
)

__all__ = [
    "Amp",
    "initialize",
    "value_and_grad",
    "state_dict",
    "load_state_dict",
    "master_params",
    "scale_loss",
    "disable_casts",
    "init",
    "half_function",
    "float_function",
    "promote_function",
    "register_half_function",
    "register_float_function",
    "register_promote_function",
    "set_half_dtype",
    "Policy",
    "get_policy",
    "DynamicLossScaler",
    "StaticLossScaler",
    "ScalerState",
    "all_finite",
]
