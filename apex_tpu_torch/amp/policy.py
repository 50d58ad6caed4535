"""Mixed-precision dtype policies, the O0–O3 opt levels (counterpart of
:mod:`apex_tpu.amp.policy`).

Reference: ``apex/amp/frontend.py:9-193``.  apex selects a
``Properties`` object by opt level and then patches torch (function
tables for O1, ``model.half()`` for O2/O3).  The JAX package applies the
same policy functionally, and so does the port: params are cast to the
storage dtype by :meth:`Policy.cast_params`, inputs to the compute dtype
at a function boundary, with an fp32 master copy in the optimizer.  The
levels, their semantics and their defaults are the JAX package's:

======  ==============================================================
level   semantics
======  ==============================================================
O0      compute = params = fp32, no loss scale
O1      compute in half, params fp32, cast at op boundaries; dynamic
        loss scale with fp16
O2      params cast to half, fp32 master weights, norm layers fp32;
        dynamic loss scale with fp16
O3      compute = params = half, no master weights
======  ==============================================================

``half_dtype=None`` is bfloat16, as in the JAX package, so that both
compute the same thing by default (bf16 needs no loss scale);
``half_dtype=torch.float16`` gives apex's fp16 semantics, dynamic
scaling on.
"""

import dataclasses
from typing import Any, Callable, Optional

import torch

from apex_tpu_torch.optimizers.tree import leaves_with_path, tree_unflatten

__all__ = ["Policy", "get_policy"]


def _is_norm_param(path: str) -> bool:
    """Whether a param is a normalization layer's, by its tree path (the
    ``jax.tree_util.keystr`` form): the JAX package's rule for apex's
    keep-``_BatchNorm``-in-fp32 (``apex/fp16_utils/fp16util.py:60-89``)."""
    p = path.lower()
    return any(k in p for k in ("batchnorm", "bn", "layernorm", "layer_norm", "groupnorm",
                                "norm", "scale_bias"))


@dataclasses.dataclass(frozen=True)
class Policy:
    """A functional mixed-precision policy: ``apex.amp.Properties``
    (``apex/amp/frontend.py:9-99``) with ``cast_model_type`` ->
    ``param_dtype``, ``patch_torch_functions`` -> ``compute_dtype``,
    ``keep_batchnorm_fp32`` -> ``keep_norm_fp32``."""

    opt_level: str
    param_dtype: Optional[Any]    # dtype params are stored / cast to (None: leave)
    compute_dtype: Optional[Any]  # dtype of op inputs (None: leave)
    keep_norm_fp32: bool
    master_weights: bool
    loss_scale: Any               # "dynamic" | float | None
    is_norm_param: Callable[[str], bool] = _is_norm_param

    def _cast_tree(self, tree, dtype, respect_norm: bool):
        if dtype is None:
            return tree

        def cast(path, x):
            if not isinstance(x, torch.Tensor) or not x.is_floating_point():
                return x
            if respect_norm and self.keep_norm_fp32 and self.is_norm_param(path):
                return x.to(torch.float32)
            return x.to(dtype)

        return tree_unflatten(tree, [cast(p, x) for p, x in leaves_with_path(tree)])

    def cast_params(self, params):
        """A param tree in the storage dtype (O2/O3 ``model.half()``)."""
        return self._cast_tree(params, self.param_dtype, respect_norm=True)

    def cast_to_compute(self, tree):
        """Activations / inputs in the compute dtype (O1's casts)."""
        return self._cast_tree(tree, self.compute_dtype, respect_norm=False)

    def cast_to_fp32(self, tree):
        return self._cast_tree(tree, torch.float32, respect_norm=False)

    @property
    def uses_loss_scaling(self) -> bool:
        return self.loss_scale is not None


def get_policy(opt_level: str = "O1", half_dtype=None, loss_scale=None) -> Policy:
    """The policy of an opt level (reference: apex/amp/frontend.py:104-193).

    ``half_dtype`` defaults to bfloat16, whose default loss scale is
    None; with float16 it is ``"dynamic"``, as in apex.  An explicit
    ``loss_scale`` always wins."""
    h = torch.bfloat16 if half_dtype is None else half_dtype
    scale = loss_scale if loss_scale is not None else (
        "dynamic" if h == torch.float16 else None)
    if opt_level == "O0":
        return Policy("O0", torch.float32, torch.float32, False, False, None)
    if opt_level == "O1":
        return Policy("O1", None, h, True, False, scale)
    if opt_level == "O2":
        return Policy("O2", h, None, True, True, scale)
    if opt_level == "O3":
        return Policy("O3", h, h, False, False, loss_scale)
    raise ValueError(f"Unexpected optimization level {opt_level!r} (expected O0/O1/O2/O3)")
