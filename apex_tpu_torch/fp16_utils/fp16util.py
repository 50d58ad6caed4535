"""Conversion and master-param helpers (counterpart of
:mod:`apex_tpu.fp16_utils.fp16util`; reference
``apex/fp16_utils/fp16util.py``), over trees of tensors."""

from typing import Any, Tuple

import torch

from apex_tpu_torch.optimizers.tree import leaves_with_path, tree_leaves, tree_map, tree_unflatten


def _is_norm(path: str) -> bool:
    p = path.lower()
    return any(k in p for k in ("batchnorm", "bn", "layernorm", "layer_norm", "norm"))


def _float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def tofp16(tree, half_dtype=torch.bfloat16):
    """Every floating leaf in half (reference fp16util.py:25 ``tofp16``)."""
    return tree_map(lambda x: x.to(half_dtype) if _float(x) else x, tree)


def network_to_half(params, half_dtype=torch.bfloat16):
    """Params in half, norm layers kept fp32 (fp16util.py:35: the
    BatchNorm exemption of ``convert_network``)."""
    return convert_network(params, half_dtype)


def _map_norm_leaves(params, norm_fn, other_fn):
    """``norm_fn`` on the floating leaves whose path names a norm layer,
    ``other_fn`` on the other floating leaves; the rest as given."""
    def one(path, x):
        if not _float(x):
            return x
        return norm_fn(x) if _is_norm(path) else other_fn(x)

    return tree_unflatten(params, [one(p, x) for p, x in leaves_with_path(params)])


def convert_network(params, dtype=torch.bfloat16):
    """Reference fp16util.py:60: every param but the norm layers' in ``dtype``."""
    return _map_norm_leaves(params, lambda x: x.to(torch.float32), lambda x: x.to(dtype))


def prep_param_lists(params, flat_master: bool = False) -> Tuple[Any, Any]:
    """``(params, fp32 master copy)`` (fp16util.py:92); with
    ``flat_master`` the master is one flat vector (the reference's
    single-tensor option).  The master never shares storage with a
    param."""
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    if flat_master:
        return params, torch.cat([m.reshape(-1) for m in tree_leaves(master)])
    return params, master


def model_grads_to_master_grads(model_grads, master_grads=None):
    """The model's (half) grads as fp32 (fp16util.py:138)."""
    return tree_map(lambda g: g.to(torch.float32), model_grads)


def master_params_to_model_params(model_params, master_params):
    """The master's values in each model param's dtype (fp16util.py:160),
    the sync after an O2 step."""
    return tree_map(lambda p, m: m.to(p.dtype), model_params, master_params)


def BN_convert_float(params):
    """Norm-layer params back to fp32 in a tree already in half
    (reference fp16util.py:22, the helper behind network_to_half)."""
    return _map_norm_leaves(params, lambda x: x.to(torch.float32), lambda x: x)


class FP16Model:
    """Reference fp16util.py:73: an apply function and its params run in
    half (norm params fp32), floating inputs cast to half;
    ``FP16Model(apply_fn, params)(x)``."""

    def __init__(self, apply_fn, params, half_dtype=torch.bfloat16):
        import warnings

        warnings.warn("fp16_utils is a legacy API (deprecated in the reference); "
                      "prefer apex_tpu_torch.amp policies.", DeprecationWarning, stacklevel=2)
        self.apply_fn = apply_fn
        self.half_dtype = half_dtype
        self.params = convert_network(params, half_dtype)

    def __call__(self, *inputs):
        cast = tuple(x.to(self.half_dtype) if _float(x) else x for x in inputs)
        return self.apply_fn(self.params, *cast)
