"""Autocast helpers (counterpart of :mod:`apex_tpu._autocast_utils`).

Reference: ``apex/_autocast_utils.py:22`` (``_cast_if_autocast_enabled``:
custom autograd Functions follow ``torch.cuda.amp.autocast`` by casting
their inputs to the autocast dtype).  As in the JAX package, the cast is
explicit, at a function boundary, and not an ambient state: the port
wraps functions and patches nothing.
"""

from typing import Callable

import torch

from apex_tpu_torch.optimizers.tree import tree_map

_SUPPORTED = (torch.float16, torch.bfloat16, torch.float32)

#: the global cast switch that ``apex_tpu_torch.amp.handle.disable_casts``
#: turns off (reference: apex/amp/handle.py ``disable_casts``); read at
#: every call of a wrapped function
_casts_disabled = False


def _is_float(a) -> bool:
    return isinstance(a, torch.Tensor) and a.is_floating_point()


def _cast_if_autocast_enabled(*args, dtype=torch.bfloat16):
    """The floating tensor arguments cast to ``dtype``, the rest as given."""
    if dtype not in _SUPPORTED:
        raise RuntimeError(f"Unsupported autocast dtype: {dtype}")
    return tuple(a.to(dtype) if _is_float(a) else a for a in args)


def autocast(fn: Callable, dtype=torch.bfloat16, output_dtype=None) -> Callable:
    """``fn`` with its floating tensor inputs cast to ``dtype`` and, with
    ``output_dtype``, its floating outputs to that (the O1 cast at op
    boundaries, reference apex/amp/wrap.py ``cached_cast``)."""

    def wrapped(*args, **kwargs):
        if _casts_disabled:
            return fn(*args, **kwargs)
        out = fn(*_cast_if_autocast_enabled(*args, dtype=dtype), **kwargs)
        if output_dtype is not None:
            out = tree_map(lambda x: x.to(output_dtype) if _is_float(x) else x, out)
        return out

    return wrapped
