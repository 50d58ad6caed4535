"""The amp decorator and registry API (counterpart of
:mod:`apex_tpu.amp.amp`).

Reference: ``apex/amp/amp.py:30-183``: the ``half_function`` /
``float_function`` / ``promote_function`` decorators and
``register_half_function(module, name)`` and its siblings, which patch
functions into the O1 cast tables.  As in the JAX package, the
decorators return wrapped functions; ``register_*`` replaces the
attribute of a module the user owns.  The casts are the reference's:
inputs to half, to fp32, or promoted to the widest floating type.
"""

from typing import Callable

import torch

from apex_tpu_torch._autocast_utils import _is_float, autocast

_HALF = torch.bfloat16


def set_half_dtype(dtype) -> None:
    """The 'half' dtype of the decorators (bfloat16 by default)."""
    global _HALF
    _HALF = dtype


def half_function(fn: Callable) -> Callable:
    """``fn`` with its floating inputs in half precision (reference
    amp.py:30).  The half dtype is read at each call, so
    ``set_half_dtype`` / ``init(half_dtype=...)`` reach functions
    decorated before (as the reference's global amp state does)."""

    def wrapped(*args, **kwargs):
        return autocast(fn, dtype=_HALF)(*args, **kwargs)

    return wrapped


def float_function(fn: Callable) -> Callable:
    """``fn`` with its floating inputs in fp32 (reference amp.py:34)."""
    return autocast(fn, dtype=torch.float32)


def promote_function(fn: Callable) -> Callable:
    """``fn`` with mixed floating inputs promoted to the widest of them
    (reference amp.py:38, wrap.py ``promote``)."""

    def wrapped(*args, **kwargs):
        floats = [a.dtype for a in (*args, *kwargs.values()) if _is_float(a)]
        if not floats:
            return fn(*args, **kwargs)
        widest = floats[0]
        for d in floats[1:]:
            widest = torch.promote_types(widest, d)
        args = tuple(a.to(widest) if _is_float(a) else a for a in args)
        kwargs = {k: v.to(widest) if _is_float(v) else v for k, v in kwargs.items()}
        return fn(*args, **kwargs)

    return wrapped


def register_half_function(module, name: str) -> None:
    """Wrap ``module.name`` in a half cast (reference amp.py:50), for a
    module the user owns."""
    setattr(module, name, half_function(getattr(module, name)))


def register_float_function(module, name: str) -> None:
    setattr(module, name, float_function(getattr(module, name)))


def register_promote_function(module, name: str) -> None:
    setattr(module, name, promote_function(getattr(module, name)))


def init(enabled: bool = True, loss_scale: str = "dynamic", half_dtype=None, **kwargs):
    """The legacy ``amp.init`` (reference apex/amp/amp.py:74).  There is
    no function table to patch: this sets the decorators' half dtype and
    returns an O1 :class:`~apex_tpu_torch.amp.frontend.Amp` whose
    ``scale_loss`` and ``state_dict`` stand for the old handle's;
    ``enabled=False`` returns an O0 Amp (the reference's NoOpHandle).
    ``init_scale``, ``growth_interval`` and ``hysteresis`` reach the
    scaler; the reference's other keywords (``verbose``,
    ``enable_caching``, ``allow_banned``, ...) are accepted and unused."""
    from apex_tpu_torch.amp import frontend

    if half_dtype is not None:
        set_half_dtype(half_dtype)
    known = {"init_scale", "growth_interval", "hysteresis"}
    _, amp = frontend.initialize(
        {}, opt_level="O1" if enabled else "O0", half_dtype=half_dtype,
        loss_scale=loss_scale if enabled else None,
        **{k: v for k, v in kwargs.items() if k in known})
    return amp
