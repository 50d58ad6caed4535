"""``scale_loss`` and ``disable_casts`` (counterpart of
:mod:`apex_tpu.amp.handle`).

Reference: ``apex/amp/handle.py:16``: ``with amp.scale_loss(loss,
optimizer) as scaled_loss: scaled_loss.backward()``.  The functional
form is :func:`apex_tpu_torch.amp.value_and_grad`, which scales the loss
before the gradient and unscales the grads after; ``scale_loss`` here
returns the scaled loss for code that takes its gradients itself.
"""

import contextlib

from apex_tpu_torch import _autocast_utils
from apex_tpu_torch.amp.frontend import Amp

__all__ = ["disable_casts", "scale_loss"]


@contextlib.contextmanager
def disable_casts():
    """Suspend the decorators' casts inside the block (reference
    apex/amp/handle.py ``disable_casts``: regions that must run in true
    fp32 under O1).  The flag is read at each call of a wrapped function."""
    prev = _autocast_utils._casts_disabled
    _autocast_utils._casts_disabled = True
    try:
        yield
    finally:
        _autocast_utils._casts_disabled = prev


def scale_loss(loss, amp: Amp, scaler_state):
    """The scaled loss (reference handle.py:113, ``loss.float() *
    loss_scale``); pair it with ``amp.unscale_grads(scaler_state,
    grads)`` after the gradient."""
    return amp.scale_loss(scaler_state, loss)
