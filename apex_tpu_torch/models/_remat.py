"""Layer remat policy (counterpart of :mod:`apex_tpu.models._remat`).

``"full"`` saves only the layer inputs across the remat boundary and
re-runs the whole layer forward inside the backward:
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` per
layer.  ``"dots"`` is the JAX package's
``dots_with_no_batch_dims_saveable``: the same checkpoint with a
selective policy (``create_selective_checkpoint_contexts``) that keeps
the outputs of the matmuls without batch dims (``aten.mm`` and
``aten.addmm``: the q, k, v, out, fc1 and fc2 products) and recomputes
everything else, the batched ``aten.bmm`` of the einsum attention
included.  The hand-written kernels launch through ``ctypes``, which no
dispatch mode sees, so they rerun in the recompute as a ``pallas_call``
does under the JAX policy.  The layers draw no random numbers (no
dropout), so the RNG state is not stashed.
"""

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

POLICIES = ("full", "dots")

#: the matmuls without batch dims: what ``"dots"`` saves
SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def validate_policy(policy: str) -> None:
    """Raise at config construction on a typo'd policy."""
    if policy not in POLICIES:
        raise ValueError(f"remat_policy must be one of {POLICIES} (got {policy!r})")


def dots_policy(ctx, op, *args, **kwargs):
    """The selective policy of ``"dots"``: save the no-batch-dims
    matmuls, recompute the rest."""
    del ctx, args, kwargs
    return CheckpointPolicy.MUST_SAVE if op in SAVED_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(dots_policy)


def remat_layer(layer, policy: str):
    """``layer`` wrapped so that its activations are recomputed in the
    backward under ``policy``."""
    validate_policy(policy)
    kw = {"context_fn": _dots_context} if policy == "dots" else {}

    def wrapped(*args):
        return checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return wrapped
