"""Layer remat policy (counterpart of :mod:`apex_tpu.models._remat`).

``"full"`` saves only the layer inputs across the remat boundary and
re-runs the whole layer forward inside the backward:
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` per
layer.  The layers draw no random numbers (no dropout), so the RNG
state is not stashed.  ``"dots"`` (save the matmul outputs, recompute
the elementwise work) is not ported yet and raises.
"""

from torch.utils.checkpoint import checkpoint

POLICIES = ("full", "dots")


def validate_policy(policy: str) -> None:
    """Raise at config construction on a typo'd policy, and on the
    policy this port does not run yet."""
    if policy not in POLICIES:
        raise ValueError(f"remat_policy must be one of {POLICIES} (got {policy!r})")
    if policy == "dots":
        raise NotImplementedError(
            "remat_policy='dots' (save matmul outputs, recompute the rest) is "
            "not ported yet; use 'full'")


def remat_layer(layer, policy: str):
    """``layer`` wrapped so that its activations are recomputed in the
    backward under ``policy``."""
    validate_policy(policy)

    def wrapped(*args):
        return checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False)

    return wrapped
