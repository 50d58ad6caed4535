"""OpenFold's kernels (counterpart of :mod:`apex_tpu.contrib.openfold_triton`;
reference ``apex/contrib/openfold_triton``: a Triton LayerNorm with
autotune, the MHA core and fused Adam + SWA).

``LayerNormSmallShapeOptImpl`` is the port's
:class:`~apex_tpu_torch.normalization.FusedLayerNorm` (the LayerNorm
kernels); the MHA core is :func:`attention_core` (the scan path, see
:mod:`~apex_tpu_torch.contrib.openfold_triton.mha`); Adam + SWA is
:class:`FusedAdamSWA` on the port's ``FusedAdam``.  The autotune-cache
broadcast has nothing to do: the port's kernels pick their tiles from the
shapes alone.
"""

from apex_tpu_torch.contrib.openfold_triton.fused_adam_swa import AdamSWAState, FusedAdamSWA
from apex_tpu_torch.contrib.openfold_triton.mha import (
    AttnBiasJIT,
    AttnNoBiasJIT,
    AttnTri,
    CanSchTriMHA,
    attention_core,
    disable,
    enable,
    is_enabled,
)
from apex_tpu_torch.normalization import FusedLayerNorm as LayerNormSmallShapeOptImpl


def sync_triton_auto_tune_cache_across_gpus() -> None:
    """Reference ``__init__.py:97`` broadcasts the Triton autotune cache
    from rank 0.  The port's kernels choose their tiles from the shapes
    alone, so there is nothing to share; kept for the API."""


__all__ = [
    "FusedAdamSWA",
    "AttnTri",
    "AttnBiasJIT",
    "AttnNoBiasJIT",
    "sync_triton_auto_tune_cache_across_gpus",
    "AdamSWAState",
    "LayerNormSmallShapeOptImpl",
    "attention_core",
    "CanSchTriMHA",
    "enable",
    "disable",
    "is_enabled",
]
