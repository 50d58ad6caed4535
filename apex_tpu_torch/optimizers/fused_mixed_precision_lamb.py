"""FusedMixedPrecisionLamb (counterpart of
:mod:`apex_tpu.optimizers.fused_mixed_precision_lamb`): the capturable
LAMB with fp32 masters.  Every port optimizer already keeps its state on
the device, takes a tensor ``lr`` and predicates its commit on a device
flag, so this is :class:`~apex_tpu_torch.optimizers.FusedLAMB` with
``master_weights=True`` by default, kept as a class for the API."""

from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB


class FusedMixedPrecisionLamb(FusedLAMB):
    def __init__(self, *args, master_weights: bool = True, **kwargs):
        kwargs["master_weights"] = master_weights
        super().__init__(*args, **kwargs)
