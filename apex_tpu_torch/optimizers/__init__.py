"""The fused optimizers of the port (counterpart of
:mod:`apex_tpu.optimizers`).

Each optimizer is a pure transform over a tree of tensors with the JAX
package's numerics (fp32 math whatever the storage dtype), its commit
predicated on a device flag, optional fp32 master weights.  All run on
the multi-tensor engine by default (``use_buckets=True``): FusedAdam's
step is the ``mt_adam`` kernel, the prepare pass (unscale, finite vote,
clip) the ``mt_scale`` and ``mt_l2norm`` kernels; see
:mod:`apex_tpu_torch.optimizers.base` and
:mod:`apex_tpu_torch.optimizers.bucketing`.
"""

from apex_tpu_torch.optimizers.bucketing import BucketPlan, Buckets, plan_of
from apex_tpu_torch.optimizers.fused_adagrad import AdagradState, FusedAdagrad
from apex_tpu_torch.optimizers.fused_adam import AdamState, FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB, LambState
from apex_tpu_torch.optimizers.fused_mixed_precision_lamb import FusedMixedPrecisionLamb
from apex_tpu_torch.optimizers.fused_novograd import FusedNovoGrad, NovoGradState
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD, SGDState

__all__ = [
    "FusedAdam",
    "AdamState",
    "FusedLAMB",
    "LambState",
    "FusedSGD",
    "SGDState",
    "FusedNovoGrad",
    "NovoGradState",
    "FusedAdagrad",
    "AdagradState",
    "FusedMixedPrecisionLamb",
    "BucketPlan",
    "Buckets",
    "plan_of",
]
