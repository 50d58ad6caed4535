"""apex_tpu_torch — the PyTorch/CUDA port of apex_tpu, for one NVIDIA H100.

The JAX package ``apex_tpu`` beside it is the reference: every module
here mirrors the module of the same name there, and the tests in
``tests/test_torch_*.py`` hold the two against each other on the CPU.
This package imports ``torch`` and ``numpy`` and never ``jax`` or
``apex_tpu``.

What is ported so far:

- the serving path of ``examples/gpt/serve_gpt.py``: GPT through the
  paged-KV continuous-batching engine (:mod:`apex_tpu_torch.inference`,
  driven by ``python -m apex_tpu_torch.serve_gpt``), with serving v2
  (speculative verify, chunked prefill, prefix sharing, the
  best-effort lane);
- the GPT training step ``bench.py`` times: ``gpt_loss`` with flash
  attention and layer remat, the dense or the fused LM-head CE head, and
  :class:`~apex_tpu_torch.optimizers.FusedAdam` (driven by ``python -m
  apex_tpu_torch.train_gpt``, ``--fused-ce`` for the fused head);
- ``apex.normalization``: the LayerNorm and RMSNorm functions and the
  ``FusedLayerNorm``/``FusedRMSNorm`` modules;
- ``apex.optimizers`` (:mod:`apex_tpu_torch.optimizers`): FusedAdam,
  FusedSGD, FusedLAMB, FusedMixedPrecisionLamb, FusedAdagrad and
  FusedNovoGrad on the multi-tensor engine (bucket plans, resident
  state, per-group hyperparameters, the folded clip and
  ``update_scaled``), with :mod:`apex_tpu_torch.multi_tensor_apply` and
  :mod:`apex_tpu_torch.contrib.clip_grad`;
- ``apex.amp`` (:mod:`apex_tpu_torch.amp`: the O0–O3 policies, dynamic
  loss scaling on the device, the decorators), ``apex.fp16_utils``
  (:mod:`apex_tpu_torch.fp16_utils`), the model-parallel ``GradScaler``
  (:mod:`apex_tpu_torch.transformer.amp`) and the step guard
  (:mod:`apex_tpu_torch.resilience`), with fp16 training of the GPT step
  (``python -m apex_tpu_torch.train_gpt --fp16``: float16 compute, the
  scaled step, ``--step-guard``, ``--clip-grad-norm``);

with hand-written CUDA kernels for the ten TPU kernels on those paths
(LayerNorm/RMSNorm forward and backward and flash attention forward, dq
and dk/dv, each also in float16, the fused LM-head CE forward, dx and dembed, paged decode
attention at ``width=1`` and ``width > 1``, the fused sampling head) and
for the optimizer engine's multi-tensor Adam, scale and L2 norm (XLA
fusions in the JAX package) under :mod:`apex_tpu_torch.ops`.

Entry points take ``device=`` and default to ``"cuda"``; with no CUDA
device they raise rather than run on the CPU.  Pass ``device="cpu"`` to
run the kernels' plain PyTorch versions (the tests do).  A kernel
wrapper picks its plain version only for tensors on the CPU: on a CUDA
tensor it launches the kernel or raises.

Importing the package is light: subpackages load on first use, and no
kernel is built until a wrapper first sees a CUDA tensor.
"""

import importlib

_SUBMODULES = ("amp", "contrib", "fp16_utils", "inference", "models", "multi_tensor_apply",
               "normalization", "ops", "optimizers", "resilience", "transformer")

__all__ = list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
