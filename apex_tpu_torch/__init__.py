"""apex_tpu_torch — the PyTorch/CUDA port of apex_tpu, for one NVIDIA H100.

The JAX package ``apex_tpu`` beside it is the reference: every module
here mirrors the module of the same name there, and the tests in
``tests/test_torch_*.py`` hold the two against each other on the CPU.
This package imports ``torch`` and ``numpy`` and never ``jax`` or
``apex_tpu``.

What is ported so far:

- the serving path of ``examples/gpt/serve_gpt.py``: GPT through the
  paged-KV continuous-batching engine (:mod:`apex_tpu_torch.inference`,
  driven by ``python -m apex_tpu_torch.serve_gpt``);
- the GPT training step ``bench.py`` times: ``gpt_loss`` with flash
  attention and layer remat, and :class:`~apex_tpu_torch.optimizers.FusedAdam`
  (driven by ``python -m apex_tpu_torch.train_gpt``);

with hand-written CUDA kernels for the seven TPU kernels on those paths
(LayerNorm forward and backward, flash attention forward, dq and dk/dv,
paged decode attention, the fused sampling head) under
:mod:`apex_tpu_torch.ops`.

Entry points take ``device=`` and default to ``"cuda"``; with no CUDA
device they raise rather than run on the CPU.  Pass ``device="cpu"`` to
run the kernels' plain PyTorch versions (the tests do).  A kernel
wrapper picks its plain version only for tensors on the CPU: on a CUDA
tensor it launches the kernel or raises.

Importing the package is light: subpackages load on first use, and no
kernel is built until a wrapper first sees a CUDA tensor.
"""

import importlib

_SUBMODULES = ("inference", "models", "normalization", "ops", "optimizers", "transformer")

__all__ = list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
