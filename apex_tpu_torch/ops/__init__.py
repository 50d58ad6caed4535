"""The port's kernels: each module holds a hand-written CUDA kernel's
wrapper (``csrc/*.cu``, built by :mod:`apex_tpu_torch.ops._build`),
its plain PyTorch version, and a launch counter ``LAUNCHES``.

- :mod:`~apex_tpu_torch.ops.layer_norm` — LayerNorm and RMSNorm forward
  and backward, with or without weight and bias;
- :mod:`~apex_tpu_torch.ops.flash_attention` — flash attention forward,
  dq and dk/dv, and their autograd Function (the ring-chunk mode's
  launches counted apart: ``RING_FWD_LAUNCHES``, ``RING_DQ_LAUNCHES``,
  ``RING_DKV_LAUNCHES``);
- :mod:`~apex_tpu_torch.ops.decode_attention` — paged decode attention;
- :mod:`~apex_tpu_torch.ops.decode_sampling` — the fused sampling head;
- :mod:`~apex_tpu_torch.ops.fused_ce_kernels` — the fused LM-head cross
  entropy's forward, dx and dembed (``FWD_LAUNCHES``, ``DX_LAUNCHES``,
  ``DEMBED_LAUNCHES``);
- :mod:`~apex_tpu_torch.ops.fused_ce` — ``fused_lm_head_ce``, the
  autograd Function over them;
- :mod:`~apex_tpu_torch.ops.multi_tensor` — the optimizer engine's
  multi-tensor Adam, scale and L2-norm kernels (``ADAM_LAUNCHES``,
  ``SCALE_LAUNCHES``, ``L2NORM_LAUNCHES``), the ZeRO remainder-mode
  Adam (``REMAINDER_LAUNCHES``) and the ``multi_tensor_*`` tree ops over
  them;
- :mod:`~apex_tpu_torch.ops.attention` — ``flash_attention`` and the
  scan specification the flash kernels' plain versions use (plain
  PyTorch);
- :mod:`~apex_tpu_torch.ops.rope` — rotary embeddings (plain PyTorch).

:func:`launch_counts` and :func:`restore_counts` read and set every
counter at once (with the MoE layer's ``all_to_all`` exchanges,
``transformer.expert_parallel.A2A_LAUNCHES``, counted beside the
kernels), for code that must not know the kernel modules (a
captured step counts its replays through them).
"""

import importlib

#: every launch counter: (kernel module, its global)
COUNTERS = (
    ("layer_norm", "LAUNCHES"), ("layer_norm", "BWD_LAUNCHES"),
    ("flash_attention", "FWD_LAUNCHES"), ("flash_attention", "DQ_LAUNCHES"),
    ("flash_attention", "DKV_LAUNCHES"), ("flash_attention", "RING_FWD_LAUNCHES"),
    ("flash_attention", "RING_DQ_LAUNCHES"), ("flash_attention", "RING_DKV_LAUNCHES"),
    ("fused_ce_kernels", "FWD_LAUNCHES"), ("fused_ce_kernels", "DX_LAUNCHES"),
    ("fused_ce_kernels", "DEMBED_LAUNCHES"),
    ("decode_attention", "LAUNCHES"), ("decode_attention", "WIDE_LAUNCHES"),
    ("decode_sampling", "LAUNCHES"),
    ("multi_tensor", "ADAM_LAUNCHES"), ("multi_tensor", "SCALE_LAUNCHES"),
    ("multi_tensor", "L2NORM_LAUNCHES"), ("multi_tensor", "REMAINDER_LAUNCHES"),
    ("apex_tpu_torch.transformer.expert_parallel", "A2A_LAUNCHES"),
)


def _module(name):
    """A kernel module of this package by its short name, or any module
    by its dotted path."""
    return importlib.import_module(name if "." in name else f"{__name__}.{name}")


def launch_counts():
    """Every counter of :data:`COUNTERS` as ``{"module.NAME": count}``."""
    return {f"{m}.{n}": getattr(_module(m), n) for m, n in COUNTERS}


def restore_counts(counts):
    """Set the counters named in ``counts`` (keys as
    :func:`launch_counts` gives them) to its values."""
    for key, value in counts.items():
        m, n = key.rsplit(".", 1)
        setattr(_module(m), n, value)
