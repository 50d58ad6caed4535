"""The port's kernels: each module holds a hand-written CUDA kernel's
wrapper (``csrc/*.cu``, built by :mod:`apex_tpu_torch.ops._build`),
its plain PyTorch version, and a launch counter ``LAUNCHES``.

- :mod:`~apex_tpu_torch.ops.layer_norm` — LayerNorm and RMSNorm forward
  and backward, with or without weight and bias;
- :mod:`~apex_tpu_torch.ops.flash_attention` — flash attention forward,
  dq and dk/dv, and their autograd Function;
- :mod:`~apex_tpu_torch.ops.decode_attention` — paged decode attention;
- :mod:`~apex_tpu_torch.ops.decode_sampling` — the fused sampling head;
- :mod:`~apex_tpu_torch.ops.fused_ce_kernels` — the fused LM-head cross
  entropy's forward, dx and dembed (``FWD_LAUNCHES``, ``DX_LAUNCHES``,
  ``DEMBED_LAUNCHES``);
- :mod:`~apex_tpu_torch.ops.fused_ce` — ``fused_lm_head_ce``, the
  autograd Function over them;
- :mod:`~apex_tpu_torch.ops.attention` — ``flash_attention`` and the
  scan specification the flash kernels' plain versions use (plain
  PyTorch);
- :mod:`~apex_tpu_torch.ops.rope` — rotary embeddings (plain PyTorch).
"""
