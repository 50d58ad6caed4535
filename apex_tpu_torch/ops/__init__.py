"""The port's kernels: each module holds a hand-written CUDA kernel's
wrapper (``csrc/*.cu``, built by :mod:`apex_tpu_torch.ops._build`),
its plain PyTorch version, and a launch counter ``LAUNCHES``.

- :mod:`~apex_tpu_torch.ops.layer_norm` — LayerNorm forward and backward;
- :mod:`~apex_tpu_torch.ops.flash_attention` — flash attention forward,
  dq and dk/dv, and their autograd Function;
- :mod:`~apex_tpu_torch.ops.decode_attention` — paged decode attention;
- :mod:`~apex_tpu_torch.ops.decode_sampling` — the fused sampling head;
- :mod:`~apex_tpu_torch.ops.attention` — ``flash_attention`` and the
  scan specification the flash kernels' plain versions use (plain
  PyTorch);
- :mod:`~apex_tpu_torch.ops.rope` — rotary embeddings (plain PyTorch).
"""
