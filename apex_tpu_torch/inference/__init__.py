"""apex_tpu_torch.inference — the paged-KV decode engine with continuous
batching, counterpart of the plain engine of :mod:`apex_tpu.inference`:

- :mod:`~apex_tpu_torch.inference.kv_cache` — page pools, page tables,
  the host allocator with the reserved garbage page;
- :mod:`~apex_tpu_torch.inference.decode` — the decode step (blocks via
  :func:`apex_tpu_torch.models.gpt.forward_decode`, paged decode
  attention, the fused sampling head) and the prompt prefill;
- :mod:`~apex_tpu_torch.inference.scheduler` — FIFO continuous batching
  with worst-case page reservation and eviction.

``apex_tpu_torch/serve_gpt.py`` drives it as a load generator.
"""

from apex_tpu_torch.inference.decode import DecodeConfig, make_decode_step, make_prefill
from apex_tpu_torch.inference.kv_cache import (
    GARBAGE_PAGE, KVCacheConfig, PageAllocator, alloc_pools, copy_page,
    decode_write_index, pages_needed, write_decode_kv, write_prompt_kv,
)
from apex_tpu_torch.inference.scheduler import (
    Completion, ContinuousBatchingScheduler, Request,
)

__all__ = [
    "Completion", "ContinuousBatchingScheduler", "DecodeConfig",
    "GARBAGE_PAGE", "KVCacheConfig", "PageAllocator", "Request",
    "alloc_pools", "copy_page", "decode_write_index", "make_decode_step",
    "make_prefill", "pages_needed", "write_decode_kv", "write_prompt_kv",
]
