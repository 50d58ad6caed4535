"""apex_tpu_torch.inference — the paged-KV decode engine with continuous
batching, counterpart of :mod:`apex_tpu.inference` (without its fleet):

- :mod:`~apex_tpu_torch.inference.kv_cache` — page pools, page tables,
  the refcounted host allocator with the reserved garbage page;
- :mod:`~apex_tpu_torch.inference.decode` — the decode step (blocks via
  :func:`apex_tpu_torch.models.gpt.forward_decode`, paged decode
  attention, the fused sampling head), the speculative verify step, the
  prompt prefill, the prefill chunk and the sampling head;
- :mod:`~apex_tpu_torch.inference.scheduler` — lane-aware continuous
  batching: FIFO admission within a lane with worst-case page
  reservation, preemption of best-effort residents, chunked prefill,
  speculative verify, copy-on-write, eviction;
- :mod:`~apex_tpu_torch.inference.spec` — n-gram drafting and the
  longest-matching-prefix acceptance rule;
- :mod:`~apex_tpu_torch.inference.prefix` — the refcounted rolling-hash
  page trie behind prefix sharing.

``apex_tpu_torch/serve_gpt.py`` drives it as a load generator.
"""

from apex_tpu_torch.inference.decode import (
    DecodeConfig, make_decode_step, make_prefill, make_prefill_chunk, make_sample_head,
    make_verify_step,
)
from apex_tpu_torch.inference.kv_cache import (
    GARBAGE_PAGE, KVCacheConfig, PageAllocator, alloc_pools, copy_page,
    decode_write_index, pages_needed, write_decode_kv, write_prompt_kv,
)
from apex_tpu_torch.inference.prefix import PrefixCache, PrefixMatch
from apex_tpu_torch.inference.scheduler import (
    LANES, Completion, ContinuousBatchingScheduler, Request,
)
from apex_tpu_torch.inference.spec import NGramProposer, accepted_tokens

__all__ = [
    "Completion", "ContinuousBatchingScheduler", "DecodeConfig",
    "GARBAGE_PAGE", "KVCacheConfig", "LANES", "NGramProposer", "PageAllocator",
    "PrefixCache", "PrefixMatch", "Request", "accepted_tokens", "alloc_pools",
    "copy_page", "decode_write_index", "make_decode_step", "make_prefill",
    "make_prefill_chunk", "make_sample_head", "make_verify_step", "pages_needed",
    "write_decode_kv", "write_prompt_kv",
]
