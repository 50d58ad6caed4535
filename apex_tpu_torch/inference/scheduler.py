"""Continuous-batching scheduler: admit, prefill, decode, evict.

Counterpart of the plain engine of :mod:`apex_tpu.inference.scheduler`
(one interactive lane, no speculation, prefix sharing or chunked
prefill).  The decode step always runs at the fixed ``max_batch`` shape
and this scheduler fills its slots:

- **admit**: between decode steps, queued requests move into free slots
  strictly FIFO, each reserving its worst-case pages
  ``ceil((prompt + max_new) / page_size)`` up front, so a resident
  sequence can never run out of pages mid-generation and the queue
  head is never overtaken;
- **prefill**: an admitted prompt runs through the full forward at the
  one padded length ``DecodeConfig.max_prompt_len``;
- **decode**: one step advances every active slot; inactive slots ride
  along masked;
- **evict**: finished sequences free their pages for the next
  admission.

Sampling seeds derive from ``(base_seed, slot, per-slot draw
counter)`` exactly as in the JAX package (``_seed_at``), and the draw
counter only grows, so the same trace of submits gives the same tokens
there and here.

Not in this slice, and raising if asked for: the ``best_effort`` lane
and preemption; speculation, prefix sharing and chunked prefill
(:class:`~apex_tpu_torch.inference.decode.DecodeConfig` refuses them).
The JAX scheduler's watchdog, metrics, tracing, drain manifest and
step-rebuild fallback are not ported; there is no fallback to rebuild
into.
"""

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.inference.decode import DecodeConfig, make_decode_step, make_prefill
from apex_tpu_torch.inference.kv_cache import PageAllocator, alloc_pools, pages_needed
from apex_tpu_torch.models.gpt import GPTConfig

__all__ = ["Completion", "ContinuousBatchingScheduler", "Request"]

_MASK32 = (1 << 32) - 1


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` token ids, ``max_new_tokens``
    to generate, optional ``eos_id`` early stop.  ``lane`` keeps the
    JAX package's field; only ``"interactive"`` is served here."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    lane: str = "interactive"


@dataclasses.dataclass
class Completion:
    """A finished request with its wall-clock trace: ``token_times[i]``
    is when ``tokens[i]`` became available; ``submit_time`` is when the
    request was admitted (as in the JAX package)."""

    rid: int
    prompt: List[int]
    tokens: List[int]
    submit_time: float
    finish_time: float
    token_times: List[float]
    lane: str = "interactive"


@dataclasses.dataclass
class _Slot:
    request: Request
    pages: List[int]
    generated: List[int]
    token_times: List[float]
    submit_time: float


class ContinuousBatchingScheduler:
    """FIFO admission into freed KV pages between decode steps, fixed
    slot shapes, eviction with page recycling, and deterministic
    per-slot sampling seeds.  ``params`` are the port's params
    (:func:`apex_tpu_torch.models.gpt.params_from_numpy`) on ``device``;
    the KV pools are allocated there."""

    def __init__(self, params, config: GPTConfig, dcfg: DecodeConfig,
                 time_fn=time.monotonic, device="cuda"):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params are on {params['embed'].device}, the scheduler's "
                f"device is {self.device}")
        if dcfg.max_prompt_len > config.max_seq_len \
                and config.position_embedding_type == "learned":
            raise ValueError(
                f"max_prompt_len ({dcfg.max_prompt_len}) exceeds the "
                f"learned position table ({config.max_seq_len})")
        cache = dcfg.cache
        self.params = params
        self.config = config
        self.dcfg = dcfg
        self._time = time_fn
        self.pools = alloc_pools(config.num_layers, config.kv_heads,
                                 config.head_dim, cache, device=self.device)
        self.allocator = PageAllocator(cache.num_pages)
        self.queue: deque = deque()
        B, P = dcfg.max_batch, cache.pages_per_seq
        self._slots: List[Optional[_Slot]] = [None] * B
        self._page_tables = np.zeros((B, P), np.int32)
        self._positions = np.zeros((B,), np.int32)
        self._tokens = np.zeros((B,), np.int32)
        self._active = np.zeros((B,), bool)
        #: per-slot sampling draw counters, monotonic for the life of
        #: the scheduler: no (slot, draw) seed is ever used twice
        self._draws = np.zeros((B,), np.int64)
        self.completed: List[Completion] = []
        self.stats: Dict[str, int] = {
            "admitted": 0, "evicted": 0, "decode_steps": 0, "prefills": 0}
        self._decode = make_decode_step(config, dcfg)
        self._prefill = make_prefill(config, dcfg)

    # ------------------------------------------------------------ seeds
    def _seed_at(self, slot: int, draw: int) -> int:
        return (self.dcfg.base_seed
                + slot * 0x9E3779B9 + draw * 0x85EBCA6B) & _MASK32

    def _seed(self, slot: int) -> int:
        d = int(self._draws[slot])
        self._draws[slot] += 1
        return self._seed_at(slot, d)

    def _to_device(self, a: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(a).to(device=self.device, dtype=dtype)

    # ---------------------------------------------------------- requests
    def submit(self, request: Request) -> None:
        """Queue a request (FIFO).  Requests that can never fit the
        fixed shapes fail here instead of blocking the queue head."""
        if request.lane != "interactive":
            raise NotImplementedError(
                f"lane {request.lane!r}: only the 'interactive' lane is "
                f"ported (the best_effort lane and preemption come later)")
        plen = len(request.prompt)
        if plen < 1:
            raise ValueError("empty prompt")
        if plen > self.dcfg.max_prompt_len:
            raise ValueError(
                f"prompt ({plen} tokens) exceeds max_prompt_len "
                f"({self.dcfg.max_prompt_len})")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.config.position_embedding_type == "learned" \
                and plen + request.max_new_tokens > self.config.max_seq_len:
            raise ValueError(
                f"prompt + max_new_tokens ({plen} + "
                f"{request.max_new_tokens}) exceeds the learned position "
                f"table ({self.config.max_seq_len})")
        need = self._total_pages(request)
        P = self.dcfg.cache.pages_per_seq
        if need > P:
            raise ValueError(
                f"request needs {need} pages; page tables hold {P} "
                f"(pages_per_seq) — raise pages_per_seq or shorten the "
                f"request")
        if need > self.allocator.num_pages - 1:
            raise ValueError(
                f"request needs {need} pages; the pool only has "
                f"{self.allocator.num_pages - 1} allocatable")
        self.queue.append(request)

    def _total_pages(self, req: Request) -> int:
        return pages_needed(len(req.prompt) + req.max_new_tokens,
                            self.dcfg.cache.page_size)

    @property
    def num_active(self) -> int:
        return int(self._active.sum())

    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self._slots)

    # ------------------------------------------------------------- admit
    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _admit(self) -> int:
        admitted = 0
        while self.queue:
            req = self.queue[0]
            slot = self._free_slot()
            need = self._total_pages(req)
            if slot is None or not self.allocator.can_allocate(need):
                break  # FIFO: the head blocks, nothing overtakes it
            self.queue.popleft()
            self._admit_into(slot, req, self.allocator.allocate(need))
            admitted += 1
        return admitted

    def _admit_into(self, slot: int, req: Request, pages: List[int]) -> None:
        t0 = self._time()
        row = np.zeros((self.dcfg.cache.pages_per_seq,), np.int32)
        row[:len(pages)] = pages
        self._page_tables[slot] = row
        plen = len(req.prompt)
        self._slots[slot] = _Slot(request=req, pages=pages, generated=[],
                                  token_times=[], submit_time=t0)
        self.stats["admitted"] += 1
        prompt = np.zeros((1, self.dcfg.max_prompt_len), np.int64)
        prompt[0, :plen] = req.prompt
        seed = np.asarray([self._seed(slot)], np.int64)
        self.pools, first = self._prefill(
            self.params, self.pools, self._to_device(prompt, torch.long), plen, 0,
            self._to_device(row, torch.int32), self._to_device(seed, torch.long))
        self.stats["prefills"] += 1
        self._start_decoding(slot, int(first.cpu()[0]))

    def _start_decoding(self, slot: int, first: int) -> None:
        s = self._slots[slot]
        req = s.request
        s.generated.append(first)
        s.token_times.append(self._time())
        self._positions[slot] = len(req.prompt)  # where `first` caches
        self._tokens[slot] = first
        self._active[slot] = True
        if (req.max_new_tokens == 1
                or (req.eos_id is not None and first == req.eos_id)):
            self._evict(slot)

    # ------------------------------------------------------------- evict
    def _evict(self, slot: int) -> None:
        s = self._slots[slot]
        self.allocator.free(s.pages)
        self._slots[slot] = None
        self._active[slot] = False
        self._page_tables[slot] = 0
        self._positions[slot] = 0
        self._tokens[slot] = 0
        self.completed.append(Completion(
            rid=s.request.rid, prompt=list(s.request.prompt),
            tokens=list(s.generated), submit_time=s.submit_time,
            finish_time=self._time(), token_times=list(s.token_times),
            lane=s.request.lane))
        self.stats["evicted"] += 1

    # -------------------------------------------------------------- step
    def step(self) -> bool:
        """Admit waiting requests, then advance every active sequence by
        one token.  Returns True when any work happened."""
        admitted = self._admit()
        if not self._active.any():
            return admitted > 0
        self._step_decode()
        return True

    def _step_decode(self) -> None:
        B = self.dcfg.max_batch
        seeds = np.zeros((B,), np.int64)
        for i in range(B):
            if self._active[i]:
                seeds[i] = self._seed(i)
        self.pools, next_tokens = self._decode(
            self.params, self.pools, self._to_device(self._tokens, torch.long),
            self._to_device(self._positions, torch.long),
            self._to_device(self._active, torch.bool),
            self._to_device(self._page_tables, torch.int32),
            self._to_device(seeds, torch.long))
        next_tokens = next_tokens.cpu().numpy()
        now = self._time()
        self.stats["decode_steps"] += 1
        for i in range(B):
            if not self._active[i]:
                continue
            s = self._slots[i]
            tok = int(next_tokens[i])
            s.generated.append(tok)
            s.token_times.append(now)
            self._tokens[i] = tok
            self._positions[i] += 1
            if (len(s.generated) >= s.request.max_new_tokens
                    or (s.request.eos_id is not None
                        and tok == s.request.eos_id)):
                self._evict(i)

    def run_until_drained(self, max_steps: int = 10_000) -> List[Completion]:
        """Drive :meth:`step` until the queue and the slots are empty."""
        for _ in range(max_steps):
            if self.idle():
                return self.completed
            self.step()
        raise RuntimeError(
            f"serve loop not drained after {max_steps} steps "
            f"(queue={len(self.queue)}, active={self.num_active})")
