"""Continuous-batching scheduler: admit, prefill, decode, evict.

Counterpart of the engine of :mod:`apex_tpu.inference.scheduler`.  The
decode step always runs at the fixed ``max_batch`` shape and this
scheduler fills its slots:

- **admit**: between steps, queued requests move into free slots FIFO
  within their lane.  Two lanes (``Request.lane``, :data:`LANES`):
  ``interactive`` is admitted strictly FIFO, each request reserving its
  worst-case pages ``ceil((prompt + max_new + draft_len) / page_size)``
  up front, so a resident sequence never runs out of pages
  mid-generation; ``best_effort`` fills leftover capacity only while the
  interactive queue is empty, and is preemptible: when the interactive
  head does not fit, the youngest best-effort resident is evicted
  through the ordinary release path and its continuation (prompt +
  tokens so far, the remaining budget) requeued at its lane's head;
- **prefill**: an admitted prompt runs through the full forward at the
  one padded length ``DecodeConfig.max_prompt_len``, or, with
  ``prefill_chunk`` set, as fixed-size chunks through the multi-position
  decode forward, one chunk a scheduler step, interleaved with the
  resident streams' decode steps;
- **prefix sharing** (``prefix_sharing``): admission matches the prompt
  against the refcounted page trie
  (:class:`~apex_tpu_torch.inference.prefix.PrefixCache`); matched full
  pages map straight into the page table, the prefill's writes start
  past them, and chunked prefill skips their compute.  A shared partial
  tail page is copied (:func:`~apex_tpu_torch.inference.kv_cache.
  copy_page`) before the first divergent write, into a reserve page
  allocated at admission, so copy-on-write never fails mid-generation;
- **decode**: one step advances every active slot; inactive slots ride
  along masked.  With ``draft_len`` k > 0 it is the verify step: an
  n-gram proposer (:class:`~apex_tpu_torch.inference.spec.NGramProposer`)
  drafts up to k tokens a slot, one pass scores all k + 1 positions,
  and the host keeps the longest matching prefix.  The stream is the
  non-speculative one token for token, greedy and sampled;
- **evict**: finished sequences drop their page references for the
  next admission and register their quiesced tail page in the trie.

**Compiled steps.** Every step is built compiled (``graphs=None``): a
:class:`~apex_tpu_torch.graphs.CapturedStep` that captures a CUDA graph
on its first call on the card and replays it after, as the JAX
scheduler's steps are ``jax.jit`` with donated pools.  The steps share
one graph memory pool (``torch.cuda.graph_pool_handle()``), freed with
the scheduler.  The host work stays on the host, between steps:
admission, drafting, copy-on-write, the readback of tokens.  Each step's
inputs are built as pinned host tensors and copied into the step's
static buffers; ``graphs=False`` runs the plain steps eagerly on inputs
uploaded each step.  On the CPU the compiled steps run their static
buffers without capture.

Sampling seeds derive from ``(base_seed, slot, per-slot draw
counter)`` exactly as in the JAX package (``_seed_at``), and the draw
counter only grows, across every generation a slot serves (preemption
re-admission included), so the same trace of submits gives the same
tokens there and here.

The JAX scheduler's watchdog, metrics, tracing, anomaly monitor, chaos
hooks, drain manifest and step-rebuild fallback are not ported; there
is no fallback to rebuild into.
"""

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.graphs import CapturedStep
from apex_tpu_torch.inference.decode import (
    DecodeConfig, make_decode_step, make_prefill, make_prefill_chunk, make_sample_head,
    make_verify_step,
)
from apex_tpu_torch.inference.kv_cache import (
    GARBAGE_PAGE, PageAllocator, alloc_pools, copy_page, pages_needed,
)
from apex_tpu_torch.inference.prefix import PrefixCache, PrefixMatch
from apex_tpu_torch.inference.spec import NGramProposer, accepted_tokens
from apex_tpu_torch.models.gpt import GPTConfig

__all__ = ["LANES", "Completion", "ContinuousBatchingScheduler", "Request"]

_MASK32 = (1 << 32) - 1

#: admission lanes, in priority order: ``interactive`` requests carry
#: the latency objective (strict FIFO, worst-case reservation, may
#: preempt); ``best_effort`` fills leftover capacity and is preemptible
LANES = ("interactive", "best_effort")


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` token ids, ``max_new_tokens``
    to generate, optional ``eos_id`` early stop, and the admission
    ``lane`` (see :data:`LANES`)."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    lane: str = "interactive"


@dataclasses.dataclass
class Completion:
    """A finished request with its wall-clock trace: ``token_times[i]``
    is when ``tokens[i]`` became available; ``submit_time`` is when the
    request was admitted (as in the JAX package).  ``preemptions`` counts
    how often a best-effort generation was evicted and requeued on the
    way."""

    rid: int
    prompt: List[int]
    tokens: List[int]
    submit_time: float
    finish_time: float
    token_times: List[float]
    lane: str = "interactive"
    preemptions: int = 0


@dataclasses.dataclass
class _Carry:
    """Continuation state of a preempted rid: the original prompt and
    admit time, and the tokens and times of its earlier legs."""

    prompt: List[int]
    tokens: List[int]
    times: List[float]
    submit_time: float
    preemptions: int = 0


@dataclasses.dataclass
class _Slot:
    request: Request
    pages: List[int]               # page-table entries, in index order
    generated: List[int]
    token_times: List[float]
    submit_time: float
    admit_seq: int = 0             # admission order (preemption takes the max)
    shared_len: int = 0            # prompt positions served by shared pages
    cow_reserve: Optional[int] = None
    chunk_next: Optional[int] = None  # next prompt position to chunk-prefill
    proposer: Optional[NGramProposer] = None


class ContinuousBatchingScheduler:
    """Lane-aware admission into freed KV pages between steps, fixed slot
    shapes, chunked prefill, speculative verify, prefix sharing with
    copy-on-write, eviction with refcounted page recycling, and
    deterministic per-slot sampling seeds (see the module docstring).
    ``params`` are the port's params
    (:func:`apex_tpu_torch.models.gpt.params_from_numpy`) on ``device``;
    the KV pools are allocated there.  ``graphs``: None (the default)
    compiles the steps, False runs the plain steps eagerly."""

    def __init__(self, params, config: GPTConfig, dcfg: DecodeConfig,
                 time_fn=time.monotonic, device="cuda", graphs=None):
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
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self.allocator, cache.page_size)
            if dcfg.prefix_sharing else None)
        self.queue: deque = deque()      # interactive lane
        self.be_queue: deque = deque()   # best-effort lane
        B, P = dcfg.max_batch, cache.pages_per_seq
        self._slots: List[Optional[_Slot]] = [None] * B
        self._page_tables = np.zeros((B, P), np.int32)
        self._positions = np.zeros((B,), np.int32)
        self._tokens = np.zeros((B,), np.int32)
        self._active = np.zeros((B,), bool)
        #: per-slot sampling draw counters, monotonic for the life of the
        #: scheduler across every generation a slot serves: no (slot,
        #: draw) seed is ever used twice
        self._draws = np.zeros((B,), np.int64)
        self._admit_counter = 0
        self.completed: List[Completion] = []
        self._carry: Dict[int, _Carry] = {}
        self.stats: Dict[str, int] = {
            "admitted": 0, "evicted": 0, "decode_steps": 0, "prefills": 0,
            "preemptions": 0, "chunk_steps": 0, "cow_copies": 0,
            "shared_full_pages": 0, "shared_tail_pages": 0,
            "spec_steps": 0, "spec_emitted": 0,
        }
        pool = (torch.cuda.graph_pool_handle()
                if self.device.type == "cuda" and graphs is not False else None)
        kw = dict(graphs=graphs, pool=pool)
        self._decode = self._verify = self._prefill = None
        self._chunk = self._sample_head = None
        if dcfg.draft_len > 0:
            self._verify = make_verify_step(config, dcfg, **kw)
        else:
            self._decode = make_decode_step(config, dcfg, **kw)
        if dcfg.prefill_chunk is not None:
            self._chunk = make_prefill_chunk(config, dcfg, **kw)
            self._sample_head = make_sample_head(config, dcfg, **kw)
        else:
            self._prefill = make_prefill(config, dcfg, **kw)

    # ------------------------------------------------------------ seeds
    def _seed_at(self, slot: int, draw: int) -> int:
        return (self.dcfg.base_seed
                + slot * 0x9E3779B9 + draw * 0x85EBCA6B) & _MASK32

    def _seed(self, slot: int) -> int:
        d = int(self._draws[slot])
        self._draws[slot] += 1
        return self._seed_at(slot, d)

    def _host(self, a: np.ndarray, dtype) -> torch.Tensor:
        """``a`` as a step input on the host: pinned when the steps run on
        the card, so that its copy into a step's buffer is asynchronous
        (the pinned-memory cache keeps the block until the copy is done)."""
        src = torch.from_numpy(a)
        if self.device.type != "cuda":
            return src.to(dtype)
        return torch.empty(src.shape, dtype=dtype, pin_memory=True).copy_(src)

    def _call(self, step, *args):
        """Run ``step``: a compiled step copies the host tensors into its
        buffers itself; a plain one (``graphs=False``) gets them
        uploaded."""
        if not isinstance(step, CapturedStep):
            args = [a.to(self.device, non_blocking=True) if isinstance(a, torch.Tensor)
                    else a for a in args]
        return step(*args)

    # ---------------------------------------------------------- requests
    def submit(self, request: Request) -> None:
        """Queue a request (FIFO within its lane).  Requests that can
        never fit the fixed shapes fail here instead of blocking the
        queue head."""
        if request.lane not in LANES:
            raise ValueError(f"unknown lane {request.lane!r}; lanes are {LANES}")
        plen = len(request.prompt)
        if plen < 1:
            raise ValueError("empty prompt")
        if self.dcfg.prefill_chunk is None and plen > self.dcfg.max_prompt_len:
            raise ValueError(
                f"prompt ({plen} tokens) exceeds max_prompt_len "
                f"({self.dcfg.max_prompt_len}) — set prefill_chunk to "
                f"admit long prompts as chunks")
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
        (self.queue if request.lane == "interactive" else self.be_queue).append(request)

    def _total_pages(self, req: Request) -> int:
        """Worst-case page-table footprint: prompt + generation budget +
        the speculative write window (draft k/v land up to ``draft_len``
        positions past the accepted stream)."""
        return pages_needed(
            len(req.prompt) + req.max_new_tokens + self.dcfg.draft_len,
            self.dcfg.cache.page_size)

    @property
    def capture_seconds(self) -> float:
        """Host time spent capturing the steps' graphs so far: each step
        captures at its first call, inside the serving loop."""
        steps = (self._decode, self._verify, self._prefill, self._chunk, self._sample_head)
        return sum(s.capture_seconds for s in steps if isinstance(s, CapturedStep))

    @property
    def num_active(self) -> int:
        return int(self._active.sum())

    def idle(self) -> bool:
        return (not self.queue and not self.be_queue
                and all(s is None for s in self._slots))

    # ------------------------------------------------------------- admit
    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _plan(self, req: Request):
        """(match, fresh pages needed) for admitting ``req`` now,
        recomputed on every attempt (the trie and the pool move)."""
        match = (self.prefix.match(req.prompt) if self.prefix is not None
                 else PrefixMatch((), None, 0))
        return match, self._total_pages(req) - match.num_full

    def _admit(self) -> int:
        admitted = self._admit_from(self.queue, can_preempt=True)
        if not self.queue:
            # best-effort fills leftover capacity only while no
            # interactive request waits
            admitted += self._admit_from(self.be_queue, can_preempt=False)
        return admitted

    def _admit_from(self, queue: deque, can_preempt: bool) -> int:
        admitted = 0
        while queue:
            req = queue[0]
            slot = self._free_slot()
            match, need_fresh = self._plan(req)
            if slot is None or not self.allocator.can_allocate(need_fresh):
                if slot is not None and self.prefix is not None and \
                        self.prefix.release(need_fresh - self.allocator.free_pages):
                    continue  # trie references dropped: plan again
                if can_preempt and self._preempt_one():
                    continue  # a best-effort resident yielded: retry
                break  # FIFO: the head blocks, nothing overtakes it
            queue.popleft()
            self._admit_into(slot, req, match, need_fresh)
            admitted += 1
        return admitted

    def _admit_into(self, slot: int, req: Request, match: PrefixMatch,
                    need_fresh: int) -> None:
        t0 = self._time()
        fresh = self.allocator.allocate(need_fresh)
        assert fresh is not None  # _admit_from checked can_allocate
        if match.num_full:
            self.allocator.share(match.full_pages)
            self.stats["shared_full_pages"] += match.num_full
        table: List[int] = list(match.full_pages)
        it = iter(fresh)
        cow_reserve = None
        if match.tail_page is not None:
            self.allocator.share([match.tail_page])
            self.stats["shared_tail_pages"] += 1
            table.append(match.tail_page)
            cow_reserve = next(it)  # the tail's copy-on-write budget
        table.extend(it)
        row = np.zeros((self.dcfg.cache.pages_per_seq,), np.int32)
        row[:len(table)] = table
        self._page_tables[slot] = row
        plen = len(req.prompt)
        self._admit_counter += 1
        s = _Slot(request=req, pages=table, generated=[], token_times=[],
                  submit_time=t0, admit_seq=self._admit_counter,
                  shared_len=match.shared_len, cow_reserve=cow_reserve)
        self._slots[slot] = s
        self.stats["admitted"] += 1
        if self.dcfg.prefill_chunk is not None:
            # chunked admission: compute starts past the shared prefix (a
            # fully cached prompt: one recompute pass over its last
            # position, no writes), one chunk a scheduler step
            s.chunk_next = (match.shared_len if match.shared_len < plen
                            else plen - 1)
            return
        prompt = np.zeros((1, self.dcfg.max_prompt_len), np.int64)
        prompt[0, :plen] = req.prompt
        seed = np.asarray([self._seed(slot)], np.int64)
        self.pools, first = self._call(
            self._prefill, self.params, self.pools, self._host(prompt, torch.long), plen,
            match.shared_len, self._host(row, torch.int32), self._host(seed, torch.long))
        self.stats["prefills"] += 1
        self._start_decoding(slot, int(first.cpu()[0]))

    def _start_decoding(self, slot: int, first: int) -> None:
        """The prefill epilogue (one-shot and chunked): record the first
        token, index the prompt's full pages in the trie, arm the slot
        and the proposer, and evict a 1-token or instant-eos generation
        at once."""
        s = self._slots[slot]
        req = s.request
        s.generated.append(first)
        s.token_times.append(self._time())
        s.chunk_next = None
        if self.prefix is not None:
            # full pages are final once the prompt is cached; the tail
            # page waits for eviction
            self.prefix.register(req.prompt, [int(p) for p in s.pages])
        if self.dcfg.draft_len > 0:
            s.proposer = NGramProposer(self.dcfg.draft_len, self.dcfg.ngram_max,
                                       self.dcfg.ngram_min)
            s.proposer.extend(list(req.prompt) + [first])
        self._positions[slot] = len(req.prompt)  # where `first` caches
        self._tokens[slot] = first
        self._active[slot] = True
        if (req.max_new_tokens == 1
                or (req.eos_id is not None and first == req.eos_id)):
            self._evict(slot)

    # --------------------------------------------------------- preemption
    def _preempt_one(self) -> bool:
        """Evict the youngest best-effort resident (decoding or still
        chunk-prefilling) and requeue its continuation at its lane's
        head.  Returns whether a victim yielded."""
        cands = [i for i, s in enumerate(self._slots)
                 if s is not None and s.request.lane == "best_effort"]
        if not cands:
            return False
        victim = max(cands, key=lambda i: self._slots[i].admit_seq)
        s = self._slots[victim]
        req = s.request
        c = self._carry.get(req.rid)
        if c is None:
            c = _Carry(prompt=list(req.prompt), tokens=[], times=[],
                       submit_time=s.submit_time)
            self._carry[req.rid] = c
        c.preemptions += 1
        remaining = req.max_new_tokens - len(s.generated)
        cont_prompt = list(req.prompt) + list(s.generated)
        can_continue = (
            s.chunk_next is None and s.generated and remaining >= 1
            and (self.dcfg.prefill_chunk is not None
                 or len(cont_prompt) <= self.dcfg.max_prompt_len))
        if can_continue:
            c.tokens.extend(s.generated)
            c.times.extend(s.token_times)
            cont = Request(rid=req.rid, prompt=cont_prompt, max_new_tokens=remaining,
                           eos_id=req.eos_id, lane=req.lane)
        else:  # restart this leg (its partial work is dropped)
            cont = Request(rid=req.rid, prompt=list(req.prompt),
                           max_new_tokens=req.max_new_tokens, eos_id=req.eos_id,
                           lane=req.lane)
        self._release_slot(victim)
        self.stats["preemptions"] += 1
        self.be_queue.appendleft(cont)
        return True

    def _release_slot(self, slot: int) -> None:
        """Return a slot's pages (and an unused copy-on-write reserve) to
        the allocator and clear its fixed-shape arrays."""
        s = self._slots[slot]
        self.allocator.free(s.pages)
        if s.cow_reserve is not None:
            self.allocator.free([s.cow_reserve])
        self._slots[slot] = None
        self._active[slot] = False
        self._page_tables[slot] = 0
        self._positions[slot] = 0
        self._tokens[slot] = 0

    # ------------------------------------------------------------- evict
    def _evict(self, slot: int) -> None:
        s = self._slots[slot]
        if self.prefix is not None and s.chunk_next is None:
            # the tail page is final now: index it (full pages re-index
            # as a no-op walk, repairing released chains)
            self.prefix.register(s.request.prompt,
                                 [int(p) for p in self._page_tables[slot]], tail=True)
        c = self._carry.pop(s.request.rid, None)
        prompt = c.prompt if c is not None else list(s.request.prompt)
        tokens = (list(c.tokens) if c is not None else []) + list(s.generated)
        times = (list(c.times) if c is not None else []) + list(s.token_times)
        submit = c.submit_time if c is not None else s.submit_time
        self._release_slot(slot)
        self.completed.append(Completion(
            rid=s.request.rid, prompt=prompt, tokens=tokens, submit_time=submit,
            finish_time=self._time(), token_times=times, lane=s.request.lane,
            preemptions=c.preemptions if c is not None else 0))
        self.stats["evicted"] += 1

    # ----------------------------------------------------- chunked prefill
    def _advance_chunks(self) -> bool:
        """One prefill chunk for each slot still prefilling; the final
        chunk's last hidden state goes through the sampling head for the
        first token."""
        progressed = False
        C = self.dcfg.prefill_chunk
        for i, s in enumerate(self._slots):
            if s is None or s.chunk_next is None:
                continue
            plen = len(s.request.prompt)
            start = s.chunk_next
            n_valid = min(C, plen - start)
            tok = np.zeros((C,), np.int64)
            tok[:n_valid] = s.request.prompt[start:start + n_valid]
            self.pools, h_last = self._call(
                self._chunk, self.params, self.pools, self._host(tok, torch.long), start,
                n_valid, s.shared_len, self._host(self._page_tables[i], torch.int32))
            self.stats["chunk_steps"] += 1
            s.chunk_next = start + n_valid
            progressed = True
            if s.chunk_next >= plen:
                seed = np.asarray([self._seed(i)], np.int64)
                first = self._call(self._sample_head, self.params, h_last,
                                   self._host(seed, torch.long))
                self.stats["prefills"] += 1
                self._start_decoding(i, int(first.cpu()[0]))
        return progressed

    # ------------------------------------------------------------- COW
    def _cow_for_writes(self, width: int) -> None:
        """Copy-on-write before a decode or verify step: a page that the
        step's write window (``positions .. positions + width - 1``)
        touches with refcount > 1 is copied into the slot's reserve and
        the table repointed, so shared pages are never written through."""
        if self.prefix is None:
            return  # no sharing: no page can hold refcount > 1
        ps = self.dcfg.cache.page_size
        P = self.dcfg.cache.pages_per_seq
        for i in range(self.dcfg.max_batch):
            if not self._active[i]:
                continue
            p0 = int(self._positions[i])
            first_ix = p0 // ps
            last_ix = min((p0 + width - 1) // ps, P - 1)
            for ix in range(first_ix, last_ix + 1):
                page = int(self._page_tables[i, ix])
                if page == GARBAGE_PAGE or self.allocator.refcount(page) <= 1:
                    continue
                s = self._slots[i]
                if s.cow_reserve is None:
                    raise RuntimeError(
                        f"slot {i}: divergent write into shared page {page} with "
                        f"no copy-on-write reserve — the admission plan must "
                        f"reserve one page per shared tail")
                new = s.cow_reserve
                s.cow_reserve = None
                self.pools = copy_page(self.pools, page, new)
                self.allocator.free([page])  # drop this slot's share
                self._page_tables[i, ix] = new
                s.pages[ix] = new
                self.stats["cow_copies"] += 1

    # -------------------------------------------------------------- step
    def step(self) -> bool:
        """Admit waiting requests (both lanes), advance chunked prefills
        by one chunk each, then advance every active sequence by one
        token (plain decode) or up to ``draft_len + 1`` (speculative
        verify).  Returns True when any work happened."""
        admitted = self._admit()
        progressed = False
        if self.dcfg.prefill_chunk is not None:
            progressed = self._advance_chunks()
        if not self._active.any():
            return admitted > 0 or progressed
        if self.dcfg.draft_len > 0:
            self._step_verify()
        else:
            self._step_decode()
        return True

    def _finish_if_done(self, i: int, tok: int) -> None:
        s = self._slots[i]
        if (len(s.generated) >= s.request.max_new_tokens
                or (s.request.eos_id is not None and tok == s.request.eos_id)):
            self._evict(i)

    def _step_decode(self) -> None:
        B = self.dcfg.max_batch
        self._cow_for_writes(width=1)
        seeds = np.zeros((B,), np.int64)
        for i in range(B):
            if self._active[i]:
                seeds[i] = self._seed(i)
        self.pools, next_tokens = self._call(
            self._decode, self.params, self.pools, self._host(self._tokens, torch.long),
            self._host(self._positions, torch.long), self._host(self._active, torch.bool),
            self._host(self._page_tables, torch.int32), self._host(seeds, torch.long))
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
            self._finish_if_done(i, tok)

    def _step_verify(self) -> None:
        """The speculative step: draft, verify all ``draft_len + 1``
        positions in one pass, keep the longest matching prefix a slot.
        Emissions spend the same (slot, draw) seeds as the plain decode
        step would."""
        B = self.dcfg.max_batch
        W = self.dcfg.draft_len + 1
        self._cow_for_writes(width=W)
        tokmat = np.zeros((B, W), np.int64)
        seeds = np.zeros((B, W), np.int64)
        for i in range(B):
            if not self._active[i]:
                continue
            tokmat[i, 0] = self._tokens[i]
            drafts = self._slots[i].proposer.propose()
            if drafts:
                k = min(len(drafts), W - 1)
                tokmat[i, 1:1 + k] = drafts[:k]
            d0 = int(self._draws[i])
            for j in range(W):
                seeds[i, j] = self._seed_at(i, d0 + j)
        self.pools, sampled = self._call(
            self._verify, self.params, self.pools, self._host(tokmat, torch.long),
            self._host(self._positions, torch.long), self._host(self._active, torch.bool),
            self._host(self._page_tables, torch.int32), self._host(seeds, torch.long))
        sampled = sampled.cpu().numpy()
        now = self._time()
        self.stats["decode_steps"] += 1
        self.stats["spec_steps"] += 1
        for i in range(B):
            if not self._active[i]:
                continue
            s = self._slots[i]
            out: List[int] = []
            for tok in accepted_tokens(tokmat[i], sampled[i]):
                # clamp to the generation budget and eos
                out.append(tok)
                if s.request.eos_id is not None and tok == s.request.eos_id:
                    break
                if len(s.generated) + len(out) >= s.request.max_new_tokens:
                    break
            self._draws[i] += len(out)  # one draw per emission
            s.generated.extend(out)
            s.token_times.extend([now] * len(out))
            s.proposer.extend(out)
            self.stats["spec_emitted"] += len(out)
            self._tokens[i] = out[-1]
            self._positions[i] += len(out)
            self._finish_if_done(i, out[-1])

    def run_until_drained(self, max_steps: int = 10_000) -> List[Completion]:
        """Drive :meth:`step` until both queues and the slots are empty."""
        for _ in range(max_steps):
            if self.idle():
                return self.completed
            self.step()
        raise RuntimeError(
            f"serve loop not drained after {max_steps} steps "
            f"(queue={len(self.queue) + len(self.be_queue)}, active={self.num_active})")
