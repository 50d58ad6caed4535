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

**Hooks** (the JAX scheduler's, all host code around the steps; none
goes inside a graph, and the streams with them on are token for token
those with them off):

- **metrics** (``metrics=True``; off by default, and then nothing is
  recorded a step or a token) on the current registry (``with
  MetricsScope(reg):`` around the serve loop routes them): the gauges ``apex_serve_queue_depth``,
  ``apex_serve_lane_queue_depth{lane}``, ``apex_serve_active_slots`` and
  ``apex_serve_free_pages``; the histograms
  ``apex_serve_admission_wait_seconds``, ``apex_serve_ttft_seconds`` and
  ``apex_serve_inter_token_seconds`` by lane, each sample with a
  ``{trace_id, rid}`` exemplar; counters for completions, tokens,
  preemptions, copies, cancellations and verify emissions;
- **tracing**: every request gets a ``trace_id`` at ``submit``; with a
  tracer installed the scheduler records ``serve.admission_wait``,
  ``serve.prefill`` / ``serve.prefill_chunk``, ``serve.decode_step`` /
  ``serve.verify_step`` (the resident trace ids, the verify step's
  emitted count) and the whole-lifetime ``serve.request`` span; a
  flight recorder listening on the tracer keeps them;
- **anomaly**: ``anomaly=`` (an
  :class:`~apex_tpu_torch.observability.anomaly.AnomalyMonitor`) scores
  every TTFT and inter-token sample by lane;
- **watchdog**: ``watchdog=`` (a
  :class:`~apex_tpu_torch.resilience.StepWatchdog`) gets a heartbeat
  each scheduler step, the first with its first-step allowance (which
  covers the graph captures and the kernels' build).  A step that never
  returns fires it: the ``on_wedge`` hook logs ``serve.step_wedged``
  with the whole :meth:`~ContinuousBatchingScheduler.drain_manifest`
  (every queued and in-flight request, with the tokens it has emitted)
  and records ``apex_serve_wedges_total``; the watchdog then drains and
  exits 75, for a :class:`~apex_tpu_torch.resilience.supervisor
  .Supervisor` to restart the server;
- **chaos**: an active :class:`~apex_tpu_torch.resilience.chaos
  .ChaosMonkey` may wedge a step (its ``wedge_step_at``, keyed on the
  decode steps taken), beside the heartbeat;
- **drain**: :meth:`~ContinuousBatchingScheduler.begin_drain` stops
  admission and hands the queued requests back as a manifest;
  :meth:`~ContinuousBatchingScheduler.cancel` takes a queued request
  back;
- **uniformity**: the decode and model configs are recorded as
  ``serve.scheduler_config`` (:func:`~apex_tpu_torch.resilience
  .uniformity.assert_uniform`).

The JAX scheduler's step rebuild after a kernel failure has no
counterpart: there is no fallback to rebuild into.
"""

import dataclasses
import logging
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
from apex_tpu_torch.observability import metrics as _metrics
from apex_tpu_torch.observability import tracing as _tracing
from apex_tpu_torch.resilience.chaos import active_monkey
from apex_tpu_torch.resilience.uniformity import assert_uniform
from apex_tpu_torch.utils.logging import get_logger, log_structured

__all__ = ["LANES", "Completion", "ContinuousBatchingScheduler", "ManifestEntry", "Request"]

_logger = get_logger("apex_tpu_torch.inference")

_MASK32 = (1 << 32) - 1

#: admission lanes, in priority order: ``interactive`` requests carry
#: the latency objective (strict FIFO, worst-case reservation, may
#: preempt); ``best_effort`` fills leftover capacity and is preemptible
LANES = ("interactive", "best_effort")


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` token ids, ``max_new_tokens``
    to generate, optional ``eos_id`` early stop, and the admission
    ``lane`` (see :data:`LANES`).  ``trace_id`` is assigned at
    ``submit`` unless the caller brings one; every span and histogram
    exemplar of the request carries it."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    lane: str = "interactive"
    trace_id: Optional[str] = None


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
    trace_id: Optional[str] = None


@dataclasses.dataclass
class ManifestEntry:
    """One unfinished request in a :meth:`ContinuousBatchingScheduler
    .drain_manifest` snapshot: what a frontend needs to resubmit it
    elsewhere and splice the continuation into the caller's stream — the
    original prompt (of all legs), every token already emitted
    (``emitted``, the splice point) and the tokens still owed
    (``remaining``).  The replay request is ``Request(rid, prompt +
    emitted, remaining, eos_id, lane, trace_id)``."""

    rid: int
    lane: str
    phase: str                     # "queued" | "in_flight"
    prompt: List[int]              # original prompt (all legs)
    emitted: List[int]             # tokens already emitted, in order
    remaining: int                 # new tokens still owed
    eos_id: Optional[int] = None
    trace_id: Optional[str] = None


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
    submitted_at: float = 0.0      # the submit time (the TTFT's base)
    shared_len: int = 0            # prompt positions served by shared pages
    cow_reserve: Optional[int] = None
    chunk_next: Optional[int] = None  # next prompt position to chunk-prefill
    proposer: Optional[NGramProposer] = None


class _NoMetrics:
    """The metrics helpers (``inc``, ``observe``, ``set_gauge``), recording
    nothing: a scheduler built without ``metrics``."""

    @staticmethod
    def _none(*args, **kwargs) -> None:
        pass

    inc = observe = set_gauge = _none


class ContinuousBatchingScheduler:
    """Lane-aware admission into freed KV pages between steps, fixed slot
    shapes, chunked prefill, speculative verify, prefix sharing with
    copy-on-write, eviction with refcounted page recycling, and
    deterministic per-slot sampling seeds (see the module docstring).
    ``params`` are the port's params
    (:func:`apex_tpu_torch.models.gpt.params_from_numpy`) on ``device``;
    the KV pools are allocated there.  ``graphs``: None (the default)
    compiles the steps, False runs the plain steps eagerly.
    ``metrics`` / ``watchdog`` / ``anomaly``: the hooks of the module
    docstring."""

    def __init__(self, params, config: GPTConfig, dcfg: DecodeConfig,
                 time_fn=time.monotonic, device="cuda", graphs=None, watchdog=None,
                 anomaly=None, metrics: bool = False):
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
        self._draining = False
        # record-only uniformity seam: the serve config shapes every
        # compiled step (batch and page shapes, the lanes); a rank of a
        # multi-process server with another one would run another program
        assert_uniform("serve.scheduler_config", {
            "decode": dataclasses.asdict(dcfg), "model": dataclasses.asdict(config)})
        #: the submit time of each queued rid (``Completion.submit_time``
        #: is the admit time; the admission-wait and TTFT histograms need
        #: the submit)
        self._submit_times: Dict[int, float] = {}
        self._m = _metrics if metrics else _NoMetrics
        self._anomaly = anomaly
        self._watchdog = watchdog
        self._beaten = False
        if watchdog is not None:
            # chain, don't replace: the driver may have its own hook
            prev = watchdog.on_wedge

            def hook(info, _prev=prev):
                if _prev is not None:
                    _prev(info)
                self._on_wedge(info)

            watchdog.on_wedge = hook
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

    # ------------------------------------------------------------ hooks
    def drain_manifest(self) -> List[ManifestEntry]:
        """Every unfinished request — queued (both lanes), then in
        flight — with the tokens each has emitted over all its legs, for
        a frontend to resubmit elsewhere and splice.  It changes nothing
        and takes no lock: ``list()`` copies of the queues and slots make
        it safe to call from the watchdog thread (whose decode thread is
        wedged when it does)."""
        out: List[ManifestEntry] = []
        for req in list(self.queue) + list(self.be_queue):
            c = self._carry.get(req.rid)
            out.append(ManifestEntry(
                rid=req.rid, lane=req.lane, phase="queued",
                prompt=list(c.prompt) if c is not None else list(req.prompt),
                emitted=list(c.tokens) if c is not None else [],
                remaining=req.max_new_tokens, eos_id=req.eos_id, trace_id=req.trace_id))
        for s in list(self._slots):
            if s is None:
                continue
            req = s.request
            c = self._carry.get(req.rid)
            gen = list(s.generated)
            out.append(ManifestEntry(
                rid=req.rid, lane=req.lane, phase="in_flight",
                prompt=list(c.prompt) if c is not None else list(req.prompt),
                emitted=(list(c.tokens) if c is not None else []) + gen,
                remaining=req.max_new_tokens - len(gen), eos_id=req.eos_id,
                trace_id=req.trace_id))
        return out

    def _on_wedge(self, info) -> None:
        """The watchdog's pre-exit hook: one ``serve.step_wedged`` record
        carrying the whole manifest (untruncated: it is the requeue
        manifest), and the wedge counter."""
        manifest = self.drain_manifest()
        queued = [m.rid for m in manifest if m.phase == "queued"]
        inflight = [m.rid for m in manifest if m.phase == "in_flight"]
        log_structured(
            _logger, logging.ERROR, "serve.step_wedged",
            decode_step=self.stats["decode_steps"], queued_rids=queued,
            inflight_rids=inflight, queued=len(queued), inflight=len(inflight),
            manifest=[dataclasses.asdict(m) for m in manifest],
            elapsed_s=info.get("elapsed_s"))
        _metrics.inc("apex_serve_wedges_total",
                     help="decode steps the watchdog declared wedged")

    def _active_trace_ids(self) -> List[str]:
        """The resident requests' trace ids, in slot order (the decode
        and verify spans carry them)."""
        return [self._slots[i].request.trace_id for i in range(self.dcfg.max_batch)
                if self._active[i] and self._slots[i] is not None
                and self._slots[i].request.trace_id is not None]

    def _record_occupancy(self) -> None:
        """The serving gauges on the current registry."""
        if self._m is _NoMetrics:
            return
        self._m.set_gauge("apex_serve_queue_depth", len(self.queue) + len(self.be_queue),
                           help="requests waiting for a slot+pages")
        self._m.set_gauge("apex_serve_lane_queue_depth", len(self.queue),
                           help="waiting requests, by lane", lane="interactive")
        self._m.set_gauge("apex_serve_lane_queue_depth", len(self.be_queue),
                           help="waiting requests, by lane", lane="best_effort")
        self._m.set_gauge("apex_serve_active_slots", self.num_active,
                           help="resident decoding sequences")
        self._m.set_gauge("apex_serve_free_pages", self.allocator.free_pages,
                           help="allocatable KV pages")

    def _inter_token(self, s: "_Slot", now: float) -> None:
        """One inter-token sample of slot ``s`` (histogram and anomaly)."""
        if self._m is _NoMetrics and self._anomaly is None:
            return
        dt = now - s.token_times[-1]
        self._m.observe("apex_serve_inter_token_seconds", dt,
                         help="previous token -> this token",
                         exemplar={"trace_id": s.request.trace_id, "rid": s.request.rid},
                         lane=s.request.lane)
        if self._anomaly is not None:
            self._anomaly.observe("inter_token", dt, lane=s.request.lane)

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
        queue head; a draining scheduler refuses every request."""
        if self._draining:
            raise RuntimeError("scheduler is draining (begin_drain) — submit to another "
                               "replica")
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
        if request.trace_id is None:
            request.trace_id = _tracing.new_trace_id()
        self._submit_times[request.rid] = self._time()
        (self.queue if request.lane == "interactive" else self.be_queue).append(request)
        self._record_occupancy()

    def cancel(self, rid: int) -> Optional[Request]:
        """Take a still-queued request (either lane) back and return it;
        None when ``rid`` is resident or unknown (a decoding sequence is
        not cancelled mid-step: the caller drops its output)."""
        for q in (self.queue, self.be_queue):
            for req in q:
                if req.rid == rid:
                    q.remove(req)
                    self._submit_times.pop(rid, None)
                    self._carry.pop(rid, None)
                    self._m.inc("apex_serve_cancelled_total",
                                 help="queued requests cancelled before admission")
                    self._record_occupancy()
                    return req
        return None

    @property
    def draining(self) -> bool:
        return self._draining

    def drained(self) -> bool:
        """True once a draining scheduler has no residents left: the
        point where stopping the server drops nothing."""
        return self._draining and all(s is None for s in self._slots)

    def begin_drain(self) -> List[ManifestEntry]:
        """A planned restart: stop admitting (``submit`` raises, admission
        does nothing), hand back the queued requests as a manifest, and
        let the residents finish through the usual step and eviction.
        The caller routes the entries elsewhere and polls
        :meth:`drained`."""
        self._draining = True
        manifest = [m for m in self.drain_manifest() if m.phase == "queued"]
        for m in manifest:
            self._submit_times.pop(m.rid, None)
            self._carry.pop(m.rid, None)
        self.queue.clear()
        self.be_queue.clear()
        log_structured(_logger, logging.INFO, "serve.drain_begun", requeued=len(manifest),
                       residents=self.num_active)
        self._record_occupancy()
        return manifest

    def _epoch(self, mono: float) -> float:
        """The epoch time of the instant ``mono`` of ``time_fn`` (spans
        emitted after the fact are stamped in wall time)."""
        return time.time() - (self._time() - mono)

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
        if self._draining:
            return 0
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
        submitted = self._submit_times.pop(req.rid, t0)
        self._m.observe("apex_serve_admission_wait_seconds", t0 - submitted,
                         help="submit -> slot+pages reserved",
                         exemplar={"trace_id": req.trace_id, "rid": req.rid}, lane=req.lane)
        tracer = _tracing.get_tracer()
        if tracer is not None:
            # both ends are known only now: emit the wait after the fact
            tracer.emit("serve.admission_wait", self._epoch(submitted), t0 - submitted,
                        rid=req.rid, trace_id=req.trace_id, lane=req.lane)
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
                  submit_time=t0, admit_seq=self._admit_counter, submitted_at=submitted,
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
        with _tracing.span("serve.prefill", rid=req.rid, trace_id=req.trace_id,
                           lane=req.lane, prompt_len=plen, shared_len=match.shared_len):
            self.pools, first = self._call(
                self._prefill, self.params, self.pools, self._host(prompt, torch.long), plen,
                match.shared_len, self._host(row, torch.int32), self._host(seed, torch.long))
            first = int(first.cpu()[0])
        self.stats["prefills"] += 1
        self._start_decoding(slot, first, submitted)

    def _start_decoding(self, slot: int, first: int, submitted: float) -> None:
        """The prefill epilogue (one-shot and chunked): record the first
        token, index the prompt's full pages in the trie, arm the slot
        and the proposer, and evict a 1-token or instant-eos generation
        at once."""
        s = self._slots[slot]
        req = s.request
        t_first = self._time()
        self._m.observe("apex_serve_ttft_seconds", t_first - submitted,
                         help="submit -> first token (prefill incl. queue)",
                         exemplar={"trace_id": req.trace_id, "rid": req.rid}, lane=req.lane)
        if self._anomaly is not None:
            self._anomaly.observe("ttft", t_first - submitted, lane=req.lane)
        s.generated.append(first)
        s.token_times.append(t_first)
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
                           eos_id=req.eos_id, lane=req.lane, trace_id=req.trace_id)
        else:  # restart this leg (its partial work is dropped)
            cont = Request(rid=req.rid, prompt=list(req.prompt),
                           max_new_tokens=req.max_new_tokens, eos_id=req.eos_id,
                           lane=req.lane, trace_id=req.trace_id)
        self._release_slot(victim)
        self.stats["preemptions"] += 1
        self._m.inc("apex_serve_preemptions_total",
                     help="best-effort residents evicted for the interactive lane")
        log_structured(_logger, logging.INFO, "serve.preempted", rid=req.rid,
                       generated=len(s.generated), requeued_prompt=len(cont.prompt))
        self._submit_times[req.rid] = self._time()
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
        finish = self._time()
        self.completed.append(Completion(
            rid=s.request.rid, prompt=prompt, tokens=tokens, submit_time=submit,
            finish_time=finish, token_times=times, lane=s.request.lane,
            preemptions=c.preemptions if c is not None else 0, trace_id=s.request.trace_id))
        tracer = _tracing.get_tracer()
        if tracer is not None:
            # the whole-lifetime span (admit -> eviction), which the TTFT
            # exemplar's trace_id joins to
            tracer.emit("serve.request", self._epoch(submit), finish - submit,
                        rid=s.request.rid, trace_id=s.request.trace_id,
                        lane=s.request.lane, tokens=len(tokens),
                        ttft_s=round(times[0] - submit, 6) if times else None,
                        preemptions=c.preemptions if c is not None else 0)
        self.stats["evicted"] += 1
        self._m.inc("apex_serve_completions_total", help="finished generations")
        self._m.inc("apex_serve_generated_tokens_total", len(tokens), help="tokens served")
        self._record_occupancy()

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
            with _tracing.span("serve.prefill_chunk", rid=s.request.rid,
                               trace_id=s.request.trace_id, lane=s.request.lane,
                               chunk_start=start, chunk_tokens=n_valid):
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
                self._start_decoding(i, int(first.cpu()[0]), s.submitted_at)
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
                self._m.inc("apex_serve_cow_copies_total",
                             help="shared pages copied before a divergent write")

    # -------------------------------------------------------------- step
    def step(self) -> bool:
        """Admit waiting requests (both lanes), advance chunked prefills
        by one chunk each, then advance every active sequence by one
        token (plain decode) or up to ``draft_len + 1`` (speculative
        verify).  Returns True when any work happened.  First the
        watchdog's heartbeat (the first with its first-step allowance)
        and an active chaos plan's wedge of this step."""
        if self._watchdog is not None:
            self._watchdog.beat(
                self.stats["decode_steps"],
                deadline=self._watchdog.first_deadline_sec if not self._beaten else None)
            self._beaten = True
        monkey = active_monkey()
        if monkey is not None:
            # the planned wedge holds this step past the watchdog's
            # deadline, as a hung kernel would (keyed on decode steps)
            monkey.maybe_wedge_step(self.stats["decode_steps"])
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
        # the attributes are worth computing only with a tracer: this is
        # the most frequent span of the serving path
        attrs = (dict(decode_step=self.stats["decode_steps"], active=self.num_active,
                      trace_ids=self._active_trace_ids()) if _tracing.enabled() else {})
        with _tracing.span("serve.decode_step", **attrs):
            self.pools, next_tokens = self._call(
                self._decode, self.params, self.pools, self._host(self._tokens, torch.long),
                self._host(self._positions, torch.long), self._host(self._active, torch.bool),
                self._host(self._page_tables, torch.int32), self._host(seeds, torch.long))
            next_tokens = next_tokens.cpu().numpy()
        now = self._time()
        self.stats["decode_steps"] += 1
        self._record_occupancy()
        for i in range(B):
            if not self._active[i]:
                continue
            s = self._slots[i]
            tok = int(next_tokens[i])
            self._inter_token(s, now)
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
        # ended by hand, so that the accepted count (known after the host
        # accepts) rides its attributes
        attrs = (dict(decode_step=self.stats["decode_steps"], active=self.num_active,
                      draft_len=W - 1, trace_ids=self._active_trace_ids())
                 if _tracing.enabled() else {})
        verify_span = _tracing.span("serve.verify_step", **attrs)
        emitted_before = self.stats["spec_emitted"]
        try:
            self.pools, sampled = self._call(
                self._verify, self.params, self.pools, self._host(tokmat, torch.long),
                self._host(self._positions, torch.long), self._host(self._active, torch.bool),
                self._host(self._page_tables, torch.int32), self._host(seeds, torch.long))
            sampled = sampled.cpu().numpy()
            now = self._time()
            self.stats["decode_steps"] += 1
            self.stats["spec_steps"] += 1
            self._record_occupancy()
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
                for tok in out:
                    self._inter_token(s, now)
                    s.generated.append(tok)
                    s.token_times.append(now)
                s.proposer.extend(out)
                self.stats["spec_emitted"] += len(out)
                self._m.inc("apex_serve_spec_emitted_total", len(out),
                             help="tokens emitted by verify steps")
                self._tokens[i] = out[-1]
                self._positions[i] += len(out)
                self._finish_if_done(i, out[-1])
        except BaseException:
            verify_span.set(error=True)
            raise
        finally:
            # the accept loop can raise too: the span never stays open
            verify_span.end(emitted=self.stats["spec_emitted"] - emitted_before)

    def run_until_drained(self, max_steps: int = 10_000) -> List[Completion]:
        """Drive :meth:`step` until both queues and the slots are empty."""
        for _ in range(max_steps):
            if self.idle():
                return self.completed
            self.step()
        raise RuntimeError(
            f"serve loop not drained after {max_steps} steps "
            f"(queue={len(self.queue) + len(self.be_queue)}, active={self.num_active})")
