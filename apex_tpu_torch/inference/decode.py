"""The decode, verify, prefill, prefill-chunk and sampling-head steps.

Counterpart of :mod:`apex_tpu.inference.decode` (``DecodeConfig``,
``make_decode_step``, ``make_verify_step``, ``make_prefill``,
``make_prefill_chunk``, ``make_sample_head``).  Each builder returns a
compiled step, as the JAX package's ``jax.jit(..., donate_argnums=(1,))``
does: a :class:`~apex_tpu_torch.graphs.CapturedStep` that captures the
step as a CUDA graph over static buffers on its first call on the card
(an eager warm-up), replays it on every later call, and runs the same
static buffers without capture on the CPU.  ``graphs=False`` returns the
plain callable under ``torch.inference_mode()`` instead, the counterpart
of ``JAX_DISABLE_JIT=1``.  No step body reads a device value on the host:
``prompt_len``, ``start``, ``start_pos``, ``valid`` and ``write_start``
may be ints or 0-d tensors, and enter as device arithmetic.

- the decode step is the embedding, every block through
  :func:`apex_tpu_torch.models.gpt.forward_decode` (paged decode
  attention, ``width == 1``), and the fused sampling head;
- the verify step (speculative decoding, ``draft_len`` k > 0) is the
  decode step at ``W = k + 1`` positions a slot: one pass through
  ``forward_decode(verify_width=W)`` (the attention kernel's
  ``width > 1`` layout) and one sampling launch over all B·W rows;
- the prefill runs the prompt through
  :func:`~apex_tpu_torch.models.gpt.gpt_forward` at one padded length,
  writes its k/v into the sequence's pages, and samples the first token
  from the last prompt position;
- the prefill chunk (``prefill_chunk`` C) runs C prompt positions
  through ``forward_decode(verify_width=C)`` and returns the last valid
  position's hidden state; the sampling head turns it into the first
  token once the final chunk lands.

Every step updates the KV pools in place (the JAX package donates
them), and a compiled step refuses pools or params other than those it
was built over.  ``pool`` (``torch.cuda.graph_pool_handle()``) lets the
steps of one scheduler share their graphs' memory: they never run at
the same time, and each step's outputs are read before the next runs.
"""

import dataclasses
from typing import Optional

import torch

from apex_tpu_torch.graphs import CapturedStep
from apex_tpu_torch.inference.kv_cache import KVCacheConfig, write_prompt_kv
from apex_tpu_torch.models.gpt import GPTConfig, forward_decode, gpt_forward
from apex_tpu_torch.ops.decode_sampling import fused_sample

__all__ = [
    "DecodeConfig", "make_decode_step", "make_prefill", "make_prefill_chunk",
    "make_sample_head", "make_verify_step",
]


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Serving configuration.  ``max_batch``: decode slots (the step's
    batch).  ``max_prompt_len``: the prefill pad length.
    ``temperature``/``top_k``: the sampling head (``temperature=0`` is
    greedy and ignores ``top_k``).  ``base_seed``: the sampling seeds'
    base.

    Serving v2, all off by default: ``draft_len`` k > 0 turns on
    speculative decoding (n-gram drafts of up to k tokens verified per
    step through the ``k + 1``-wide verify step), with
    ``ngram_max``/``ngram_min`` bounding the prompt-lookup sweep;
    ``prefill_chunk`` C admits prompts as C-token chunks interleaved
    with decode steps (any prompt length up to the page table's);
    ``prefix_sharing`` dedupes identical prompt-prefix pages through the
    refcounted trie (:mod:`apex_tpu_torch.inference.prefix`) with
    copy-on-write at the first divergent write."""

    cache: KVCacheConfig = dataclasses.field(default_factory=KVCacheConfig)
    max_batch: int = 8
    max_prompt_len: int = 128
    temperature: float = 1.0
    top_k: int = 0
    base_seed: int = 0
    draft_len: int = 0
    ngram_max: int = 3
    ngram_min: int = 1
    prefill_chunk: Optional[int] = None
    prefix_sharing: bool = False

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0 (got {self.temperature}); "
                "0 means greedy")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (got {self.top_k})")
        if self.draft_len < 0:
            raise ValueError(f"draft_len must be >= 0 (got "
                             f"{self.draft_len}); 0 disables speculation")
        if not (1 <= self.ngram_min <= self.ngram_max):
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"({self.ngram_min}, {self.ngram_max})")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1 (got "
                             f"{self.prefill_chunk}); None disables it")


def _compiled(fn, graphs, pool, donate=(0, 1)):
    """``fn`` itself with ``graphs=False``; otherwise (None) ``fn`` as a
    :class:`~apex_tpu_torch.graphs.CapturedStep` with ``donate`` (the
    params and the pools) referenced."""
    if graphs is False:
        return fn
    return CapturedStep(fn, donate=donate, pool=pool)


def make_decode_step(config: GPTConfig, dcfg: DecodeConfig, graphs=None, pool=None):
    """The one-token-per-sequence decode step,
    ``step(params, pools, tokens, positions, active, page_tables, seeds)
    -> (pools, next_tokens)``: ``tokens``/``positions``/``active`` (B,),
    ``page_tables`` (B, P) int32, ``seeds`` (B,) int64 holding uint32
    sampling counters.  ``pools`` is written in place and returned.
    Compiled unless ``graphs=False`` (module docstring); the plain step
    takes its inputs on the params' device."""

    @torch.inference_mode()
    def step(params, pools, tokens, positions, active, page_tables, seeds):
        hidden, pools = forward_decode(params, tokens, positions, active, pools,
                                       page_tables, config)
        return pools, fused_sample(hidden, params["embed"], seeds,
                                   temperature=dcfg.temperature, top_k=dcfg.top_k)

    return _compiled(step, graphs, pool)


def make_verify_step(config: GPTConfig, dcfg: DecodeConfig, graphs=None, pool=None):
    """The speculative verify step, the decode step grown to
    ``W = draft_len + 1`` positions a slot: ``verify(params, pools,
    tokens, positions, active, page_tables, seeds) -> (pools, sampled)``
    with ``tokens`` (B, W) (column 0 the slot's current token, columns
    1..k its drafts), ``positions``/``active`` (B,) as in the decode
    step, ``page_tables`` (B, P) int32, ``seeds`` (B, W) int64 holding
    the slot's next W uint32 draw counters, and ``sampled`` (B, W) int32:
    the sampling head's token at every verified position.

    One pass scores all B·W positions (each layer writes the W rows'
    k/v, then every row attends at its own length) and one sampling
    launch draws them all.  The host keeps the longest prefix where
    ``sampled[:, j-1] == tokens[:, j]``
    (:func:`apex_tpu_torch.inference.spec.accepted_tokens`): each kept
    token is conditioned on a verified prefix and spends the seed the
    plain decode step would, so the stream is the non-speculative one.
    Compiled unless ``graphs=False``."""
    W = dcfg.draft_len + 1

    @torch.inference_mode()
    def verify(params, pools, tokens, positions, active, page_tables, seeds):
        B = tokens.shape[0]
        off = torch.arange(W, device=positions.device)
        pos_f = (positions.long()[:, None] + off[None, :]).reshape(B * W)
        hidden, pools = forward_decode(
            params, tokens.reshape(B * W), pos_f, active.repeat_interleave(W),
            pools, page_tables, config, verify_width=W)
        sampled = fused_sample(hidden, params["embed"], seeds.reshape(B * W),
                               temperature=dcfg.temperature, top_k=dcfg.top_k)
        return pools, sampled.reshape(B, W)

    return _compiled(verify, graphs, pool)


def make_prefill(config: GPTConfig, dcfg: DecodeConfig, graphs=None, pool=None):
    """The prompt prefill step, ``prefill(params, pools, prompt,
    prompt_len, start, page_table_row, seed) -> (pools, first_token)``:
    ``prompt`` (1, max_prompt_len) int (zero-padded past ``prompt_len``;
    the pad tail's k/v go to the garbage page), ``start`` the write
    window (0 = write every prompt position), both ints or 0-d tensors,
    ``page_table_row`` (P,) int32, ``seed`` (1,) int64.  ``first_token``
    is a (1,) int32 tensor sampled from the last prompt position, picked
    on the device.  Compiled unless ``graphs=False``."""
    S = dcfg.max_prompt_len

    @torch.inference_mode()
    def prefill(params, pools, prompt, prompt_len, start, page_table_row, seed):
        hidden, (k_stack, v_stack) = gpt_forward(params, prompt, config,
                                                 return_hidden=True, return_kv=True)
        ks = k_stack[:, 0].transpose(1, 2)  # (L, S, KVH, hd)
        vs = v_stack[:, 0].transpose(1, 2)
        write_prompt_kv(pools["k"], pools["v"], ks, vs, page_table_row,
                        prompt_len, start=start)
        last = torch.clamp(torch.as_tensor(prompt_len, device=hidden.device) - 1,
                           0, S - 1).reshape(1)
        h_last = hidden[:, 0].index_select(0, last)  # (1, H)
        first = fused_sample(h_last, params["embed"], seed,
                             temperature=dcfg.temperature, top_k=dcfg.top_k)
        return pools, first

    return _compiled(prefill, graphs, pool)


def make_prefill_chunk(config: GPTConfig, dcfg: DecodeConfig, graphs=None, pool=None):
    """The chunked-prefill step, ``chunk(params, pools, tokens,
    start_pos, valid, write_start, page_table_row) -> (pools, h_last)``:
    ``tokens`` (C,) the prompt slice at positions ``start_pos ..
    start_pos + C - 1``, of which the first ``valid`` are real (the last
    chunk pads), through ``forward_decode(verify_width=C)``: each layer
    writes the chunk's k/v into the sequence's pages, then every
    position attends over the whole cached prefix plus its predecessors
    in the chunk.  Positions below ``write_start`` (shared-prefix pages,
    or a recompute pass over cached positions) skip the write.
    ``start_pos``, ``valid`` and ``write_start`` are ints or 0-d tensors;
    ``page_table_row`` is (P,) int32.  ``h_last`` (H,) is the last valid
    position's hidden state, the sampling head's input once the final
    chunk lands (:func:`make_sample_head`).  Compiled unless
    ``graphs=False``."""
    C = int(dcfg.prefill_chunk)

    @torch.inference_mode()
    def chunk(params, pools, tokens, start_pos, valid, write_start, page_table_row):
        dev = tokens.device
        off = torch.arange(C, device=dev)
        pos = start_pos + off
        act = off < valid
        wmask = act & (pos >= write_start)
        hidden, pools = forward_decode(
            params, tokens, pos, act, pools, page_table_row[None], config,
            verify_width=C, write_mask=wmask)
        last = torch.clamp(torch.as_tensor(valid, device=dev) - 1, 0, C - 1).reshape(1)
        return pools, hidden.index_select(0, last)[0]

    return _compiled(chunk, graphs, pool)


def make_sample_head(config: GPTConfig, dcfg: DecodeConfig, graphs=None, pool=None):
    """The standalone sampling head, ``head(params, hidden, seed) ->
    token``: hidden (H,) and seed (1,) int64 to a (1,) int32 token, used
    once per chunked admission (sampling stays out of the chunk step, so
    intermediate chunks never pay the vocab product).  Compiled, the
    params referenced, unless ``graphs=False``."""
    del config  # the head is described by dcfg and the params

    @torch.inference_mode()
    def head(params, hidden, seed):
        return fused_sample(hidden[None].contiguous(), params["embed"], seed,
                            temperature=dcfg.temperature, top_k=dcfg.top_k)

    return _compiled(head, graphs, pool, donate=(0,))
