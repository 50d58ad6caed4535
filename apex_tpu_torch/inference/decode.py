"""The single-token decode step and the prompt prefill step.

Counterpart of :mod:`apex_tpu.inference.decode` (``DecodeConfig``,
``make_decode_step``, ``make_prefill``).  The steps are plain callables
run under ``torch.inference_mode()``, not compiled: the decode step is
the embedding, every block through
:func:`apex_tpu_torch.models.gpt.forward_decode` (paged decode
attention), and the fused sampling head; the prefill runs the prompt
through :func:`~apex_tpu_torch.models.gpt.gpt_forward` at one padded
length, writes its k/v into the sequence's pages, and samples the first
token from the last prompt position.  Both update the KV pools in place
(the JAX package donates them).

Speculative decoding (``draft_len``), chunked prefill
(``prefill_chunk``) and prefix sharing come in later slices; setting
them raises.
"""

import dataclasses

import torch

from apex_tpu_torch.inference.kv_cache import KVCacheConfig, write_prompt_kv
from apex_tpu_torch.models.gpt import GPTConfig, forward_decode, gpt_forward
from apex_tpu_torch.ops.decode_sampling import fused_sample

__all__ = ["DecodeConfig", "make_decode_step", "make_prefill"]


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Serving configuration.  ``max_batch``: decode slots (the step's
    batch).  ``max_prompt_len``: the prefill pad length.
    ``temperature``/``top_k``: the sampling head (``temperature=0`` is
    greedy and ignores ``top_k``).  ``base_seed``: the sampling seeds'
    base.  ``draft_len``, ``prefill_chunk`` and ``prefix_sharing`` keep
    the JAX package's names and must stay off in this slice."""

    cache: KVCacheConfig = dataclasses.field(default_factory=KVCacheConfig)
    max_batch: int = 8
    max_prompt_len: int = 128
    temperature: float = 1.0
    top_k: int = 0
    base_seed: int = 0
    draft_len: int = 0
    prefill_chunk: int = None
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
        for name, on in (("draft_len", self.draft_len != 0),
                         ("prefill_chunk", self.prefill_chunk is not None),
                         ("prefix_sharing", self.prefix_sharing)):
            if on:
                raise NotImplementedError(
                    f"DecodeConfig.{name} is not ported yet (speculative "
                    f"decoding, chunked prefill and prefix sharing come in "
                    f"later slices)")


def make_decode_step(config: GPTConfig, dcfg: DecodeConfig):
    """The one-token-per-sequence decode step,
    ``step(params, pools, tokens, positions, active, page_tables, seeds)
    -> (pools, next_tokens)``: ``tokens``/``positions``/``active`` (B,),
    ``page_tables`` (B, P) int32, ``seeds`` (B,) int64 holding uint32
    sampling counters, all on the params' device.  ``pools`` is written
    in place and returned."""

    @torch.inference_mode()
    def step(params, pools, tokens, positions, active, page_tables, seeds):
        hidden, pools = forward_decode(params, tokens, positions, active, pools,
                                       page_tables, config)
        return pools, fused_sample(hidden, params["embed"], seeds,
                                   temperature=dcfg.temperature, top_k=dcfg.top_k)

    return step


def make_prefill(config: GPTConfig, dcfg: DecodeConfig):
    """The prompt prefill step, ``prefill(params, pools, prompt,
    prompt_len, start, page_table_row, seed) -> (pools, first_token)``:
    ``prompt`` (1, max_prompt_len) int (zero-padded past ``prompt_len``;
    the pad tail's k/v go to the garbage page), ``start`` the write
    window (0 = write every prompt position), ``page_table_row`` (P,)
    int32, ``seed`` (1,) int64.  ``first_token`` is a (1,) int32 tensor
    sampled from the last prompt position."""
    S = dcfg.max_prompt_len

    @torch.inference_mode()
    def prefill(params, pools, prompt, prompt_len, start, page_table_row, seed):
        hidden, (k_stack, v_stack) = gpt_forward(params, prompt, config,
                                                 return_hidden=True, return_kv=True)
        ks = k_stack[:, 0].transpose(1, 2)  # (L, S, KVH, hd)
        vs = v_stack[:, 0].transpose(1, 2)
        write_prompt_kv(pools["k"], pools["v"], ks, vs, page_table_row,
                        prompt_len, start=start)
        h_last = hidden[min(max(int(prompt_len) - 1, 0), S - 1), 0]
        first = fused_sample(h_last[None].contiguous(), params["embed"], seed,
                             temperature=dcfg.temperature, top_k=dcfg.top_k)
        return pools, first

    return prefill
