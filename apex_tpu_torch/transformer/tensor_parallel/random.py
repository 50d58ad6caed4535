"""Parallel RNG streams and activation checkpointing (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel.random`).

Reference: ``apex/transformer/tensor_parallel/random.py``:
``CudaRNGStatesTracker`` (:124), ``model_parallel_cuda_manual_seed``
(:204), ``CheckpointFunction`` / ``checkpoint`` (:237, :308).

The tracker holds named ``torch.Generator`` streams; :meth:`fork` hands
out the named generator, which random ops take explicitly
(``torch.rand(..., generator=g)``).  The seeds are the JAX package's
arithmetic (its :93-116), key for key: ``PRNGKey(seed)`` and
``fold_in`` are threefry-2x32 (computed here in numpy, bit for bit), the
data-parallel stream is the seed's key and the model-parallel stream
``fold_in(fold_in(fold_in(key, 2718 + 1), tp_rank), 100 + pp_rank)``, so
that dropout on split activations differs between tp ranks while the
default stream agrees.  A key's two words seed a generator as one
64-bit integer (:func:`generator_seed`).

:func:`checkpoint` is ``torch.utils.checkpoint`` (recompute in the
backward) with the tracker's generators restored for the recompute, as
the reference's ``CheckpointFunction`` restores them, so a recomputed
dropout draws what the forward drew.
"""

import contextlib
from typing import Dict

import numpy as np
import torch

__all__ = ["RNGStatesTracker", "get_rng_state_tracker", "get_cuda_rng_tracker",
           "model_parallel_seed", "model_parallel_cuda_manual_seed", "checkpoint",
           "prng_key", "fold_in", "generator_seed",
           "init_checkpointed_activations_memory_buffer",
           "reset_checkpointed_activations_memory_buffer"]

_MODEL_PARALLEL_RNG = "model-parallel-rng"

# the reference's offsets (random.py:204-220)
_TP_OFFSET = 2718
_PP_OFFSET = 100

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key, x0: int, x1: int):
    """Threefry-2x32 with 20 rounds of one (x0, x1) block under ``key``
    (two uint32 words), as JAX's ``threefry2x32_p`` computes it."""
    m = 0xFFFFFFFF
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x = [(x0 + ks[0]) & m, (x1 + ks[1]) & m]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & m
            x[1] = ((x[1] << r) | (x[1] >> (32 - r))) & m
            x[1] ^= x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & m
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & m
    return np.array(x, dtype=np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s two uint32 words (threefry)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``'s words."""
    return _threefry2x32(key, 0, int(data) & 0xFFFFFFFF)


def generator_seed(key) -> int:
    """The 64-bit ``torch.Generator`` seed of a key: its two words."""
    return (int(key[0]) << 32) | int(key[1])


def model_parallel_seed(seed: int, tp_rank: int, pp_rank: int = 0):
    """``(data_parallel_key, model_parallel_key)``, the JAX package's
    keys: the first the same on every tp rank, the second different per
    tp and pp rank."""
    base = prng_key(seed)
    mp_key = fold_in(fold_in(base, _TP_OFFSET + 1), tp_rank)
    if pp_rank is not None:
        mp_key = fold_in(mp_key, _PP_OFFSET * 1 + pp_rank)
    return base, mp_key


class RNGStatesTracker:
    """Named generator streams (reference ``CudaRNGStatesTracker``,
    random.py:124) on ``device`` (resolved when a stream is added;
    default ``"cuda"``, which raises without a GPU)."""

    def __init__(self, device="cuda"):
        self.device = device
        self.states_: Dict[str, torch.Generator] = {}
        self.counts_: Dict[str, int] = {}

    def reset(self):
        self.states_ = {}
        self.counts_ = {}

    def get_states(self) -> Dict[str, torch.Tensor]:
        """Each stream's generator state (a CPU byte tensor)."""
        return {name: g.get_state() for name, g in self.states_.items()}

    def set_states(self, states):
        """Restore :meth:`get_states`' snapshot into the streams."""
        for name, state in states.items():
            if name not in self.states_:
                raise KeyError(f"rng state {name} is not added")
            self.states_[name].set_state(torch.as_tensor(np.asarray(state), dtype=torch.uint8))

    def add(self, name: str, seed):
        """A stream seeded by ``seed``: an int or a key (two uint32
        words, :func:`model_parallel_seed`'s)."""
        from apex_tpu_torch._device import resolve_device

        if name in self.states_:
            raise Exception(f"rng state {name} already exists")
        s = int(seed) if np.ndim(seed) == 0 else generator_seed(seed)
        g = torch.Generator(device=resolve_device(self.device))
        g.manual_seed(s)
        self.states_[name] = g
        self.counts_[name] = 0

    def fork(self, name: str = _MODEL_PARALLEL_RNG) -> torch.Generator:
        """The named stream's generator, for the random ops that follow to
        take; each call counts one fork."""
        if name not in self.states_:
            raise Exception(f"rng state {name} is not added")
        self.counts_[name] += 1
        return self.states_[name]


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    """Reference: get_cuda_rng_tracker (random.py:194)."""
    return _TRACKER


get_cuda_rng_tracker = get_rng_state_tracker


def model_parallel_cuda_manual_seed(seed: int, tp_rank: int, pp_rank: int = 0,
                                    device="cuda") -> None:
    """Install the ``"default"`` and model-parallel streams of
    :func:`model_parallel_seed` in the global tracker, on ``device``."""
    _TRACKER.reset()
    _TRACKER.device = device
    dp_key, mp_key = model_parallel_seed(seed, tp_rank, pp_rank)
    _TRACKER.add("default", dp_key)
    _TRACKER.add(_MODEL_PARALLEL_RNG, mp_key)


def checkpoint(function, distribute_saved_activations: bool = False, *args):
    """Activation checkpointing (reference random.py:308): ``function(*args)``
    with its activations recomputed in the backward, the tracker's
    streams restored for the recompute.  ``distribute_saved_activations``
    (split the saved inputs over tp) is accepted for parity and keeps
    them whole, as the JAX package does."""
    from torch.utils.checkpoint import checkpoint as _checkpoint

    tracker = get_rng_state_tracker()
    saved = tracker.get_states()

    @contextlib.contextmanager
    def recompute():
        now = tracker.get_states()
        tracker.set_states(saved)
        try:
            yield
        finally:
            tracker.set_states(now)

    return _checkpoint(function, *args, use_reentrant=False,
                       context_fn=lambda: (contextlib.nullcontext(), recompute()))


# the checkpointed-activations buffer (reference random.py:44-88,
# deprecated there, kept for its API)
_CHECKPOINTED_BUFFER_NAME = "checkpointed activations"


def _checkpointed_buffer():
    from apex_tpu_torch.transformer.tensor_parallel.memory import get_mem_buffs

    return get_mem_buffs().get(_CHECKPOINTED_BUFFER_NAME)


def init_checkpointed_activations_memory_buffer(
        micro_batch_size, max_position_embeddings, hidden_size, num_layers,
        tensor_model_parallel_size, checkpoint_num_layers, fp16, device=None):
    """Reference random.py:48-81: seq x micro batch x hidden / tp elements
    a checkpointed layer."""
    from apex_tpu_torch.transformer.tensor_parallel.memory import allocate_mem_buff

    per_layer = (micro_batch_size * max_position_embeddings * hidden_size
                 // tensor_model_parallel_size)
    if num_layers % checkpoint_num_layers != 0:
        raise ValueError("number of layers is not divisible by checkpoint-num-layers")
    numel = per_layer * (num_layers // checkpoint_num_layers)
    if _checkpointed_buffer() is not None:
        raise RuntimeError("checkpointed activations memory buffer is already allocated.")
    return allocate_mem_buff(_CHECKPOINTED_BUFFER_NAME, numel,
                             torch.float16 if fp16 else torch.float32, track_usage=False,
                             device=device)


def reset_checkpointed_activations_memory_buffer():
    """Reference random.py:84-88."""
    buf = _checkpointed_buffer()
    if buf is not None:
        buf.reset()
