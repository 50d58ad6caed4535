"""Context parallelism: ring attention over a process group (counterpart
of :mod:`apex_tpu.transformer.context_parallel`).

The sequence is split over the ``cp`` group: each rank holds a chunk of
S / cp positions (rank r the positions ``r·S/cp ..``) and attention runs
as a ring -- at each hop every rank attends its own queries to the k/v
chunk it holds, then passes k/v one rank back with ``torch.distributed``
point-to-point ops (the JAX package's ``ppermute``).  Chunk results merge
by the online-softmax (out, logsumexp) rule, so the result is full
attention.  Causality across ranks comes from the chunks' global
positions: the chunk of rank j seen from rank i is fully masked when j >
i, fully visible when j < i and triangular when i == j.
"""

from apex_tpu_torch.transformer.context_parallel.ring_attention import (
    ring_attention,
    shard_sequence,
    unshard_sequence,
)

__all__ = ["ring_attention", "shard_sequence", "unshard_sequence"]
