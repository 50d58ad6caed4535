"""Tensor-parallel utilities (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel.utils`; reference
``apex/transformer/tensor_parallel/utils.py``)."""

from typing import Tuple

from apex_tpu_torch.transformer.utils import divide

__all__ = ["split_tensor_along_last_dim", "VocabUtility"]


def split_tensor_along_last_dim(tensor, num_partitions: int, contiguous_split_chunks=False):
    """A tuple of ``num_partitions`` equal views of ``tensor`` along its
    last dim (reference utils.py:17)."""
    chunk = divide(tensor.shape[-1], num_partitions)
    parts = tensor.split(chunk, dim=-1)
    return tuple(p.contiguous() for p in parts) if contiguous_split_chunks else parts


class VocabUtility:
    """The vocab range ``[first, last)`` a rank holds (reference
    utils.py:46)."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size: int, rank, world_size: int) -> Tuple[int, int]:
        index_f = rank * per_partition_vocab_size
        return index_f, index_f + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(global_vocab_size: int, rank, world_size: int):
        per_partition = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per_partition, rank, world_size)
