"""Utilities shared by tensor parallelism and, later, the pipeline
(counterpart of :mod:`apex_tpu.transformer.utils`; reference
``apex/transformer/utils.py``).

``split_tensor_into_1d_equal_chunks`` keeps this rank's equal piece of a
flattened tensor and ``gather_split_1d_tensor`` all-gathers the pieces
back over the tensor-parallel group (the reference's sequence-parallel
activation stash).  The JAX package reads the rank from the ``tp`` mesh
axis inside ``shard_map``; here it is the process's rank in the group.
"""

import torch

__all__ = ["divide", "ensure_divisibility", "split_tensor_into_1d_equal_chunks",
           "gather_split_1d_tensor"]


def ensure_divisibility(numerator: int, denominator: int) -> None:
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    """Integer division asserting exact divisibility."""
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def _tp_group(group):
    from apex_tpu_torch.transformer import parallel_state

    return parallel_state.get_tensor_model_parallel_group() if group is None else group


def split_tensor_into_1d_equal_chunks(tensor, *, rank=None, world_size=None, group=None):
    """This rank's equal 1-D chunk of ``tensor`` (flattened): the rank and
    world of ``group`` (default the tensor-parallel group) unless given."""
    g = None if rank is not None and world_size is not None else _tp_group(group)
    world_size = g.size() if world_size is None else int(world_size)
    rank = g.rank() if rank is None else int(rank)
    data = tensor.reshape(-1)
    partition = divide(data.numel(), world_size)
    return data[rank * partition:(rank + 1) * partition]


def gather_split_1d_tensor(tensor, group=None):
    """The opposite of :func:`split_tensor_into_1d_equal_chunks`: every
    rank's 1-D chunk over ``group`` (default the tensor-parallel group),
    concatenated in rank order."""
    from apex_tpu_torch.transformer.tensor_parallel.mappings import all_gather_dim

    return all_gather_dim(tensor.reshape(-1), _tp_group(group), 0)
