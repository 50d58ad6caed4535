"""Broadcasting the batch over the tensor-parallel group (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel.data`; reference
``apex/transformer/tensor_parallel/data.py:80``): tp rank 0 sends, so
that every rank of the group computes on the same data."""

import torch

from apex_tpu_torch.transformer.tensor_parallel.mappings import tp_group

__all__ = ["broadcast_data", "broadcast_from_rank0"]


def broadcast_from_rank0(x, axis_name=None):
    """Tensor-parallel rank 0's ``x`` on every rank of ``axis_name``
    (default the tensor-parallel group); a new tensor."""
    import torch.distributed as dist

    axis = tp_group(axis_name)
    out = torch.as_tensor(x).contiguous().clone()
    if axis.size() > 1:
        dist.broadcast(out, src=axis.ranks[0], group=axis.group)
    return out


def broadcast_data(keys, data: dict, datatype=None, axis_name=None) -> dict:
    """``data[k]`` for each of ``keys``, cast to ``datatype`` when given,
    from tp rank 0 (data.py:80's signature).  Every rank's tensors must
    have rank 0's shapes."""
    out = {}
    for k in keys:
        v = torch.as_tensor(data[k])
        if datatype is not None:
            v = v.to(datatype)
        out[k] = broadcast_from_rank0(v, axis_name)
    return out
