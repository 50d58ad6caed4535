"""``multi_tensor_applier`` (counterpart of
:mod:`apex_tpu.multi_tensor_apply`, after
``apex/multi_tensor_apply/multi_tensor_apply.py``).

On the card the chunked dispatch is real: the ops of
:mod:`apex_tpu_torch.ops.multi_tensor` launch kernels that read many
tensors through one table of pointers.  ``multi_tensor_applier`` calls
an op with the tensor lists and returns the noop flag as a value,
OR-ed with the op's own found-inf vote, so the flag accumulates across
chained calls as apex's device buffer does.
"""

import torch

from apex_tpu_torch.ops.multi_tensor import (
    multi_tensor_axpby,
    multi_tensor_l2norm,
    multi_tensor_scale,
    tree_not_finite,
)


class MultiTensorApply:
    """Callable as ``multi_tensor_applier(op, noop_flag, lists, *args)``,
    returning ``(out, noop_flag_out)``: ``noop_flag_out`` is an int32
    0/1 tensor, the incoming flag (None or 0 on the first call) OR-ed
    with the op's found-inf vote.  Ops without a vote
    (``multi_tensor_l2norm``) pass the flag through."""

    available = True
    warned = False

    def __init__(self, chunk_size: int = 2048 * 32):
        self.chunk_size = chunk_size

    def __call__(self, op, noop_flag, tensor_lists, *args):
        out = op(*tensor_lists, *args)
        flag = (torch.zeros((), dtype=torch.int32) if noop_flag is None
                else torch.as_tensor(noop_flag).to(torch.int32))
        # (result, found_inf) ops: fold the vote in.  A vote is a 0-d
        # bool tensor; l2norm's (norm, [per-leaf norms]) is not one.
        if (isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], torch.Tensor)
                and out[1].dtype == torch.bool and out[1].dim() == 0):
            result, found = out
            return result, flag.to(found.device) | found.to(torch.int32)
        return out, flag


multi_tensor_applier = MultiTensorApply(2048 * 32)

__all__ = [
    "MultiTensorApply",
    "multi_tensor_applier",
    "multi_tensor_scale",
    "multi_tensor_axpby",
    "multi_tensor_l2norm",
    "tree_not_finite",
]
