"""Vocab-parallel cross entropy (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel.cross_entropy`).

Reference: ``apex/transformer/tensor_parallel/cross_entropy.py:23-132``
(``_VocabParallelCrossEntropy``), the dense LM head's loss under tensor
parallelism.  The logits are split over the vocab; no rank ever holds
them whole:

1. the max of the logits over the group (all-reduce MAX), subtracted;
2. the target's shifted logit, on the rank whose rows hold it (0 on the
   others: an id outside every rank's rows gives 0), summed;
3. the sum of ``exp`` over the group; ``loss = log(sum_exp) - target``.
   An out-of-range id's loss is thus ``log(sum_exp)``, the
   log-sum-exp less the max (the JAX package's dense head clamps it
   instead);
4. label smoothing takes the *partition's* vocab size and a
   partition-local mean of the log-probabilities, as the reference does
   (cross_entropy.py:78-97).

The backward is ``softmax - (smoothed) onehot`` times the cotangent, on
the local vocab rows, as in the reference and the JAX package's
``custom_vjp``.
"""

import torch

from apex_tpu_torch.transformer.tensor_parallel.mappings import all_reduce_sum, tp_group

__all__ = ["vocab_parallel_cross_entropy"]


def _all_reduce_max(x, axis):
    import torch.distributed as dist

    if axis.size() == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis.group)
    return out


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target, label_smoothing, axis):
        lmax = _all_reduce_max(logits.max(dim=-1).values, axis)
        logits = logits - lmax[..., None]
        partition = logits.shape[-1]
        local_t = target.long() - axis.rank() * partition
        mask = (local_t < 0) | (local_t >= partition)
        local_t = local_t.clamp(0, partition - 1)
        predicted = logits.gather(-1, local_t[..., None])[..., 0].masked_fill(mask, 0.0)
        predicted = all_reduce_sum(predicted, axis)
        exp_logits = torch.exp(logits)
        sum_exp = all_reduce_sum(exp_logits.sum(dim=-1), axis)
        loss = torch.log(sum_exp) - predicted
        softmax = exp_logits / sum_exp[..., None]
        if label_smoothing > 0:
            if not 0.0 < label_smoothing < 1.0:
                raise ValueError(f"label_smoothing must be in (0, 1), got {label_smoothing}")
            smoothing = label_smoothing * partition / (partition - 1)
            mean_log_probs = torch.log(softmax).mean(dim=-1)
            loss = (1.0 - smoothing) * loss - smoothing * mean_log_probs
        ctx.save_for_backward(softmax, mask, local_t)
        ctx.label_smoothing = label_smoothing
        return loss

    @staticmethod
    def backward(ctx, g):
        softmax, mask, local_t = ctx.saved_tensors
        partition = softmax.shape[-1]
        onehot = torch.zeros_like(softmax).scatter_(
            -1, local_t[..., None], (~mask).to(softmax.dtype)[..., None])
        if ctx.label_smoothing > 0:
            smoothing = ctx.label_smoothing * partition / (partition - 1)
            grad = softmax - (1.0 - smoothing) * onehot - smoothing / partition
        else:
            grad = softmax - onehot
        return grad * g[..., None], None, None, None


def vocab_parallel_cross_entropy(vocab_parallel_logits, target, label_smoothing: float = 0.0,
                                 axis_name=None):
    """Per-token CE loss of logits split over the vocab across
    ``axis_name`` (default the tensor-parallel group); ``target`` holds
    global ids.  Reference cross_entropy.py:132."""
    return _VocabParallelCE.apply(vocab_parallel_logits, target, float(label_smoothing),
                                  tp_group(axis_name))
