"""Pipeline-parallel utilities (counterpart of
:mod:`apex_tpu.transformer.pipeline_parallel.utils`).

Reference: ``apex/transformer/pipeline_parallel/utils.py`` —
``setup_microbatch_calculator`` (:58), ``get_kth_microbatch`` (:122),
``_Timers`` (:146 via _timers.py), ``print_rank_0`` (:159),
``calc_params_l2_norm`` (:213), ``report_memory`` (:253).  The ranks are
``torch.distributed``'s; the timers synchronize the CUDA device where
the JAX package blocks on a device value.
"""

import time
from typing import List, Optional

import torch

from apex_tpu_torch.transformer.microbatches import build_num_microbatches_calculator

__all__ = ["setup_microbatch_calculator", "get_micro_batch_size", "get_num_microbatches",
           "get_current_global_batch_size", "update_num_microbatches",
           "destroy_num_microbatches_calculator", "get_kth_microbatch", "listify_model",
           "calc_params_l2_norm", "print_rank_0", "print_rank_last", "report_memory",
           "get_autoresume", "get_timers"]

_GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
_GLOBAL_TIMERS = None


def setup_microbatch_calculator(rank: int, rampup_batch_size: Optional[List[int]],
                                global_batch_size: int, micro_batch_size: int,
                                data_parallel_size: int) -> None:
    """Reference: utils.py:58."""
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    assert _GLOBAL_NUM_MICROBATCHES_CALCULATOR is None, \
        "num microbatches calculator is already initialized."
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size, data_parallel_size)


def get_micro_batch_size():
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.micro_batch_size


def get_num_microbatches():
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get()


def get_current_global_batch_size():
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get_current_global_batch_size()


def update_num_microbatches(consumed_samples, consistency_check=True):
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR.update(consumed_samples, consistency_check)


def destroy_num_microbatches_calculator():
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None


def get_kth_microbatch(batch, k: int):
    """Microbatch k of a tree of tensors (reference utils.py:122): rows
    ``[k·mbs, (k+1)·mbs)`` of every leaf."""
    from apex_tpu_torch.optimizers.tree import tree_map

    if batch is None:
        return batch
    mbs = get_micro_batch_size()
    return tree_map(lambda x: x[k * mbs:(k + 1) * mbs], batch)


def listify_model(model):
    return model if isinstance(model, list) else [model]


def calc_params_l2_norm(params, bf16: bool = False, attrs=None, tp_rank: Optional[int] = None,
                        axis_name=None, tp_axis_name=None):
    """Reference utils.py:213: the global L2 norm of the params (the
    ``mt_l2norm`` kernel over this rank's leaves).

    ``attrs``: a tree of :class:`~apex_tpu_torch.transformer.
    tensor_parallel.attributes.TensorParallelAttributes` shaped like
    ``params``: a tp-replicated leaf counts only on tp rank 0
    (``param_is_not_tensor_parallel_duplicate``, utils.py:217-222; the
    rank is ``tp_rank``, else ``tp_axis_name``'s, else the registered
    tensor-parallel group's).  ``axis_name``: the groups (an
    ``AxisGroup`` or a tuple of them, e.g. the tp and pp groups) this
    rank's leaves are one piece of; the squared norm is summed over each
    in turn (reference :234-238, the model-parallel all-reduce).  A leaf
    replicated over tp but split over pp (a stage's LayerNorm) counts on
    every stage.  Without ``axis_name`` the norm is this rank's alone."""
    import torch.distributed as dist

    from apex_tpu_torch.ops.multi_tensor import mt_l2norm
    from apex_tpu_torch.optimizers.tree import tree_leaves

    leaves = tree_leaves(params)
    if attrs is not None:
        from apex_tpu_torch.transformer.tensor_parallel.attributes import (
            param_is_not_tensor_parallel_duplicate,
        )

        if tp_rank is None:
            if tp_axis_name is None:
                from apex_tpu_torch.transformer import parallel_state

                tp_axis_name = parallel_state.get_tensor_model_parallel_group()
            tp_rank = tp_axis_name.rank()
        attr_leaves = tree_leaves(attrs)
        if len(attr_leaves) != len(leaves):
            raise ValueError(f"attrs has {len(attr_leaves)} leaves, params {len(leaves)}")
        leaves = [p for p, a in zip(leaves, attr_leaves)
                  if param_is_not_tensor_parallel_duplicate(a, tp_rank)]
    sq, _ = mt_l2norm([p.detach().to(torch.float32) for p in leaves])
    if axis_name is not None:
        groups = axis_name if isinstance(axis_name, (tuple, list)) else (axis_name,)
        sq = sq.reshape(1).clone()
        for g in groups:
            if g.group is not None:
                dist.all_reduce(sq, group=g.group)
        sq = sq[0]
    return torch.sqrt(sq)


def print_rank_0(message: str) -> None:
    """Reference: utils.py:159 — only global rank 0 prints."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_rank() == 0:
        print(message, flush=True)


def print_rank_last(message: str) -> None:
    """Only the last global rank prints (reference utils.py:167)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_rank() == dist.get_world_size() - 1:
        print(message, flush=True)


def report_memory(name: str) -> None:
    """Reference: utils.py:253 — this rank's CUDA memory, in MB."""
    if not torch.cuda.is_available():
        print_rank_0(f"[{name}] memory stats unavailable: no CUDA device")
        return
    mega = 1024 * 1024
    print_rank_0(f"[{name}] memory (MB) | allocated: {torch.cuda.memory_allocated() / mega:.1f}"
                 f" | max allocated: {torch.cuda.max_memory_allocated() / mega:.1f}"
                 f" | reserved: {torch.cuda.memory_reserved() / mega:.1f}"
                 f" | max reserved: {torch.cuda.max_memory_reserved() / mega:.1f}")


def get_autoresume():
    """Reference: utils.py:142 — an ADLR AutoResume hook; none exists."""
    return None


class _Timer:
    """A named wall-clock timer that synchronizes the CUDA device at start
    and stop (reference _timers.py:1-40)."""

    def __init__(self, name):
        self.name_ = name
        self.elapsed_ = 0.0
        self.started_ = False
        self.start_time = time.time()

    @staticmethod
    def _sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def start(self):
        assert not self.started_, "timer has already been started"
        self._sync()
        self.start_time = time.time()
        self.started_ = True

    def stop(self):
        assert self.started_, "timer is not started"
        self._sync()
        self.elapsed_ += time.time() - self.start_time
        self.started_ = False

    def reset(self):
        self.elapsed_ = 0.0
        self.started_ = False

    def elapsed(self, reset=True):
        started_ = self.started_
        if self.started_:
            self.stop()
        elapsed_ = self.elapsed_
        if reset:
            self.reset()
        if started_:
            self.start()
        return elapsed_


class _Timers:
    """Named timer group (reference _timers.py:43-83)."""

    def __init__(self):
        self.timers = {}

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def log(self, names, normalizer=1.0, reset=True):
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            elapsed_time = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
            string += " | {}: {:.2f}".format(name, elapsed_time)
        print_rank_last(string)


def get_timers():
    global _GLOBAL_TIMERS
    if _GLOBAL_TIMERS is None:
        _GLOBAL_TIMERS = _Timers()
    return _GLOBAL_TIMERS
