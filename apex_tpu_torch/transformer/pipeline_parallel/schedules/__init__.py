"""Schedule selector (counterpart of
:mod:`apex_tpu.transformer.pipeline_parallel.schedules`; reference
``schedules/__init__.py:22``), and the encoder/decoder schedule of T5
(:mod:`.tick_schedule_encdec`: ``forward_backward_pipelining_encdec``
and its per-stage layout), which the selector does not pick, as in the
JAX package: ``models.t5.make_pp_train_step`` calls it."""

from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
    broadcast_from_last_stage,
    build_model,
    pipelined_apply,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_no_pipelining import (
    forward_backward_no_pipelining,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_pipelining_with_interleaving import (  # noqa: E501
    forward_backward_pipelining_with_interleaving,
    interleaved_pipelined_apply,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_pipelining_without_interleaving import (  # noqa: E501
    forward_backward_pipelining_without_interleaving,
    make_pipeline_loss_fn,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.tick_schedule_encdec import (
    forward_backward_pipelining_encdec,
    pad_stage_layout_encdec,
    unpad_stage_layout_encdec,
)


def get_forward_backward_func(virtual_pipeline_model_parallel_size, pipeline_model_parallel_size):
    """Reference: schedules/__init__.py:22 — pick the schedule."""
    if pipeline_model_parallel_size > 1:
        if virtual_pipeline_model_parallel_size is not None:
            return forward_backward_pipelining_with_interleaving
        return forward_backward_pipelining_without_interleaving
    return forward_backward_no_pipelining


__all__ = [
    "get_forward_backward_func",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_without_interleaving",
    "forward_backward_pipelining_with_interleaving",
    "forward_backward_pipelining_encdec",
    "interleaved_pipelined_apply",
    "make_pipeline_loss_fn",
    "pad_stage_layout_encdec",
    "pipelined_apply",
    "broadcast_from_last_stage",
    "build_model",
    "unpad_stage_layout_encdec",
]
