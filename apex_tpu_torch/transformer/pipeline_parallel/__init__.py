"""Pipeline parallelism (counterpart of
:mod:`apex_tpu.transformer.pipeline_parallel`; reference
``apex/transformer/pipeline_parallel``): the stage-to-stage messages,
the 1F1B and interleaved schedules and the no-pipelining path, each
rank running its own stage over ``torch.distributed``."""

from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    build_model,
    forward_backward_no_pipelining,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
    get_forward_backward_func,
    pipelined_apply,
)

__all__ = [
    "p2p_communication",
    "get_forward_backward_func",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_without_interleaving",
    "forward_backward_pipelining_with_interleaving",
    "pipelined_apply",
    "build_model",
]
