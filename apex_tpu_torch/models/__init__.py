"""Models of the port (counterpart of :mod:`apex_tpu.models`): GPT
(:mod:`.gpt`: serving, training, tensor, pipeline, context and expert
parallelism), BERT (:mod:`.bert`: the masked-LM encoder, tensor
parallel) and ResNet (:mod:`.resnet`: ResNet-50 with SyncBatchNorm)."""

from apex_tpu_torch.models import bert, gpt, resnet

__all__ = ["bert", "gpt", "resnet"]
