"""Models of the port (counterpart of :mod:`apex_tpu.models`): GPT
(:mod:`.gpt`: serving, training, tensor, pipeline, context and expert
parallelism), BERT (:mod:`.bert`: the masked-LM encoder, tensor
parallel), ResNet (:mod:`.resnet`: ResNet-50 with SyncBatchNorm) and T5
(:mod:`.t5`: the encoder-decoder, tensor and pipeline parallel across
the split rank)."""

from apex_tpu_torch.models import bert, gpt, resnet, t5

__all__ = ["bert", "gpt", "resnet", "t5"]
