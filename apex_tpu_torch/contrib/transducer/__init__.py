from apex_tpu_torch.contrib.transducer.transducer import (
    TransducerJoint,
    TransducerLoss,
    transducer_loss,
)

__all__ = ["TransducerJoint", "TransducerLoss", "transducer_loss"]
