"""Training of the port's decoder and sentence encoder (``train.py``) and
its checkpoints (``checkpoint.py``)."""

from ragmeup_tpu_torch.train.train import (
    TrainState, contrastive_loss, decoder_loss, make_decoder_train_step,
    make_encoder_train_step,
)

__all__ = ["TrainState", "make_decoder_train_step", "make_encoder_train_step",
           "decoder_loss", "contrastive_loss"]
