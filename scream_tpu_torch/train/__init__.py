"""Training: the generator steps (registration and OpenGF; point loss,
optional GAN) and the discriminator step on ``torch.optim.Adam`` with the
reference's LR decay, and the epoch-level trainers around them."""

from scream_tpu_torch.train.optim import (decay_epochs, discriminator_optimizer,
                                          generator_optimizer, lr_schedule)
from scream_tpu_torch.train.steps import (DiscState, TrainState, init_train_state,
                                          make_dem_train_step,
                                          make_disc_logit_fn,
                                          make_discriminator_step,
                                          make_registration_train_step)
from scream_tpu_torch.train.trainer import DEMTrainer, RegistrationTrainer

__all__ = ["DEMTrainer", "DiscState", "RegistrationTrainer", "TrainState",
           "decay_epochs", "discriminator_optimizer",
           "generator_optimizer", "init_train_state", "lr_schedule",
           "make_dem_train_step", "make_disc_logit_fn", "make_discriminator_step",
           "make_registration_train_step"]
