"""Training steps and optimizers: the generator step (point loss, optional
GAN) and the discriminator step, on ``torch.optim.Adam`` with the
reference's LR decay."""

from scream_tpu_torch.train.optim import (decay_epochs, discriminator_optimizer,
                                          generator_optimizer, lr_schedule)
from scream_tpu_torch.train.steps import (DiscState, TrainState, init_train_state,
                                          make_disc_logit_fn,
                                          make_discriminator_step,
                                          make_registration_train_step)

__all__ = ["DiscState", "TrainState", "decay_epochs", "discriminator_optimizer",
           "generator_optimizer", "init_train_state", "lr_schedule",
           "make_disc_logit_fn", "make_discriminator_step",
           "make_registration_train_step"]
