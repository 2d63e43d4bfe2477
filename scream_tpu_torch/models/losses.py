"""Adversarial (hinge) losses for the rendering GAN (port of
``scream_tpu/models/losses.py``; reference ``loss.py:16-66``,
``AdversarialLoss``). Pure functions; the alternating G/D updates live in
:mod:`scream_tpu_torch.train.steps`.
"""

from __future__ import annotations

from typing import Iterable

import torch


def generator_hinge_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    """``-mean(D(fake))`` (reference ``loss.py:53-57``)."""
    return -torch.mean(logits_fake)


def discriminator_hinge_loss(logits_real: torch.Tensor,
                             logits_fake: torch.Tensor) -> torch.Tensor:
    """``0.5 * (mean(relu(1 - D(real))) + mean(relu(1 + D(fake))))``
    (reference ``loss.py:31-35``). Callers detach the images, as the
    reference does."""
    loss_real = torch.mean(torch.relu(1.0 - logits_real))
    loss_fake = torch.mean(torch.relu(1.0 + logits_fake))
    return 0.5 * (loss_real + loss_fake)


def calculate_adaptive_weight(nll_grads: Iterable[torch.Tensor],
                              g_grads: Iterable[torch.Tensor],
                              discriminator_weight: float = 1.0, eps: float = 1e-4,
                              max_weight: float = 1e4) -> torch.Tensor:
    """VQGAN-style adaptive GAN weight (reference ``loss.py:37-48``): the
    ratio of the reconstruction loss's to the GAN loss's gradient norm at the
    generator's last layer, clipped to ``[0, max_weight]``, detached and
    scaled. Takes the two lists of last-layer gradients."""

    def norm(grads):
        return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))

    w = norm(nll_grads) / (norm(g_grads) + eps)
    return torch.clamp(w, 0.0, max_weight).detach() * discriminator_weight


def adopt_weight(weight, global_step, threshold: int = 0, value: float = 0.0):
    """Gate a loss weight until ``global_step >= threshold`` (reference
    ``loss.py:26-29``)."""
    return torch.where(torch.as_tensor(global_step) < threshold,
                       torch.as_tensor(value), torch.as_tensor(weight))
