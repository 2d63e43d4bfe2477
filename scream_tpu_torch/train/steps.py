"""Training steps: generator (point loss + optional GAN) and discriminator
(port of ``scream_tpu/train/steps.py``; reference
``train_3d_match.py:166-205``), and the OpenGF generator step
(``train_open_gf.py:89-103``).

One generator step is forward -> point loss -> (GAN: render the predicted
source beside the target, score it with the frozen discriminator, hinge)
-> backward -> Adam update, batched over pairs. One discriminator step
renders the GT-aligned source ("real"), scores real then the generator's
detached render ("fake") in train mode, and takes one hinge update. The
trainer runs them in that order (``scream_tpu/train/trainer.py:296-308``).

The JAX steps are pure functions of explicit states; here the model, the
discriminator and their optimizers are updated in place (parameters, Adam
moments and BatchNorm running averages), and a step returns the same state
object with its count advanced. Metrics come back as detached tensors on the
step's device: nothing here waits for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from scream_tpu_torch.config import RenderConfig
from scream_tpu_torch.models.gan import images_to_nhwc
from scream_tpu_torch.models.losses import (discriminator_hinge_loss,
                                            generator_hinge_loss)
from scream_tpu_torch.models.point_transformer import DEMTransformer, PointTransformer
from scream_tpu_torch.ops.render import render_from_config
from scream_tpu_torch.pipeline.register import gt_aligned_src, gt_center_hint


@dataclasses.dataclass
class TrainState:
    """The generator's training state: its optimizer (bound to the model's
    parameters), the LR schedule (None for a constant LR) and the count of
    updates taken."""

    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None
    step: int = 0


@dataclasses.dataclass
class DiscState:
    """The discriminator (parameters and BatchNorm running averages) and its
    optimizer."""

    disc: nn.Module
    optimizer: torch.optim.Optimizer


def init_train_state(optimizer: torch.optim.Optimizer,
                     scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None
                     ) -> TrainState:
    return TrainState(optimizer, scheduler, 0)


def make_disc_logit_fn() -> Callable:
    """Frozen-discriminator logits for the generator loss: ``apply(disc,
    imgs)`` scores renderer output ``(B, V, 2, w, w)``.

    BatchNorm runs on the batch statistics with nothing stored (the
    reference's discriminator stays in train mode for the generator pass,
    ``loss.py:53-57``; its running averages are known to be unusable, see
    the JAX package's ``make_disc_logit_fn``). Gradients flow through the
    discriminator to the images; the generator step differentiates only the
    generator's parameters, so none reaches the discriminator's."""

    def apply(disc, imgs):
        return disc(images_to_nhwc(imgs), train=True, update_stats=False)

    return apply


def make_registration_train_step(
    model: PointTransformer,
    use_gan: bool = False,
    disc_apply: Optional[Callable] = None,
    render_cfg: RenderConfig = RenderConfig(),
    gan_weight: float = 0.1,
    center_mode: str = "trans",
):
    """The generator step for the registration tasks:
    ``step(state, batch, disc=None, stage_hook=None) -> (state, metrics, fake)``.

    ``batch`` holds ``src``, ``tgt``, ``src_mask``, ``tgt_mask``, ``rot`` and
    ``trans`` as tensors on the model's device; ``disc`` is the
    discriminator module when ``use_gan``. ``fake`` (detached, None without
    the GAN) is the render the discriminator step takes, as the reference
    re-uses the generator's images (``train_3d_match.py:186-205``).
    ``stage_hook(name)``, if given, is called after each stage ("forward",
    "render", "discriminator", "backward", "optimizer") for timing."""
    if use_gan and disc_apply is None:
        raise ValueError("use_gan needs disc_apply (make_disc_logit_fn())")
    params = [p for p in model.parameters() if p.requires_grad]

    def step(state: TrainState, batch: Dict[str, torch.Tensor], disc=None,
             stage_hook=None):
        mark = stage_hook or (lambda name: None)
        src, tgt = batch["src"], batch["tgt"]
        src_mask, tgt_mask = batch["src_mask"], batch["tgt_mask"]
        state.optimizer.zero_grad(set_to_none=True)
        # GT hint: t for 3DMatch (reference train_3d_match.py:171), -R^T t
        # for KITTI (train_kitti.py:156).
        src_center = gt_center_hint(batch["rot"], batch["trans"], center_mode)
        src_pred = model(src, tgt, src_mask, tgt_mask, src_center).float()
        point_loss = PointTransformer.loss(
            src_pred, src, batch["rot"], batch["trans"], src_mask,
            point_reduce=getattr(model, "point_reduce", None))
        mark("forward")
        metrics = {"point_loss": point_loss}
        total, fake = point_loss, None
        if use_gan:
            fake = render_from_config(src_pred, tgt, render_cfg, src_mask, tgt_mask)
            mark("render")
            g_loss = generator_hinge_loss(disc_apply(disc, fake))
            mark("discriminator")
            total = point_loss + gan_weight * g_loss
            metrics["g_loss"] = g_loss
        metrics["loss"] = total
        total.backward(inputs=params)
        mark("backward")
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        mark("optimizer")
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, metrics, None if fake is None else fake.detach()

    step.model = model
    return step


def make_dem_train_step(
    model: DEMTransformer,
    use_gan: bool = False,
    disc_apply: Optional[Callable] = None,
    render_cfg: RenderConfig = RenderConfig(multi_view=False),
    gan_weight: float = 0.1,
):
    """The generator step for OpenGF ground generation:
    ``step(state, batch, disc=None, stage_hook=None) -> (state, metrics, fake)``
    (reference ``train_open_gf.py:89-103``).

    ``batch`` holds ``dsm``, ``dem``, ``dem_coarse`` and their masks. The
    point loss is the per-index L1 between ``dem_pred`` (one point per DSM
    point) and the DEM over points valid in both. With the GAN on, the
    single-view renderer pairs ``dem_pred`` with the coarse DEM (reference
    ``models/pointnet.py:156-159``). Stages and ``stage_hook`` as in
    :func:`make_registration_train_step`."""
    if use_gan and disc_apply is None:
        raise ValueError("use_gan needs disc_apply (make_disc_logit_fn())")
    params = [p for p in model.parameters() if p.requires_grad]

    def step(state: TrainState, batch: Dict[str, torch.Tensor], disc=None,
             stage_hook=None):
        mark = stage_hook or (lambda name: None)
        state.optimizer.zero_grad(set_to_none=True)
        dem_pred = model(batch["dsm"], batch["dem_coarse"], batch["dsm_mask"],
                         batch["dem_coarse_mask"]).float()
        point_loss = DEMTransformer.loss(dem_pred, batch["dem"],
                                         batch["dsm_mask"] & batch["dem_mask"],
                                         point_reduce=getattr(model, "point_reduce", None))
        mark("forward")
        metrics = {"point_loss": point_loss}
        total, fake = point_loss, None
        if use_gan:
            fake = render_from_config(dem_pred, batch["dem_coarse"], render_cfg,
                                      batch["dsm_mask"], batch["dem_coarse_mask"])
            mark("render")
            g_loss = generator_hinge_loss(disc_apply(disc, fake))
            mark("discriminator")
            total = point_loss + gan_weight * g_loss
            metrics["g_loss"] = g_loss
        metrics["loss"] = total
        total.backward(inputs=params)
        mark("backward")
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        mark("optimizer")
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, metrics, None if fake is None else fake.detach()

    step.model = model
    return step


def make_discriminator_step(render_cfg: RenderConfig = RenderConfig()):
    """The discriminator hinge step:
    ``step(disc_state, fake, real_src, tgt, src_mask, tgt_mask, rot=None,
    trans=None) -> (disc_state, d_loss)``.

    It renders the real images from the GT-aligned source (``R src + t`` when
    ``rot``/``trans`` are given, reference ``train_3d_match.py:195-205``),
    scores real and then fake in train mode, each pass folding its batch
    statistics into the running averages (twice per step, real first, as
    the JAX step threads its ``batch_stats``), and takes one update on the
    hinge loss of the detached images."""

    def step(disc_state: DiscState, fake, real_src, tgt, src_mask, tgt_mask,
             rot=None, trans=None):
        disc, opt = disc_state.disc, disc_state.optimizer
        with torch.no_grad():
            if rot is not None:
                real_src = gt_aligned_src(real_src, rot, trans)
            real = render_from_config(real_src, tgt, render_cfg, src_mask, tgt_mask)
        opt.zero_grad(set_to_none=True)
        logits_real = disc(images_to_nhwc(real), train=True, update_stats=True)
        logits_fake = disc(images_to_nhwc(fake.detach()), train=True, update_stats=True)
        d_loss = discriminator_hinge_loss(logits_real, logits_fake)
        d_loss.backward()
        opt.step()
        return disc_state, d_loss.detach()

    return step
