"""Epoch-level trainers for the three tasks (port of
``scream_tpu/train/trainer.py``; reference ``train_3d_match.py:156-233``,
``train_kitti.py:138-234``, ``train_open_gf.py:79-148``).

The reference's recipes: Adam with the stepped LR decay, optional
alternating GAN updates at weight 0.1, validation after every epoch, and
best-metric checkpoints (min point loss, max success rate, min chamfer);
batched steps on the card, and a full-state checkpoint after every epoch
that ``fit`` resumes from.

The trainers build their models in :meth:`init`, from
``torch.Generator().manual_seed(seed)`` (the JAX package initializes from
``PRNGKey(seed)``; the two draw different numbers, so a comparison loads one
init into both). ``RegistrationTrainer`` takes any pair loader, the
size-bucketed one of ``train --multi-scale`` too (one batch shape a bucket).
Multi-chip meshes (``--mesh``, including the pipeline trainer) and the GAN
sample-image dump (``--sample-img-dir``) are not ported (ROADMAP.md):
asking for them raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch

from scream_tpu_torch.config import EvalConfig, ModelConfig, RenderConfig, TrainConfig
from scream_tpu_torch.geometry.metrics import chamfer_distance, height_mae
from scream_tpu_torch.models import DEMTransformer, PatchDiscriminator, PointTransformer
from scream_tpu_torch.pipeline.register import gt_center_hint, register_batch, to_device
from scream_tpu_torch.train.optim import discriminator_optimizer, generator_optimizer
from scream_tpu_torch.train.steps import (DiscState, init_train_state,
                                          make_dem_train_step, make_disc_logit_fn,
                                          make_discriminator_step,
                                          make_registration_train_step)
from scream_tpu_torch.utils.checkpoint import (BestCheckpointer, load_train_state,
                                               save_train_state)
from scream_tpu_torch.utils.device import resolve_device
from scream_tpu_torch.utils.logging import MetricsLogger
from scream_tpu_torch.utils.profiling import ThroughputMeter, trace


def _refuse_unported(mesh, sample_img_dir) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "training on a mesh (--mesh) is not ported (ROADMAP.md, multi-GPU)")
    if sample_img_dir:
        raise NotImplementedError(
            "the GAN sample-image dump (--sample-img-dir) is not ported "
            "(ROADMAP.md, user surface)")


class _Trainer:
    """What both trainers share: the generator's optimizer and the GAN
    discriminator built in :meth:`_init_optimizers`, the per-epoch loop over
    the step, full-state save and restore, and :meth:`fit`."""

    def _init_optimizers(self, model, step_fn, decay_mode=None):
        self.model = model
        opt, sched = generator_optimizer(model.parameters(), self.train_cfg,
                                         self.steps_per_epoch, decay_mode)
        self.state = init_train_state(opt, sched)
        self.disc_state, self.disc_step = None, None
        if self.use_gan:
            # PRNGKey(1) in the JAX trainer, whatever the generator's seed.
            disc = PatchDiscriminator(input_nc=2, device=self.device,
                                      generator=torch.Generator().manual_seed(1))
            self.disc_state = DiscState(disc, discriminator_optimizer(disc.parameters(),
                                                                      self.train_cfg))
            self.disc_step = make_discriminator_step(self.render_cfg)
        self.train_step = step_fn(
            model, use_gan=self.use_gan,
            disc_apply=make_disc_logit_fn() if self.use_gan else None,
            render_cfg=self.render_cfg, gan_weight=self.train_cfg.gan_weight)
        return self.state

    def _train_loop(self, real_keys, count_items: bool) -> Dict[str, float]:
        """One pass over the train loader: a generator step per batch and,
        with the GAN, a discriminator step on its render against the render
        of ``real_keys``' clouds. Sums stay on the device; the host reads
        them every ``log_every`` batches and at the end."""
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        for batch in self.train_loader:
            tb = to_device(batch, self.device)
            disc = self.disc_state.disc if self.use_gan else None
            self.state, metrics, fake = self.train_step(self.state, tb, disc)
            if self.use_gan:
                self.disc_state, d_loss = self.disc_step(
                    self.disc_state, fake, *(tb[k] for k in real_keys))
                metrics["d_loss"] = d_loss
            count += 1
            if count_items:
                self.throughput.step(next(iter(tb.values())).shape[0])
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
            if count % self.logger.print_every == 0:
                snap = {k: float(v) / count for k, v in sums.items()}
                if count_items:
                    snap["pairs_per_sec"] = self.throughput.items_per_sec
                self.logger.log(self.state.step, snap, prefix="train")
        out = {k: float(v) / max(count, 1) for k, v in sums.items()}
        if count_items:
            out["pairs_per_sec"] = self.throughput.items_per_sec
        return out

    def save_state(self, directory: str) -> None:
        """Checkpoint the full train state for resuming: the generator's
        weights, its Adam state and LR schedule, the step count, and under
        GAN the discriminator's weights, running averages and Adam state
        (the reference saves weights only, ``train_3d_match.py:226-230``)."""
        tree = {"gen": {"params": self.model.state_dict(),
                        "opt_state": self.state.optimizer.state_dict(),
                        "scheduler": self.state.scheduler.state_dict(),
                        "step": self.state.step}}
        if self.use_gan:
            tree["disc"] = {"variables": self.disc_state.disc.state_dict(),
                            "opt_state": self.disc_state.optimizer.state_dict()}
        save_train_state(directory, tree)

    def restore_state(self, directory: str) -> None:
        """Load :meth:`save_state`'s checkpoint into this (initialized)
        trainer, in place."""
        tree = load_train_state(directory)
        gen = tree["gen"]
        self.model.load_state_dict(gen["params"], strict=True)
        self.state.optimizer.load_state_dict(gen["opt_state"])
        self.state.scheduler.load_state_dict(gen["scheduler"])
        self.state.step = int(gen["step"])
        if self.use_gan:
            self.disc_state.disc.load_state_dict(tree["disc"]["variables"], strict=True)
            self.disc_state.optimizer.load_state_dict(tree["disc"]["opt_state"])

    def fit(self, epochs: Optional[int] = None,
            profile_dir: Optional[str] = None) -> Dict[str, float]:
        """Run ``epochs - 1`` training epochs (numbered 1..epochs-1), the
        reference's exclusive bound (``train_3d_match.py:159``: ``for epoch
        in range(1, epoch_num)``), so ``epochs=1`` trains nothing. After
        :meth:`restore_state` it resumes at the epoch after the last one
        completed (one generator update per batch), the LR schedule already
        positioned by the restored state. Each epoch: train, validate, log,
        save the weights if the checkpoint metric improved, save the full
        state. ``profile_dir`` traces the first epoch."""
        epochs = epochs or self.train_cfg.epochs
        start = 1 + self.state.step // self.steps_per_epoch
        if start > 1:
            print(f"resuming at epoch {start} (restored step {self.state.step})")
        last_val: Dict[str, float] = {}
        for epoch in range(start, epochs):
            with trace(profile_dir if epoch == start else None):
                train_metrics = self.train_epoch(epoch)
            last_val = self.evaluate()
            self.logger.log(self.state.step, last_val, prefix="val")
            print(f"\nepoch {epoch}  " + "  ".join(
                f"{k}: {v:.5f}" for k, v in {**train_metrics, **last_val}.items()))
            if self.checkpointer:
                metric = last_val[self.train_cfg.checkpoint_metric]
                if self.checkpointer.maybe_save(metric, self.model.state_dict(),
                                                dataclasses.asdict(self.model.cfg)):
                    print("checkpoint saved (new best)")
            if self.checkpoint_dir:
                self.save_state(os.path.join(self.checkpoint_dir, "state"))
        return last_val


class RegistrationTrainer(_Trainer):
    """Train the PointTransformer on registration pairs (3DMatch, KITTI)."""

    def __init__(
        self,
        train_loader,
        val_loader,
        model_cfg: ModelConfig = ModelConfig(),
        train_cfg: TrainConfig = TrainConfig(),
        eval_cfg: EvalConfig = EvalConfig(),
        render_cfg: RenderConfig = RenderConfig(),
        decay_mode: Optional[str] = None,
        checkpoint_dir: Optional[str] = None,
        logger: Optional[MetricsLogger] = None,
        val_use_icp: bool = True,
        sample_img_dir: Optional[str] = None,
        mesh=None,
        device="cuda",
    ):
        _refuse_unported(mesh, sample_img_dir)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.eval_cfg = eval_cfg
        self.render_cfg = render_cfg
        self.decay_mode = decay_mode
        self.device = resolve_device(device)
        self.logger = logger or MetricsLogger(print_every=train_cfg.log_every)
        # Both reference train loops refine the validation pose with ICP
        # before RE/TE and the success rate that gates KITTI's best
        # checkpoint (train_3d_match.py:106-153, train_kitti.py:106-116);
        # False is an opt-out for quick runs.
        self.val_use_icp = val_use_icp
        self.steps_per_epoch = max(len(train_loader), 1)
        self.use_gan = train_cfg.use_gan
        mode = "max" if train_cfg.checkpoint_metric == "success_rate" else "min"
        self.checkpoint_dir = checkpoint_dir
        self.checkpointer = (BestCheckpointer(checkpoint_dir, mode=mode)
                             if checkpoint_dir else None)
        self.throughput = ThroughputMeter()

    def init(self, seed: Optional[int] = None):
        """The generator (and discriminator) from ``seed`` (default
        ``train_cfg.seed``), their optimizers and the steps."""
        seed = self.train_cfg.seed if seed is None else seed
        model = PointTransformer(self.model_cfg, device=self.device,
                                 generator=torch.Generator().manual_seed(seed))
        step_fn = lambda m, **kw: make_registration_train_step(
            m, center_mode=self.eval_cfg.center_mode, **kw)
        return self._init_optimizers(model, step_fn, self.decay_mode)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        # The discriminator's real render: the GT-aligned source beside the
        # target (train_3d_match.py:195-199).
        return self._train_loop(("src", "tgt", "src_mask", "tgt_mask", "rot", "trans"),
                                count_items=True)

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """Validation: point loss, then ``register_batch`` (pose solve and,
        with ``val_use_icp``, ICP) for RE/TE and the KITTI-style success
        rate (reference ``train_3d_match.py:106-153``,
        ``train_kitti.py:63-135``)."""
        ec = self.eval_cfg
        tot_loss, tot_re, tot_te, n = 0.0, 0.0, 0.0, 0
        succ, succ_re, succ_te = 0, 0.0, 0.0
        for batch in self.val_loader:
            tb = to_device(batch, self.device)
            src_pred = self.model(tb["src"], tb["tgt"], tb["src_mask"], tb["tgt_mask"],
                                  gt_center_hint(tb["rot"], tb["trans"], ec.center_mode))
            loss = PointTransformer.loss(src_pred.float(), tb["src"], tb["rot"],
                                         tb["trans"], tb["src_mask"])
            m = register_batch(self.model, tb, dis_thresh=ec.dis_thresh, corr=ec.corr,
                               icp_thresh=ec.icp_thresh, icp_max_iter=ec.icp_max_iter,
                               use_icp=self.val_use_icp, center_mode=ec.center_mode,
                               device=self.device)
            re, te = m.re_deg.cpu().numpy(), m.te.cpu().numpy()
            b = re.shape[0]
            tot_loss += float(loss) * b
            tot_re += float(re.sum())
            tot_te += float(te.sum())
            ok = (re <= ec.success_re_deg) & (te <= ec.success_te)
            succ += int(ok.sum())
            succ_re += float(re[ok].sum())
            succ_te += float(te[ok].sum())
            n += b
        return {
            "point_loss": tot_loss / max(n, 1),
            "rre": tot_re / max(n, 1),
            "rte": tot_te / max(n, 1),
            "success_rate": succ / max(n, 1),
            "success_rre": succ_re / max(succ, 1),
            "success_rte": succ_te / max(succ, 1),
        }


class DEMTrainer(_Trainer):
    """Train the DEMTransformer on OpenGF patches (reference
    ``train_open_gf.py``)."""

    def __init__(
        self,
        train_loader,
        val_loader,
        model_cfg: ModelConfig = ModelConfig(separate_stems=True),
        train_cfg: TrainConfig = TrainConfig(checkpoint_metric="chamfer"),
        render_cfg: RenderConfig = RenderConfig(multi_view=False),
        checkpoint_dir: Optional[str] = None,
        logger: Optional[MetricsLogger] = None,
        mesh=None,
        sample_img_dir: Optional[str] = None,
        device="cuda",
    ):
        _refuse_unported(mesh, sample_img_dir)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.model_cfg = model_cfg
        # DEM validation reports chamfer and height_mae only: the generic
        # default ("point_loss") becomes chamfer, anything else is refused.
        if train_cfg.checkpoint_metric == "point_loss":
            train_cfg = dataclasses.replace(train_cfg, checkpoint_metric="chamfer")
        elif train_cfg.checkpoint_metric not in ("chamfer", "height_mae"):
            raise ValueError(
                f"DEMTrainer checkpoint_metric {train_cfg.checkpoint_metric!r} "
                "is not produced by DEM validation (choose 'chamfer' or "
                "'height_mae')")
        self.train_cfg = train_cfg
        self.render_cfg = render_cfg
        self.device = resolve_device(device)
        self.logger = logger or MetricsLogger(print_every=train_cfg.log_every)
        self.steps_per_epoch = max(len(train_loader), 1)
        self.use_gan = train_cfg.use_gan
        self.checkpoint_dir = checkpoint_dir
        self.checkpointer = (BestCheckpointer(checkpoint_dir, mode="min")
                             if checkpoint_dir else None)

    def init(self, seed: Optional[int] = None):
        seed = self.train_cfg.seed if seed is None else seed
        model = DEMTransformer(self.model_cfg, device=self.device,
                               generator=torch.Generator().manual_seed(seed))
        return self._init_optimizers(model, make_dem_train_step)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        # The discriminator's real render: the GT DEM beside the coarse DEM.
        return self._train_loop(("dem", "dem_coarse", "dem_mask", "dem_coarse_mask"),
                                count_items=False)

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """Chamfer distance and height MAE of ``dem_pred`` against the DEM,
        averaged over patches (reference ``train_open_gf.py``)."""
        tot_cd, tot_h, n = 0.0, 0.0, 0
        for batch in self.val_loader:
            tb = to_device(batch, self.device)
            dem_pred = self.model(tb["dsm"], tb["dem_coarse"], tb["dsm_mask"],
                                  tb["dem_coarse_mask"]).float()
            cd = chamfer_distance(dem_pred, tb["dem"], tb["dsm_mask"], tb["dem_mask"])
            h = height_mae(dem_pred, tb["dem"], tb["dsm_mask"] & tb["dem_mask"])
            tot_cd += float(cd.sum())
            tot_h += float(h.sum())
            n += cd.shape[0]
        return {"chamfer": tot_cd / max(n, 1), "height_mae": tot_h / max(n, 1)}
