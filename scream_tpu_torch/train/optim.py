"""Optimizers and LR schedules (port of ``scream_tpu/train/optim.py``).

Reference semantics: generator Adam lr 2e-4 (3DMatch/OpenGF,
``train_3d_match.py:34-39``) or 3.2e-4 (KITTI), betas (0.9, 0.999);
discriminator Adam lr 1e-4, betas (0.5, 0.999) (``train_3d_match.py:41``).
The generator LR halves with a 1e-5 floor at fixed epoch boundaries: every
15 epochs, or first at epoch 10 then every 30 (KITTI,
``train_kitti.py:231-234``). The schedule is indexed by update count, as
optax's ``piecewise_constant_schedule``: update ``k`` (0-based) runs at
``lr(k)``, and a boundary's factor applies from the update whose count
equals it.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence, Tuple

import torch

from scream_tpu_torch.config import TrainConfig


def decay_epochs(mode: str, total_epochs: int) -> Sequence[int]:
    """Epoch boundaries at which the LR halves: "every15" -> 15, 30, 45...;
    "kitti" -> 10, 30, 60, 90 (the reference's ``lr_update_epoch`` switches
    10 -> 30 right after the epoch-10 decay)."""
    if mode == "every15":
        return list(range(15, total_epochs + 1, 15))
    if mode == "kitti":
        return [10] + list(range(30, total_epochs + 1, 30))
    raise ValueError(f"unknown decay mode {mode!r}")


def lr_schedule(base_lr: float, boundaries_epochs: Sequence[int], steps_per_epoch: int,
                gamma: float = 0.5, min_lr: float = 1e-5) -> Callable[[int], float]:
    """Piecewise-constant step decay with a floor: ``count -> lr``."""
    values = [base_lr]
    for _ in boundaries_epochs:
        values.append(max(values[-1] * gamma, min_lr))
    scales = sorted((int(e * steps_per_epoch), values[i + 1] / values[i])
                    for i, e in enumerate(boundaries_epochs) if values[i + 1] != values[i])

    def schedule(count: int) -> float:
        lr = base_lr
        for boundary, scale in scales:
            if count >= boundary:
                lr *= scale
        return lr

    return schedule


def generator_optimizer(params: Iterable[torch.nn.Parameter], cfg: TrainConfig,
                        steps_per_epoch: int, decay_mode: str | None = None
                        ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam with the epoch-boundary step decay of ``cfg.decay_mode``
    (``decay_mode`` overrides it): ``(optimizer, scheduler)``; call
    ``scheduler.step()`` after each ``optimizer.step()``."""
    sched = lr_schedule(cfg.lr_g, decay_epochs(decay_mode or cfg.decay_mode, cfg.epochs),
                        steps_per_epoch, cfg.lr_decay_gamma, cfg.min_lr)
    opt = torch.optim.Adam(params, lr=cfg.lr_g, betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: sched(k) / cfg.lr_g)


def discriminator_optimizer(params: Iterable[torch.nn.Parameter],
                            cfg: TrainConfig) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=cfg.lr_d, betas=(cfg.adam_b1_d, cfg.adam_b2),
                            eps=1e-8)
