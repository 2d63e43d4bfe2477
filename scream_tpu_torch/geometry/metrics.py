"""Registration metrics, batched (port of ``scream_tpu/geometry/metrics.py``):
RE/TE (reference ``utils.py:181-189``) and the redwood RMSE
(reference ``evaluate_3d_match.py:31-50``)."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from scream_tpu_torch.geometry import so3


def transformation_error(pred_trans: torch.Tensor, gt_trans: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(RE degrees, TE) between ``(..., 4, 4)`` transforms:
    ``RE = arccos(clamp((tr(Rp^T Rg) - 1) / 2)) * 180/pi``, ``TE = |tp - tg|``."""
    tr = (pred_trans[..., :3, :3] * gt_trans[..., :3, :3]).sum((-1, -2))
    re = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)) * (180.0 / math.pi)
    te = torch.linalg.vector_norm(pred_trans[..., :3, 3] - gt_trans[..., :3, 3], dim=-1)
    return re, te


def redwood_rmse(trans: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """``er^T info er / info[0, 0]`` for the residual transform ``trans``,
    ``er = [t, q_xyz]`` with the w >= 0 canonical quaternion."""
    t = trans[..., :3, 3]
    q = so3.quat_from_matrix(trans[..., :3, :3])
    q = torch.where(q[..., 0:1] < 0.0, -q, q)
    er = torch.cat([t, q[..., 1:]], -1)
    return torch.einsum("...i,...ij,...j->...", er, info, er) / info[..., 0, 0]


def registration_recall_rmse(pred_T: torch.Tensor, gt_T: torch.Tensor,
                             info: torch.Tensor) -> torch.Tensor:
    """sqrt(redwood RMSE) of ``gt^-1 @ pred``; success iff < 0.2 m
    (reference ``evaluate_3d_match.py:122-126``). A negative quadratic form
    maps to +inf, the decision the reference's unguarded sqrt makes."""
    residual = torch.linalg.inv(gt_T) @ pred_T
    p = redwood_rmse(residual, info)
    return torch.where(p < 0.0, torch.full_like(p, math.inf),
                       torch.sqrt(torch.clamp_min(p, 0.0)))
