"""Registration and ground-generation metrics, batched (port of
``scream_tpu/geometry/metrics.py``): RE/TE (reference ``utils.py:181-189``),
the redwood RMSE (reference ``evaluate_3d_match.py:31-50``), and the DEM
metrics, chamfer distance and height MAE/MSE (reference
``evaluate_open_gf.py:25-66``)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from scream_tpu_torch.geometry import so3
from scream_tpu_torch.geometry.pairwise import masked_square_distance


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


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x.mean(-1)
    m = mask.to(x.dtype)
    return (x * m).sum(-1) / torch.clamp_min(m.sum(-1), 1.0)


def chamfer_distance(f: torch.Tensor, f_: torch.Tensor,
                     mask_f: Optional[torch.Tensor] = None,
                     mask_f_: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Both-direction mean of min squared distances, per batch element:
    ``mean_i min_j d(i,j) + mean_j min_i d(i,j)`` (squared, no sqrt;
    reference ``evaluate_open_gf.py:25-41``); the masked variant averages
    over valid points only."""
    dist = masked_square_distance(f, f_, mask_f, mask_f_)
    return _masked_mean(dist.amin(-1), mask_f) + _masked_mean(dist.amin(-2), mask_f_)


def height_mae(pred: torch.Tensor, gt: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean ``|z_pred - z_gt|`` (reference ``evaluate_open_gf.py:62-63``)."""
    return _masked_mean(torch.abs(pred[..., 2] - gt[..., 2]), mask)


def height_mse(pred: torch.Tensor, gt: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean ``(z_pred - z_gt)^2`` (reference ``evaluate_open_gf.py:65-66``)."""
    return _masked_mean((pred[..., 2] - gt[..., 2]) ** 2, mask)
