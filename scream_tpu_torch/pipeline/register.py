"""End-to-end registration of a padded batch (port of the ``register_batch``
path of ``scream_tpu/pipeline/register.py``; reference
``evaluate_3d_match.py:53-171``).

Protocol details kept from the JAX package, each load-bearing:

* the NN validity threshold applies to **squared** distances of the
  de-scaled but not de-centred clouds ``src_pred/s`` vs ``tgt/s``
  (reference ``:94-96``);
* Kabsch runs in the fully de-normalized frame ``x/s + c`` (``:97-101``);
* zero-overlap mode ("src_pred") pairs ``src`` with ``src_pred`` itself;
* the GT pose is re-derived in the de-normalized frame as
  ``[R | t/s + c - R c]`` (``:90``);
* ICP (threshold 0.1, 30 iterations) is kept only if RE *and* TE both
  improve (``:109-119``).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from scream_tpu_torch.geometry.icp import icp_refine_if_better
from scream_tpu_torch.geometry.kabsch import kabsch
from scream_tpu_torch.geometry.metrics import (registration_recall_rmse,
                                               transformation_error)
from scream_tpu_torch.ops.nn_cuda import nearest_neighbor_full
from scream_tpu_torch.utils.device import resolve_device


class PoseSolution(NamedTuple):
    transform: torch.Tensor  # (B, 4, 4) in the de-normalized frame
    n_corr: torch.Tensor  # (B,) number of valid correspondences


class RegistrationMetrics(NamedTuple):
    transform: torch.Tensor  # (B, 4, 4)
    re_deg: torch.Tensor  # (B,)
    te: torch.Tensor  # (B,)
    n_corr: torch.Tensor  # (B,)
    rmse: Optional[torch.Tensor] = None  # (B,) redwood RMSE when covariance given


def spread_subsample_indices(n: int, k: int) -> np.ndarray:
    """``k`` evenly spaced indices into ``range(n)``: ``floor(i * n / k)``,
    so a ``k`` that does not divide ``n`` still spans the whole cloud."""
    return np.floor(np.arange(k) * (n / k)).astype(np.int32)


def denormalized_gt(rot, trans, scale, center) -> torch.Tensor:
    """GT pose in the de-normalized frame: ``[R | t/s + c - R c]``
    (reference ``evaluate_3d_match.py:90``)."""
    t = trans.reshape(*trans.shape[:-2], 3) / scale[..., None]
    t = t + center - torch.einsum("...ij,...j->...i", rot, center)
    T = torch.zeros(*rot.shape[:-2], 4, 4, dtype=torch.float32, device=rot.device)
    T[..., :3, :3] = rot
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def solve_pose(src, src_pred, tgt, src_mask, tgt_mask, scale, center,
               dis_thresh: float = 0.1, corr: str = "tgt") -> PoseSolution:
    """Batched rigid pose from the predicted source cloud: exact NN of
    ``src_pred/s`` in ``tgt/s``, inliers below ``dis_thresh`` (squared),
    weighted Kabsch in the de-normalized frame. ``corr="src_pred"`` pairs
    src with src_pred directly (ZeroMatch)."""
    inv_s = (1.0 / scale)[:, None, None]
    nn_d2, _, nn_xyz = nearest_neighbor_full(src_pred * inv_s, tgt * inv_s, tgt_mask)
    valid = (nn_d2 < dis_thresh) & src_mask

    src_dn = src * inv_s + center[:, None, :]
    if corr == "tgt":
        # nn_xyz is already de-scaled (the search saw tgt/s).
        partner = nn_xyz + center[:, None, :]
    elif corr == "src_pred":
        partner = src_pred * inv_s + center[:, None, :]
    else:
        raise ValueError(f"unknown corr mode {corr!r}")

    T = kabsch(src_dn, partner, weights=valid.float())
    return PoseSolution(T, valid.sum(-1))


def gt_center_hint(rot, trans, mode: str = "trans"):
    """The GT-derived ``src_center`` hint the protocols feed the model,
    ``(B, 1, 3)``: ``t`` for 3DMatch (``"trans"``, reference
    ``evaluate_3d_match.py:84``), ``-R^T t`` for KITTI (``"neg_rt"``,
    ``evaluate_kitti.py:39``), None for the model's masked centroid."""
    if mode == "none":
        return None
    if mode == "trans":
        return trans.transpose(-1, -2)
    if mode == "neg_rt":
        return -torch.einsum("bji,bjk->bik", rot, trans).transpose(-1, -2)
    raise ValueError(f"unknown center mode {mode!r}")


def _register_solve_stage(model, batch, dis_thresh, corr, center_mode):
    """Forward + pose solve + de-normalization (the pre-ICP prefix)."""
    src, tgt = batch["src"], batch["tgt"]
    src_mask, tgt_mask = batch["src_mask"], batch["tgt_mask"]
    rot, trans = batch["rot"], batch["trans"]
    scale, center = batch["scale"], batch["center"]

    src_center = gt_center_hint(rot, trans, center_mode)
    src_pred = model(src, tgt, src_mask, tgt_mask, src_center)
    sol = solve_pose(src, src_pred.float(), tgt, src_mask, tgt_mask, scale,
                     center, dis_thresh, corr)
    gt_T = denormalized_gt(rot, trans, scale, center)
    inv_s = (1.0 / scale)[:, None, None]
    src_dn = src * inv_s + center[:, None, :]
    tgt_dn = tgt * inv_s + center[:, None, :]
    return sol, gt_T, src_dn, tgt_dn


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy arrays or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


@torch.no_grad()
def register_batch(
    model: Callable,
    batch: Dict,
    dis_thresh: float = 0.1,
    corr: str = "tgt",
    icp_thresh: float = 0.1,
    icp_max_iter: int = 30,
    use_icp: bool = True,
    icp_subsample: Optional[int] = None,
    center_mode: str = "trans",
    device="cuda",
) -> RegistrationMetrics:
    """Full eval step for one padded batch: forward, solve, refine, measure.

    ``batch`` uses the loader schema (src/tgt/masks/rot/trans/scale/center,
    optional covariance), as numpy arrays or tensors; it is moved to
    ``device``. ``model(src, tgt, src_mask, tgt_mask, src_center)`` returns
    ``src_pred`` (a :class:`PointTransformer` on ``device``). As in the
    reference protocol, ``src_center`` is the GT-derived hint.

    ``icp_subsample=k`` refines on ``k`` evenly spaced src points
    (throughput mode; the reference refines on all points).
    """
    dev = resolve_device(device)
    batch = to_device(batch, dev)
    src_mask, tgt_mask = batch["src_mask"], batch["tgt_mask"]
    sol, gt_T, src_dn, tgt_dn = _register_solve_stage(
        model, batch, dis_thresh, corr, center_mode)

    if use_icp:
        icp_src, icp_src_mask = src_dn, src_mask
        if icp_subsample is not None and icp_subsample < src_dn.shape[1]:
            idx = torch.as_tensor(
                spread_subsample_indices(src_dn.shape[1], icp_subsample),
                dtype=torch.long, device=dev)
            icp_src, icp_src_mask = src_dn[:, idx], src_mask[:, idx]
        T, re, te = icp_refine_if_better(
            icp_src, tgt_dn, sol.transform, gt_T, icp_thresh,
            max_iteration=icp_max_iter, src_mask=icp_src_mask, tgt_mask=tgt_mask)
    else:
        T = sol.transform
        re, te = transformation_error(T, gt_T)

    rmse = None
    if "covariance" in batch:
        rmse = registration_recall_rmse(T, gt_T, batch["covariance"])
    return RegistrationMetrics(T, re, te, sol.n_corr, rmse)
