"""Weighted Kabsch/SVD rigid-pose solver (port of
``scream_tpu/geometry/kabsch.py``; reference ``utils.py:112-178``).

Batched and on the device: the 3x3 SVD is ``torch.linalg.svd`` (the JAX
package leaves it to XLA), everything in fp32 with TF32 off.
"""

from __future__ import annotations

from typing import Optional

import torch


def integrate_trans(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotation ``(..., 3, 3)`` + translation ``(..., 3, 1)`` -> ``(..., 4, 4)``."""
    batch = R.shape[:-2]
    T = torch.eye(4, dtype=R.dtype, device=R.device).expand(*batch, 4, 4).clone()
    T[..., :3, :3] = R
    T[..., :3, 3:4] = t.reshape(*batch, 3, 1)
    return T


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of ``(..., 3, 3)`` by cofactors (no LU, no library call)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def kabsch(
    A: torch.Tensor,
    B: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    weight_threshold: float = 0.0,
) -> torch.Tensor:
    """Weighted rigid alignment ``B ~ R A + t`` -> ``(..., 4, 4)``.

    Weights below ``weight_threshold`` are zeroed; weighted centroids with a
    1e-6 denominator guard; ``H = Am^T diag(w) Bm``; SVD with the
    determinant correction so ``R`` is a proper rotation
    (``R = V diag(1, 1, det(V U^T)) U^T``).
    """
    A = A.float()
    B = B.float()
    if weights is None:
        weights = torch.ones(A.shape[:-1], dtype=torch.float32, device=A.device)
    else:
        weights = weights.float()
    weights = torch.where(weights < weight_threshold, torch.zeros_like(weights), weights)

    w_sum = weights.sum(-1, keepdim=True)[..., None] + 1e-6
    centroid_A = (A * weights[..., None]).sum(-2, keepdim=True) / w_sum
    centroid_B = (B * weights[..., None]).sum(-2, keepdim=True) / w_sum

    Am = A - centroid_A
    Bm = B - centroid_B
    H = (Am * weights[..., None]).transpose(-1, -2) @ Bm

    U, _, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    det = _det3(V @ Ut)
    diag = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = (V * diag[..., None, :]) @ Ut

    t = centroid_B.transpose(-1, -2) - R @ centroid_A.transpose(-1, -2)
    return integrate_trans(R, t)


def kabsch_from_correspondence(src: torch.Tensor, dst_gathered: torch.Tensor,
                               valid: torch.Tensor) -> torch.Tensor:
    """Kabsch over gathered correspondences with a validity mask: the padded
    form of the reference's ``rigid_transform_3d(src[:, valid_ind],
    tgt[:, tgt_ind])`` (``models/pointnet.py:67-74``), invalid rows at
    weight 0 instead of compacted away."""
    return kabsch(src, dst_gathered, weights=valid.float())
