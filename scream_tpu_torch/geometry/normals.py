"""Point-cloud normals by PCA over the k nearest neighbours (port of
``scream_tpu/geometry/normals.py``; Open3D's ``estimate_normals``, which the
reference calls before its visualizations, ``visualize_3d_match.py:175-177``).

Batched on the clouds' device: the masked squared-distance matrix, the k
nearest by ``torch.topk``, the neighbourhood covariance, and its smallest
eigenvector by a batched ``torch.linalg.eigh``. As in Open3D without an
orientation pass, the sign is arbitrary; :func:`orient_normals_towards`
flips normals towards a camera.
"""

from __future__ import annotations

from typing import Optional

import torch

from scream_tpu_torch.geometry.pairwise import BIG, masked_square_distance


def estimate_normals(points: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     k: int = 30) -> torch.Tensor:
    """Unit normals ``(B, N, 3)`` of clouds ``(B, N, 3)`` (or ``(N, 3)`` ->
    ``(N, 3)``). ``k`` is Open3D's ``KDTreeSearchParamKNN(knn=30)`` default;
    the point itself is one of its neighbours; masked rows get a zero
    normal, and masked neighbours (present only when a row has fewer than
    ``k`` valid candidates) weigh nothing."""
    if points.dim() == 2:
        return estimate_normals(points[None], None if mask is None else mask[None], k)[0]
    B, N, _ = points.shape
    if mask is None:
        mask = torch.ones((B, N), dtype=torch.bool, device=points.device)
    pts = points.float()

    d2 = masked_square_distance(pts, pts, dst_mask=mask)
    neg_d, idx = torch.topk(-d2, min(k, N), dim=-1)  # (B, N, k), nearest first
    bi = torch.arange(B, device=pts.device)[:, None, None]
    w = ((neg_d > -BIG / 2) & mask[bi, idx]).float()[..., None]  # (B, N, k, 1)

    nb = pts[bi, idx]  # (B, N, k, 3)
    n_nb = torch.clamp_min(w.sum(2), 1.0)  # (B, N, 1)
    mean = (nb * w).sum(2) / n_nb
    centered = (nb - mean[:, :, None, :]) * w
    cov = torch.einsum("bnkc,bnkd->bncd", centered, centered) / n_nb[..., None]

    _, vecs = torch.linalg.eigh(cov)  # ascending eigenvalues
    normal = vecs[..., 0]
    normal = normal / torch.clamp_min(torch.linalg.vector_norm(normal, dim=-1, keepdim=True),
                                      1e-12)
    return torch.where(mask[..., None], normal, torch.zeros_like(normal))


def orient_normals_towards(normals: torch.Tensor, points: torch.Tensor,
                           camera: torch.Tensor) -> torch.Tensor:
    """Flip normals to face ``camera`` (Open3D
    ``orient_normals_towards_camera_location``)."""
    sign = torch.sign((normals * (camera - points)).sum(-1, keepdim=True))
    return normals * torch.where(sign == 0, torch.ones_like(sign), sign)
