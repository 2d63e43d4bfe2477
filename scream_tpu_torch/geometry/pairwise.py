"""Pairwise squared distances and masked nearest-neighbour search in plain
PyTorch (port of ``scream_tpu/geometry/pairwise.py``; reference
``utils.py:72-78``). One fp32 matmul plus rank-1 norms, TF32 off."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

BIG = 1e10


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``(..., N, 3), (..., M, 3) -> (..., N, M)``: ``-2 S D^T + |s|^2 + |d|^2``
    in fp32, clamped at 0 (the expansion can go slightly negative)."""
    src, dst = src.float(), dst.float()
    sq_src = (src * src).sum(-1)[..., :, None]
    sq_dst = (dst * dst).sum(-1)[..., None, :]
    cross = src @ dst.transpose(-1, -2)
    return torch.clamp_min(sq_src + sq_dst - 2.0 * cross, 0.0)


def masked_square_distance(
    src: torch.Tensor,
    dst: torch.Tensor,
    src_mask: Optional[torch.Tensor] = None,
    dst_mask: Optional[torch.Tensor] = None,
    fill: float = BIG,
) -> torch.Tensor:
    """:func:`square_distance` with invalid rows/cols set to ``fill``."""
    dist = square_distance(src, dst)
    if dst_mask is not None:
        dist = torch.where(dst_mask[..., None, :], dist, torch.full_like(dist, fill))
    if src_mask is not None:
        dist = torch.where(src_mask[..., :, None], dist, torch.full_like(dist, fill))
    return dist


def nearest_neighbor(
    src: torch.Tensor,
    dst: torch.Tensor,
    dst_mask: Optional[torch.Tensor] = None,
    chunk: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per src point, the squared distance and index of its NN in dst,
    streamed over ``chunk``-row src tiles; invalid dst points never win."""
    dists, idxs = [], []
    for n0 in range(0, src.shape[-2], chunk):
        d = masked_square_distance(src[..., n0:n0 + chunk, :], dst, dst_mask=dst_mask)
        m, i = d.min(-1)
        dists.append(m)
        idxs.append(i)
    return torch.cat(dists, -1), torch.cat(idxs, -1)


def radius_count(
    src: torch.Tensor,
    dst: torch.Tensor,
    radius: float,
    src_mask: Optional[torch.Tensor] = None,
    dst_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Number of dst points within ``radius`` of each src point, ``(..., N)``
    (the KD-tree radius search of reference ``utils.py:94-108``)."""
    return radius_correspondence_mask(src, dst, radius, src_mask, dst_mask).sum(-1)


def radius_correspondence_mask(
    src: torch.Tensor,
    dst: torch.Tensor,
    radius: float,
    src_mask: Optional[torch.Tensor] = None,
    dst_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Boolean ``(..., N, M)`` correspondences ``dist(i, j) < radius``."""
    return masked_square_distance(src, dst, src_mask, dst_mask) < radius * radius
