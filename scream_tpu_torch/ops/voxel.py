"""Voxel-grid downsampling on the device at a fixed capacity (port of
``scream_tpu/ops/voxel.py``; Open3D's ``voxel_down_sample``, reference
``process_3d_match.py:31``, ``datasets/open_gf.py:22``).

Open3D's semantics: voxel index ``floor((p - min_bound) / voxel_size)``,
output the centroid of each occupied voxel. :func:`voxel_downsample` keeps
static shapes, as the JAX op does: ``(capacity, 3)`` centroids and a mask,
voxels in key order, those beyond ``capacity`` dropped. It sorts the
integer voxel coordinates lexicographically (three stable sorts, the last
on the first coordinate), marks run starts, numbers the runs by a cumulative
sum and adds each run's points and count into its slot. The offline
preprocessors keep the native library (``scream_tpu_torch/native``);
:func:`voxel_downsample_np` is the numpy version of the same function.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_SENTINEL = torch.iinfo(torch.int32).max


def voxel_downsample(points: torch.Tensor, voxel_size: float, capacity: int,
                     mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(N, 3)`` points -> ``(centroids (capacity, 3), valid (capacity,))``
    on the points' device: ``centroids[i]`` the mean of the i-th occupied
    voxel in key order, unoccupied slots zero and invalid. ``mask`` marks
    the valid rows of a padded input."""
    n = points.shape[0]
    dev = points.device
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    pts = points.float()
    origin = torch.where(mask[:, None], pts, torch.full_like(pts, 3e38)).amin(0)
    coords = torch.floor((pts - origin) / voxel_size).to(torch.int32)
    coords = torch.where(mask[:, None], coords, torch.full_like(coords, _SENTINEL))
    # Lexicographic on (c0, c1, c2): stable sorts from the last key to the
    # first (the JAX op's lexsort; no int64 key that a fine grid overflows).
    order = torch.arange(n, device=dev)
    for c in (2, 1, 0):
        order = order[torch.argsort(coords[order, c], stable=True)]
    coords_sorted, pts_sorted, valid_sorted = coords[order], pts[order], mask[order]

    prev = torch.cat([torch.full((1, 3), -1, dtype=coords.dtype, device=dev),
                      coords_sorted[:-1]])
    run_start = (coords_sorted != prev).any(1) & valid_sorted
    seg_id = torch.cumsum(run_start.to(torch.int64), 0) - 1
    # Invalid rows, and voxels beyond the capacity, go to the dropped slot.
    seg_id = torch.where(valid_sorted, torch.clamp_max(seg_id, capacity),
                         torch.full_like(seg_id, capacity))

    sums = torch.zeros((capacity + 1, 3), dtype=torch.float32, device=dev)
    sums.index_add_(0, seg_id, pts_sorted)
    counts = torch.zeros((capacity + 1,), dtype=torch.float32, device=dev)
    counts.index_add_(0, seg_id, torch.ones((n,), dtype=torch.float32, device=dev))
    sums, counts = sums[:capacity], counts[:capacity]

    valid = counts > 0
    centroids = sums / torch.clamp_min(counts[:, None], 1.0)
    return torch.where(valid[:, None], centroids, torch.zeros_like(centroids)), valid


def voxel_downsample_np(points, voxel_size: float) -> np.ndarray:
    """Host (numpy, float64) version with the same semantics: only the
    occupied voxels, in key order."""
    pts = np.asarray(points, dtype=np.float64)
    origin = pts.min(axis=0)
    coords = np.floor((pts - origin) / voxel_size).astype(np.int64)
    dims = coords.max(axis=0) + 1
    key = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    pts_sorted = pts[order]
    starts = np.flatnonzero(np.concatenate([[True], key_sorted[1:] != key_sorted[:-1]]))
    sums = np.add.reduceat(pts_sorted, starts, axis=0)
    counts = np.diff(np.concatenate([starts, [len(pts)]]))
    return (sums / counts[:, None]).astype(np.float32)
