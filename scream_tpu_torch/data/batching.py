"""Static-shape batching: pad-to-capacity clouds with validity masks
(port of ``scream_tpu/data/batching.py``). Batches are dicts of numpy
arrays; the pipeline and the trainers move them to the device in one step."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def pad_cloud(points: np.ndarray, capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad ``(n, 3)`` points to ``(capacity, 3)`` plus a boolean mask.
    Oversize input is an error: callers downsample first."""
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"cloud has {n} points > capacity {capacity}; downsample first")
    out = np.zeros((capacity, 3), dtype=np.float32)
    out[:n] = points
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return out, mask


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket capacity >= n (buckets sorted ascending)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} points exceed largest bucket {buckets[-1]}")


def collate_pairs(
    items: List[dict],
    src_capacity: int,
    tgt_capacity: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Stack pair dicts (``src, tgt, rot, trans, scale, center`` plus the
    optional ``idx, covariance, scene`` sidecars) into one padded batch
    with ``src_mask``/``tgt_mask``."""
    if tgt_capacity is None:
        tgt_capacity = src_capacity
    b = len(items)
    batch: Dict[str, np.ndarray] = {
        "src": np.zeros((b, src_capacity, 3), np.float32),
        "tgt": np.zeros((b, tgt_capacity, 3), np.float32),
        "src_mask": np.zeros((b, src_capacity), bool),
        "tgt_mask": np.zeros((b, tgt_capacity), bool),
        "rot": np.zeros((b, 3, 3), np.float32),
        "trans": np.zeros((b, 3, 1), np.float32),
        "scale": np.zeros((b,), np.float32),
        "center": np.zeros((b, 3), np.float32),
    }
    # All-or-none sidecars: a mixed batch would drop them depending on order.
    with_cov = ["covariance" in it for it in items]
    if any(with_cov) and not all(with_cov):
        raise ValueError(
            "collate_pairs: batch mixes items with and without 'covariance' "
            f"sidecars ({sum(with_cov)}/{len(items)} have it)"
        )
    has_info = with_cov[0]
    if has_info:
        batch["idx"] = np.zeros((b, 2), np.int32)
        batch["covariance"] = np.zeros((b, 6, 6), np.float32)
        batch["scene"] = np.zeros((b,), np.int32)

    for i, it in enumerate(items):
        batch["src"][i], batch["src_mask"][i] = pad_cloud(it["src"], src_capacity)
        batch["tgt"][i], batch["tgt_mask"][i] = pad_cloud(it["tgt"], tgt_capacity)
        batch["rot"][i] = it["rot"]
        batch["trans"][i] = np.reshape(it["trans"], (3, 1))
        batch["scale"][i] = it.get("scale", 1.0)
        batch["center"][i] = it.get("center", np.zeros(3))
        if has_info:
            batch["idx"][i] = it["idx"]
            batch["covariance"][i] = it["covariance"]
            batch["scene"][i] = it.get("scene", 0)
    return batch


def collate_dem(
    items: List[dict], dsm_capacity: int, dem_capacity: int, coarse_capacity: int
) -> Dict[str, np.ndarray]:
    """Stack OpenGF items (``dsm, dem, dem_coarse``, optional ``center``)
    into one padded batch with ``dsm_mask``, ``dem_mask`` and
    ``dem_coarse_mask``."""
    b = len(items)
    batch = {
        "dsm": np.zeros((b, dsm_capacity, 3), np.float32),
        "dem": np.zeros((b, dem_capacity, 3), np.float32),
        "dem_coarse": np.zeros((b, coarse_capacity, 3), np.float32),
        "dsm_mask": np.zeros((b, dsm_capacity), bool),
        "dem_mask": np.zeros((b, dem_capacity), bool),
        "dem_coarse_mask": np.zeros((b, coarse_capacity), bool),
    }
    # All-or-none, as collate_pairs' sidecars: a mixed batch would zero some
    # rows' centres.
    with_center = ["center" in it for it in items]
    if any(with_center) and not all(with_center):
        raise ValueError("either every item carries 'center' or none does")
    if with_center[0]:
        batch["center"] = np.zeros((b, 2), np.float32)
    for i, it in enumerate(items):
        batch["dsm"][i], batch["dsm_mask"][i] = pad_cloud(it["dsm"], dsm_capacity)
        batch["dem"][i], batch["dem_mask"][i] = pad_cloud(it["dem"], dem_capacity)
        batch["dem_coarse"][i], batch["dem_coarse_mask"][i] = pad_cloud(
            it["dem_coarse"], coarse_capacity)
        if "center" in it:
            batch["center"][i] = np.asarray(it["center"], np.float32).reshape(-1)[:2]
    return batch
