"""Dataset readers (port of ``scream_tpu/data/datasets.py``): the
registration splits of the preprocessed ``.npy`` layout
(``<root>/<split>/src%d.npy / tgt%d.npy / T%d.npy``, test sidecars under
``info/``), the OpenGF patches (``<root>/OpenGF_<split>/%d.npy`` holding
``[dsm | dem]`` columns, centres under ``centers/``), and the synthetic
pairs; the same item schemas and seeds as the JAX package.
"""

from __future__ import annotations

import os
import threading
import warnings
from typing import Dict, List, Optional

import numpy as np

from scream_tpu_torch.data import transforms
from scream_tpu_torch.data.synthetic import make_pair

# Canonical split sizes (reference datasets/three_d_match.py:173,200,226,252,278,
# datasets/kitti.py:281,308,333, datasets/open_gf.py:16,36,56).
CANONICAL_SIZES = {
    "3DMatch_train": 27730,
    "3DMatch_val": 1749,
    "3DMatch_test": 1253,
    "3DLoMatch_test": 1518,
    "3DZeroMatch_test": 1389,
    "KITTI_train": 1358,
    "KITTI_val": 180,
    "KITTI_test": 554,
    "OpenGF_train": 10693,
    "OpenGF_val": 75,
    "OpenGF_test": 650,
}

# The 8 redwood test scenes (reference datasets/three_d_match.py:156-165).
SCENE_NAME_TO_IDX = {
    "7-scenes-redkitchen": 0,
    "sun3d-home_at-home_at_scan1_2013_jan_1": 1,
    "sun3d-home_md-home_md_scan9_2012_sep_30": 2,
    "sun3d-hotel_uc-scan3": 3,
    "sun3d-hotel_umd-maryland_hotel1": 4,
    "sun3d-hotel_umd-maryland_hotel3": 5,
    "sun3d-mit_76_studyroom-76-1studyroom2": 6,
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika": 7,
}

OPENGF_SCALE_FACTOR = 50.0  # reference datasets/open_gf.py:8
OPENGF_COARSE_RESOLUTION = 20.0  # reference datasets/open_gf.py:13


def _count_items(directory: str, pattern: str = "src%d.npy") -> int:
    n = 0
    while os.path.exists(os.path.join(directory, pattern % n)):
        n += 1
    return n


def _check_canonical_size(split_dir: str, discovered: int) -> None:
    """Warn when a discovered split length disagrees with the reference's
    count (usually a truncated download): lengths are discovered, so
    partial datasets still load, but protocol numbers over them are not
    comparable."""
    expected = CANONICAL_SIZES.get(split_dir)
    if expected is not None and discovered not in (0, expected):
        warnings.warn(
            f"{split_dir}: found {discovered} items on disk but the reference "
            f"split has {expected}; possibly a truncated download, and protocol "
            "metrics over this split will not be comparable.",
            stacklevel=3,
        )


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Centroid per occupied voxel, ordered by the linearized voxel key
    (the numpy version of the JAX package's ``ops/voxel.py``, which its
    native ``pointops.cpp`` matches; float64 sums, fp32 out)."""
    pts = np.asarray(points, dtype=np.float64)
    origin = pts.min(axis=0)
    coords = np.floor((pts - origin) / voxel_size).astype(np.int64)
    dims = coords.max(axis=0) + 1
    key = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    starts = np.flatnonzero(np.concatenate([[True], key_sorted[1:] != key_sorted[:-1]]))
    sums = np.add.reduceat(pts[order], starts, axis=0)
    counts = np.diff(np.concatenate([starts, [len(pts)]]))
    return (sums / counts[:, None]).astype(np.float32)


def _norm_fn(name: str):
    """Strict normalization lookup: an unknown mode fails fast."""
    try:
        return {
            "unit_sphere": transforms.normalize_unit_sphere,
            "unit_sphere_raw": transforms.normalize_unit_sphere_raw,
            "unit_cube": transforms.normalize_unit_cube,
            "unit_cube_raw": transforms.normalize_unit_cube_raw,
        }[name]
    except KeyError:
        raise ValueError(
            f"unknown normalize mode {name!r}; expected 'unit_sphere', "
            "'unit_sphere_raw', 'unit_cube' or 'unit_cube_raw'"
        ) from None


class _PerItemSeeds:
    """Thread-safe, reproducible augmentation RNG streams: each
    (item, visit-count) pair gets its own deterministic seed."""

    def __init__(self, seed: int):
        self.seed = seed
        self._counts: Dict[int, int] = {}
        self._lock = threading.Lock()

    def rng(self, item: int) -> np.random.Generator:
        with self._lock:
            k = self._counts.get(item, 0)
            self._counts[item] = k + 1
        return np.random.default_rng((self.seed, item, k))


class PairDataset:
    """Registration pairs of a preprocessed split, augmented and normalized
    on read: ``normalize`` "unit_sphere" (3DMatch) or "unit_cube" (KITTI),
    ``augment=True`` the training perturbation.

    ``max_points``: clouds larger than this are subsampled on read (seeded
    per item) to fit the padding bucket; None keeps them whole (the loader
    then raises on an oversize cloud).
    """

    def __init__(
        self,
        root: str,
        split_dir: str,
        normalize: str = "unit_sphere",
        augment: bool = False,
        perturb_both_sides: bool = True,
        perturb_std: float = 0.1,
        jitter_std: float = 0.003,
        with_info: bool = False,
        seed: int = 0,
        max_points: Optional[int] = None,
    ):
        self.dir = os.path.join(root, split_dir)
        self.split_dir = split_dir
        self.normalize = normalize
        self.augment = augment
        self.perturb_both_sides = perturb_both_sides
        self.perturb_std = perturb_std
        self.jitter_std = jitter_std
        self.with_info = with_info
        self.max_points = max_points
        self._seeds = _PerItemSeeds(seed)
        self.length = _count_items(self.dir)
        _check_canonical_size(split_dir, self.length)
        self.scene_names: Optional[List[str]] = None
        if with_info:
            names_path = os.path.join(self.dir, "info", "scene_names.txt")
            # Without scene names every pair would collate to scene 0 and the
            # per-scene recall would average one bucket.
            if not os.path.exists(names_path):
                raise FileNotFoundError(
                    f"{names_path} missing: with_info=True needs the scene-name "
                    "sidecar (or pass with_info=False)")
            with open(names_path) as f:
                self.scene_names = [line.strip() for line in f]

    def __len__(self) -> int:
        return self.length

    def _cap(self, pts: np.ndarray, item: int, salt: int) -> np.ndarray:
        if self.max_points is None or len(pts) <= self.max_points:
            return pts
        r = np.random.default_rng(item * 2 + salt)
        return pts[r.choice(len(pts), self.max_points, replace=False)]

    def __getitem__(self, item: int) -> Dict[str, np.ndarray]:
        src = self._cap(np.load(os.path.join(self.dir, "src%d.npy" % item)), item, 0)
        tgt = self._cap(np.load(os.path.join(self.dir, "tgt%d.npy" % item)), item, 1)
        T = np.load(os.path.join(self.dir, "T%d.npy" % item))
        if self.augment:
            src, tgt, T = transforms.augment_pair(
                self._seeds.rng(item), src, tgt, T,
                perturb_std=self.perturb_std, jitter_std=self.jitter_std,
                perturb_both_sides=self.perturb_both_sides)
        rot, trans = T[:3, :3], T[:3, 3:]
        src_n, tgt_n, trans_n, s, c = _norm_fn(self.normalize)(src, tgt, rot, trans)
        out = {
            "src": src_n.astype(np.float32),
            "tgt": tgt_n.astype(np.float32),
            "rot": rot.astype(np.float32),
            "trans": trans_n.astype(np.float32),
            "scale": np.float32(s),
            "center": c.astype(np.float32),
        }
        if self.with_info:
            out["idx"] = np.load(os.path.join(self.dir, "info", "idx%d.npy" % item))
            out["covariance"] = np.load(
                os.path.join(self.dir, "info", "covariance%d.npy" % item))
            out["scene"] = np.int32(SCENE_NAME_TO_IDX[self.scene_names[item]])
        return out


class OpenGFDataset:
    """OpenGF patches: ``[dsm | dem]`` columns, the coarse DEM derived on
    read, the DEM voxel-downsampled at resolution 20 before the /50
    coordinate scaling (reference ``datasets/open_gf.py:18-28``)."""

    def __init__(self, root: str, split: str = "train", with_centers: bool = False):
        self.dir = os.path.join(root, f"OpenGF_{split}")
        self.with_centers = with_centers
        n = 0
        while os.path.exists(os.path.join(self.dir, "%d.npy" % (n + 1))):
            n += 1
        self.length = n
        _check_canonical_size(f"OpenGF_{split}", self.length)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, item: int) -> Dict[str, np.ndarray]:
        dsm_dem = np.load(os.path.join(self.dir, "%d.npy" % (item + 1)))
        dsm, dem = dsm_dem[:, :3], dsm_dem[:, 3:]
        dem_coarse = voxel_downsample(dem, OPENGF_COARSE_RESOLUTION)
        out = {
            "dsm": (dsm / OPENGF_SCALE_FACTOR).astype(np.float32),
            "dem": (dem / OPENGF_SCALE_FACTOR).astype(np.float32),
            "dem_coarse": (dem_coarse / OPENGF_SCALE_FACTOR).astype(np.float32),
        }
        if self.with_centers:
            out["center"] = np.load(
                os.path.join(self.dir, "centers", "%d.npy" % (item + 1))).astype(np.float32)
        return out


class SyntheticPairDataset:
    """Fixed-seed synthetic pairs with the loader's item schema
    (``src, tgt, rot, trans, scale, center``, optional eval sidecars)."""

    def __init__(
        self,
        length: int = 64,
        n_src: int = 512,
        n_tgt: int = 512,
        overlap: float = 0.7,
        normalize: str = "unit_sphere",
        augment: bool = False,
        seed: int = 0,
        with_info: bool = False,
        extent: float = 1.0,
    ):
        self.length = length
        self.n_src, self.n_tgt, self.overlap = n_src, n_tgt, overlap
        self.normalize = normalize
        self.augment = augment
        self.seed = seed
        self.with_info = with_info
        self.extent = extent
        self._seeds = _PerItemSeeds(seed + 99991)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, item: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 1_000_003 + item)
        pair = make_pair(rng, self.n_src, self.n_tgt, overlap=self.overlap,
                         extent=self.extent)
        src, tgt = pair["src"], pair["tgt"]
        T = np.eye(4, dtype=np.float64)
        T[:3, :3], T[:3, 3:] = pair["rot"], pair["trans"]
        if self.augment:
            src, tgt, T = transforms.augment_pair(self._seeds.rng(item), src, tgt, T)
        rot, trans = T[:3, :3], T[:3, 3:]
        src_n, tgt_n, trans_n, s, c = _norm_fn(self.normalize)(src, tgt, rot, trans)
        out = {
            "src": src_n.astype(np.float32),
            "tgt": tgt_n.astype(np.float32),
            "rot": rot.astype(np.float32),
            "trans": trans_n.astype(np.float32),
            "scale": np.float32(s),
            "center": c.astype(np.float32),
        }
        if self.with_info:
            out["idx"] = np.array([item * 3, item * 3 + 2], np.int32)  # idx gap > 1
            out["covariance"] = np.eye(6, dtype=np.float32) * float(self.n_src)
            out["scene"] = np.int32(item % 8)
        return out
