"""The synthetic pair dataset (port of ``SyntheticPairDataset`` in
``scream_tpu/data/datasets.py``), with the same item schema and seeds."""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np

from scream_tpu_torch.data import transforms
from scream_tpu_torch.data.synthetic import make_pair


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
