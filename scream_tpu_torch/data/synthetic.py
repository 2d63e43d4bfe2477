"""Synthetic registration pairs and ground-generation patches (port of
``scream_tpu/data/synthetic.py``).

numpy only, and bit-identical to the JAX package for the same seed: scenes
are unions of random Gaussian clusters over a bumpy ground plane; DEM
patches are a smooth ground with raised clutter.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from scream_tpu_torch.data.transforms import rodrigues, uniform_2_sphere


def make_scene(rng: np.random.Generator, n: int, extent: float = 1.0) -> np.ndarray:
    """A structured ``(n, 3)`` cloud: clustered blobs over a bumpy ground plane."""
    n_clusters = int(rng.integers(4, 9))
    centers = rng.uniform(-extent, extent, (n_clusters, 3)) * np.array([1, 1, 0.4])
    sizes = rng.uniform(0.05, 0.25, n_clusters) * extent
    n_blob = n // 2
    assign = rng.integers(0, n_clusters, n_blob)
    blobs = centers[assign] + rng.standard_normal((n_blob, 3)) * sizes[assign, None]

    n_ground = n - n_blob
    xy = rng.uniform(-extent, extent, (n_ground, 2))
    z = 0.08 * extent * np.sin(3.0 * xy[:, 0]) * np.cos(2.0 * xy[:, 1]) - 0.5 * extent
    ground = np.concatenate([xy, z[:, None]], axis=1)
    return np.concatenate([blobs, ground], axis=0).astype(np.float32)


def random_se3(rng: np.random.Generator, max_angle: float = np.pi,
               max_trans: float = 0.5) -> np.ndarray:
    """Uniform-axis random rigid transform as a 4x4 matrix."""
    axis = uniform_2_sphere(rng)
    angle = rng.uniform(-max_angle, max_angle)
    T = np.eye(4)
    T[:3, :3] = rodrigues(axis * angle)
    T[:3, 3] = rng.uniform(-max_trans, max_trans, 3)
    return T


def make_pair(
    rng: np.random.Generator,
    n_src: int = 512,
    n_tgt: int = 512,
    overlap: float = 0.7,
    noise: float = 0.0,
    max_angle: float = np.pi / 2,
    max_trans: float = 0.5,
    extent: float = 1.0,
) -> Dict[str, np.ndarray]:
    """A registration pair ``{src, tgt, rot, trans}`` with known GT.

    The scene lives in the target frame; the source samples a half-space
    slab whose position sets the overlap fraction. GT maps src -> tgt
    frame: ``tgt_frame = R src + t``.
    """
    scene = make_scene(rng, n_src + n_tgt + 2048, extent=extent)
    max_trans = max_trans * extent
    noise = noise * extent
    d = uniform_2_sphere(rng)
    proj = scene @ d
    order = np.argsort(proj)
    n_total = len(scene)

    tgt_lo = int(n_total * (1.0 - overlap) * 0.5)
    tgt_pool = scene[order[tgt_lo:]]
    src_pool = scene[order[: tgt_lo + int(n_total * overlap)]] if overlap > 0 else scene[order[:tgt_lo]]
    if len(src_pool) < n_src:
        src_pool = scene[order[: max(n_src, len(src_pool))]]

    tgt = tgt_pool[rng.choice(len(tgt_pool), n_tgt, replace=len(tgt_pool) < n_tgt)]
    src_world = src_pool[rng.choice(len(src_pool), n_src, replace=len(src_pool) < n_src)]

    T = random_se3(rng, max_angle, max_trans)
    # src in its own frame: src = T^-1 src_world.
    Ti = np.linalg.inv(T)
    src = src_world @ Ti[:3, :3].T + Ti[:3, 3]
    if noise > 0:
        src = src + rng.standard_normal(src.shape) * noise
        tgt = tgt + rng.standard_normal(tgt.shape) * noise
    return {
        "src": src.astype(np.float32),
        "tgt": tgt.astype(np.float32),
        "rot": T[:3, :3].astype(np.float32),
        "trans": T[:3, 3:4].astype(np.float32),
    }


def make_dem_patch(
    rng: np.random.Generator, n_dsm: int = 1024, n_dem: int = 1024, extent: float = 1.0
) -> Dict[str, np.ndarray]:
    """A synthetic OpenGF-style patch ``{dsm, dem, dem_coarse}``: smooth
    ground DEM and a DSM with clutter.

    ``dsm[i]`` is the highest surface point above ``dem[i]`` (same xy up to a
    small offset, z raised where buildings or vegetation sit), as in the
    reference's patches (``process_open_gf.py:217-231``), so the per-index
    L1 loss is well-posed. The coarse DEM is a sparse ground subsample.
    """

    def ground_z(xy):
        return 0.15 * extent * (
            np.sin(2.1 * xy[:, 0]) * np.cos(1.7 * xy[:, 1]) + 0.3 * np.sin(0.9 * xy[:, 0] + 1.0)
        )

    n = max(n_dsm, n_dem)
    xy = rng.uniform(-extent, extent, (n, 2))
    dem = np.concatenate([xy, ground_z(xy)[:, None]], axis=1)[:n_dem]

    xy_dsm = xy[:n_dsm] + rng.standard_normal((n_dsm, 2)) * 0.01 * extent
    z = ground_z(xy_dsm)
    raised = rng.random(n_dsm) < 0.35
    z = z + raised * rng.uniform(0.1, 0.6 * extent, n_dsm)
    dsm = np.concatenate([xy_dsm, z[:, None]], axis=1)

    n_coarse = max(16, n_dem // 16)
    dem_coarse = dem[rng.choice(n_dem, n_coarse, replace=False)]
    return {
        "dsm": dsm.astype(np.float32),
        "dem": dem.astype(np.float32),
        "dem_coarse": dem_coarse.astype(np.float32),
    }
