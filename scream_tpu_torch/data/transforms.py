"""Host-side (numpy) transforms used by the synthetic pair dataset.

Copies of ``scream_tpu/data/transforms.py`` (the port imports nothing of the
JAX package): the same numpy calls in the same order, so one seed gives
bit-identical clouds in both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def uniform_2_sphere(rng: np.random.Generator, size: Optional[int] = None) -> np.ndarray:
    """Uniform unit vectors on S^2 (reference ``lie/numpy/so3_common.py:185-210``)."""
    shape = () if size is None else (size,)
    phi = rng.uniform(0.0, 2 * np.pi, shape)
    cos_theta = rng.uniform(-1.0, 1.0, shape)
    sin_theta = np.sqrt(np.clip(1.0 - cos_theta**2, 0.0, None))
    return np.stack(
        [sin_theta * np.cos(phi), sin_theta * np.sin(phi), cos_theta], axis=-1
    )


def rodrigues(axis_angle: np.ndarray) -> np.ndarray:
    """exp: so(3) -> SO(3) for a single (3,) axis-angle vector."""
    theta = np.linalg.norm(axis_angle)
    if theta < 1e-12:
        return np.eye(3)
    k = axis_angle / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def sample_small_se3(rng: np.random.Generator, std: float) -> np.ndarray:
    """Small random SE(3) perturbation as a 4x4 matrix (reference
    ``lie/numpy/se3.py:37-44``): axis uniform on S^2, angle
    ~ N(0, (std*pi/sqrt(3))^2), translation ~ N(0, (std/sqrt(3))^2)."""
    axis = uniform_2_sphere(rng)
    theta = rng.standard_normal() * std * np.pi / np.sqrt(3.0)
    R = rodrigues(axis * theta)
    t = rng.standard_normal(3) * std / np.sqrt(3.0)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def augment_pair(
    rng: np.random.Generator,
    src: np.ndarray,
    tgt: np.ndarray,
    T: np.ndarray,
    perturb_std: float = 0.1,
    jitter_std: float = 0.003,
    perturb_both_sides: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SE(3) perturbation centred on the perturbed cloud's centroid, then
    jitter (reference ``datasets/three_d_match.py:129-153``). Perturbing src
    by P updates ``T <- T P^-1``; perturbing tgt updates ``T <- P T``."""
    T = np.concatenate([T[:3], [[0.0, 0.0, 0.0, 1.0]]], axis=0)
    perturb_source = True if not perturb_both_sides else rng.random() > 0.5

    perturb = sample_small_se3(rng, perturb_std)
    centroid = np.mean(src if perturb_source else tgt, axis=0)
    C = np.eye(4)
    C[:3, 3] = -centroid
    C_inv = np.eye(4)
    C_inv[:3, 3] = centroid
    perturb = C_inv @ perturb @ C

    if perturb_source:
        T = T @ np.linalg.inv(perturb)
        src = src @ perturb[:3, :3].T + perturb[:3, 3]
    else:
        T = perturb @ T
        tgt = tgt @ perturb[:3, :3].T + perturb[:3, 3]

    if jitter_std > 0.0:
        src = src + rng.standard_normal(src.shape) * jitter_std
        tgt = tgt + rng.standard_normal(tgt.shape) * jitter_std
    return src, tgt, T


def derive_normalized_trans(s: float, c: np.ndarray, rot: np.ndarray,
                            trans: np.ndarray) -> np.ndarray:
    """GT translation in the normalized frame: ``s (t - c + R c)``
    (reference ``datasets/three_d_match.py:190``)."""
    t = trans.reshape(3)
    return (s * (t - c + rot @ c)).reshape(trans.shape)


def normalize_unit_sphere(src, tgt, rot, trans):
    """Unit-sphere normalization over the GT-registered union (3DMatch).
    Returns ``(src_n, tgt_n, trans_n, s, c)`` with ``x_n = s (x - c)``."""
    registered = np.concatenate([src @ rot.T + trans.reshape(3), tgt], axis=0)
    c = np.mean(registered, axis=0)
    s = 1.0 / np.max(np.linalg.norm(registered - c, axis=1))
    return s * (src - c), s * (tgt - c), derive_normalized_trans(s, c, rot, trans), s, c


def normalize_unit_sphere_raw(src, tgt, rot, trans):
    """Unit-sphere normalization over the UN-registered union (GT-free)."""
    union = np.concatenate([src, tgt], axis=0)
    c = np.mean(union, axis=0)
    s = 1.0 / max(float(np.max(np.linalg.norm(union - c, axis=1))), 1e-12)
    return s * (src - c), s * (tgt - c), derive_normalized_trans(s, c, rot, trans), s, c


def normalize_unit_cube(src, tgt, rot, trans):
    """Unit-cube (bbox) normalization over the registered union (KITTI,
    reference ``datasets/kitti.py:268-273``)."""
    registered = np.concatenate([src @ rot.T + trans.reshape(3), tgt], axis=0)
    lo, hi = registered.min(axis=0), registered.max(axis=0)
    c = (lo + hi) / 2.0
    s = 2.0 / np.max(hi - lo)
    return s * (src - c), s * (tgt - c), derive_normalized_trans(s, c, rot, trans), s, c


def normalize_unit_cube_raw(src, tgt, rot, trans):
    """Unit-cube normalization over the UN-registered union (GT-free)."""
    union = np.concatenate([src, tgt], axis=0)
    lo, hi = union.min(axis=0), union.max(axis=0)
    c = (lo + hi) / 2.0
    s = 2.0 / max(float(np.max(hi - lo)), 1e-12)
    return s * (src - c), s * (tgt - c), derive_normalized_trans(s, c, rot, trans), s, c
