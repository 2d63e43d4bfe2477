"""SO(3) rotations as batched PyTorch functions (port of
``scream_tpu/geometry/so3.py``; reference ``lie/numpy/so3.py``,
``lie/numpy/so3_common.py``).

Rotations are plain ``(..., 3, 3)`` tensors, tangent vectors ``(..., 3)``,
quaternions ``(..., 4)`` in (w, x, y, z) order. Every function works over
leading batch dims on the tensors' device; branches are selected with
``torch.where`` on safe inputs, so no NaN leaks through an untaken branch
into a gradient. The samplers draw from a ``torch.Generator`` (the JAX
package takes a key) and return tensors on ``device``.
"""

from __future__ import annotations

import math

import torch

from scream_tpu_torch.geometry.kabsch import _det3
from scream_tpu_torch.utils.device import resolve_device

_EPS = 1e-6


def _eye_like(M: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``(..., 3)`` vectors -> ``(..., 3, 3)``."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack([torch.stack([zeros, -wz, wy], -1),
                        torch.stack([wz, zeros, -wx], -1),
                        torch.stack([-wy, wx, zeros], -1)], -2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: ``(..., 3, 3)`` skew matrix -> ``(..., 3)``."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector ``(..., 3)`` -> rotation matrix: Rodrigues with a
    second-order Taylor expansion near theta = 0 (reference
    ``lie/numpy/so3.py:81-101``)."""
    theta_sq = (w * w).sum(-1)
    small = theta_sq < _EPS * _EPS
    theta_s = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    W = hat(w)
    W2 = W @ W
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta_s) / theta_s)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta_s)) / (theta_s * theta_s))
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector ``(..., 3)``, the reference's three
    branches (``lie/numpy/so3.py:103-154``) with its numerics: ``sin`` from
    the skew part, ``theta = atan2(sin, cos)``; generic
    ``0.5 theta / sin vee(R - R^T)``, first order near 0, and near pi the
    magnitudes from the diagonal with the skew part's signs; at exactly pi
    (skew part pure rounding) a sign-coherent axis from the dominant column
    of ``(R + I) / 2``."""
    angle_axis = vee(R - R.transpose(-1, -2))
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    trace = diag.sum(-1)
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)

    norm_sq = (angle_axis * angle_axis).sum(-1)
    tiny = norm_sq < 1e-24
    sin_theta = 0.5 * torch.sqrt(torch.where(tiny, torch.ones_like(norm_sq), norm_sq))
    sin_theta = torch.clamp_max(torch.where(tiny, torch.zeros_like(sin_theta), sin_theta),
                                1.0)
    theta = torch.atan2(sin_theta, cos_theta)

    near_zero_or_pi = sin_theta < 1e-5
    near_zero = theta < 1e-5

    denom = torch.where(near_zero_or_pi, torch.ones_like(sin_theta), sin_theta)
    w_generic = (0.5 * theta / denom)[..., None] * angle_axis
    w_zero = 0.5 * angle_axis

    ratio = (diag - cos_theta[..., None]) / torch.clamp_min((1.0 - cos_theta)[..., None],
                                                           1e-6)
    w_pi = theta[..., None] * torch.sqrt(torch.clamp_min(ratio, 1e-12))
    w_pi = torch.where(angle_axis * sin_theta[..., None] < 0.0, -w_pi, w_pi)

    B = (R + _eye_like(R)) * 0.5
    b_diag = torch.clamp_min(torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], -1),
                             0.0)
    k = torch.argmax(b_diag, dim=-1)
    Bk = torch.gather(B, -1, k[..., None, None].expand(*B.shape[:-1], 1))[..., 0]
    axis = Bk / torch.clamp_min(torch.linalg.vector_norm(Bk, dim=-1, keepdim=True), 1e-12)
    w_exact_pi = theta[..., None] * axis
    w_pi = torch.where((sin_theta < 1e-7)[..., None], w_exact_pi, w_pi)

    w = torch.where(near_zero_or_pi[..., None], w_pi, w_generic)
    return torch.where(near_zero[..., None], w_zero, w)


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle in radians (reference ``lie/numpy/so3.py:175-181``)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def compare(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Angular difference (radians) between two rotations."""
    return rotation_angle(R1 @ R2.transpose(-1, -2))


def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion ``(..., 4)`` (w, x, y, z).

    Branchless Shepperd-style conversion (reference
    ``lie/numpy/so3_common.py:99-141``, incl. the ~180 degree branch).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    trace = m00 + m11 + m22

    qw0 = torch.sqrt(torch.clamp_min(1.0 + trace, 1e-12)) * 0.5
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], -1)
    qx1 = torch.sqrt(torch.clamp_min(1.0 + m00 - m11 - m22, 1e-12)) * 0.5
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], -1)
    qy2 = torch.sqrt(torch.clamp_min(1.0 - m00 + m11 - m22, 1e-12)) * 0.5
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], -1)
    qz3 = torch.sqrt(torch.clamp_min(1.0 - m00 - m11 + m22, 1e-12)) * 0.5
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], -1)

    cond0 = (trace > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    # Canonical hemisphere qw >= 0, as the reference's generic branch gives.
    return torch.where(q[..., 0:1] < 0.0, -q, q)


def matrix_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix (reference
    ``lie/numpy/so3_common.py:66-96``); a zero quaternion gives the identity
    with finite gradients."""
    nsq = (q * q).sum(-1, keepdim=True)
    degen = nsq < 1e-24
    unit = torch.zeros_like(q)
    unit[..., 0] = 1.0
    q = torch.where(degen, unit, q / torch.sqrt(torch.where(degen, torch.ones_like(nsq), nsq)))
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


def euler_zyx_matrix(euler: torch.Tensor) -> torch.Tensor:
    """Extrinsic z-y-x Euler angles ``(..., 3)`` -> rotation matrix, as
    ``scipy.spatial.transform.Rotation.from_euler('zyx', e)``:
    ``R = Rx(x) @ Ry(y) @ Rz(z)`` (reference ``models/render.py:67``)."""
    z, y, x = euler[..., 0], euler[..., 1], euler[..., 2]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    row0 = torch.stack([cy * cz, -cy * sz, sy], -1)
    row1 = torch.stack([sx * sy * cz + cx * sz, -sx * sy * sz + cx * cz, -sx * cy], -1)
    row2 = torch.stack([-cx * sy * cz + sx * sz, cx * sy * sz + sx * cz, cx * cy], -1)
    return torch.stack([row0, row1, row2], -2)


def _draw(kind: str, generator: torch.Generator, shape, device, **kw) -> torch.Tensor:
    """fp32 draws on the generator's device, moved to ``device``: one
    generator gives the same numbers whatever the caller's device."""
    dev = resolve_device(device)
    gdev = generator.device
    if kind == "uniform":
        lo, hi = kw["low"], kw["high"]
        x = torch.rand(shape, generator=generator, device=gdev) * (hi - lo) + lo
    else:
        x = torch.randn(shape, generator=generator, device=gdev)
    return x.to(dev)


def uniform_2_sphere(generator: torch.Generator, shape=(), device="cuda") -> torch.Tensor:
    """Uniform unit vectors ``shape + (3,)`` on S^2 (reference
    ``lie/numpy/so3_common.py:185-210``)."""
    shape = tuple(shape)
    phi = _draw("uniform", generator, shape, device, low=0.0, high=2 * math.pi)
    cos_theta = _draw("uniform", generator, shape, device, low=-1.0, high=1.0)
    sin_theta = torch.sqrt(1.0 - cos_theta ** 2)
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta],
                       -1)


def sample_uniform(generator: torch.Generator, shape=(), device="cuda") -> torch.Tensor:
    """Uniform random rotations ``shape + (3, 3)`` from normalized Gaussian
    quaternions."""
    return matrix_from_quat(_draw("normal", generator, tuple(shape) + (4,), device))


def sample_small(generator: torch.Generator, std: float, shape=(),
                 device="cuda") -> torch.Tensor:
    """Small random rotations: uniform axis, angle ~ N(0, (std pi / sqrt 3)^2)
    (reference ``lie/numpy/so3.py:30-38``)."""
    shape = tuple(shape)
    axis = uniform_2_sphere(generator, shape, device)
    theta = _draw("normal", generator, shape, device) * (std * math.pi / math.sqrt(3.0))
    return exp(axis * theta[..., None])


def is_valid(R: torch.Tensor, atol: float = 5e-5) -> torch.Tensor:
    """Orthogonal with determinant 1 within ``atol`` (reference
    ``lie/numpy/so3_common.py:14-29``: loose for fp32 compositions)."""
    orth = ((R @ R.transpose(-1, -2) - _eye_like(R)).abs() < atol).all(-1).all(-1)
    return orth & ((_det3(R) - 1.0).abs() < atol)


def make_valid(R: torch.Tensor) -> torch.Tensor:
    """Nearest rotation by SVD with the determinant fix (reference
    ``lie/numpy/so3_common.py:32-40``)."""
    U, _, Vh = torch.linalg.svd(R)
    det = _det3(U @ Vh)
    fix = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    return (U * fix[..., None, :]) @ Vh


def quat_inv(quat: torch.Tensor) -> torch.Tensor:
    """Unit-quaternion inverse (the conjugate), wxyz."""
    return torch.cat([quat[..., 0:1], -quat[..., 1:]], -1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``q1 * q2``, wxyz (reference
    ``lie/numpy/so3_common.py:152-172``)."""
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def quat_rot(quat: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Rotate points ``(..., N, 3)`` by unit quaternions ``(..., 4)``:
    ``q * (0, p) * q^-1``."""
    v = torch.cat([torch.zeros_like(pts[..., 0:1]), pts], -1)
    q = quat[..., None, :]
    return quat_mul(quat_mul(q, v), quat_inv(q))[..., 1:]
