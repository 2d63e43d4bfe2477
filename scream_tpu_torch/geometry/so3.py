"""The SO(3) piece the metrics need (port of ``quat_from_matrix`` in
``scream_tpu/geometry/so3.py``)."""

from __future__ import annotations

import torch


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
