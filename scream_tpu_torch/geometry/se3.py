"""SE(3) rigid transforms as batched PyTorch functions (port of
``scream_tpu/geometry/se3.py``; reference ``lie/numpy/se3.py``,
``lie/torch/se3.py``, ``lie/numpy/utils.py``).

Two representations, as in the JAX package: compact ``(..., 3, 4)`` pose
matrices ``[R | t]`` and ``(..., 6)`` tangent vectors ``[u, w]``
(translation part first). The samplers draw from a ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch

from scream_tpu_torch.geometry import so3

_EPS = 1e-6


def se3_init(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """``(..., 3, 3)`` rotation and ``(..., 3, 1)`` translation -> ``(..., 3, 4)``."""
    return torch.cat([rot, trans], -1)


def se3_cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose two ``(..., 3, 4)`` transforms: ``a . b``."""
    rot_a, trans_a = a[..., :3, :3], a[..., :3, 3:4]
    rot_b, trans_b = b[..., :3, :3], b[..., :3, 3:4]
    return se3_init(rot_a @ rot_b, rot_a @ trans_b + trans_a)


def se3_inv(pose: torch.Tensor) -> torch.Tensor:
    """Invert a ``(..., 3, 4)`` transform."""
    irot = pose[..., :3, :3].transpose(-1, -2)
    return se3_init(irot, -irot @ pose[..., :3, 3:4])


def se3_transform(pose: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Apply ``(..., 3, 4)`` poses to ``(..., N, 3)`` points: ``R x + t``."""
    rot, trans = pose[..., :3, :3], pose[..., :3, 3:4]
    return torch.einsum("...ij,...nj->...ni", rot, xyz) + trans.transpose(-1, -2)


def to_4x4(pose: torch.Tensor) -> torch.Tensor:
    """``(..., 3, 4)`` -> homogeneous ``(..., 4, 4)``."""
    bottom = torch.zeros_like(pose[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([pose, bottom], -2)


def from_4x4(T: torch.Tensor) -> torch.Tensor:
    """``(..., 4, 4)`` -> ``(..., 3, 4)``."""
    return T[..., :3, :]


def _safe_theta(w: torch.Tensor):
    theta_sq = (w * w).sum(-1)
    small = theta_sq < _EPS * _EPS
    return theta_sq, small, torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))


def _v_matrix(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3): ``I + (1 - cos t)/t^2 W + (t - sin t)/t^3 W^2``."""
    theta_sq, small, t = _safe_theta(w)
    W = so3.hat(w)
    W2 = W @ W
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(t)) / (t ** 2))
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (t - torch.sin(t)) / (t ** 3))
    return so3._eye_like(W) + b[..., None, None] * W + c[..., None, None] * W2


def _v_inv_matrix(w: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of the left Jacobian:
    ``I - W / 2 + (1 - t/2 cot(t/2)) / t^2 W^2``."""
    theta_sq, small, t = _safe_theta(w)
    W = so3.hat(w)
    W2 = W @ W
    cot_term = (t * 0.5) * torch.cos(t * 0.5) / torch.sin(t * 0.5)
    coef = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0, (1.0 - cot_term) / (t ** 2))
    return so3._eye_like(W) - 0.5 * W + coef[..., None, None] * W2


def exp(vec: torch.Tensor) -> torch.Tensor:
    """``(..., 6)`` tangent ``[u, w]`` -> ``(..., 3, 4)`` pose, the Sophus
    closed form (reference ``lie/numpy/se3.py:99-137``)."""
    u, w = vec[..., :3], vec[..., 3:]
    t = torch.einsum("...ij,...j->...i", _v_matrix(w), u)
    return se3_init(so3.exp(w), t[..., None])


def log(pose: torch.Tensor) -> torch.Tensor:
    """``(..., 3, 4)`` pose -> ``(..., 6)`` tangent ``[u, w]``."""
    w = so3.log(pose[..., :3, :3])
    u = torch.einsum("...ij,...j->...i", _v_inv_matrix(w), pose[..., :3, 3])
    return torch.cat([u, w], -1)


def pexp(vec: torch.Tensor) -> torch.Tensor:
    """Pseudo-exponential: rotation by exp, translation verbatim (reference
    ``lie/torch/se3.py:113-135``)."""
    return se3_init(so3.exp(vec[..., 3:]), vec[..., :3, None])


def plog(pose: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pexp`."""
    return torch.cat([pose[..., :3, 3], so3.log(pose[..., :3, :3])], -1)


def boxplus_left(pose: torch.Tensor, delta: torch.Tensor, pseudo: bool = False) -> torch.Tensor:
    """Left plus: ``exp(delta) . pose``."""
    return se3_cat(pexp(delta) if pseudo else exp(delta), pose)


def boxplus_right(pose: torch.Tensor, delta: torch.Tensor, pseudo: bool = False) -> torch.Tensor:
    """Right plus: ``pose . exp(delta)``."""
    return se3_cat(pose, pexp(delta) if pseudo else exp(delta))


def sample_small(generator: torch.Generator, std: float, shape=(),
                 device="cuda") -> torch.Tensor:
    """Small random poses: ``so3.sample_small`` rotation and
    N(0, std / sqrt 3) translation (reference ``lie/numpy/se3.py:38-44``)."""
    shape = tuple(shape)
    R = so3.sample_small(generator, std, shape, device)
    t = so3._draw("normal", generator, shape + (3, 1), device) * (std / math.sqrt(3.0))
    return se3_init(R, t)


def sample_uniform(generator: torch.Generator, shape=(), trans_scale: float = 1.0,
                   device="cuda") -> torch.Tensor:
    """Uniform rotation and translation uniform in ``[-scale, scale]^3``."""
    shape = tuple(shape)
    R = so3.sample_uniform(generator, shape, device)
    t = so3._draw("uniform", generator, shape + (3, 1), device, low=-trans_scale,
                  high=trans_scale)
    return se3_init(R, t)


def _hat_e(k: int, like: torch.Tensor) -> torch.Tensor:
    e = torch.zeros(3, dtype=like.dtype, device=like.device)
    e[k] = 1.0
    return so3.hat(e)


def jacob_expeD_de(D: torch.Tensor, pseudo: bool = True) -> torch.Tensor:
    """``d(exp(eps) . D) / d eps`` at 0: ``(..., 12, 6)``, rows the
    row-major flattened ``[R | t]``, columns ``[u, w]`` (reference
    ``lie/torch/se3.py:183-209``, section 10.3.3). ``pseudo`` does not
    change it: the exp and pexp charts agree to first order at 0."""
    del pseudo
    R, t = D[..., :3, :3], D[..., :3, 3:4]
    batch = D.shape[:-2]
    out = torch.zeros(batch + (3, 4, 6), dtype=D.dtype, device=D.device)
    out[..., :, 3, :3] = torch.eye(3, dtype=D.dtype, device=D.device)
    for k in range(3):
        He = _hat_e(k, D)
        out[..., :, :3, 3 + k] = torch.einsum("ij,...jl->...il", He, R)
        out[..., :, 3, 3 + k] = torch.einsum("ij,...jl->...il", He, t)[..., 0]
    return out.reshape(batch + (12, 6))


def jacob_Dexpe_de(D: torch.Tensor) -> torch.Tensor:
    """``d(D . exp(eps)) / d eps`` at 0: ``(..., 12, 6)`` (reference
    ``lie/torch/se3.py:211-232``, section 10.3.4)."""
    R = D[..., :3, :3]
    batch = D.shape[:-2]
    out = torch.zeros(batch + (3, 4, 6), dtype=D.dtype, device=D.device)
    out[..., :, 3, :3] = R
    for k in range(3):
        out[..., :, :3, 3 + k] = torch.einsum("...ij,jl->...il", R, _hat_e(k, D))
    return out.reshape(batch + (12, 6))


def jacob_dAexpeD_de(A: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """``d(A . exp(eps) . D) / d eps`` at 0: ``(..., 12, 6)`` (reference
    ``lie/numpy/se3.py:185-229``, ``lie/torch/se3.py:234-278``, 10.3.7)."""
    batch = torch.broadcast_shapes(A.shape[:-2], D.shape[:-2])
    Ra = A[..., :3, :3].expand(batch + (3, 3))
    Rd = D[..., :3, :3].expand(batch + (3, 3))
    td = D[..., :3, 3:4].expand(batch + (3, 1))
    out = torch.zeros(batch + (3, 4, 6), dtype=A.dtype, device=A.device)
    out[..., :, 3, :3] = Ra
    for k in range(3):
        He = _hat_e(k, A)
        out[..., :, :3, 3 + k] = torch.einsum("...ij,jl,...lm->...im", Ra, He, Rd)
        out[..., :, 3, 3 + k] = torch.einsum("...ij,jl,...lm->...im", Ra, He, td)[..., 0]
    return out.reshape(batch + (12, 6))


def make_valid(pose: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block (reference ``lie/torch/se3.py:318``)."""
    return se3_init(so3.make_valid(pose[..., :3, :3]), pose[..., :3, 3:4])


def as_quat_trans(pose: torch.Tensor) -> torch.Tensor:
    """``(..., 3, 4)`` -> ``[qw qx qy qz tx ty tz]`` (reference
    ``lie/numpy/se3.py:240-256``)."""
    return torch.cat([so3.quat_from_matrix(pose[..., :3, :3]), pose[..., :3, 3]], -1)


def from_quat_trans(vec7: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`as_quat_trans`."""
    return se3_init(so3.matrix_from_quat(vec7[..., :4]), vec7[..., 4:7, None])
