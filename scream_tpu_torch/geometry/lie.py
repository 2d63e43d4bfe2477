"""Object-style Lie-group API: ``SO3`` / ``SE3`` classes (port of
``scream_tpu/geometry/lie.py``; reference ``lie/numpy/liegroupbase.py``,
``lie/numpy/so3.py``, ``lie/numpy/se3.py``, ``lie/torch/se3.py``).

The working layer is the functional one (:mod:`scream_tpu_torch.geometry.so3`
/ ``se3``: batched tensor functions); these classes give the reference's
object surface over it: ``SE3.exp(v) * pose.inv()``, ``pose.transform(pts)``,
``pose.rot`` / ``pose.trans``, ``boxplus_left`` and friends. An instance
holds one tensor, ``data`` (``(..., 3, 3)`` or ``(..., 4, 4)``), on the
device of the tensor it was built from.

As in the JAX package:

* the samplers take an explicit ``torch.Generator`` (the JAX package a key)
  and an explicit ``device`` (default ``"cuda"``);
* instances do not change in place: ``__setitem__`` raises, and
  ``x.set(index, value)`` returns a new instance over a copy, so a tensor a
  caller shares is never written;
* ``from_matrix(check=True)`` and ``from_rtvec`` check their input (the JAX
  package checks only concrete arrays; every torch tensor is concrete, so
  the checks always run), raising ``AssertionError``;
* ``SE3.log`` works (the reference mirrors raise ``NotImplementedError``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from scream_tpu_torch.geometry import se3 as se3f
from scream_tpu_torch.geometry import so3 as so3f
from scream_tpu_torch.utils.device import resolve_device


def _require(cond, msg: str) -> None:
    """The JAX package's host-side asserts, kept under ``python -O``."""
    if not cond:
        raise AssertionError(msg)


def _allclose(a: torch.Tensor, b: torch.Tensor, atol: float) -> bool:
    return bool(torch.allclose(a, b, rtol=1e-5, atol=atol))


class _LieBase:
    """Shared container mechanics (``lie/numpy/liegroupbase.py:9-117``)."""

    name = "LieGroupBase"

    def __init__(self, data):
        self.data = torch.as_tensor(data)

    # -- group ops shared across SO3/SE3 -----------------------------------
    def __mul__(self, other):
        """Group composition ``self . other`` (liegroupbase.py:60-61)."""
        return self.__class__(self.data @ other.data)

    def boxplus_left(self, delta: torch.Tensor):
        """``exp(delta) * self`` (liegroupbase.py:46-48)."""
        return self.__class__.exp(delta) * self

    def boxplus_right(self, delta: torch.Tensor):
        """``self * exp(delta)`` (liegroupbase.py:50-55, eq. 10.6)."""
        return self * self.__class__.exp(delta)

    def as_matrix(self) -> torch.Tensor:
        return self.data

    # -- container protocol ------------------------------------------------
    def __getitem__(self, item):
        return self.__class__(self.data[item])

    def __setitem__(self, index, value):
        raise TypeError(
            f"{self.name} does not change in place; use x.set(index, value), which "
            "returns a new instance")

    def set(self, index, value):
        """Out-of-place element update: a new instance over a copy of the
        data with ``index`` set to ``value``."""
        value = value.data if isinstance(value, _LieBase) else torch.as_tensor(value)
        out = self.data.clone()
        out[index] = value.to(out.dtype)
        return self.__class__(out)

    def __repr__(self):
        return "{} containing {}".format(self.name, str(self.data))

    def __str__(self):
        return "{}{}".format(self.name, list(self.data.shape[:-2]))

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.data.detach().cpu(), dtype=dtype)

    @property
    def shape(self):
        return tuple(self.data.shape[:-2])

    def __len__(self):
        shape = self.shape
        return shape[0] if len(shape) >= 1 else 1

    @classmethod
    def stack(cls, transforms: List["_LieBase"]):
        """Concatenate along the leading batch axis (liegroupbase.py:113-117)."""
        return cls(torch.cat([t.data for t in transforms], 0))

    def astype(self, dtype):
        """Dtype cast (the torch mirror's ``.type()``)."""
        return self.__class__(self.data.to(dtype))


class SO3(_LieBase):
    """Rotation as a ``(..., 3, 3)`` matrix (``lie/numpy/so3.py:10-202``)."""

    DIM = 9
    DOF = 3
    N = 3
    name = "SO3"

    # -- constructors ------------------------------------------------------
    @staticmethod
    def identity(size: Optional[int] = None, device="cuda") -> "SO3":
        eye = torch.eye(3, device=resolve_device(device))
        return SO3(eye if size is None else eye.expand(size, 3, 3).clone())

    @staticmethod
    def sample_uniform(generator: torch.Generator, size: Optional[int] = None,
                       device="cuda") -> "SO3":
        """Uniform random rotations (so3.py:24-28), drawn from ``generator``."""
        shape = () if size is None else (size,)
        return SO3(so3f.sample_uniform(generator, shape, device))

    @staticmethod
    def sample_small(generator: torch.Generator, size: Optional[int] = None,
                     std: float = 0.1, device="cuda") -> "SO3":
        """Uniform axis, angle ~ N(0, std*pi/sqrt(3)) (so3.py:30-38)."""
        shape = () if size is None else (size,)
        return SO3(so3f.sample_small(generator, std, shape, device))

    @staticmethod
    def from_matrix(mat, normalize: bool = False, check: bool = True) -> "SO3":
        mat = torch.as_tensor(mat)
        _require(tuple(mat.shape[-2:]) == (3, 3), "Matrix should be of shape ([*,] 3, 3)")
        if normalize:
            fixed = so3f.make_valid(mat)
            if check:
                _require(_allclose(fixed, mat, 1e-3),
                         "Provided matrix too far from being valid")
            return SO3(fixed)
        if check:
            _require(bool(so3f.is_valid(mat).all()), "Matrix is not a valid rotation")
        return SO3(mat)

    @staticmethod
    def from_quaternion(quat, normalize: bool = False) -> "SO3":
        """wxyz unit quaternion -> SO3 (so3.py:53-58)."""
        quat = torch.as_tensor(quat)
        if normalize:
            quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
        return SO3(so3f.matrix_from_quat(quat))

    # -- maps --------------------------------------------------------------
    @staticmethod
    def exp(omega) -> "SO3":
        return SO3(so3f.exp(torch.as_tensor(omega)))

    @staticmethod
    def exp_and_theta(omega):
        """Exp that also returns the rotation angle (so3.py:81-101), in the
        reference's keepdims shape ``(..., 1)``."""
        omega = torch.as_tensor(omega)
        return SO3(so3f.exp(omega)), torch.linalg.norm(omega, dim=-1, keepdim=True)

    def log(self) -> torch.Tensor:
        return so3f.log(self.data)

    def inv(self) -> "SO3":
        return SO3(self.data.transpose(-1, -2))

    def transform(self, pts: torch.Tensor) -> torch.Tensor:
        """Rotate ``([*,] N, 3)`` points (so3.py:156-161)."""
        _require(len(self.shape) == pts.ndim - 2, "batch shapes of pose and points differ")
        return (self.data @ pts.transpose(-1, -2)).transpose(-1, -2)

    # -- algebra -----------------------------------------------------------
    hat = staticmethod(so3f.hat)
    vee = staticmethod(so3f.vee)

    # -- comparison --------------------------------------------------------
    def rotation_angle(self) -> torch.Tensor:
        """Angle in radians (so3.py:176-180)."""
        return so3f.rotation_angle(self.data)

    def compare(self, other: "SO3") -> Dict:
        """``{'rot_deg': ...}`` error dict (so3.py:182-187)."""
        error = self * other.inv()
        return {"rot_deg": error.rotation_angle() * 180.0 / math.pi}

    # -- conversions -------------------------------------------------------
    def vec(self) -> torch.Tensor:
        """Column-major flattened 9-vector (so3.py:189-191)."""
        return self.data.transpose(-1, -2).reshape(*self.data.shape[:-2], 9)

    def as_quaternion(self) -> torch.Tensor:
        return so3f.quat_from_matrix(self.data)

    def is_valid(self) -> torch.Tensor:
        return so3f.is_valid(self.data)

    def make_valid(self) -> "SO3":
        """SVD re-orthonormalization (lie/torch/so3.py:213)."""
        return SO3(so3f.make_valid(self.data))


class SE3(_LieBase):
    """Rigid transform as a ``(..., 4, 4)`` matrix (``lie/numpy/se3.py:10-264``).

    Stored 4x4 like the reference class; the functional layer's compact
    ``(..., 3, 4)`` form is :attr:`compact`.
    """

    DIM = 12
    DOF = 6
    N = 4
    name = "SE3"

    # -- constructors ------------------------------------------------------
    @staticmethod
    def identity(size: Optional[int] = None, device="cuda") -> "SE3":
        eye = torch.eye(4, device=resolve_device(device))
        return SE3(eye if size is None else eye.expand(size, 4, 4).clone())

    @staticmethod
    def sample_uniform(generator: torch.Generator, size: Optional[int] = None,
                       device="cuda") -> "SE3":
        """Uniform rotation and translation uniform in [-1, 1]^3 (both of
        the reference's branches sample the stated cube, as in the JAX
        package; se3.py:30-34)."""
        shape = () if size is None else (size,)
        return SE3(_lift(se3f.sample_uniform(generator, shape, device=device)))

    @staticmethod
    def sample_small(generator: torch.Generator, size: Optional[int] = None,
                     std: float = 0.1, device="cuda") -> "SE3":
        """Small pose: SO3.sample_small + N(0, std/sqrt(3)) translation (se3.py:37-44)."""
        shape = () if size is None else (size,)
        return SE3(_lift(se3f.sample_small(generator, std, shape, device)))

    @staticmethod
    def _from_rt(rot: Union[SO3, torch.Tensor], trans) -> "SE3":
        """Concatenate ``([*,]3,3)`` rotation and ``([*,]3,1)`` translation (se3.py:46-63)."""
        rot_mat = rot.data if isinstance(rot, SO3) else torch.as_tensor(rot)
        return SE3(_lift(se3f.se3_init(rot_mat, torch.as_tensor(trans))))

    from_rt = _from_rt  # public alias; the reference name is "private" but used

    @staticmethod
    def from_rtvec(vec, normalize: bool = False) -> "SE3":
        """7-vector [qw qx qy qz tx ty tz] -> SE3 (se3.py:65-74). With
        ``normalize`` the quaternion must still be within 1e-3 of unit
        length: normalizing fixes rounding drift, not a degenerate vector."""
        vec = torch.as_tensor(vec)
        if normalize:
            q = vec[..., :4] / torch.linalg.norm(vec[..., :4], dim=-1, keepdim=True)
            _require(_allclose(q, vec[..., :4], 1e-3),
                     "quaternion is too far from unit length to normalize")
            vec = torch.cat([q, vec[..., 4:]], -1)
        else:
            n = torch.linalg.norm(vec[..., :4], dim=-1)
            _require(_allclose(n, torch.ones_like(n), 1e-3), "quaternion is not unit length")
        return SE3(_lift(se3f.from_quat_trans(vec)))

    @staticmethod
    def from_matrix(mat, normalize: bool = False, check: bool = True) -> "SE3":
        """Accepts ``([*,] 3, 4)`` or ``([*,] 4, 4)`` (se3.py:76-91)."""
        mat = torch.as_tensor(mat)
        _require(tuple(mat.shape[-2:]) in [(4, 4), (3, 4)],
                 "Matrix should be of shape ([*,] 3/4, 4)")
        compact = mat[..., :3, :]
        if normalize:
            fixed = se3f.make_valid(compact)
            if check:
                _require(_allclose(fixed, compact, 1e-3),
                         "Original SE3 is too far from being valid")
            return SE3(_lift(fixed))
        if check:
            # Default atol (5e-5): the reference's loose fp32 tolerance
            # (so3_common.py:27).
            _require(bool(so3f.is_valid(compact[..., :3, :3]).all()),
                     "Matrix is not a valid SE(3)")
        return SE3(_lift(compact))

    # -- maps --------------------------------------------------------------
    @staticmethod
    def exp(vec) -> "SE3":
        """Tangent ``[u, w]`` -> SE3 (se3.py:99-137)."""
        return SE3(_lift(se3f.exp(torch.as_tensor(vec))))

    @staticmethod
    def pexp(vec) -> "SE3":
        """Pseudo-exp: translation verbatim (lie/torch/se3.py:113-135)."""
        return SE3(_lift(se3f.pexp(torch.as_tensor(vec))))

    def log(self) -> torch.Tensor:
        return se3f.log(self.compact)

    def plog(self) -> torch.Tensor:
        """Inverse of :meth:`pexp`."""
        return se3f.plog(self.compact)

    def boxplus_left(self, delta, pseudo: bool = False) -> "SE3":
        """``exp(delta) * self``; pseudo-aware (lie/torch/liegroupbase.py:51-57)."""
        return SE3(_lift(se3f.boxplus_left(self.compact, torch.as_tensor(delta), pseudo)))

    def boxplus_right(self, delta, pseudo: bool = False) -> "SE3":
        """``self * exp(delta)``; pseudo-aware (lie/torch/liegroupbase.py:59-66)."""
        return SE3(_lift(se3f.boxplus_right(self.compact, torch.as_tensor(delta), pseudo)))

    def inv(self) -> "SE3":
        return SE3(_lift(se3f.se3_inv(self.compact)))

    def transform(self, pts: torch.Tensor) -> torch.Tensor:
        """Apply to ``([*,] N, 3)`` points (se3.py:144-149)."""
        _require(len(self.shape) == pts.ndim - 2, "batch shapes of pose and points differ")
        return se3f.se3_transform(self.compact, pts)

    # -- algebra -----------------------------------------------------------
    @staticmethod
    def hat(v) -> torch.Tensor:
        """Tangent ``[u, w]`` -> 4x4 twist matrix (se3.py:151-164)."""
        v = torch.as_tensor(v)
        u, w = v[..., :3], v[..., 3:]
        top = torch.cat([so3f.hat(w), u[..., None]], -1)
        return torch.cat([top, torch.zeros_like(top[..., :1, :])], -2)

    @staticmethod
    def vee(mat) -> torch.Tensor:
        """4x4 twist matrix -> ``[u, w]`` (se3.py:166-175)."""
        mat = torch.as_tensor(mat)
        return torch.cat([mat[..., :3, 3], so3f.vee(mat[..., :3, :3])], -1)

    # -- jacobians (torch extras; lie/torch/se3.py:183-278) ----------------
    # The functional layer vectorizes [R|t] row-major, the reference classes
    # column-major (as their vec()); these return the reference's layout.

    @staticmethod
    def jacob_expeD_de(D: "SE3", pseudo: bool = True) -> torch.Tensor:
        """d(exp(eps).D)/d(eps) at 0, ``(...,12,6)`` (se3.py:183-209, 10.3.3)."""
        return se3f.jacob_expeD_de(_as_compact(D), pseudo)[..., _REF_ROW_ORDER, :]

    @staticmethod
    def jacob_Dexpe_de(D: "SE3") -> torch.Tensor:
        """d(D.exp(eps))/d(eps) at 0 (se3.py:211-232, 10.3.4)."""
        return se3f.jacob_Dexpe_de(_as_compact(D))[..., _REF_ROW_ORDER, :]

    @staticmethod
    def jacob_dAexpeD_de(A: "SE3", D: "SE3", full_matrix: bool = True) -> torch.Tensor:
        """d(A.exp(eps).D)/d(eps) at 0 (se3.py:234-278, 10.3.7).

        ``full_matrix=False`` returns the reference's ``(..., 15, 3)``
        stacked non-zero blocks [A; B; C; D; E] instead of the sparse
        ``(..., 12, 6)`` matrix.
        """
        jac = se3f.jacob_dAexpeD_de(_as_compact(A), _as_compact(D))[..., _REF_ROW_ORDER, :]
        if full_matrix:
            return jac
        return torch.cat([jac[..., 9:12, 0:3],  # block A
                          jac[..., 0:3, 3:6],  # block B
                          jac[..., 3:6, 3:6],  # block C
                          jac[..., 6:9, 3:6],  # block D
                          jac[..., 9:12, 3:6]],  # block E
                         -2)

    # -- comparison --------------------------------------------------------
    def compare(self, other: "SE3") -> Dict:
        """``{'rot_deg', 'trans'}`` error dict (se3.py:232-238)."""
        error = self * other.inv()
        return {"rot_deg": error.rot.rotation_angle() * 180.0 / math.pi,
                "trans": torch.linalg.norm(self.trans - other.trans, dim=-1)}

    # -- conversions -------------------------------------------------------
    @property
    def compact(self) -> torch.Tensor:
        """The functional layer's ``(..., 3, 4)`` working form."""
        return self.data[..., :3, :]

    @property
    def rot(self) -> SO3:
        return SO3(self.data[..., :3, :3])

    @property
    def trans(self) -> torch.Tensor:
        return self.data[..., :3, 3]

    def vec(self) -> torch.Tensor:
        """Column-major flattened 12-vector of ``[R|t]`` (se3.py:248-250)."""
        return self.compact.transpose(-1, -2).reshape(*self.data.shape[:-2], 12)

    def as_quat_trans(self) -> torch.Tensor:
        """7-vector [qw qx qy qz tx ty tz] (se3.py:252-256)."""
        return se3f.as_quat_trans(self.compact)

    def is_valid(self) -> torch.Tensor:
        return so3f.is_valid(self.data[..., :3, :3])

    def make_valid(self) -> "SE3":
        """Re-orthonormalize the rotation block (lie/torch/se3.py:318)."""
        return SE3(_lift(se3f.make_valid(self.compact)))


# perm[ref_row] = functional_row: reference row 3j+i (column-major over the
# 3x4 [R|t]) comes from the functional layer's row-major row 4i+j.
_REF_ROW_ORDER = [4 * (r % 3) + r // 3 for r in range(12)]


def _lift(compact: torch.Tensor) -> torch.Tensor:
    """``(..., 3, 4)`` -> ``(..., 4, 4)`` with the [0 0 0 1] bottom row."""
    return se3f.to_4x4(compact)


def _as_compact(pose: Union[SE3, torch.Tensor]) -> torch.Tensor:
    """An SE3 instance or a raw (...,3,4)/(...,4,4) tensor, as (..., 3, 4)."""
    data = pose.data if isinstance(pose, SE3) else torch.as_tensor(pose)
    return data[..., :3, :]


__all__ = ["SO3", "SE3"]
