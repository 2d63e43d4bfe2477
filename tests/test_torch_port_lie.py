"""The port's class API ``SO3`` / ``SE3`` (``geometry/lie.py``) against the
JAX package's classes on the CPU.

Bars: every method within 1e-5 per entry of the JAX class's on the same
seeded inputs (fp32), relative to the entry where it exceeds 1 (angles in
degrees), boolean results and shapes equal; the checks of
``from_matrix`` / ``from_rtvec`` raise where the JAX ones do; the samplers'
mean angle over 20,000 draws within 0.02 rad of the JAX sampler's (the
draws' standard error is 0.005; the two draw different numbers).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from scream_tpu.geometry import lie as jlie
from scream_tpu_torch.geometry import lie as tlie
from scream_tpu_torch.geometry import SE3, SO3

TOL = 1e-5
RNG = np.random.default_rng(16)
OMEGA = (RNG.standard_normal((5, 3)) * 0.8).astype(np.float32)
TWIST = (RNG.standard_normal((5, 6)) * 0.5).astype(np.float32)
OMEGA2 = (RNG.standard_normal((5, 3)) * 0.8).astype(np.float32)
TWIST2 = (RNG.standard_normal((5, 6)) * 0.5).astype(np.float32)
PTS = RNG.standard_normal((5, 7, 3)).astype(np.float32)
QUAT = RNG.standard_normal((5, 4)).astype(np.float32)
# Valid rotations and poses (scipy), and the same off by 1e-4 a entry.
R_MAT = Rotation.from_rotvec(OMEGA).as_matrix().astype(np.float32)
T_MAT = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
T_MAT[:, :3, :3], T_MAT[:, :3, 3] = R_MAT, TWIST[:, :3]
QT = np.concatenate([Rotation.from_matrix(R_MAT).as_quat()[:, [3, 0, 1, 2]], TWIST[:, :3]],
                    1).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, (tlie._LieBase, jlie._LieBase)):
        x = x.data
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _same(got, want):
    if isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in got:
            _same(got[k], want[k])
        return
    if isinstance(got, tuple):
        for a, b in zip(got, want):
            _same(a, b)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.dtype == bool:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


# Each case: a function of (classes module, array converter) giving a result.
CASES = {
    "so3_exp": lambda L, a: L.SO3.exp(a(OMEGA)),
    "so3_exp_and_theta": lambda L, a: L.SO3.exp_and_theta(a(OMEGA)),
    "so3_log": lambda L, a: L.SO3.exp(a(OMEGA)).log(),
    "so3_inv": lambda L, a: L.SO3.exp(a(OMEGA)).inv(),
    "so3_mul": lambda L, a: L.SO3.exp(a(OMEGA)) * L.SO3.exp(a(OMEGA2)),
    "so3_boxplus": lambda L, a: (L.SO3.exp(a(OMEGA)).boxplus_left(a(OMEGA2)),
                                 L.SO3.exp(a(OMEGA)).boxplus_right(a(OMEGA2))),
    "so3_transform": lambda L, a: L.SO3.exp(a(OMEGA)).transform(a(PTS)),
    "so3_hat_vee": lambda L, a: (L.SO3.hat(a(OMEGA)), L.SO3.vee(L.SO3.hat(a(OMEGA)))),
    "so3_rotation_angle": lambda L, a: L.SO3.exp(a(OMEGA)).rotation_angle(),
    "so3_compare": lambda L, a: L.SO3.exp(a(OMEGA)).compare(L.SO3.exp(a(OMEGA2))),
    "so3_vec": lambda L, a: L.SO3.exp(a(OMEGA)).vec(),
    "so3_as_quaternion": lambda L, a: L.SO3.exp(a(OMEGA)).as_quaternion(),
    "so3_from_quaternion": lambda L, a: L.SO3.from_quaternion(a(QUAT), normalize=True),
    "so3_is_valid": lambda L, a: (L.SO3.exp(a(OMEGA)).is_valid(),
                                  L.SO3(a(np.eye(3, dtype=np.float32) * 1.01)).is_valid()),
    "so3_make_valid": lambda L, a: L.SO3(
        a(R_MAT + 1e-4)).make_valid(),
    "so3_from_matrix": lambda L, a: (
        L.SO3.from_matrix(a(R_MAT)),
        L.SO3.from_matrix(a(R_MAT + 1e-4), normalize=True)),
    "so3_identity_container": lambda L, a: (
        L.SO3.identity(4, **({} if L is jlie else {"device": "cpu"})),
        L.SO3.identity(**({} if L is jlie else {"device": "cpu"})),
        L.SO3.exp(a(OMEGA))[1:3],
        L.SO3.stack([L.SO3.exp(a(OMEGA)), L.SO3.exp(a(OMEGA2))]),
        L.SO3.exp(a(OMEGA)).set(2, L.SO3.exp(a(OMEGA2[0]))),
        L.SO3.exp(a(OMEGA)).as_matrix()),
    "se3_exp_pexp": lambda L, a: (L.SE3.exp(a(TWIST)), L.SE3.pexp(a(TWIST))),
    "se3_log_plog": lambda L, a: (L.SE3.exp(a(TWIST)).log(), L.SE3.pexp(a(TWIST)).plog()),
    "se3_inv_mul": lambda L, a: (L.SE3.exp(a(TWIST)).inv(),
                                 L.SE3.exp(a(TWIST)) * L.SE3.exp(a(TWIST2))),
    "se3_boxplus": lambda L, a: tuple(
        getattr(L.SE3.exp(a(TWIST)), f)(a(TWIST2), pseudo=p)
        for f in ("boxplus_left", "boxplus_right") for p in (False, True)),
    "se3_transform": lambda L, a: L.SE3.exp(a(TWIST)).transform(a(PTS)),
    "se3_hat_vee": lambda L, a: (L.SE3.hat(a(TWIST)), L.SE3.vee(L.SE3.hat(a(TWIST)))),
    "se3_jacobians": lambda L, a: (
        L.SE3.jacob_expeD_de(L.SE3.exp(a(TWIST))),
        L.SE3.jacob_expeD_de(L.SE3.exp(a(TWIST)), pseudo=False),
        L.SE3.jacob_Dexpe_de(L.SE3.exp(a(TWIST))),
        L.SE3.jacob_dAexpeD_de(L.SE3.exp(a(TWIST)), L.SE3.exp(a(TWIST2))),
        L.SE3.jacob_dAexpeD_de(L.SE3.exp(a(TWIST)), L.SE3.exp(a(TWIST2)), full_matrix=False)),
    "se3_compare": lambda L, a: L.SE3.exp(a(TWIST)).compare(L.SE3.exp(a(TWIST2))),
    "se3_parts": lambda L, a: (L.SE3.exp(a(TWIST)).compact, L.SE3.exp(a(TWIST)).rot,
                               L.SE3.exp(a(TWIST)).trans, L.SE3.exp(a(TWIST)).vec(),
                               L.SE3.exp(a(TWIST)).as_quat_trans(),
                               L.SE3.exp(a(TWIST)).is_valid()),
    "se3_make_valid": lambda L, a: L.SE3(
        a(T_MAT + 1e-4)).make_valid(),
    "se3_from_rt": lambda L, a: (
        L.SE3.from_rt(L.SO3.exp(a(OMEGA)), a(TWIST[:, :3, None])),
        L.SE3._from_rt(a(R_MAT), a(TWIST[:, :3, None]))),
    "se3_from_rtvec": lambda L, a: (
        L.SE3.from_rtvec(a(QT)),
        L.SE3.from_rtvec(a(QT * np.float32(
            [1.0004] * 4 + [1.0] * 3)), normalize=True)),
    "se3_from_matrix": lambda L, a: (
        L.SE3.from_matrix(a(T_MAT)),
        L.SE3.from_matrix(a(T_MAT[:, :3])),
        L.SE3.from_matrix(a(T_MAT + 1e-4), normalize=True)),
    "se3_identity_container": lambda L, a: (
        L.SE3.identity(3, **({} if L is jlie else {"device": "cpu"})),
        L.SE3.exp(a(TWIST))[0],
        L.SE3.stack([L.SE3.exp(a(TWIST)), L.SE3.exp(a(TWIST2))]),
        L.SE3.exp(a(TWIST)).set(slice(0, 2), L.SE3.exp(a(TWIST2[:2]))),
        L.SE3.exp(a(TWIST)).astype(np.float32 if L is jlie else torch.float32)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_method_matches_jax(case):
    got = CASES[case](tlie, torch.from_numpy)
    want = jax.jit(lambda: CASES[case](jlie, jnp.asarray))()  # one compile a case
    _same(got, want)


def test_container_protocol():
    """Shapes, lengths, ``__array__``, the immutable ``__setitem__`` and a
    ``set`` that leaves the caller's tensor as it was."""
    R = SO3.exp(torch.from_numpy(OMEGA))
    J = jlie.SO3.exp(OMEGA)
    assert R.shape == tuple(J.shape) and len(R) == len(J) == 5
    assert len(SO3.identity(device="cpu")) == len(jlie.SO3.identity()) == 1
    assert str(R) == str(J) == "SO3[5]"
    np.testing.assert_allclose(np.asarray(R), np.asarray(J), atol=TOL)
    with pytest.raises(TypeError):
        R[0] = SO3.identity(device="cpu")
    with pytest.raises(TypeError):
        J[0] = jlie.SO3.identity()
    shared = torch.from_numpy(OMEGA.copy())
    P = SE3.exp(torch.zeros((5, 6)))
    before = P.data.clone()
    Q = P.set(1, SE3.exp(shared[:1].repeat(1, 2))[0])
    assert torch.equal(P.data, before) and not torch.equal(Q.data, before)


@pytest.mark.parametrize("call", [
    lambda L, a: L.SO3.from_matrix(a(np.eye(3, dtype=np.float32) * 1.1)),
    lambda L, a: L.SO3.from_matrix(a(np.eye(3, dtype=np.float32) * 1.1), normalize=True),
    lambda L, a: L.SO3.from_matrix(a(np.eye(4, dtype=np.float32))),
    lambda L, a: L.SE3.from_matrix(a(np.eye(4, dtype=np.float32) * 1.1)),
    lambda L, a: L.SE3.from_matrix(a(np.eye(3, dtype=np.float32))),
    lambda L, a: L.SE3.from_rtvec(a(np.float32([2, 0, 0, 0, 1, 2, 3]))),
    lambda L, a: L.SE3.from_rtvec(a(np.float32([2, 0, 0, 0, 1, 2, 3])), normalize=True),
    lambda L, a: L.SO3.exp(a(OMEGA)).transform(a(PTS[0])),
])
def test_checks_raise_where_jax_raises(call):
    with pytest.raises(AssertionError):
        call(jlie, jnp.asarray)
    with pytest.raises(AssertionError):
        call(tlie, torch.from_numpy)


@pytest.mark.parametrize("kind", ["SO3", "SE3"])
def test_samplers_mean_angle(kind):
    """20,000 draws of each sampler from a ``torch.Generator``: valid, and
    their mean angle within 0.02 rad of the JAX sampler's (uniform: the
    SO(3) mean pi/2 + 2/pi)."""
    g = torch.Generator().manual_seed(5)
    key = jax.random.PRNGKey(5)
    for name, kw in (("sample_uniform", {}), ("sample_small", {"std": 0.1})):
        t = getattr(getattr(tlie, kind), name)(g, 20000, device="cpu", **kw)
        j = jax.jit(lambda k: getattr(getattr(jlie, kind), name)(k, 20000, **kw))(key)
        assert bool(t.is_valid().all())
        rot = lambda x: x.rot if kind == "SE3" else x
        ta = float(rot(t).rotation_angle().mean())
        ja = float(jnp.mean(rot(j).rotation_angle()))
        assert abs(ta - ja) <= 0.02, (name, ta, ja)
        if name == "sample_uniform":
            assert abs(ta - (math.pi / 2 + 2 / math.pi)) <= 0.02
            if kind == "SE3":
                assert float(t.trans.abs().max()) <= 1.0
