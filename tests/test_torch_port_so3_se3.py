"""The port's SO(3) / SE(3) functions, normals, voxel downsample, radius
queries and ``kabsch_from_correspondence`` against the JAX package on the
CPU.

Bars: every deterministic so3 / se3 function within 1e-5 per entry on
seeded inputs (log's near-pi band and exact pi, the Jacobians included),
boolean results equal; the samplers give valid rotations (``is_valid``), and
the mean angle of 20,000 ``sample_uniform`` draws is within 0.02 rad of the
uniform SO(3) mean pi/2 + 2/pi (the draws' standard error is 0.005); normals
equal up to sign, |dot| >= 1 - 1e-5, on a height field (a surface: each
neighbourhood's smallest eigenvalue stands apart, so the normal is defined);
the voxel masks equal and centroids within 1e-6; ``radius_count`` and the
correspondence mask exactly equal; ``kabsch_from_correspondence`` 1e-5.
"""

import importlib
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from scream_tpu.geometry import normals as jnormals
from scream_tpu.geometry import pairwise as jpairwise
from scream_tpu.geometry import se3 as _jse3
from scream_tpu.geometry import so3 as _jso3
from scream_tpu.ops import voxel as jvoxel
from scream_tpu_torch.geometry import normals as tnormals
from scream_tpu_torch.geometry import pairwise as tpairwise
from scream_tpu_torch.geometry import se3 as tse3
from scream_tpu_torch.geometry import so3 as tso3
from scream_tpu_torch.native import voxel_downsample as native_voxel
from scream_tpu_torch.ops import voxel as tvoxel

# The geometry packages re-export the function ``kabsch`` under the module's name.
jkabsch = importlib.import_module("scream_tpu.geometry.kabsch")
tkabsch = importlib.import_module("scream_tpu_torch.geometry.kabsch")
TOL = 1e-5


class _Jitted:
    """A JAX module's functions under ``jax.jit`` (static bools and
    floats): one compile a shape, not one a primitive."""

    def __init__(self, mod, static=()):
        self.mod, self.static = mod, static

    def __getattr__(self, name):
        fn = getattr(self.mod, name)
        params = inspect.signature(fn).parameters
        return jax.jit(fn, static_argnames=[a for a in self.static if a in params])


jso3 = _Jitted(_jso3, static=("atol",))
jse3 = _Jitted(_jse3, static=("pseudo",))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


def rotations(rng, n, max_angle=np.pi):
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    w = axis * rng.uniform(-max_angle, max_angle, (n, 1))
    return Rotation.from_rotvec(w).as_matrix().astype(np.float32)


def poses(rng, n):
    P = np.zeros((n, 3, 4), np.float32)
    P[:, :, :3] = rotations(rng, n)
    P[:, :, 3] = rng.uniform(-2, 2, (n, 3))
    return P


def near_pi_rotations(rng):
    """The fp32 band of arccos(trace) near 180 deg, and exactly 180 deg."""
    axis = rng.standard_normal((6, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    out = [Rotation.from_rotvec(axis * (np.pi - eps)).as_matrix()
           for eps in (3e-3, 1e-3, 3e-4, 2e-4, 1e-4, 5e-5, 1e-5, 0.0)]
    k = np.eye(3)[[0, 1, 2]]
    out.append(2 * np.einsum("ni,nj->nij", k, k) - np.eye(3))  # pi about the axes
    return np.concatenate(out).astype(np.float32)


class TestSO3:
    def test_hat_vee(self, rng):
        w = rng.standard_normal((7, 3)).astype(np.float32)
        close(tso3.hat(t(w)), jso3.hat(w))
        W = rng.standard_normal((7, 3, 3)).astype(np.float32)
        close(tso3.vee(t(W)), jso3.vee(W))

    @pytest.mark.parametrize("scale", [1e-8, 1e-4, 1.0, 3.0])
    def test_exp(self, rng, scale):
        w = (rng.standard_normal((11, 3)) * scale).astype(np.float32)
        close(tso3.exp(t(w)), jso3.exp(w))

    @pytest.mark.parametrize("kind", ["generic", "small", "near_pi", "identity"])
    def test_log(self, rng, kind):
        R = {"generic": lambda: rotations(rng, 32),
             "small": lambda: rotations(rng, 16, max_angle=1e-4),
             "near_pi": lambda: near_pi_rotations(rng),
             "identity": lambda: np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))}[kind]()
        close(tso3.log(t(R)), jso3.log(R))

    def test_angle_compare_quat(self, rng):
        R1, R2 = rotations(rng, 16), rotations(rng, 16)
        close(tso3.rotation_angle(t(R1)), jso3.rotation_angle(R1))
        close(tso3.compare(t(R1), t(R2)), jso3.compare(R1, R2))
        R = np.concatenate([R1, near_pi_rotations(rng)])
        close(tso3.quat_from_matrix(t(R)), jso3.quat_from_matrix(R))
        q = rng.standard_normal((9, 4)).astype(np.float32)
        q[0] = 0.0  # the degenerate quaternion: the identity
        close(tso3.matrix_from_quat(t(q)), jso3.matrix_from_quat(q))
        e = rng.uniform(-np.pi, np.pi, (9, 3)).astype(np.float32)
        close(tso3.euler_zyx_matrix(t(e)), jso3.euler_zyx_matrix(e))

    def test_valid(self, rng):
        R = rotations(rng, 8)
        bad = R + rng.standard_normal(R.shape).astype(np.float32) * 1e-2
        both = np.concatenate([R, bad])
        assert np.array_equal(tso3.is_valid(t(both)).numpy(), np.asarray(jso3.is_valid(both)))
        close(tso3.make_valid(t(bad)), jso3.make_valid(bad))

    def test_quaternion_ops(self, rng):
        q1 = rng.standard_normal((6, 4)).astype(np.float32)
        q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
        q2 = rng.standard_normal((6, 4)).astype(np.float32)
        close(tso3.quat_inv(t(q1)), jso3.quat_inv(q1))
        close(tso3.quat_mul(t(q1), t(q2)), jso3.quat_mul(q1, q2))
        pts = rng.standard_normal((6, 20, 3)).astype(np.float32)
        close(tso3.quat_rot(t(q1), t(pts)), jso3.quat_rot(q1, pts))

    def test_samplers(self):
        g = torch.Generator().manual_seed(0)
        v = tso3.uniform_2_sphere(g, (500,), device="cpu")
        close(torch.linalg.vector_norm(v, dim=-1), np.ones(500))
        for R in (tso3.sample_uniform(g, (2000,), device="cpu"),
                  tso3.sample_small(g, 0.1, (2000,), device="cpu")):
            assert R.shape == (2000, 3, 3) and bool(tso3.is_valid(R).all())
        angles = tso3.rotation_angle(tso3.sample_uniform(g, (20000,), device="cpu"))
        assert abs(float(angles.mean()) - (math.pi / 2 + 2 / math.pi)) <= 0.02
        small = tso3.rotation_angle(tso3.sample_small(g, 0.01, (2000,), device="cpu"))
        assert float(small.max()) < 0.2  # std 0.01 pi / sqrt 3 = 0.018 rad


class TestSE3:
    def test_compact_ops(self, rng):
        a, b = poses(rng, 5), poses(rng, 5)
        rot, trans = a[..., :3], a[..., 3:]
        close(tse3.se3_init(t(rot), t(trans)), jse3.se3_init(rot, trans))
        close(tse3.se3_cat(t(a), t(b)), jse3.se3_cat(a, b))
        close(tse3.se3_inv(t(a)), jse3.se3_inv(a))
        xyz = rng.standard_normal((5, 30, 3)).astype(np.float32)
        close(tse3.se3_transform(t(a), t(xyz)), jse3.se3_transform(a, xyz))
        T = np.asarray(jse3.to_4x4(a))
        close(tse3.to_4x4(t(a)), T)
        close(tse3.from_4x4(t(T)), jse3.from_4x4(T))

    @pytest.mark.parametrize("scale", [1e-8, 1e-3, 1.0])
    def test_exp_log(self, rng, scale):
        vec = (rng.standard_normal((9, 6)) * scale).astype(np.float32)
        close(tse3.exp(t(vec)), jse3.exp(vec))
        close(tse3.pexp(t(vec)), jse3.pexp(vec))
        P = poses(rng, 9)
        close(tse3.log(t(P)), jse3.log(P))
        close(tse3.plog(t(P)), jse3.plog(P))

    def test_log_near_pi(self, rng):
        R = near_pi_rotations(rng)
        P = np.concatenate([R, rng.uniform(-1, 1, (len(R), 3, 1)).astype(np.float32)], -1)
        close(tse3.log(t(P)), jse3.log(P))

    @pytest.mark.parametrize("pseudo", [False, True])
    def test_boxplus(self, rng, pseudo):
        P = poses(rng, 4)
        d = (rng.standard_normal((4, 6)) * 0.3).astype(np.float32)
        close(tse3.boxplus_left(t(P), t(d), pseudo), jse3.boxplus_left(P, d, pseudo))
        close(tse3.boxplus_right(t(P), t(d), pseudo), jse3.boxplus_right(P, d, pseudo))

    def test_jacobians(self, rng):
        A, D = poses(rng, 3), poses(rng, 3)
        close(tse3.jacob_expeD_de(t(D)), jse3.jacob_expeD_de(D))
        close(tse3.jacob_Dexpe_de(t(D)), jse3.jacob_Dexpe_de(D))
        close(tse3.jacob_dAexpeD_de(t(A), t(D)), jse3.jacob_dAexpeD_de(A, D))
        # Broadcast: one A against a batch of D.
        close(tse3.jacob_dAexpeD_de(t(A[0]), t(D)), jse3.jacob_dAexpeD_de(A[0], D))

    def test_valid_and_quat_trans(self, rng):
        P = poses(rng, 6)
        bad = P + rng.standard_normal(P.shape).astype(np.float32) * 1e-2
        close(tse3.make_valid(t(bad)), jse3.make_valid(bad))
        close(tse3.as_quat_trans(t(P)), jse3.as_quat_trans(P))
        v = np.asarray(jse3.as_quat_trans(P))
        close(tse3.from_quat_trans(t(v)), jse3.from_quat_trans(v))

    def test_samplers(self):
        g = torch.Generator().manual_seed(1)
        for P in (tse3.sample_small(g, 0.1, (500,), device="cpu"),
                  tse3.sample_uniform(g, (500,), trans_scale=2.0, device="cpu")):
            assert P.shape == (500, 3, 4) and bool(tso3.is_valid(P[..., :3]).all())
        P = tse3.sample_uniform(g, (500,), trans_scale=2.0, device="cpu")
        assert float(P[..., 3].abs().max()) <= 2.0


def height_field(rng, B, N):
    """Clouds on a smooth surface z = f(x, y), with a little noise."""
    xy = rng.uniform(-1, 1, (B, N, 2))
    z = 0.15 * np.sin(3.0 * xy[..., 0]) * np.cos(2.0 * xy[..., 1])
    pts = np.concatenate([xy, z[..., None]], -1) + rng.standard_normal((B, N, 3)) * 1e-3
    return pts.astype(np.float32)


class TestNormals:
    def test_matches_jax_up_to_sign(self, rng):
        pts = height_field(rng, 2, 300)
        mask = np.ones((2, 300), bool)
        mask[1, 250:] = False
        got = tnormals.estimate_normals(t(pts), t(mask), k=30).numpy()
        want = np.asarray(jnormals.estimate_normals(pts, mask, k=30))
        dots = np.abs((got * want).sum(-1))[mask]
        assert dots.min() >= 1 - 1e-5, dots.min()
        assert (got[~mask] == 0).all()
        # Unbatched, and fewer valid points than k in a batch.
        one = tnormals.estimate_normals(t(pts[0, :20]), k=30).numpy()
        ref = np.asarray(jnormals.estimate_normals(pts[0, :20], k=30))
        assert np.abs((one * ref).sum(-1)).min() >= 1 - 1e-5

    def test_orient_towards(self, rng):
        pts = height_field(rng, 1, 100)
        n = rng.standard_normal((1, 100, 3)).astype(np.float32)
        cam = np.array([0.0, 0.0, 5.0], np.float32)
        close(tnormals.orient_normals_towards(t(n), t(pts), t(cam)),
              jnormals.orient_normals_towards(n, pts, cam))


class TestVoxel:
    @pytest.mark.parametrize("voxel,capacity", [(0.1, 2048), (0.25, 256), (0.1, 64)])
    def test_matches_jax(self, rng, voxel, capacity):
        pts = rng.uniform(-1, 1, (1500, 3)).astype(np.float32)
        mask = rng.uniform(size=1500) > 0.1
        got_c, got_v = tvoxel.voxel_downsample(t(pts), voxel, capacity, t(mask))
        want_c, want_v = jvoxel.voxel_downsample(pts, voxel, capacity, mask)
        assert np.array_equal(got_v.numpy(), np.asarray(want_v))
        close(got_c, want_c, 1e-6)

    def test_against_host_versions(self, rng):
        pts = rng.uniform(-2, 2, (3000, 3)).astype(np.float32)
        cent, valid = tvoxel.voxel_downsample(t(pts), 0.3, 4096)
        host = tvoxel.voxel_downsample_np(pts, 0.3)
        np.testing.assert_array_equal(host, jvoxel.voxel_downsample_np(pts, 0.3))
        assert int(valid.sum()) == len(host)
        close(cent[valid], host, 1e-5)
        native = native_voxel(pts, 0.3)
        assert len(native) == len(host)
        close(np.sort(native, axis=0), np.sort(host, axis=0), 1e-5)


class TestRadiusAndKabsch:
    def test_radius(self, rng):
        src = rng.uniform(-1, 1, (2, 200, 3)).astype(np.float32)
        dst = rng.uniform(-1, 1, (2, 150, 3)).astype(np.float32)
        sm, dm = rng.uniform(size=(2, 200)) > 0.1, rng.uniform(size=(2, 150)) > 0.1
        for r in (0.1, 0.3):
            got = tpairwise.radius_count(t(src), t(dst), r, t(sm), t(dm)).numpy()
            want = np.asarray(jpairwise.radius_count(src, dst, r, sm, dm))
            assert np.array_equal(got, want)
            got = tpairwise.radius_correspondence_mask(t(src), t(dst), r, t(sm), t(dm))
            want = jpairwise.radius_correspondence_mask(src, dst, r, sm, dm)
            assert np.array_equal(got.numpy(), np.asarray(want))

    def test_kabsch_from_correspondence(self, rng):
        A = rng.uniform(-1, 1, (3, 120, 3)).astype(np.float32)
        R = rotations(rng, 3)
        B = (np.einsum("bij,bnj->bni", R, A) + rng.uniform(-1, 1, (3, 1, 3))
             + rng.standard_normal(A.shape) * 0.01).astype(np.float32)
        valid = rng.uniform(size=(3, 120)) > 0.3
        B[~valid] += 5.0  # the invalid rows' partners are wrong
        close(tkabsch.kabsch_from_correspondence(t(A), t(B), t(valid)),
              jkabsch.kabsch_from_correspondence(jnp.asarray(A), jnp.asarray(B),
                                                 jnp.asarray(valid)))


def test_geometry_api_exports():
    """The port's geometry package exports the JAX package's API (its class
    API SO3 / SE3 aside)."""
    import scream_tpu.geometry as jgeo
    import scream_tpu_torch.geometry as tgeo

    assert set(jgeo.__all__) - {"SO3", "SE3"} <= set(tgeo.__all__)
