"""The port's geometry against the JAX package on the CPU: weighted Kabsch,
the registration metrics, the spatial sort, batched ICP (one step, whole
trajectories, keep-iff-both-improve) and the single-pair ICP with its early
exit (one step, trajectories, and against the batched loop).

Bars (CLAUDE.md): kabsch 1e-5; one ICP step 1e-5; an ICP trajectory 2e-2 on
the transform with iteration counts within 1 (the JAX CPU path and the port
sum in other orders, and over unconverged iterations one threshold-boundary
weight can flip); metrics 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scream_tpu.data.synthetic import make_pair
from scream_tpu.geometry import icp as jicp
from scream_tpu.geometry import metrics as jmetrics
from scream_tpu.geometry import so3 as jso3
from scream_tpu_torch.data.transforms import rodrigues
from scream_tpu_torch.geometry import icp as ticp
from scream_tpu_torch.geometry import kabsch as tkabsch
from scream_tpu_torch.geometry import metrics as tmetrics
from scream_tpu_torch.geometry import so3 as tso3
from scream_tpu_torch.ops import nn_cuda

# scream_tpu.geometry re-exports the function ``kabsch`` under the module's name.
jkabsch = importlib.import_module("scream_tpu.geometry.kabsch")


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _rot(rng, max_angle):
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    return rodrigues(axis * rng.uniform(-max_angle, max_angle))


def _transforms(rng, B, max_angle=np.pi, max_t=1.0):
    T = np.tile(np.eye(4), (B, 1, 1))
    for b in range(B):
        T[b, :3, :3] = _rot(rng, max_angle)
        T[b, :3, 3] = rng.uniform(-max_t, max_t, 3)
    return T.astype(np.float32)


class TestKabsch:
    @pytest.mark.parametrize("weighted,threshold", [(False, 0.0), (True, 0.0), (True, 0.3)])
    def test_matches_jax(self, rng, weighted, threshold):
        B, N = 4, 200
        A = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
        T = _transforms(rng, B)
        Bp = (A @ T[:, :3, :3].transpose(0, 2, 1) + T[:, None, :3, 3]
              + rng.standard_normal((B, N, 3)) * 0.01).astype(np.float32)
        w = (rng.random((B, N)) * (rng.random((B, N)) > 0.2)).astype(np.float32) \
            if weighted else None
        want = jkabsch.kabsch(jnp.asarray(A), jnp.asarray(Bp),
                              None if w is None else jnp.asarray(w), threshold)
        got = tkabsch.kabsch(t(A), t(Bp), None if w is None else t(w), threshold)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.numpy(), T, atol=0.02)

    def test_reflection_corrected(self, rng):
        A = rng.uniform(-1, 1, (1, 50, 3)).astype(np.float32)
        Bm = A * np.array([1, 1, -1], np.float32)  # a mirror image
        got = tkabsch.kabsch(t(A), t(Bm))[0, :3, :3]
        assert abs(float(torch.linalg.det(got)) - 1.0) < 1e-5
        want = jkabsch.kabsch(jnp.asarray(A), jnp.asarray(Bm))[0, :3, :3]
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    def test_integrate_trans(self, rng):
        R = rng.standard_normal((2, 3, 3, 3)).astype(np.float32)
        tr = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
        np.testing.assert_array_equal(
            tkabsch.integrate_trans(t(R), t(tr)).numpy(),
            jkabsch.integrate_trans(jnp.asarray(R), jnp.asarray(tr)))


class TestMetrics:
    def test_transformation_error(self, rng):
        P, G = _transforms(rng, 6), _transforms(rng, 6)
        P[0] = G[0]
        want = jmetrics.transformation_error(jnp.asarray(P), jnp.asarray(G))
        got = tmetrics.transformation_error(t(P), t(G))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-5)

    def test_quat_from_matrix(self, rng):
        R = _transforms(rng, 16)[:, :3, :3]
        R[0] = _rot(np.random.default_rng(1), 1e-3)
        R[1] = np.diag([1.0, -1.0, -1.0])  # the 180-degree branch
        np.testing.assert_allclose(tso3.quat_from_matrix(t(R)).numpy(),
                                   jso3.quat_from_matrix(jnp.asarray(R)), atol=1e-5)

    def test_registration_recall_rmse(self, rng):
        G = _transforms(rng, 5)
        P = G @ _transforms(rng, 5, max_angle=0.1, max_t=0.1)
        A = rng.standard_normal((5, 6, 6)).astype(np.float32)
        info = (A @ A.transpose(0, 2, 1) + 6 * np.eye(6)).astype(np.float32)
        want = jmetrics.registration_recall_rmse(jnp.asarray(P), jnp.asarray(G),
                                                 jnp.asarray(info))
        got = tmetrics.registration_recall_rmse(t(P), t(G), t(info))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            tmetrics.redwood_rmse(t(P), t(info)).numpy(),
            jmetrics.redwood_rmse(jnp.asarray(P), jnp.asarray(info)), rtol=1e-4, atol=1e-5)


def _icp_batch(B=3, N=256, M=300, seed=0, perturb=0.08):
    """Synthetic pairs in their own frames, GT poses and perturbed inits."""
    rng = np.random.default_rng(seed)
    src = np.zeros((B, N, 3), np.float32)
    tgt = np.zeros((B, M, 3), np.float32)
    gt = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        p = make_pair(rng, N - 20, M - 10, overlap=0.8, noise=0.003)
        src[b, :N - 20], tgt[b, :M - 10] = p["src"], p["tgt"]
        gt[b, :3, :3], gt[b, :3, 3] = p["rot"], p["trans"][:, 0]
    sm = np.arange(N)[None].repeat(B, 0) < N - 20
    tm = np.arange(M)[None].repeat(B, 0) < M - 10
    init = (gt @ _transforms(rng, B, max_angle=perturb, max_t=perturb)).astype(np.float32)
    return src, tgt, sm, tm, gt, init


class TestICP:
    def test_spatial_sort_matches_jax(self, rng):
        pts = rng.uniform(-1, 1, (2, 100, 3)).astype(np.float32)
        mask = rng.random((2, 100)) > 0.2
        axis = _transforms(rng, 2)[:, 0, :3]
        wp, wm = jax.vmap(jicp._spatial_sort)(jnp.asarray(pts), jnp.asarray(mask),
                                             jnp.asarray(axis))
        gp, gm = ticp._spatial_sort(t(pts), t(mask), t(axis))
        np.testing.assert_array_equal(gm.numpy(), wm)
        np.testing.assert_array_equal(gp.numpy()[gm.numpy()], np.asarray(wp)[np.asarray(wm)])
        xp, xm = ticp._spatial_sort(t(pts), t(mask))
        assert (np.diff(xp.numpy()[0][xm.numpy()[0]][:, 0]) >= 0).all()

    def test_one_step_matches_jax(self):
        src, tgt, sm, tm, gt, init = _icp_batch()
        thresh_sq = ticp._f32_square(0.1)
        step, _, _ = ticp._make_icp_fns(t(src), t(tgt), t(sm), t(tm), thresh_sq,
                                        1e-6, 1e-6)
        T_new, fit, rmse = step(t(init))
        for b in range(src.shape[0]):
            jstep, _, _ = jicp._make_icp_fns(
                jnp.asarray(src[b]), jnp.asarray(tgt[b]), jnp.asarray(sm[b]),
                jnp.asarray(tm[b]), jnp.float32(0.1) ** 2, 1e-6, 1e-6, True)
            wT, wf, wr = jstep(jnp.asarray(init[b]))
            np.testing.assert_allclose(T_new[b].numpy(), wT, atol=1e-5, rtol=0)
            np.testing.assert_allclose(float(fit[b]), float(wf), atol=1e-5)
            np.testing.assert_allclose(float(rmse[b]), float(wr), atol=1e-5)

    def test_threshold_square_rounds_like_jax(self):
        assert np.float32(ticp._f32_square(0.1)) == np.asarray(jnp.float32(0.1) ** 2)

    @pytest.mark.parametrize("max_iteration", [3, 30])
    def test_trajectory_matches_jax(self, max_iteration):
        src, tgt, sm, tm, gt, init = _icp_batch(seed=1)
        init[1] = gt[1]  # a lane that starts converged and breaks early
        want = jicp.registration_icp_batched(
            jnp.asarray(src), jnp.asarray(tgt), 0.1, init=jnp.asarray(init),
            max_iteration=max_iteration, src_mask=jnp.asarray(sm),
            tgt_mask=jnp.asarray(tm), force_xla=True)
        got = ticp.registration_icp_batched(t(src), t(tgt), 0.1, init=t(init),
                                            max_iteration=max_iteration,
                                            src_mask=t(sm), tgt_mask=t(tm))
        np.testing.assert_allclose(got.transformation.numpy(), want.transformation,
                                   atol=2e-2, rtol=0)
        it_g, it_w = got.iterations.numpy(), np.asarray(want.iterations)
        assert (np.abs(it_g - it_w) <= 1).all(), (it_g, it_w)
        assert (it_g <= max_iteration).all()
        np.testing.assert_allclose(got.fitness.numpy(), want.fitness, atol=2e-2)
        np.testing.assert_allclose(got.inlier_rmse.numpy(), want.inlier_rmse, atol=2e-2)
        if max_iteration == 30:
            assert it_g[1] < 30  # the converged lane broke early

    def test_no_inliers_keeps_transform(self):
        src, tgt, sm, tm, gt, init = _icp_batch(B=2, seed=2)
        init[0, :3, 3] += 50.0  # nothing within the threshold
        got = ticp.registration_icp_batched(t(src), t(tgt), 0.1, init=t(init),
                                            max_iteration=5, src_mask=t(sm),
                                            tgt_mask=t(tm))
        np.testing.assert_array_equal(got.transformation[0].numpy(), init[0])
        assert float(got.fitness[0]) == 0.0

    def test_refine_if_better_matches_jax(self):
        src, tgt, sm, tm, gt, init = _icp_batch(B=3, seed=3)
        want = jax.vmap(lambda s, d, a, b, T0, Tg: jicp.icp_refine_if_better(
            s, d, T0, Tg, 0.1, max_iteration=30, src_mask=a, tgt_mask=b,
            force_xla=True))(*map(jnp.asarray, (src, tgt, sm, tm, init, gt)))
        got = ticp.icp_refine_if_better(t(src), t(tgt), t(init), t(gt), 0.1,
                                        max_iteration=30, src_mask=t(sm),
                                        tgt_mask=t(tm))
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=2e-2)
        np.testing.assert_allclose(got[1].numpy(), want[1], atol=2e-2)
        np.testing.assert_allclose(got[2].numpy(), want[2], atol=2e-2)
        re_i, te_i = tmetrics.transformation_error(t(init), t(gt))
        assert (got[1] <= re_i + 1e-6).all() and (got[2] <= te_i + 1e-6).all()


class TestICPSingle:
    """The unbatched ``registration_icp`` (host loop with Open3D's early
    exit, unbatched bounded NN) against the JAX package's unbatched
    ``registration_icp`` and against the port's batched loop."""

    def test_one_step_matches_jax(self):
        src, tgt, sm, tm, gt, init = _icp_batch(B=2, seed=4)
        for b in range(2):
            step, _, _ = ticp._make_icp_fns(
                t(src[b:b + 1]), t(tgt[b:b + 1]), t(sm[b:b + 1]), t(tm[b:b + 1]),
                ticp._f32_square(0.1), 1e-6, 1e-6, nn=nn_cuda.nn_bounded_single)
            T_new, fit, rmse = step(t(init[b:b + 1]))
            jstep, _, _ = jicp._make_icp_fns(
                jnp.asarray(src[b]), jnp.asarray(tgt[b]), jnp.asarray(sm[b]),
                jnp.asarray(tm[b]), jnp.float32(0.1) ** 2, 1e-6, 1e-6, True)
            wT, wf, wr = jstep(jnp.asarray(init[b]))
            np.testing.assert_allclose(T_new[0].numpy(), wT, atol=1e-5, rtol=0)
            np.testing.assert_allclose(float(fit[0]), float(wf), atol=1e-5)
            np.testing.assert_allclose(float(rmse[0]), float(wr), atol=1e-5)

    @pytest.mark.parametrize("max_iteration", [3, 30])
    def test_trajectory_matches_jax_and_batched(self, max_iteration):
        src, tgt, sm, tm, gt, init = _icp_batch(seed=5)
        init[1] = gt[1]  # starts converged: breaks early
        batched = ticp.registration_icp_batched(
            t(src), t(tgt), 0.1, init=t(init), max_iteration=max_iteration,
            src_mask=t(sm), tgt_mask=t(tm))
        for b in range(src.shape[0]):
            want = jicp.registration_icp(
                jnp.asarray(src[b]), jnp.asarray(tgt[b]), 0.1, init=jnp.asarray(init[b]),
                max_iteration=max_iteration, src_mask=jnp.asarray(sm[b]),
                tgt_mask=jnp.asarray(tm[b]))
            got = ticp.registration_icp(t(src[b]), t(tgt[b]), 0.1, init=t(init[b]),
                                        max_iteration=max_iteration,
                                        src_mask=t(sm[b]), tgt_mask=t(tm[b]))
            assert got.transformation.shape == (4, 4) and got.iterations.dim() == 0
            for ref in (want, _lane(batched, b)):
                np.testing.assert_allclose(got.transformation.numpy(),
                                           ref.transformation, atol=2e-2, rtol=0)
                assert abs(int(got.iterations) - int(ref.iterations)) <= 1
                assert abs(float(got.fitness) - float(ref.fitness)) <= 2e-2
                assert abs(float(got.inlier_rmse) - float(ref.inlier_rmse)) <= 2e-2
            assert int(got.iterations) <= max_iteration
            if max_iteration == 30 and b == 1:
                assert int(got.iterations) < 30

    def test_masked_tgt_rows_never_match(self):
        """Masked tgt rows placed exactly on the GT-posed source change
        nothing, in either loop: they are never correspondences."""
        src, tgt, sm, tm, gt, init = _icp_batch(B=2, seed=8)
        bait = tgt.copy()
        bait[:, -10:] = (src @ gt[:, :3, :3].transpose(0, 2, 1) + gt[:, None, :3, 3])[:, :10]
        assert not tm[:, -10:].any()
        for b in range(2):
            a, c = (ticp.registration_icp(t(src[b]), t(x[b]), 0.1, init=t(init[b]),
                                          src_mask=t(sm[b]), tgt_mask=t(tm[b]))
                    for x in (tgt, bait))
            assert all(torch.equal(u, v) for u, v in zip(a, c))
        a, c = (ticp.registration_icp_batched(t(src), t(x), 0.1, init=t(init),
                                              src_mask=t(sm), tgt_mask=t(tm))
                for x in (tgt, bait))
        assert all(torch.equal(u, v) for u, v in zip(a, c))
        assert float(a.fitness.min()) > 0.5

    def test_defaults_and_no_inliers(self):
        src, tgt, sm, tm, gt, init = _icp_batch(B=1, seed=6)
        far = init[0].copy()
        far[:3, 3] += 50.0
        got = ticp.registration_icp(t(src[0]), t(tgt[0]), 0.1, init=t(far),
                                    max_iteration=4, src_mask=t(sm[0]), tgt_mask=t(tm[0]))
        np.testing.assert_array_equal(got.transformation.numpy(), far)
        assert float(got.fitness) == 0.0
        # No init, no masks: identity start over every point.
        want = jicp.registration_icp(jnp.asarray(src[0]), jnp.asarray(src[0]), 0.1,
                                     max_iteration=5)
        got = ticp.registration_icp(t(src[0]), t(src[0]), 0.1, max_iteration=5)
        np.testing.assert_allclose(got.transformation.numpy(), want.transformation,
                                   atol=1e-5)
        assert int(got.iterations) == int(want.iterations)


def _lane(res, b):
    """Lane ``b`` of a batched ICPResult."""
    return ticp.ICPResult(*(x[b] for x in res))
