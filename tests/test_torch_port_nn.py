"""The port's distance and nearest-neighbour search against the JAX package
on the CPU: the plain pairwise functions, and the NN kernels' wrappers
(which run their plain versions for CPU tensors) against the Pallas kernels
in interpret mode: exact NN, the batched bounded NN against each TPU tiling
of it (fine, coarse ``fine=False``, grouped ``SCREAM_NN_DSTGROUP=4``), and
its unbatched B=1 launch against ``_bounded_impl``.

Bars: exact NN gives identical indices on inputs without near-ties and
equal winner coordinates; bounded NN gives equal coordinates for every point
whose true NN lies within the threshold. Distances agree within 1e-6
relative to the terms of the expansion, ``|s|^2 + |d|^2``: the JAX side forms
``d . s`` as a matmul (another summation order, FMAs on the CPU), and the
cancellation in ``|d|^2 + |s|^2 - 2 d.s`` leaves an fp32 rounding error of a
few ulp of those terms. Against its own plain version the CUDA kernel is held
to 1e-6 absolute (bit-identical arithmetic) on the card, by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scream_tpu.geometry import pairwise as jpw
from scream_tpu.ops import nn_pallas as jnn
from scream_tpu_torch.geometry import pairwise as tpw
from scream_tpu_torch.ops import nn_cuda


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def assert_dist_close(got, want, src, winner_xyz):
    """Distances within 1e-6 relative to |s|^2 + |d|^2 of the winning pair."""
    terms = (np.asarray(src, np.float64) ** 2).sum(-1) \
        + (np.asarray(winner_xyz, np.float64) ** 2).sum(-1)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= 1e-6 * terms).all(), float((err / terms).max())


def _clouds(rng, B, N, M, scale=1.0):
    src = (rng.standard_normal((B, N, 3)) * scale).astype(np.float32)
    dst = (rng.standard_normal((B, M, 3)) * scale).astype(np.float32)
    return src, dst


class TestPairwise:
    def test_square_distance(self, rng):
        src, dst = _clouds(rng, 2, 50, 70)
        want = jpw.square_distance(jnp.asarray(src), jnp.asarray(dst))
        got = tpw.square_distance(t(src), t(dst))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)

    def test_masked_square_distance(self, rng):
        src, dst = _clouds(rng, 2, 30, 40)
        sm, dm = rng.random((2, 30)) > 0.3, rng.random((2, 40)) > 0.3
        want = jpw.masked_square_distance(jnp.asarray(src), jnp.asarray(dst),
                                          jnp.asarray(sm), jnp.asarray(dm))
        got = tpw.masked_square_distance(t(src), t(dst), t(sm), t(dm))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)

    @pytest.mark.parametrize("chunk", [16, 2048])
    def test_nearest_neighbor(self, rng, chunk):
        src, dst = _clouds(rng, 2, 45, 60)
        dm = rng.random((2, 60)) > 0.2
        wd, wi = jpw.nearest_neighbor(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(dm), chunk=chunk)
        gd, gi = tpw.nearest_neighbor(t(src), t(dst), t(dm), chunk=chunk)
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_allclose(gd.numpy(), wd, atol=1e-5)


class TestExactNN:
    @pytest.mark.parametrize("n,m", [(128, 512), (200, 700), (64, 100)])
    def test_matches_pallas_kernel(self, rng, n, m):
        src, dst = _clouds(rng, 2, n, m)
        mask = rng.random((2, m)) > 0.25
        want = jax.vmap(lambda s, d, k: jnn.nearest_neighbor_pallas(
            s, d, k, interpret=True))(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(mask))
        got = nn_cuda.nearest_neighbor_full(t(src), t(dst), t(mask))
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(got[2].numpy(), want[2])
        assert_dist_close(got[0].numpy(), want[0], src, want[2])

    def test_matches_xla_dispatch(self, rng):
        src, dst = _clouds(rng, 3, 90, 130)
        mask = rng.random((3, 130)) > 0.3
        wd, wi, wx = jnn.nearest_neighbor_full(jnp.asarray(src), jnp.asarray(dst),
                                               jnp.asarray(mask), force_xla=True)
        gd, gi, gx = nn_cuda.nearest_neighbor_full(t(src), t(dst), t(mask))
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gx.numpy(), wx)
        assert_dist_close(gd.numpy(), wd, src, wx)

    def test_masked_dst_never_wins(self, rng):
        src = rng.standard_normal((1, 64, 3)).astype(np.float32)
        dst = np.concatenate([src, src * 0.5], axis=1)
        mask = np.arange(128)[None] >= 64  # mask out the identical first half
        d, i, xyz = nn_cuda.nearest_neighbor_full(t(src), t(dst), t(mask))
        assert (i.numpy() >= 64).all()
        np.testing.assert_array_equal(xyz.numpy(), dst[0][i.numpy()[0]][None])

    def test_tie_break_first_index(self):
        d, i = nn_cuda.nn_exact(torch.zeros((1, 8, 3)), torch.zeros((1, 16, 3)))
        assert (i == 0).all() and (d == 0).all()

    def test_distance_expression_order(self, rng):
        """The plain version evaluates (|d|^2 + |s|^2) - 2 (d . s) with the
        products summed x, y, z in order, as the kernel does bit for bit."""
        src, dst = _clouds(rng, 1, 33, 47)
        d, i = nn_cuda.nn_exact(t(src), t(dst))
        s, q = src[0][:, None, :], dst[0][None, :, :]
        cross = (q[..., 0] * s[..., 0] + q[..., 1] * s[..., 1]) + q[..., 2] * s[..., 2]
        dsq = (q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]) + q[..., 2] * q[..., 2]
        ssq = (s[..., 0] * s[..., 0] + s[..., 1] * s[..., 1]) + s[..., 2] * s[..., 2]
        d2 = (dsq + ssq) - np.float32(2.0) * cross
        np.testing.assert_array_equal(i.numpy()[0], d2.argmin(-1))
        np.testing.assert_array_equal(d.numpy()[0], np.maximum(d2.min(-1), 0))


def _sorted_scene(rng, B, N, M):
    """Spatially sorted clouds, as ICP feeds the bounded kernel, so the
    Pallas kernel actually prunes tiles."""
    src = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    dst = (src[:, :M] + rng.standard_normal((B, M, 3)) * 0.02).astype(np.float32) \
        if M <= N else rng.uniform(-1, 1, (B, M, 3)).astype(np.float32)
    src = np.take_along_axis(src, np.argsort(src[..., 0], 1)[..., None], 1)
    dst = np.take_along_axis(dst, np.argsort(dst[..., 0], 1)[..., None], 1)
    return src, dst


class TestBoundedNN:
    @pytest.mark.parametrize("B,N,M", [(2, 1024, 768), (3, 700, 512)])
    def test_contract_vs_pallas_kernel(self, rng, B, N, M):
        src, dst = _sorted_scene(rng, B, N, M)
        mask = rng.random((B, M)) > 0.1
        dead = np.zeros(B, bool)
        dead[-1] = True
        thresh_sq = np.float32(0.01)
        wd, wx = jnn._bounded_batched(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(thresh_sq), jnp.asarray(mask),
                                      jnp.asarray(dead), interpret=True)
        wd, wx = np.asarray(wd), np.asarray(wx)
        gd, gx = nn_cuda.nearest_neighbor_bounded_batched(
            t(src), t(dst), float(thresh_sq), t(mask), dead=t(dead))
        gd, gx = gd.numpy(), gx.numpy()
        # Ground truth: the exact NN over valid dst rows.
        ed, _, ex = nn_cuda.nearest_neighbor_full(t(src), t(dst), t(mask))
        within = (ed.numpy() < thresh_sq) & ~dead[:, None]
        assert within.sum() > 100 and (~within[:-1]).sum() > 10
        np.testing.assert_array_equal(gx[within], wx[within])
        assert_dist_close(gd[within], wd[within], src[within], wx[within])
        np.testing.assert_array_equal(gx[within], ex.numpy()[within])
        # Beyond the threshold both only promise a distance > thresh.
        assert (gd[~within] >= thresh_sq).all() and (wd[~within] >= thresh_sq).all()
        # Dead lanes: the no-hit sentinel on both sides.
        assert (wd[-1] == nn_cuda.NO_HIT).all() and (gd[-1] == nn_cuda.NO_HIT).all()
        assert (gx[-1] == 0).all()

    def test_tile_boxes_match_pallas_wrapper(self, rng):
        """The CUDA wrapper's per-tile boxes (FAR rows left out, empty tiles
        at (+inf, -inf)) equal the JAX wrapper's."""
        _, dst = _clouds(rng, 2, 1, 600)
        mask = rng.random((2, 600)) > 0.3
        mask[1, 256:512] = False  # one all-masked tile
        far = nn_cuda.mask_far(t(dst), t(mask))
        got = nn_cuda.tile_boxes(far).numpy()
        pad = np.pad(far.numpy(), ((0, 0), (0, 768 - 600), (0, 0)),
                     constant_values=jnn.FAR)
        lo, hi = jax.vmap(lambda p: jnn._tile_boxes(p, 256, far_sentinel=jnn.FAR))(
            jnp.asarray(pad))
        np.testing.assert_array_equal(got, np.concatenate([lo, hi], -1))
        assert np.isinf(got[1, 1]).all()

    def test_dead_lane_plain_sentinel(self, rng):
        src, dst = _clouds(rng, 2, 20, 30)
        d, xyz = nn_cuda.nn_bounded(t(src), t(dst), 0.01,
                                    dead=torch.tensor([True, False]))
        assert (d[0] == nn_cuda.NO_HIT).all() and (xyz[0] == 0).all()
        ed, ei = nn_cuda.nn_exact(t(src), t(dst))
        np.testing.assert_array_equal(d[1].numpy(), ed[1].numpy())


def _assert_bounded_contract(gd, gx, wd, wx, src, exact_d, exact_x, thresh_sq, dead):
    """Equal winners and distances (1e-6 of |s|^2 + |d|^2) within the
    threshold, both sides > thresh outside it, dead lanes at the sentinel."""
    within = (exact_d < thresh_sq) & ~dead[:, None]
    assert within.sum() > 50 and (~within & ~dead[:, None]).sum() > 10
    np.testing.assert_array_equal(gx[within], wx[within])
    np.testing.assert_array_equal(gx[within], exact_x[within])
    assert_dist_close(gd[within], wd[within], src[within], wx[within])
    outside = ~within & ~dead[:, None]
    assert (gd[outside] >= thresh_sq).all() and (wd[outside] >= thresh_sq).all()
    assert (gd[dead] == nn_cuda.NO_HIT).all() and (wd[dead] == nn_cuda.NO_HIT).all()
    assert (gx[dead] == 0).all()


class TestBoundedNNSingle:
    """Kernel 6: the unbatched bounded NN (the B=1 launch of the bounded
    kernel) against ``_bounded_impl`` in interpret mode, the TPU's
    ``_nn_bounded_kernel`` with its whole-block (1024 x 256) pruning."""

    @pytest.mark.parametrize("N,M,dead", [(1100, 700, False), (700, 1300, False),
                                          (300, 257, True)])
    def test_contract_vs_pallas_kernel(self, rng, N, M, dead):
        src, dst = _sorted_scene(rng, 1, N, M)
        src, dst = src[0], dst[0]
        mask = rng.random(M) > 0.1
        thresh_sq = np.float32(0.01)
        jd = jnp.asarray(dead) if dead else None
        wd, wx = jnn._bounded_impl(jnp.asarray(src), jnp.asarray(dst),
                                   jnp.asarray(thresh_sq), jnp.asarray(mask), jd,
                                   interpret=True, tile_n=1024, tile_m=256)
        gd, gx = nn_cuda.nearest_neighbor_bounded(
            t(src), t(dst), float(thresh_sq), t(mask),
            dead=torch.tensor(dead) if dead else None)
        assert gd.shape == (N,) and gx.shape == (N, 3)
        ed, _, ex = nn_cuda.nearest_neighbor_full(t(src[None]), t(dst[None]), t(mask[None]))
        lane_dead = np.array([dead])
        if dead:  # every lane at the sentinel; the contract check needs live points
            assert (gd.numpy() == nn_cuda.NO_HIT).all() and (np.asarray(wd) == nn_cuda.NO_HIT).all()
            assert (gx.numpy() == 0).all() and (np.asarray(wx) == 0).all()
            return
        _assert_bounded_contract(gd.numpy()[None], gx.numpy()[None], np.asarray(wd)[None],
                                 np.asarray(wx)[None], src[None], ed.numpy(), ex.numpy(),
                                 thresh_sq, lane_dead)

    def test_single_equals_batched_lane(self, rng):
        """The unbatched wrapper is lane 0 of the batched one, bit for bit."""
        src, dst = _sorted_scene(rng, 1, 600, 500)
        a = nn_cuda.nearest_neighbor_bounded(t(src[0]), t(dst[0]), 0.01)
        b = nn_cuda.nn_bounded(t(src), t(dst), 0.01)
        assert torch.equal(a[0], b[0][0]) and torch.equal(a[1], b[1][0])


class TestBoundedNNTilings:
    """Kernels 7 and 8: the TPU's coarse (``fine=False``) and grouped
    (``SCREAM_NN_DSTGROUP=4``) tilings of the batched bounded NN compute the
    function the port's ``nn_bounded`` computes (one kernel serves all)."""

    @pytest.mark.parametrize("variant", ["coarse", "dstgroup4"])
    def test_contract_vs_pallas_variant(self, rng, monkeypatch, variant):
        B, N, M = 3, 1500, 1300
        src, dst = _sorted_scene(rng, B, N, M)
        mask = rng.random((B, M)) > 0.1
        dead = np.array([False, True, False])
        thresh_sq = np.float32(0.01)
        kw = dict(interpret=True)
        if variant == "coarse":
            kw["fine"] = False
        else:
            monkeypatch.setenv("SCREAM_NN_DSTGROUP", "4")
        wd, wx = jnn._bounded_batched(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(thresh_sq), jnp.asarray(mask),
                                      jnp.asarray(dead), **kw)
        gd, gx = nn_cuda.nearest_neighbor_bounded_batched(
            t(src), t(dst), float(thresh_sq), t(mask), dead=t(dead))
        ed, _, ex = nn_cuda.nearest_neighbor_full(t(src), t(dst), t(mask))
        _assert_bounded_contract(gd.numpy(), gx.numpy(), np.asarray(wd), np.asarray(wx),
                                 src, ed.numpy(), ex.numpy(), thresh_sq, dead)


# ---- The kernel's split-and-merge order (csrc/nn.cu:nn_bounded_kernel) ----

def _sq3(p):
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]) + p[..., 2] * p[..., 2]


def split_ranges(M, splits):
    """The dst tiles ``[t0, t1)`` each split of the kernel scans, in merge
    order: ``tps = ceil(tiles / splits)`` tiles a split."""
    mt = -(-M // nn_cuda.BOUNDED_TILE)
    tps = -(-mt // splits)
    return [(s * tps, min(mt, (s + 1) * tps)) for s in range(splits)]


def emulate_bounded(src, dst, thresh_sq, dead=None, boxes=None):
    """A numpy model of the bounded kernel, in fp32 with the kernel's
    operation order: 128-point sub-slabs, the box test per (sub-slab,
    256-row tile), the dst tiles split over ``bounded_splits`` blocks, each
    split scanning its tiles in ascending order with a strict <, then the
    splits merged in ascending order with a strict <. Returns ``(min_d2,
    xyz, dst index or -1)``."""
    B, N, _ = src.shape
    M = dst.shape[1]
    f32, thresh = np.float32, np.float32(thresh_sq)
    if boxes is None:
        boxes = nn_cuda.tile_boxes(t(dst)).numpy()
    ranges = split_ranges(M, nn_cuda.bounded_splits(B, N, M))
    no_hit = f32(nn_cuda.NO_HIT)
    d2_out = np.full((B, N), no_hit, f32)
    idx_out = np.full((B, N), -1, np.int64)
    dsq = _sq3(dst)
    for b in range(B):
        if dead is not None and dead[b]:
            continue
        for s0 in range(0, N, nn_cuda.BOUNDED_SLAB):
            sl = src[b, s0:s0 + nn_cuda.BOUNDED_SLAB]
            lo, hi, ssq = sl.min(0), sl.max(0), _sq3(sl)
            wb, wi = np.full(len(sl), no_hit, f32), np.full(len(sl), -1, np.int64)
            for t0, t1 in ranges:
                best, bi = np.full(len(sl), no_hit, f32), np.full(len(sl), -1, np.int64)
                for tt in range(t0, t1):
                    bt = boxes[b, tt]
                    g = np.maximum(np.maximum(lo - bt[3:], bt[:3] - hi), f32(0))
                    if not _sq3(g) <= thresh:
                        continue
                    m0 = tt * nn_cuda.BOUNDED_TILE
                    dd = dst[b, m0:m0 + nn_cuda.BOUNDED_TILE]
                    cross = (dd[None, :, 0] * sl[:, None, 0] + dd[None, :, 1] * sl[:, None, 1]) \
                        + dd[None, :, 2] * sl[:, None, 2]
                    d2 = (dsq[b, m0:m0 + len(dd)][None] + ssq[:, None]) - f32(2.0) * cross
                    m, a = d2.min(1), d2.argmin(1)  # the first index attaining the min
                    upd = m < best
                    best[upd], bi[upd] = m[upd], m0 + a[upd]
                upd = best < wb  # merge: ascending split order, strict <
                wb[upd], wi[upd] = best[upd], bi[upd]
            d2_out[b, s0:s0 + len(sl)] = np.maximum(wb, f32(0))
            idx_out[b, s0:s0 + len(sl)] = wi
    xyz = np.where((idx_out >= 0)[..., None],
                   np.take_along_axis(dst, np.maximum(idx_out, 0)[..., None], 1), f32(0))
    return d2_out, xyz.astype(f32), idx_out


def _tie_scene(n_grid):
    """Exact ties with distinct winners: src on a 1/4 grid, dst the same grid
    moved by -1/32 (first half) and +1/32 (second half) in x. Every value is
    a short dyadic fraction, so both candidates' d2 are equal bit for bit;
    the lowest index, the -1/32 copy, must win."""
    k = np.arange(n_grid)
    g = np.stack([(k % 16) / 4, (k // 16 % 16) / 4, (k // 256) / 4], -1).astype(np.float32)
    e = np.array([1 / 32, 0, 0], np.float32)
    return g, np.concatenate([g - e, g + e])


class TestBoundedSplitMerge:
    """The bounded kernel splits the dst tiles over blocks where B x
    sub-slabs would leave the card idle and merges the splits in ascending
    order with a strict <. The numpy model of that order gives the plain
    version's winners bit for bit: exact distances, the same dst index
    (lowest on ties), the same xyz; dead lanes at the sentinel."""

    @pytest.mark.parametrize("case", ["ties_1x512", "dup_1x1000x2300", "dead_3x300x700",
                                      "ties_16x512"])
    def test_emulated_kernel_equals_plain(self, rng, case):
        dead = None
        if case.startswith("ties"):
            g, dst1 = _tie_scene(256)
            B = 16 if case == "ties_16x512" else 1
            src = np.repeat(g[None], 2, 1).repeat(B, 0)  # 512 points, every one tied
            dst = np.repeat(dst1[None], B, 0)
        elif case == "dup_1x1000x2300":
            src, dst = _sorted_scene(rng, 1, 1000, 2300)
            dst[:, 1200:2300] = dst[:, :1100]  # duplicated dst points, later splits
        else:
            src, dst = _sorted_scene(rng, 3, 300, 700)
            dst[:, 400:] = dst[:, 100:400]
            dead = np.array([False, True, False])
        B, N, M = src.shape[0], src.shape[1], dst.shape[1]
        splits = nn_cuda.bounded_splits(B, N, M)
        thresh_sq = float(np.float32(0.1) ** 2)
        d2, xyz, idx = emulate_bounded(src, dst, thresh_sq, dead)
        pd, px = nn_cuda.nn_bounded_plain(t(src), t(dst), thresh_sq,
                                          None if dead is None else t(dead))
        _, pi = nn_cuda._exact_plain(t(src), t(dst))
        pd, px, pi = pd.numpy(), px.numpy(), pi.numpy()
        live = np.ones((B, N), bool) if dead is None else ~dead[:, None].repeat(N, 1)
        within = (pd < thresh_sq) & live
        assert within.sum() > 100
        np.testing.assert_array_equal(d2[within], pd[within])
        np.testing.assert_array_equal(idx[within], pi[within])
        np.testing.assert_array_equal(xyz[within], px[within])
        assert (d2[live & ~within] >= thresh_sq).all()
        if dead is not None:
            assert (d2[~live] == nn_cuda.NO_HIT).all() and (xyz[~live] == 0).all()
            assert (pd[~live] == nn_cuda.NO_HIT).all()
        if case.startswith("ties"):
            assert splits == 2  # 4 and 64 sub-slabs: the tiles split in two
            assert (idx < M // 2).all()  # the -1/32 copy, the lower index
            np.testing.assert_array_equal(xyz, np.repeat(dst[:, :M // 2], 2, 1))
        else:
            assert splits > 1

    def test_splits_from_shape(self):
        """The split count depends on the shape alone: 1 at 16 x 4,096, 2 at
        1 x 512, 4 at 1 x 4,096, never above 8 or one tile a split; the
        split ranges cover every tile once, in ascending order."""
        assert nn_cuda.bounded_splits(16, 4096, 4096) == 1
        assert nn_cuda.bounded_splits(1, 512, 512) == 2
        assert nn_cuda.bounded_splits(1, 4096, 4096) == 4
        assert nn_cuda.bounded_splits(1, 4096, 40960) == 4
        assert nn_cuda.bounded_splits(1, 100, 100) == 1
        for B, N, M in [(1, 1000, 2300), (1, 128, 65536), (7, 448, 512), (3, 300, 700)]:
            s = nn_cuda.bounded_splits(B, N, M)
            mt = -(-M // nn_cuda.BOUNDED_TILE)
            assert 1 <= s <= nn_cuda.BOUNDED_MAX_SPLITS and s <= mt
            tiles = [tt for t0, t1 in split_ranges(M, s) for tt in range(t0, t1)]
            assert tiles == list(range(mt))

    def test_wrappers_take_given_boxes_on_the_cpu(self, rng):
        """``boxes=`` changes nothing on the CPU path (the plain version is
        the exact NN) and the dead flags stay bool."""
        src, dst = _sorted_scene(rng, 2, 300, 400)
        boxes = nn_cuda.nn_tile_boxes(t(dst))
        np.testing.assert_array_equal(boxes.numpy(), nn_cuda.tile_boxes(t(dst)).numpy())
        dead = torch.tensor([False, True])
        a = nn_cuda.nn_bounded(t(src), t(dst), 0.01, dead, boxes=boxes)
        b = nn_cuda.nn_bounded(t(src), t(dst), 0.01, dead)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        c = nn_cuda.nn_bounded_single(t(src[:1]), t(dst[:1]), 0.01, boxes=boxes[:1])
        assert torch.equal(c[0][0], a[0][0])


def _icp_pairs(B, N, M, seed):
    """Synthetic pairs (padded, masked) and inits 0.05 rad / 0.05 off GT."""
    from scream_tpu.data.synthetic import make_pair
    from scream_tpu_torch.data.transforms import rodrigues

    rng = np.random.default_rng(seed)
    src, tgt = np.zeros((B, N, 3), np.float32), np.zeros((B, M, 3), np.float32)
    init = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        p = make_pair(rng, N - 20, M - 10, overlap=0.8, noise=0.003)
        src[b, :N - 20], tgt[b, :M - 10] = p["src"], p["tgt"]
        axis = rng.standard_normal(3)
        init[b, :3, :3] = rodrigues(axis / np.linalg.norm(axis) * 0.05) @ p["rot"]
        init[b, :3, 3] = p["trans"][:, 0] + 0.05
    sm = np.arange(N)[None].repeat(B, 0) < N - 20
    tm = np.arange(M)[None].repeat(B, 0) < M - 10
    return src, tgt, sm, tm, init


class TestICPBoxesOncePerCall:
    """ICP makes the dst tile boxes once per call and hands them to every
    step's NN. With the NN replaced by the kernel's numpy model, the result
    is the same with those boxes as with boxes made by each call, and stays
    within the JAX package's ICP bars (the geometry tests' 2e-2)."""

    @staticmethod
    def _patch(monkeypatch, seen, per_call):
        from scream_tpu_torch.geometry import icp as ticp

        def nn(src_t, dst, thresh_sq, dead=None, boxes=None):
            seen.append((boxes, dst))
            d2, xyz, _ = emulate_bounded(
                src_t.numpy(), dst.numpy(), thresh_sq,
                None if dead is None else dead.numpy(),
                None if boxes is None else boxes.numpy())
            return t(d2), t(xyz)

        make = ticp._make_icp_fns
        monkeypatch.setattr(ticp, "_make_icp_fns",
                            lambda *a, nn=None, **k: make(*a, nn=nn_model, **k))
        nn_model = nn
        if per_call:
            monkeypatch.setattr(ticp, "nn_tile_boxes", lambda dst: None)
        return ticp

    @pytest.mark.parametrize("batched", [False, True])
    def test_same_result_with_boxes_made_once(self, monkeypatch, batched):
        from scream_tpu.geometry import icp as jicp

        src, tgt, sm, tm, init = _icp_pairs(B=2, N=300, M=400, seed=11)
        results = []
        for per_call in (False, True):
            seen = []
            with monkeypatch.context() as mp:
                ticp = self._patch(mp, seen, per_call)
                if batched:
                    r = ticp.registration_icp_batched(t(src), t(tgt), 0.1, init=t(init),
                                                      max_iteration=8, src_mask=t(sm),
                                                      tgt_mask=t(tm))
                else:
                    r = ticp.registration_icp(t(src[0]), t(tgt[0]), 0.1, init=t(init[0]),
                                              max_iteration=8, src_mask=t(sm[0]),
                                              tgt_mask=t(tm[0]))
            assert len(seen) >= 2
            if per_call:
                assert all(b is None for b, _ in seen)
            else:  # one boxes tensor for the whole call: dst's own boxes
                assert all(b is seen[0][0] for b, _ in seen)
                np.testing.assert_array_equal(seen[0][0].numpy(),
                                              nn_cuda.tile_boxes(seen[0][1]).numpy())
            results.append(r)
        assert all(torch.equal(x, y) for x, y in zip(*results))
        got = results[0]
        if batched:
            want = jicp.registration_icp_batched(
                jnp.asarray(src), jnp.asarray(tgt), 0.1, init=jnp.asarray(init),
                max_iteration=8, src_mask=jnp.asarray(sm), tgt_mask=jnp.asarray(tm),
                force_xla=True)
        else:
            want = jicp.registration_icp(
                jnp.asarray(src[0]), jnp.asarray(tgt[0]), 0.1, init=jnp.asarray(init[0]),
                max_iteration=8, src_mask=jnp.asarray(sm[0]), tgt_mask=jnp.asarray(tm[0]))
        np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                                   atol=2e-2, rtol=0)
        assert (np.abs(got.iterations.numpy() - np.asarray(want.iterations)) <= 1).all()
        np.testing.assert_allclose(got.fitness.numpy(), np.asarray(want.fitness), atol=2e-2)
        np.testing.assert_allclose(got.inlier_rmse.numpy(), np.asarray(want.inlier_rmse),
                                   atol=2e-2)
