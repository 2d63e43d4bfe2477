"""Models of the splat and exact-NN kernels' evaluation orders
(``csrc/splat.cu``, ``csrc/nn.cu:nn_exact_kernel``) on the CPU.

* Splat: a torch model of the kernel's algorithm, in fp32 with the
  kernel's operations: 16 x 16 pixel tiles of eight 8 x 4 warps, points in
  chunks of 512 tested against the tile box and the tile's smallest
  log-domain threshold, the kept (point, channel)s compacted in ascending
  index, each warp's test of 32 entries at a time against its box and its
  own smallest threshold, the survivors two at a time through the
  per-pixel test before ``exp``, the seed (thresholds at -inf until a pixel has a best), and a tile's points
  split in runs whose bests are shared between chunks. It skips only pairs the
  kernel's proof (``csrc/splat.cu``'s header, P1-P6; each step checked
  at its edge by ``TestCullMargins``) shows cannot change a pixel's (max,
  argmax), so it is held
  bit for bit to ``max_splat_plain`` (values and argmax), on the renderer's
  real inputs at 2 x 1,024 x 32^2 and on adversarial scenes (duplicated
  points, exact ties, v = 0 and v < 0, all-zero pixels, points just inside
  and just outside the skip thresholds, subnormal winners, very large and
  very small v), and to ``splat_pallas.max_splat`` in interpret mode at
  ``test_torch_port_render.py``'s bars (images 5e-5 absolute; argmax equal
  where the max is a normal fp32 number, since XLA:CPU flushes subnormals).
  The skip rule for pixels whose best is below 2^-100 rests on ``exp(x) ==
  0`` for x <= ``EXP_ZERO``: checked here for the CPU's ``exp`` (which the
  model uses) and by ``chip_smoke.py`` for the kernel's ``expf`` over every
  fp32 input.
* Exact NN: a numpy model of the kernel's order (dst split over
  ``exact_splits`` blocks, each split scanning its rows in ascending order
  with a strict <, the splits merged in ascending order with a strict <),
  held bit for bit to ``nn_exact_plain`` and to ``nearest_neighbor_pallas``
  in interpret mode at ``TestExactNN``'s bars (equal indices and winners,
  distances within 1e-6 of |s|^2 + |d|^2), on tie and duplicate scenes.
* The d^2 identity both kernels use: ``fmaf(-2, c, s)`` (one rounding of the
  exact ``s - 2c``) equals the plain ``s - 2c`` with ``2c`` rounded first,
  on random and adversarial fp32 values (an exact rational fma here).
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scream_tpu.ops import nn_pallas as jnn
from scream_tpu.ops import splat_pallas
from scream_tpu_torch.ops import nn_cuda, render, splat_cuda

F32 = torch.float32
INF = float("inf")
# csrc/splat.cu's constants.
TILE, CHUNK = splat_cuda.SPLAT_TILE, 512
D2_REL, LOG_MARGIN = 2.0 ** -20, 2.0 ** -12
BEST_NORMAL, V_MAX, V_LOG, LNV_MIN, L_ZERO = 2.0 ** -100, 2.0 ** 20, 2.0 ** -24, -16.0, -120.625
LOG_ERR = 2.0 ** -20


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


# ---- The splat kernel's algorithm ----

def _full(like, v):
    return torch.full_like(like, v)


def _threshold(b):
    """The log-domain threshold L of pixels whose best is ``b``."""
    lg = torch.log(torch.where(b > 0, b, torch.ones_like(b))) - LOG_MARGIN
    return torch.where(b >= BEST_NORMAL, lg,
                       torch.where(b >= 0, _full(b, L_ZERO), _full(b, -INF)))


def _strict_threshold(b):
    """The threshold from another split's best: only where it is strict."""
    lg = torch.log(torch.where(b > 0, b, torch.ones_like(b))) - LOG_MARGIN
    return torch.where(b >= BEST_NORMAL, lg, _full(b, -INF))


def _log_value(v):
    """ln v rounded up (the kernel rounds __logf up by its error bound)."""
    lg = torch.log(torch.where(v > 0, v, torch.ones_like(v)))
    lg = torch.clamp_min(lg + LOG_ERR + LOG_ERR * lg.abs(), LNV_MIN)
    return torch.where(~(v > 0), _full(v, -INF),
                       torch.where(v > V_MAX, _full(v, INF),
                                   torch.where(v < V_LOG, _full(v, LNV_MIN), lg)))


def _pixel_coord(k, half):
    return ((k.to(F32) - half) + 0.5) / half


def _box(c0, c1, r0, r1, half):
    k = torch.tensor([c0, c1, r0, r1])
    x0, x1, y0, y1 = _pixel_coord(k, half)
    mx, my = torch.maximum(x0.abs(), x1.abs()), torch.maximum(y0.abs(), y1.abs())
    return x0, x1, y0, y1, mx * mx + my * my


def _box_d2lo(q, psq, box):
    """The kernel's lower bound of the rounded d2 of points ``q`` (k, 2)
    over a box of pixel centres."""
    x0, x1, y0, y1, sq_max = box
    gx = torch.clamp_min(torch.maximum(x0 - q[:, 0], q[:, 0] - x1), 0.0)
    gy = torch.clamp_min(torch.maximum(y0 - q[:, 1], q[:, 1] - y1), 0.0)
    g2 = gx * gx + gy * gy
    return torch.clamp_min(g2 * (1.0 - D2_REL) - (psq + sq_max) * D2_REL, 0.0)


def _box_t(q, psq, lnv, box, neg):
    """fl(fl(d2lo * neg) + ln v) of points ``q`` (k, 2) against a box."""
    return _box_d2lo(q, psq, box) * neg + lnv


class _Split:
    """One split's pixels of one tile: (best, argmax, L) per channel and
    thread."""

    def __init__(self, lo, hi):
        self.lo, self.hi = lo, hi
        n = TILE * TILE
        self.best = torch.full((2, n), -INF, dtype=F32)
        self.lim = torch.full((2, n), -INF, dtype=F32)
        self.win = torch.zeros((2, n), dtype=torch.int64)


def splat_model(xy, vals, rho, width, splits=None, chunk=CHUNK):
    """The splat kernel's evaluation order on CPU tensors: ``(img (I, 2, P),
    arg (I, 2, P) int32, counts)``, counts as ``splat_cull_counts`` names
    them, and ``shared``: the (pixel, channel)s whose threshold another
    split's best raised. ``splits`` (default ``splat_splits(N)``) point
    splits per tile run in lockstep, one chunk a round, reading each other's
    bests at the start of a round (one of the schedules the kernel's may
    take); ``chunk`` other than the kernel's 512 makes more rounds."""
    I, N = xy.shape[0], xy.shape[1]
    P = width * width
    half = float(width // 2)
    neg = splat_cuda._neg_half_rho_sq(rho)
    S = splat_cuda.splat_splits(N) if splits is None else splits
    nps = -(-N // S)
    img = torch.zeros((I, 2, P), dtype=F32)
    arg = torch.zeros((I, 2, P), dtype=torch.int32)
    tiles = -(-width // TILE)
    thread = torch.arange(TILE * TILE)
    warp, lane = thread // 32, thread % 32
    counts = dict(tile_kept=0, staged=0, warp_kept=0, warp_staged=0, exp_pairs=0, pairs=0,
                  shared=0)
    for im in range(I):
        pts = dict(q=xy[im], v=vals[im])
        pts["psq"] = pts["q"][:, 0] * pts["q"][:, 0] + pts["q"][:, 1] * pts["q"][:, 1]
        pts["lnv"] = _log_value(pts["v"])
        for ty in range(tiles):
            for tx in range(tiles):
                wc = tx * TILE + (warp & 1) * 8
                wr = ty * TILE + (warp >> 1) * 4
                col, row = wc + (lane & 7), wr + (lane >> 3)
                pix = dict(x=_pixel_coord(col, half), y=_pixel_coord(row, half))
                pix["sq"] = pix["x"] * pix["x"] + pix["y"] * pix["y"]
                tbox = _box(tx * TILE, tx * TILE + TILE - 1, ty * TILE,
                            ty * TILE + TILE - 1, half)
                wboxes = [_box(int(wc[32 * k]), int(wc[32 * k]) + 7, int(wr[32 * k]),
                               int(wr[32 * k]) + 3, half) for k in range(8)]
                sp = [_Split(s * nps, min(N, (s + 1) * nps)) for s in range(S)]
                for n0 in range(0, nps, chunk):
                    pub = [x.best.clone() for x in sp]
                    for s, x in enumerate(sp):
                        if S > 1:
                            others = torch.stack([pub[r] for r in range(S) if r != s]).amax(0)
                            lim = torch.maximum(x.lim, _strict_threshold(others))
                            counts["shared"] += int((lim > x.lim).sum())
                            x.lim = lim
                        lo = x.lo + n0
                        if lo < x.hi:
                            _chunk(x, torch.arange(lo, min(x.hi, lo + chunk)), pts, pix, tbox,
                                   wboxes, neg, counts)
                best, win = sp[0].best.clone(), sp[0].win.clone()
                for x in sp[1:]:  # ascending split order, strict >
                    upd = x.best > best
                    best, win = torch.where(upd, x.best, best), torch.where(upd, x.win, win)
                valid = (col < width) & (row < width)
                p = (row * width + col)[valid]
                img[im, :, p] = best[:, valid]
                arg[im, :, p] = win[:, valid].to(torch.int32)
                counts["staged"] += 2 * N
                counts["warp_staged"] += 2 * N * 8
                counts["pairs"] += 2 * N * TILE * TILE
    return img, arg, counts


def _chunk(x, idx, pts, pix, tbox, wboxes, neg, counts):
    """One chunk of one split: the tile test, the ascending list, and each
    warp's walk of it."""
    for c in (0, 1):
        kept = ~(_box_t(pts["q"][idx], pts["psq"][idx], pts["lnv"][idx, c], tbox, neg)
                 < x.lim[c].min())
        lst = idx[kept]  # ascending
        counts["tile_kept"] += len(lst)
        for k in range(8):
            lanes = slice(32 * k, 32 * k + 32)
            for g in range(0, len(lst), 32):
                grp = lst[g:g + 32]
                keep_w = ~(_box_t(pts["q"][grp], pts["psq"][grp], pts["lnv"][grp, c], wboxes[k],
                                  neg) < x.lim[c, lanes].min())
                surv = grp[keep_w].tolist()
                counts["warp_kept"] += len(surv)
                for i in range(0, len(surv), 2):
                    _pairs(x, c, lanes, surv[i:i + 2], pts, pix, neg, counts)


def _pairs(x, c, lanes, js, pts, pix, neg, counts):
    """Up to two entries against one warp's 32 pixels in channel ``c``, as
    the kernel takes them: both through the per-pixel test on the
    thresholds of the step's start, their contributions (the plain
    version's) compared in order, L raised once after both."""
    px, py, xsq = pix["x"][lanes], pix["y"][lanes], pix["sq"][lanes]
    best, win = x.best[c, lanes], x.win[c, lanes]
    lim = x.lim[c, lanes]
    up_any = torch.zeros(32, dtype=torch.bool)
    gos, exs = [], []
    for j in js:
        qx, qy = pts["q"][j, 0], pts["q"][j, 1]
        cross = qx * px + qy * py
        e = torch.clamp_min((pts["psq"][j] + xsq) - 2.0 * cross, 0.0) * neg
        gos.append(~(e + pts["lnv"][j, c] < lim))
        exs.append(e)
    for j, go, e in zip(js, gos, exs):
        counts["exp_pairs"] += int(go.sum())
        contrib = pts["v"][j, c] * torch.exp(e)
        up = go & (contrib > best)
        best = torch.where(up, contrib, best)
        win = torch.where(up, torch.full_like(win, j), win)
        up_any |= up
    x.best[c, lanes], x.win[c, lanes] = best, win
    x.lim[c, lanes] = torch.where(up_any, torch.maximum(lim, _threshold(best)), lim)


def renderer_inputs(n_points=512, images=2, rho_mode="back", seed=0):
    """The renderer's real inputs: ``images`` pairs of ``n_points`` src and
    tgt points (a bumpy surface and its rigid copy, some rows masked) through
    ``render.splat_inputs``: ``(I, 2 n_points, 2)``."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.5, 0.5, (images, n_points, 2))
    z = 0.15 * np.sin(3 * u[..., :1]) * np.cos(2 * u[..., 1:])
    src = np.concatenate([u, z], -1).astype(np.float32)
    a = 0.2
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                   np.float32)
    tgt = (src @ rot.T + 0.03).astype(np.float32)
    sm = rng.random((images, n_points)) > 0.05
    tm = rng.random((images, n_points)) > 0.05
    views = render.view_matrices(view_mode=rho_mode)
    xy, vals = render.splat_inputs(t(src), t(tgt), t(sm), t(tm), views)
    return xy.contiguous(), vals.contiguous()


def adversarial_scene(kind, w=32, seed=0):
    """``(xy, vals)`` of one adversarial scene (see the module docstring)."""
    rng = np.random.default_rng(seed)
    half = w // 2
    pix = (np.stack(np.meshgrid(np.arange(w), np.arange(w)), -1).reshape(-1, 2)
           - half + 0.5) / half
    if kind == "duplicates":
        xy = rng.uniform(-0.7, 0.7, (2, 700, 2))
        vals = rng.uniform(0, 1, (2, 700, 2)) * (rng.random((2, 700, 1)) > 0.5)
        xy[:, 350:], vals[:, 350:] = xy[:, :350], vals[:, :350]  # later copies
        xy[:, 100:120], vals[:, 100:120] = xy[:, 600:620], vals[:, 600:620]
    elif kind == "ties":
        # Dyadic points at +-1/64 around dyadic pixel centres: the expanded
        # d2 is exact, so equal distances tie bit for bit; the four points
        # around a centre share their values.
        base = pix[rng.choice(len(pix), 150, replace=False)]
        offs = np.array([[1, 0], [-1, 0], [0, 1], [0, -1]]) / 64.0
        xy = (base[:, None] + offs[None]).reshape(-1, 2)
        v = np.repeat(rng.choice([0.25, 0.5, 1.0], 150), 4)
        order = rng.permutation(len(xy))
        xy, v = xy[order][None], v[order]
        vals = np.stack([v, v[::-1]], -1)[None]
    elif kind == "signs":
        # v = 0, v = -0.0 and v < 0 beside positive values; the second image
        # has a channel with only negative values.
        xy = rng.uniform(-1.2, 1.2, (2, 600, 2))
        vals = rng.choice([0.0, -0.0, -0.5, 0.3, 1.0, -2.0], (2, 600, 2))
        xy[1] = rng.uniform(-0.15, 0.15, (600, 2))  # no weight underflows near it
        vals[1, :, 1] = -rng.uniform(0.1, 1.0, 600)
        vals[0, 0] = -1.0  # point 0 negative in both channels
    elif kind == "zero_pixels":
        # Points in one corner: most pixels see only underflowed weights
        # and are won by point 0 at 0.
        xy = rng.uniform(0.55, 0.95, (2, 600, 2))
        vals = rng.uniform(0.05, 1.0, (2, 600, 2))
    elif kind == "radius":
        # Around 40 pixel centres in one corner: a bright point on the centre
        # (best 1), points with v = 1.0001 at distances around the crossing
        # of 1 (sqrt(ln 1.0001 / 288)), points with v = 1 around the skip
        # margin, a duplicate of the bright point (a tie). Around the
        # opposite corner pixel, whose best is 0 until they come: points
        # just inside and just outside exp's underflow (e = -103 ... -105),
        # whose subnormal contributions must win.
        corner = pix[(pix[:, 0] > 0.3) & (pix[:, 1] > 0.3)]
        centres = corner[rng.choice(len(corner), 40, replace=False)]
        r = np.concatenate([np.zeros((40, 1)),
                            np.sqrt(np.log(1.0001) / 288.0)
                            * np.array([[0.97, 0.99, 1.0, 1.01, 1.03]]).repeat(40, 0),
                            np.sqrt(2.0 ** -12 / 288.0) * np.array([[0.9, 1.1]]).repeat(40, 0),
                            np.zeros((40, 1))], 1)
        ang = rng.uniform(0, 2 * np.pi, r.shape)
        pts = centres[:, None] + r[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1)
        v = np.concatenate([np.ones((40, 1)), np.full((40, 5), 1.0001), np.ones((40, 3))], 1)
        low = np.sqrt(np.array([103.0, 103.9, 104.5, 105.0]) / 288.0)
        ang = rng.uniform(np.pi, 1.5 * np.pi, 4)
        ring = pix[0] + low[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
        far = np.array([[-3.0, -3.0]])  # point 0: far from everything
        xy = np.concatenate([far, pts.reshape(-1, 2), ring])[None]
        v0 = np.concatenate([[1.0], v.reshape(-1), np.ones(4)])
        vals = np.stack([v0, v0], -1)[None]
    elif kind == "band":
        # Values in [1.13e-7, 1.19e-7]: above e^-16, below 2^-23, where a
        # ln v taken as -16 would lie below the true one. 40 points around
        # each of 9 centres 0.6 apart, at distances where e spreads over a
        # few units, in random order: many pixels see a later point beat
        # the running best by a few hundredths in the log domain.
        c = np.array([-0.6, 0.0, 0.6])
        centres = np.stack(np.meshgrid(c, c), -1).reshape(-1, 2)
        r = rng.uniform(0.12, 0.2, (9, 40))
        ang = rng.uniform(0, 2 * np.pi, (9, 40))
        pts = centres[:, None] + r[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1)
        xy = rng.permutation(pts.reshape(-1, 2))[None]
        vals = rng.uniform(1.13e-7, 1.19e-7, (1, 360, 2))
    elif kind == "magnitudes":
        # Very large (> 2^20) and very small (< e^-16) values.
        xy = rng.uniform(-1, 1, (1, 800, 2))
        vals = rng.choice([1e-30, 1e-8, 3e6, 5e20, 0.5], (1, 800, 2)) \
            * rng.uniform(0.5, 1.0, (1, 800, 2))
    else:
        raise ValueError(kind)
    return t(xy.astype(np.float32)), t(vals.astype(np.float32))


def assert_bit_equal(got_img, got_arg, want_img, want_arg):
    assert torch.equal(got_img, want_img), float((got_img - want_img).abs().max())
    assert torch.equal(got_arg, want_arg), int((got_arg != want_arg).sum())


@pytest.fixture(scope="module")
def real_inputs():
    """The renderer's inputs at 2 x 1,024 x 32^2 (rho 24 and 48), with the
    plain version's and the model's results, the points in one split (as
    the kernel takes 1,024 points) and in four (as it takes 8,192)."""
    out = {}
    xy, vals = renderer_inputs()
    for rho, splits in ((24.0, 1), (24.0, 4), (48.0, 1), (48.0, 4)):
        want = splat_cuda.max_splat_plain(xy, vals, rho, 32)
        out[rho, splits] = (xy, vals, want, splat_model(xy, vals, rho, 32, splits))
    return out


class TestSplatModel:
    @pytest.mark.parametrize("rho,splits", [(24.0, 1), (24.0, 4), (48.0, 1), (48.0, 4)])
    def test_real_inputs_bit_for_bit(self, real_inputs, rho, splits):
        xy, vals, (img_p, arg_p), (img, arg, counts) = real_inputs[rho, splits]
        assert xy.shape == (2, 1024, 2)
        assert splat_cuda.splat_splits(1024) == 1
        assert_bit_equal(img, arg, img_p, arg_p)
        # The cull does work on these inputs: most (pair, channel)s never
        # reach exp, and the tile test drops a share of the points.
        assert counts["exp_pairs"] < 0.1 * counts["pairs"], counts
        assert counts["exp_pairs"] <= 32 * counts["warp_kept"]
        if splits == 1:  # four splits of 256 points are all seed
            assert counts["tile_kept"] < counts["staged"], counts
        assert (img_p == 0).any()  # some all-zero pixels, won by point 0
        assert (arg_p[img_p == 0] == 0).all()

    @pytest.mark.parametrize("kind", ["duplicates", "ties", "signs", "zero_pixels",
                                      "radius", "band", "magnitudes"])
    def test_adversarial_bit_for_bit(self, kind):
        xy, vals = adversarial_scene(kind)
        for rho, splits in ((24.0, 1), (48.0, 3)):
            img_p, arg_p = splat_cuda.max_splat_plain(xy, vals, rho, 32)
            img, arg, _ = splat_model(xy, vals, rho, 32, splits)
            assert_bit_equal(img, arg, img_p, arg_p)
            if kind == "ties" and rho == 24.0:
                # Exact ties reached: a pixel whose max two points attain.
                _, dense = _dense(xy, vals, rho, 32)
                tied = (dense == img_p[:, :, None, :]).sum(2) > 1
                assert (tied & (img_p > 0)).any()
            if kind == "radius" and rho == 24.0:
                sub = (img_p > 0) & (img_p < np.finfo(np.float32).tiny)
                assert sub.any()  # subnormal winners over an all-zero best
            if kind == "signs":
                # A channel of negative values only: bests < 0 near the
                # points, -0.0 where some weight underflows.
                assert (img_p[1, 1] <= 0).all() and (img_p[1, 1] < 0).any()

    def test_odd_width_and_ragged_points(self):
        """Tiles that overhang the image (width 24), N not a multiple of the
        512-point chunk, splits of unequal length."""
        xy, vals = renderer_inputs(n_points=300, images=1)
        img_p, arg_p = splat_cuda.max_splat_plain(xy, vals, 24.0, 24)
        for splits in (1, 7):
            img, arg, _ = splat_model(xy, vals, 24.0, 24, splits)
            assert_bit_equal(img, arg, img_p, arg_p)

    @pytest.mark.parametrize("splits", [2, 3])
    def test_splits_share_their_bests(self, real_inputs, splits):
        """Splits that read each other's bests between chunks (chunks of 128
        here, so that there are several) skip strictly below them and still
        give the plain version's bits."""
        xy, vals, (img_p, arg_p), _ = real_inputs[24.0, 1]
        img, arg, counts = splat_model(xy[:1], vals[:1], 24.0, 32, splits, chunk=128)
        assert_bit_equal(img, arg, img_p[:1], arg_p[:1])
        assert counts["shared"] > 1000

    def test_splits_from_shape(self):
        """The point splits of a tile depend on N alone: 1 below 4,096, 4 at
        path 3's 8,192, 8 at KITTI's 16,384, never above 8."""
        assert [splat_cuda.splat_splits(n) for n in (600, 4095, 4096, 8192, 16384, 10 ** 6)] \
            == [1, 1, 2, 4, 8, 8]

    @pytest.mark.parametrize("scene", ["real", "duplicates", "ties"])
    def test_matches_pallas_interpret(self, real_inputs, scene):
        """At rho 24 and points near the centre, where the render test's bars
        were set (JAX forms d2 with a dot product, whose rounding the weight
        amplifies by rho^2 / 2). Not held to JAX, only bit for bit to the
        plain version: the scenes whose points reach |xy|^2 + |pix|^2 ~ 4
        ("signs", "zero_pixels": the two expressions then differ by up to
        1.4e-4), the "radius" scene's near-ties (contributions within 3e-6
        relative) and the "magnitudes" scene (values up to 5e20)."""
        rho = 24.0
        if scene == "real":
            xy, vals, _, (img, arg, _) = real_inputs[rho, 1]
        else:
            xy, vals = adversarial_scene(scene)
            img, arg, _ = splat_model(xy, vals, rho, 32)
        fwd = jax.vmap(lambda a, b: splat_pallas._splat_forward(a, b, rho, 32, True))
        want_img, want_arg = fwd(jnp.asarray(xy.numpy()), jnp.asarray(vals.numpy()))
        want_img, want_arg = np.asarray(want_img), np.asarray(want_arg)
        np.testing.assert_allclose(img.numpy(), want_img, atol=5e-5, rtol=0)
        normal = np.abs(want_img) >= np.finfo(np.float32).tiny
        np.testing.assert_array_equal(arg.numpy()[normal], want_arg[normal])

    def test_cpu_exp_is_zero_below_the_cut(self):
        """The model's skip rule for pixels whose best is below 2^-100 rests
        on exp(x) == 0 for x <= EXP_ZERO: every fp32 in [-128, EXP_ZERO],
        and a sample below."""
        lo = np.float32(splat_cuda.EXP_ZERO).view(np.uint32)
        bits = np.arange(lo, np.float32(-128.0).view(np.uint32) + 1, dtype=np.uint32)
        x = torch.from_numpy(bits.view(np.float32))
        assert float(x.max()) == splat_cuda.EXP_ZERO
        assert (torch.exp(x) == 0).all()
        far = -torch.logspace(2.11, 38, 4000, dtype=F32)
        assert (torch.exp(far) == 0).all() and torch.exp(torch.tensor(-INF)) == 0
        assert splat_cuda.EXP_ZERO >= L_ZERO - LNV_MIN


def _dense(xy, vals, rho, width):
    """Every (point, pixel) contribution, the plain version's expression:
    ``(max (I, 2, P), contributions (I, 2, N, P))``."""
    pix = splat_cuda.pixel_grid(width)
    x_sq = pix[:, 0] * pix[:, 0] + pix[:, 1] * pix[:, 1]
    p_sq = xy[..., 0] * xy[..., 0] + xy[..., 1] * xy[..., 1]
    cross = xy[..., 0:1] * pix[:, 0] + xy[..., 1:2] * pix[:, 1]
    d2 = torch.clamp_min((p_sq[..., None] + x_sq) - 2.0 * cross, 0.0)
    wgt = torch.exp(d2 * splat_cuda._neg_half_rho_sq(rho))
    contrib = torch.stack([vals[..., c:c + 1] * wgt for c in (0, 1)], 1)
    return contrib.amax(2), contrib


# ---- The margins of the splat's skip rules ----
#
# Each test checks one step of the proof in csrc/splat.cu's header (P1-P3,
# P5, P6; P4, the ascending scan, is what the bit-for-bit tests above hold)
# on fp32 values near its edge, with the errors the CUDA math API states taken at
# their worst: __logf off by 2^-21.41 absolute on [0.5, 2] and 3 ulp
# elsewhere, logf by 1 ulp, expf by 2 ulp.

F64 = np.float64


def _f32_down(x):
    """The largest fp32 <= each float64 in ``x``."""
    f = np.asarray(x, F64).astype(np.float32)
    return np.where(f.astype(F64) > x, np.nextafter(f, np.float32(-np.inf)), f)


def _f32_up(x):
    """The smallest fp32 >= each float64 in ``x``."""
    f = np.asarray(x, F64).astype(np.float32)
    return np.where(f.astype(F64) < x, np.nextafter(f, np.float32(np.inf)), f)


def _ulp32(x):
    return np.spacing(np.abs(np.asarray(x, np.float32))).astype(F64)


def _kernel_log_value(v):
    """log_value(v) of csrc/splat.cu with the lowest __logf the CUDA math
    API allows: fp32, per element of the fp32 array ``v``."""
    v = np.asarray(v, np.float32)
    ln = np.log(np.where(v > 0, v, 1).astype(F64))
    err = np.where((v >= 0.5) & (v <= 2), 2.0 ** -21.41, 3 * _ulp32(ln))
    l = _f32_down(ln - err)
    out = (l + np.float32(LOG_ERR)) + np.float32(LOG_ERR) * np.abs(l)  # fp32 ops
    out = np.maximum(out, np.float32(LNV_MIN))
    out = np.where(v < np.float32(V_LOG), np.float32(LNV_MIN), out)
    out = np.where(v > np.float32(V_MAX), np.float32(np.inf), out)
    return np.where(~(v > 0), np.float32(-np.inf), out).astype(np.float32)


def _sweep_values(rng, n):
    """Positive fp32 values: log-uniform over the whole range, dense in
    [e^-16, 2^-23] and [2^-25, 2^-23], and every fp32 next to the cut-offs."""
    edges = np.float32([V_LOG, V_MAX, np.exp(-16.0), 2.0 ** -23, 0.5, 2.0, 1.0])
    near = np.concatenate([np.nextafter(edges, np.float32(0)), edges,
                           np.nextafter(edges, np.float32(np.inf))])
    return np.concatenate([
        np.exp(rng.uniform(np.log(1e-45), np.log(3e38), n)),
        rng.uniform(np.exp(-16.0), 2.0 ** -23, n // 4),
        rng.uniform(2.0 ** -25, 2.0 ** -23, n // 4), near]).astype(np.float32)


def _last_skipped_exponent(lnv, lim):
    """The largest fp32 e <= 0 with fl(e + lnv) < lim, or nan where no e
    is skipped (a finite lnv, lim per element)."""
    e = np.minimum(_f32_down(lim.astype(F64) - lnv.astype(F64)), np.float32(0))
    for _ in range(4):  # up while the next one up is still skipped
        up = np.minimum(np.nextafter(e, np.float32(np.inf)), np.float32(0))
        e = np.where((up + lnv < lim) & (up > e), up, e)
    for _ in range(4):  # down while e itself is not skipped
        e = np.where(~(e + lnv < lim), np.nextafter(e, np.float32(-np.inf)), e)
    return np.where(e + lnv < lim, e, np.nan).astype(np.float32)


def _worst_contribution(v, e):
    """An upper bound of fl(v * expf(e)) over expf's 2 ulp, in float64."""
    ex = np.exp(e.astype(F64))
    hi = ex * (1 + 2.0 ** -22) + 2 * 2.0 ** -149  # 2 ulp, normal or subnormal
    return v.astype(F64) * hi * (1 + 2.0 ** -24)


def _margin_log_value(rng):
    """P1: ln v is never below the true value: every shortcut and clamp
    of log_value, with __logf at its lowest."""
    v = _sweep_values(rng, 200_000)
    ln = np.log(v.astype(F64))
    for lnv in (_kernel_log_value(v), _log_value(torch.from_numpy(v)).numpy()):
        assert (lnv.astype(F64) >= ln).all(), v[lnv.astype(F64) < ln][:5]
    assert np.log(V_LOG) <= LNV_MIN  # the shortcut below V_LOG


def _margin_threshold(rng, strict=False):
    """P2, P6: a skip against L = logf(b) - 2^-12 (logf 1 ulp high) proves the
    contribution <= b (< b for the threshold from another split's best),
    for v up to V_MAX and ln v at its lowest (rounded up from the true)."""
    n = 100_000
    b = np.exp(rng.uniform(np.log(2.0 ** -100), np.log(3e38), n)).astype(np.float32)
    v = _sweep_values(rng, n)[:n]
    v = v[(v <= V_MAX)][: n // 2]
    b = b[: len(v)]
    b[: len(v) // 4] = (v[: len(v) // 4] * rng.uniform(0.9, 1.1, len(v) // 4)).astype(np.float32)
    b = np.maximum(b, np.float32(2.0 ** -100))
    lnb = np.log(b.astype(F64))
    lim = _f32_up(_f32_up(lnb + _ulp32(lnb)).astype(F64) - LOG_MARGIN)
    lnv = np.maximum(_f32_up(np.log(v.astype(F64))), np.float32(LNV_MIN))
    e = _last_skipped_exponent(lnv, lim)
    ok = ~np.isnan(e)
    worst = _worst_contribution(v[ok], e[ok])
    bf = b[ok].astype(F64)
    assert ok.sum() > len(v) // 2
    assert ((worst * (1 + 2.0 ** -23) < bf) if strict else (worst <= bf)).all()


def _margin_zero_best(rng):
    """P3: 0 <= b < 2^-100: a skip against L_ZERO needs e <= EXP_ZERO, where
    expf is 0, for every ln v the kernel forms (>= LNV_MIN)."""
    lnv = np.concatenate([[LNV_MIN], rng.uniform(LNV_MIN, np.log(V_MAX) + 1, 10_000)])
    lnv = lnv.astype(np.float32)
    e = _last_skipped_exponent(lnv, np.full_like(lnv, L_ZERO))
    assert (e <= splat_cuda.EXP_ZERO).all()


def _margin_box_d2(rng):
    """P5: d2lo over a box is at most the plain version's rounded d2 at each
    pixel centre of the box (tile and warp boxes, widths 32 and 64), for
    points inside, near and far from it, rounded separately (the model) or
    in float64 (an FMA-contracted kernel)."""
    for w in (32, 64):
        half = float(w // 2)
        for c0, c1, r0, r1 in ((0, 15, 16, 31), (8, 15, 4, 7), (w - 16, w - 1, 0, 15)):
            box = _box(c0, c1, r0, r1, half)
            cols, rows = torch.meshgrid(torch.arange(c0, c1 + 1), torch.arange(r0, r1 + 1),
                                        indexing="ij")
            px, py = _pixel_coord(cols.reshape(-1), half), _pixel_coord(rows.reshape(-1), half)
            lo = torch.tensor([float(box[0]), float(box[2])])
            hi = torch.tensor([float(box[1]), float(box[3])])
            q = torch.cat([
                lo + (hi - lo) * torch.rand(300, 2, dtype=F32),  # inside
                torch.stack([px, py], -1)[torch.randint(len(px), (300,))]
                + (torch.rand(300, 2) - 0.5) * 1e-3,  # on pixel centres
                lo - 0.2 + (hi - lo + 0.4) * torch.rand(600, 2),  # near
                (torch.rand(300, 2) - 0.5) * 16,  # far
            ]).to(F32)
            psq = q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]
            xsq = px * px + py * py
            cross = q[:, 0:1] * px + q[:, 1:2] * py
            d2 = torch.clamp_min((psq[:, None] + xsq) - 2.0 * cross, 0.0)
            d2lo = _box_d2lo(q, psq, box)
            assert (d2lo[:, None] <= d2).all()
            x0, x1, y0, y1, sq_max = (float(b) for b in box)
            qd = q.double()
            gx = torch.clamp_min(torch.maximum(x0 - qd[:, 0], qd[:, 0] - x1), 0.0)
            gy = torch.clamp_min(torch.maximum(y0 - qd[:, 1], qd[:, 1] - y1), 0.0)
            g2 = gx * gx + gy * gy
            d2lo64 = torch.clamp_min(g2 * (1 - D2_REL) - (psq.double() + sq_max) * D2_REL, 0)
            assert (d2lo64[:, None] <= d2.double()).all()


class TestCullMargins:
    @pytest.mark.parametrize("step", ["log_value", "threshold", "strict_threshold",
                                      "zero_best", "box_d2"])
    def test_margin_holds(self, step):
        rng = np.random.default_rng(7)
        torch.manual_seed(7)
        {"log_value": _margin_log_value, "threshold": _margin_threshold,
         "strict_threshold": lambda r: _margin_threshold(r, strict=True),
         "zero_best": _margin_zero_best, "box_d2": _margin_box_d2}[step](rng)


# ---- The exact NN kernel's order ----

def emulate_exact(src, dst):
    """A numpy model of the exact kernel in fp32: dst rows split over
    ``exact_splits`` blocks (``rps = ceil(M / splits)`` rows each), each
    split scanning its rows in ascending order with a strict < (the first
    index attaining its min), the splits merged in ascending order with a
    strict <. Returns ``(min_d2 clamped at 0, idx)``."""
    B, N, _ = src.shape
    M = dst.shape[1]
    f32 = np.float32
    splits = nn_cuda.exact_splits(B, N, M)
    rps = -(-M // splits)
    ssq = (src[..., 0] * src[..., 0] + src[..., 1] * src[..., 1]) + src[..., 2] * src[..., 2]
    dsq = (dst[..., 0] * dst[..., 0] + dst[..., 1] * dst[..., 1]) + dst[..., 2] * dst[..., 2]
    best = np.full((B, N), np.inf, f32)
    idx = np.zeros((B, N), np.int64)
    for s in range(splits):
        m0, m1 = s * rps, min(M, (s + 1) * rps)
        if m0 >= m1:
            continue
        d = dst[:, None, m0:m1]
        sp = src[:, :, None]
        cross = (d[..., 0] * sp[..., 0] + d[..., 1] * sp[..., 1]) + d[..., 2] * sp[..., 2]
        d2 = (dsq[:, None, m0:m1] + ssq[:, :, None]) - f32(2.0) * cross
        m, a = d2.min(-1), d2.argmin(-1)
        upd = m < best  # ascending split order, strict <
        best[upd], idx[upd] = m[upd], m0 + a[upd]
    return np.maximum(best, f32(0)), idx


def _exact_tie_scene(n_grid, B):
    """Src on a 1/4 grid (each point twice), dst the grid moved by -1/32
    (first half) and +1/32 (second half) in x: every src point has two dst
    at exactly the same d2, the lower index (first half) must win."""
    k = np.arange(n_grid)
    g = np.stack([(k % 16) / 4, (k // 16 % 16) / 4, (k // 256) / 4], -1).astype(np.float32)
    e = np.array([1 / 32, 0, 0], np.float32)
    src = np.repeat(np.concatenate([g, g])[None], B, 0)
    dst = np.repeat(np.concatenate([g - e, g + e])[None], B, 0)
    return src, dst


class TestExactSplitMerge:
    @pytest.mark.parametrize("case", ["ties_1x512", "ties_16x512", "dup_1x700x900",
                                      "masked_3x300x700", "ties_2x2048"])
    def test_emulated_kernel_equals_plain(self, rng, case):
        if case.startswith("ties"):
            B = int(case.split("_")[1].split("x")[0])
            src, dst = _exact_tie_scene(int(case.split("x")[-1]) // 2, B)
        elif case == "dup_1x700x900":
            src = rng.standard_normal((1, 700, 3)).astype(np.float32)
            dst = rng.standard_normal((1, 900, 3)).astype(np.float32)
            dst[:, 450:] = dst[:, :450]  # duplicates in later splits
            src[:, :200] = dst[:, 600:800]  # exact hits on the later copies
        else:
            src = rng.standard_normal((3, 300, 3)).astype(np.float32)
            dst = rng.standard_normal((3, 700, 3)).astype(np.float32)
            mask = rng.random((3, 700)) > 0.3
            dst = nn_cuda.mask_far(t(dst), t(mask)).numpy()
        B, N, M = src.shape[0], src.shape[1], dst.shape[1]
        d2, idx = emulate_exact(src, dst)
        pd, pi = nn_cuda.nn_exact_plain(t(src), t(dst))
        np.testing.assert_array_equal(d2, pd.numpy())
        np.testing.assert_array_equal(idx, pi.numpy())
        assert nn_cuda.exact_splits(B, N, M) > 1
        if case.startswith("ties"):
            assert (idx < M // 2).all()  # the -1/32 copy, the lower index
        if case == "dup_1x700x900":
            assert (idx[0, :200] < 450).all() and (d2[0, :200] == 0).all()

    @pytest.mark.parametrize("case", ["ties", "duplicates"])
    def test_emulated_kernel_matches_pallas(self, rng, case):
        if case == "ties":
            src, dst = _exact_tie_scene(256, 2)
            mask = np.ones(dst.shape[:2], bool)
        else:
            src = rng.standard_normal((2, 200, 3)).astype(np.float32)
            dst = rng.standard_normal((2, 600, 3)).astype(np.float32)
            dst[:, 300:] = dst[:, :300]
            mask = rng.random((2, 600)) > 0.2
        want = jax.vmap(lambda s, d, k: jnn.nearest_neighbor_pallas(
            s, d, k, interpret=True))(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask))
        d2, idx = emulate_exact(src, nn_cuda.mask_far(t(dst), t(mask)).numpy())
        np.testing.assert_array_equal(idx, np.asarray(want[1]))
        winners = np.take_along_axis(dst, idx[..., None], 1)
        np.testing.assert_array_equal(winners, np.asarray(want[2]))
        terms = (src.astype(np.float64) ** 2).sum(-1) + (winners.astype(np.float64) ** 2).sum(-1)
        assert (np.abs(d2 - np.asarray(want[0], np.float64)) <= 1e-6 * terms).all()

    def test_splits_from_shape(self):
        """The split count depends on the shape alone: 8 at 16 x 4,096 and
        at path 2's B = 1, 7 and 8 x 512, never above 8 or below 64 rows a
        split; the rows of the splits cover dst once, in ascending order."""
        assert nn_cuda.exact_splits(16, 4096, 4096) == 8
        for B in (1, 7, 8):
            assert nn_cuda.exact_splits(B, 512, 512) == 8
        assert nn_cuda.exact_splits(1, 100, 100) == 1
        for B, N, M in [(16, 4096, 4096), (1, 512, 512), (3, 300, 700), (1, 5000, 130)]:
            s = nn_cuda.exact_splits(B, N, M)
            assert 1 <= s <= nn_cuda.BOUNDED_MAX_SPLITS
            assert s == 1 or M // s >= nn_cuda.EXACT_MIN_ROWS
            rps = -(-M // s)
            rows = [m for k in range(s) for m in range(k * rps, min(M, (k + 1) * rps))]
            assert rows == list(range(M))


# ---- The d^2 identity ----

def _round_f32(fr):
    """The fp32 nearest to the rational ``fr`` (ties to even)."""
    d = np.float32(float(fr))
    cands = [np.nextafter(d, np.float32(-np.inf)), d, np.nextafter(d, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - fr),
                                     int(np.float32(c).view(np.uint32)) & 1))


def fma32(a, b, c):
    """fp32 fma: ``a * b + c`` exactly, rounded once."""
    return _round_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


class TestD2Identity:
    @pytest.mark.parametrize("kind", ["random", "adversarial"])
    def test_fma_form_equals_plain_expression(self, kind):
        rng = np.random.default_rng(1)
        if kind == "random":
            s = (rng.uniform(0, 8, 3000) * 10.0 ** rng.integers(-6, 6, 3000)).astype(np.float32)
            c = (s * rng.uniform(0.3, 0.7, 3000)).astype(np.float32)
            c[::3] = rng.standard_normal(1000).astype(np.float32)
        else:
            tiny = np.float32(np.finfo(np.float32).tiny)
            sub = np.float32(1.4e-45)
            s = np.array([1.0, 1.0, 2.0, 0.0, -0.0, tiny, sub * 3, 1e30, 4.0, 3.0, 1.0,
                          np.float32(1 + 2 ** -23), 5.0, 2e-38, 1e-40], np.float32)
            c = np.array([0.5, 3 * 2 ** -26, 1.0, 0.0, 0.0, tiny / 2, sub, 5e29, 2.0 - 2 ** -22,
                          1.5, 2 ** -26, 2 ** -25, np.nextafter(np.float32(2.5), 0), 1e-38,
                          -1e-40], np.float32)
            # Near-cancellation: c = s / 2 to within a few ulp.
            base = (rng.uniform(0.1, 6, 400)).astype(np.float32)
            near = (base / 2).astype(np.float32)
            near = np.nextafter(near, near + rng.choice([-1, 0, 1], 400).astype(np.float32))
            s, c = np.concatenate([s, base]), np.concatenate([c, near])
        plain = s - np.float32(2.0) * c  # the plain expression: 2c rounded, then s - 2c
        fused = np.array([fma32(np.float32(-2.0), ci, si) for si, ci in zip(s, c)], np.float32)
        assert np.isfinite(plain).all()
        np.testing.assert_array_equal(fused, plain)
