"""Two-channel Gaussian max-splat, the depth renderer's hot op: one
hand-written kernel (``csrc/splat.cu``), port of ``scream_tpu/ops/splat_pallas.py``.

For ``I`` images of ``N`` points each, with xy ``(I, N, 2)`` in the pixel
frame and per-point values ``(I, N, 2)`` for the (src, tgt) channels, every
pixel of the ``width x width`` grid (:func:`pixel_grid`) gets, per channel,
the max over points of ``val * exp(-|xy - pix|^2 * rho^2 / 2)`` and the
lowest point index attaining it.

* :func:`splat_forward` (kernel ``max_splat_kernel``, replaces the TPU's
  ``_splat_kernel`` through ``_splat_forward``): ``(img, arg)``, one launch
  for all images. It launches the kernel for CUDA tensors and runs
  :func:`max_splat_plain` only for CPU tensors. The kernel evaluates only
  the (point, pixel) pairs that could change a pixel's (max, argmax) and
  proves the others cannot, so its result is the dense scan's bit for bit
  (``csrc/splat.cu``); :func:`splat_cull_counts` launches it with its work
  counters and :func:`expf_zero_check` checks on the card the property of
  ``expf`` its proof rests on.
* :func:`max_splat_plain`: the plain version, the same distance expression
  elementwise in the kernel's order (bit for bit on the card), streamed over
  pixel tiles so that the points x pixels block stays small. Its image is
  differentiable by autograd through ``amax``, which splits a tie's
  cotangent evenly as the JAX package's XLA renderer does.
* :func:`max_splat`: the differentiable splat the renderer calls
  (``splat_pallas.max_splat``), a ``torch.autograd.Function`` whose
  backward (``_max_splat_bwd``, plain in the JAX package too) routes each
  pixel's cotangent to its argmax point with ``index_add_``.

Contract: any finite ``vals`` (the renderer's inverse depths lie in
[0, 1], one channel 0 on every row) and ``xy`` whose squared norms are
finite.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from scream_tpu_torch.ops import _build

_PLAIN_TILE = 256  # pixels per step of the plain version
SPLAT_TILE = 16  # the kernel's pixel tile edge (csrc/splat.cu SP_TW)
SPLAT_WARPS = 8  # warps a tile, each on 8 x 4 pixels
EXP_ZERO = -104.5  # expf(x) == 0 for every fp32 x <= this (csrc/splat.cu)
SPLAT_MAX_SPLITS = 8  # point splits per tile: the portable cluster size
SPLAT_SPLIT_POINTS = 2048  # points per split at least


def pixel_grid(w: int, device=None) -> torch.Tensor:
    """Normalized ``(w*w, 2)`` pixel-centre grid: row-major pixel k is
    (col k % w, row k // w), mapped to ``((col, row) - w//2 + 0.5) / (w//2)``
    (``render.pixel_grid``; reference ``models/render.py:14-16``)."""
    k = torch.arange(w * w, device=device)
    xy = torch.stack([(k % w).float(), (k // w).float()], dim=-1)
    return (xy - w // 2 + 0.5) / (w // 2)


def _neg_half_rho_sq(rho: float) -> float:
    return -0.5 * rho * rho


def _splat_tile(xy, vals, p_sq, pix, neg):
    """One pixel tile: ``(img (I, 2, T), arg (I, 2, T))``."""
    n = xy.shape[1]
    x_sq = pix[:, 0] * pix[:, 0] + pix[:, 1] * pix[:, 1]
    cross = xy[..., 0:1] * pix[:, 0] + xy[..., 1:2] * pix[:, 1]  # (I, N, T)
    d2 = torch.clamp_min((p_sq[..., None] + x_sq) - 2.0 * cross, 0.0)
    wgt = torch.exp(d2 * neg)
    rows = torch.arange(n, device=xy.device, dtype=torch.int32)[:, None]
    imgs, args = [], []
    for c in (0, 1):
        contrib = vals[..., c:c + 1] * wgt
        m = torch.amax(contrib, dim=1)
        big = torch.full_like(rows, n)
        a = torch.where(contrib >= m[:, None], rows, big).amin(dim=1)
        imgs.append(m)
        args.append(a)
    return torch.stack(imgs, 1), torch.stack(args, 1)


def max_splat_plain(xy, vals, rho: float, width: int, tile: int = _PLAIN_TILE):
    """Plain version of the splat kernel: ``xy``, ``vals`` ``(I, N, 2)``
    fp32 -> ``img`` ``(I, 2, width*width)`` fp32, ``arg`` same shape int32.

    Under autograd each pixel tile is recomputed in the backward
    (``torch.utils.checkpoint``), so the stored points x pixels blocks stay
    one tile deep."""
    xy, vals = xy.float(), vals.float()
    pix = pixel_grid(width, xy.device)
    neg = _neg_half_rho_sq(rho)
    p_sq = xy[..., 0] * xy[..., 0] + xy[..., 1] * xy[..., 1]
    grad = torch.is_grad_enabled() and (xy.requires_grad or vals.requires_grad)
    imgs, args = [], []
    for t0 in range(0, pix.shape[0], tile):
        pt = pix[t0:t0 + tile]
        if grad:
            img, arg = checkpoint(_splat_tile, xy, vals, p_sq, pt, neg,
                                  use_reentrant=False)
        else:
            img, arg = _splat_tile(xy, vals, p_sq, pt, neg)
        imgs.append(img)
        args.append(arg)
    return torch.cat(imgs, -1), torch.cat(args, -1)


def splat_forward(xy, vals, rho: float, width: int):
    """The splat kernel: ``(img (I, 2, w*w) fp32, arg (I, 2, w*w) int32)``
    for ``xy``, ``vals`` ``(I, N, 2)``; its plain version for CPU tensors."""
    if not _build.route(xy):
        with torch.no_grad():
            return max_splat_plain(xy, vals, rho, width)
    I, N = xy.shape[0], xy.shape[1]
    if N == 0 or I == 0:
        raise ValueError(f"splat kernel: needs points and images, got xy {tuple(xy.shape)}")
    f32 = torch.float32
    _build.check_tensor(xy, "xy", f32, (I, N, 2), align=8)
    _build.check_tensor(vals, "vals", f32, (I, N, 2), align=8)
    img, arg = _launch(xy, vals, rho, width, None)
    max_splat.launches += 1
    return img, arg


def splat_splits(N: int) -> int:
    """Point splits per pixel tile of the splat kernel, from the point count
    alone: one per ``SPLAT_SPLIT_POINTS`` points, a power of two up to 8
    (4 at 8,192 points, 8 at 16,384, 1 below 4,096). The splits of a tile form
    a thread-block cluster; split ``s`` scans points ``s * nps .. s * nps +
    nps - 1``, ``nps = ceil(N / splits)``."""
    s = 1
    while s < SPLAT_MAX_SPLITS and 2 * s * SPLAT_SPLIT_POINTS <= N:
        s *= 2
    return s


def _launch(xy, vals, rho, width, stats):
    I, N = xy.shape[0], xy.shape[1]
    P = width * width
    img = torch.empty((I, 2, P), device=xy.device, dtype=torch.float32)
    arg = torch.empty((I, 2, P), device=xy.device, dtype=torch.int32)
    err = _build.kernels().scream_max_splat(
        xy.data_ptr(), vals.data_ptr(), img.data_ptr(), arg.data_ptr(), I, N, width,
        _neg_half_rho_sq(rho), splat_splits(N), None if stats is None else stats.data_ptr(),
        _build.stream_ptr(xy))
    _build.check(err, "max_splat")
    return img, arg


def splat_cull_counts(xy, vals, rho: float, width: int):
    """The splat kernel's counting build on CUDA tensors: ``(img, arg,
    counts)``, counts a dict of the (point, channel)s kept by the 16 x 16
    tile test (``tile_kept``), the (point, channel, warp)s kept by the
    8 x 4 warp test (``warp_kept``; each takes the per-pixel test at the
    warp's 32 pixels) and the (point, pixel, channel)s that reached
    ``expf`` (``exp_pairs``), beside the totals they are shares of
    (``staged``: 2 N per tile, ``warp_staged``: 2 N per warp, ``pairs``:
    2 N per pixel). A diagnostic; the path calls :func:`splat_forward`,
    whose launch compiles the counters out."""
    I, N = xy.shape[0], xy.shape[1]
    _build.check_tensor(xy, "xy", torch.float32, (I, N, 2), align=8)
    _build.check_tensor(vals, "vals", torch.float32, (I, N, 2), align=8)
    stats = torch.zeros(3, device=xy.device, dtype=torch.int64)
    img, arg = _launch(xy, vals, rho, width, stats)
    max_splat.launches += 1
    tiles = I * (-(-width // SPLAT_TILE)) ** 2
    tile_kept, warp_kept, exp_pairs = (int(v) for v in stats.tolist())
    return img, arg, dict(tile_kept=tile_kept, staged=2 * N * tiles,
                          warp_kept=warp_kept, warp_staged=2 * N * tiles * SPLAT_WARPS,
                          exp_pairs=exp_pairs,
                          pairs=2 * N * tiles * SPLAT_TILE * SPLAT_TILE)


def expf_zero_check(device="cuda"):
    """``(not monotone, nonzero)`` over every non-positive fp32 x on the
    card: the x where the kernels' ``expf`` exceeds its value at the next
    float below, and the x <= ``EXP_ZERO`` where it is not 0. The splat
    kernel's skip rule for pixels whose best is below 2^-100 needs the
    second to be 0. One launch."""
    bad = torch.zeros(2, device=device, dtype=torch.int64)
    err = _build.kernels().scream_splat_expf_check(bad.data_ptr(),
                                                   _build.stream_ptr(bad))
    _build.check(err, "splat_expf_check")
    return tuple(int(v) for v in bad.tolist())


def _max_splat_bwd(xy, vals, arg, g, rho: float, width: int):
    """``(d xy, d vals)`` for the image cotangent ``g`` ``(I, 2, P)``: each
    pixel's cotangent goes to its winning point (``splat_pallas._max_splat_bwd``).
    Pixels whose winner index is ``>= N`` carry no gradient."""
    I, N = xy.shape[0], xy.shape[1]
    pix = pixel_grid(width, xy.device)
    xy_flat = xy.reshape(I * N, 2)
    vals_flat = vals.reshape(I * N, 2)
    base = (torch.arange(I, device=xy.device) * N)[:, None]
    g_xy = torch.zeros_like(xy_flat)
    g_vals = []
    for c in (0, 1):
        idx = arg[:, c].long()  # (I, P) winning point per pixel
        real = idx < N
        flat = (torch.where(real, idx, 0) + base).reshape(-1)
        d = xy_flat[flat].reshape(I, -1, 2) - pix
        wgt = torch.exp((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                        * _neg_half_rho_sq(rho))
        gc = g[:, c]
        gv = torch.where(real, gc * wgt, 0.0)  # d img / d val = wgt
        vi = vals_flat[flat, c].reshape(I, -1)
        gxy = torch.where(real, gc * vi * wgt * (-rho * rho), 0.0)[..., None] * d
        g_vals.append(torch.zeros(I * N, dtype=gv.dtype, device=gv.device)
                      .index_add_(0, flat, gv.reshape(-1)))
        g_xy.index_add_(0, flat, gxy.reshape(-1, 2))
    return g_xy.reshape(I, N, 2), torch.stack(g_vals, -1).reshape(I, N, 2)


class _MaxSplat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xy, vals, rho, width):
        img, arg = splat_forward(xy, vals, rho, width)
        ctx.save_for_backward(xy, vals, arg)
        ctx.rho, ctx.width = rho, width
        return img

    @staticmethod
    def backward(ctx, g):
        xy, vals, arg = ctx.saved_tensors
        g_xy, g_vals = _max_splat_bwd(xy, vals, arg, g.float(), ctx.rho, ctx.width)
        return g_xy, g_vals, None, None


def max_splat(xy, vals, rho: float, width: int):
    """Differentiable two-channel max-splat: ``xy``, ``vals`` ``(I, N, 2)``
    -> ``(I, 2, width*width)``, through the kernel for CUDA tensors (its
    plain version for CPU tensors) and the argmax backward."""
    return _MaxSplat.apply(xy.float().contiguous(), vals.float().contiguous(),
                           float(rho), int(width))


max_splat.launches = 0
