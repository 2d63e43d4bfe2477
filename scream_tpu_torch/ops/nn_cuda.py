"""Nearest-neighbour search: two hand-written kernels (``csrc/nn.cu``), port
of ``scream_tpu/ops/nn_pallas.py``.

* :func:`nn_exact` (replaces ``_nn_kernel``/``nearest_neighbor_pallas``):
  the pose solve's exact NN, per src point the min squared distance and the
  first dst index attaining it. Four src points a thread; where B x src
  slabs would leave the card idle, dst splits over up to 8 blocks
  (:func:`exact_splits`) merged in one launch, as the bounded kernel's are.
* :func:`nn_bounded` (replaces ``_nn_bounded_batched_fine_kernel``, reached
  through ``_bounded_batched``): the batched ICP's threshold-bounded NN,
  per src point the min squared distance and the winner's xyz, exact for
  every point whose true NN lies within the threshold. Tiles whose boxes
  are farther apart than the threshold and lanes flagged ``dead`` are
  skipped; a point with no live tile keeps ``(3e38, (0, 0, 0))``.
* :func:`nn_bounded_single` (replaces ``_nn_bounded_kernel``, reached
  through ``_bounded_impl``): the same function for one pair, the
  single-pair ICP's NN, on a one-lane batch. The TPU kernel differs from the batched one only in
  its pruning tile (a whole 1024 x 256 block against 128-point sub-slabs);
  here it is the B = 1 launch of the same kernel, with its own launch
  count. The TPU's other tilings of the batched kernel
  (``_nn_bounded_batched_kernel``, ``fine=False``, and
  ``_nn_bounded_batched_fine4_kernel``) compute this function too.

Both take dst with masked rows already moved to ``FAR`` (:func:`mask_far`).
The bounded NN reads per-tile boxes of dst: :func:`nn_tile_boxes` (kernel
``tile_boxes_kernel``; plain version :func:`tile_boxes`) makes them, once
per ICP call in ``geometry/icp.py``, and the wrappers take them as
``boxes=`` or make them themselves when not given. Where B x sub-slabs
would leave the card idle, the bounded kernel splits the dst tiles over up
to 8 blocks (:func:`bounded_splits`) and merges the splits in one launch.
Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version only for CPU tensors. The plain versions evaluate the
kernels' distance expression elementwise in the same order, so the two agree
bit for bit; the plain bounded NN is the exact NN (which meets the bounded
contract), with dead lanes at the no-hit sentinel as in the kernel. Besides
``launches`` (calls that launched), the bounded wrappers count the device
kernels their calls launched in ``device_launches``: one a call when the
boxes are given, two when the wrapper makes them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from scream_tpu_torch.ops import _build

# Far-away coordinate for masked dst points: (2e17)^2 = 4e34 stays finite in
# f32 and dominates any real distance.
FAR = 2.0e17
# Min distance of a point that met no live tile of the bounded kernel.
NO_HIT = 3.0e38
BOUNDED_TILE = 256  # dst rows per box-tested tile (csrc/nn.cu BD_TILE)
BOUNDED_SLAB = 128  # src points per block (csrc/nn.cu BD_THREADS)
BOUNDED_MAX_SPLITS = 8  # dst splits per sub-slab: the portable cluster size
BOUNDED_MIN_BLOCKS = 128  # split the dst tiles until this many blocks
EXACT_SLAB = 512  # src points per block of the exact kernel (csrc/nn.cu EX_SLAB)
EXACT_MIN_BLOCKS = 528  # split dst until this many blocks: four per SM
EXACT_MIN_ROWS = 64  # dst rows per split at least
_PLAIN_CHUNK = 1024  # src rows per step of the plain versions' distance block


def mask_far(dst: torch.Tensor, dst_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """fp32 contiguous dst with masked rows at ``FAR``."""
    dst = dst.float()
    if dst_mask is not None:
        dst = torch.where(dst_mask[..., None], dst, torch.full_like(dst, FAR))
    return dst.contiguous()


def _sq3(p):
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]) + p[..., 2] * p[..., 2]


def _dist2(src, dst, d_sq):
    """``(d_sq + s_sq) - 2 (d . s)`` for ``(B, n, 3)`` x ``(B, M, 3)``,
    elementwise in the kernels' order (no matmul, no FMA)."""
    s = src[:, :, None, :]
    d = dst[:, None, :, :]
    cross = (d[..., 0] * s[..., 0] + d[..., 1] * s[..., 1]) + d[..., 2] * s[..., 2]
    return (d_sq[:, None, :] + _sq3(src)[:, :, None]) - 2.0 * cross


def _exact_plain(src, dst):
    d_sq = _sq3(dst)
    mins, idxs = [], []
    for n0 in range(0, src.shape[1], _PLAIN_CHUNK):
        m, i = _dist2(src[:, n0:n0 + _PLAIN_CHUNK], dst, d_sq).min(-1)
        mins.append(m)
        idxs.append(i)
    return torch.cat(mins, 1), torch.cat(idxs, 1)


def nn_exact_plain(src, dst):
    """Plain version of the exact NN: ``(B, N, 3)``, ``(B, M, 3)`` fp32 ->
    min squared distance ``(B, N)`` clamped at 0 and index ``(B, N)`` int64
    (first index attaining the min, as ``argmin``)."""
    m, i = _exact_plain(src, dst)
    return torch.clamp_min(m, 0.0), i


def nn_bounded_plain(src, dst, thresh_sq: float, dead):
    """Plain version of the bounded NN: the exact NN (exact everywhere, so
    within the threshold too) with its winner's xyz; dead lanes at
    ``(NO_HIT, 0)``."""
    m, i = _exact_plain(src, dst)
    xyz = torch.gather(dst, 1, i[..., None].expand(-1, -1, 3))
    d2 = torch.clamp_min(m, 0.0)
    if dead is not None:
        d2 = torch.where(dead[:, None], torch.full_like(d2, NO_HIT), d2)
        xyz = torch.where(dead[:, None, None], torch.zeros_like(xyz), xyz)
    return d2, xyz


def nn_exact(src, dst):
    """Exact NN (kernel 3). ``dst`` has masked rows at ``FAR``."""
    if not _build.route(src):
        return nn_exact_plain(src, dst)
    B, N, _ = src.shape
    M = dst.shape[1]
    _build.check_tensor(src, "src", torch.float32, (B, N, 3))
    _build.check_tensor(dst, "dst", torch.float32, (B, M, 3))
    min_d2 = torch.empty((B, N), device=src.device, dtype=torch.float32)
    idx = torch.empty((B, N), device=src.device, dtype=torch.int64)
    err = _build.kernels().scream_nn_exact(
        src.data_ptr(), dst.data_ptr(), min_d2.data_ptr(), idx.data_ptr(),
        B, N, M, exact_splits(B, N, M), _build.stream_ptr(src))
    _build.check(err, "nn_exact")
    nn_exact.launches += 1
    return min_d2, idx


nn_exact.launches = 0


def exact_splits(B: int, N: int, M: int) -> int:
    """Dst splits per src slab of the exact kernel, from the shape alone:
    doubled from 1 while the grid has fewer than ``EXACT_MIN_BLOCKS`` blocks,
    up to 8 and to ``EXACT_MIN_ROWS`` rows a split (8 at 16 x 4,096 and at
    1 x 512). Split ``s`` scans rows ``s * rps .. s * rps + rps - 1``,
    ``rps = ceil(M / splits)``."""
    slabs = -(-N // EXACT_SLAB)
    s = 1
    while (s < BOUNDED_MAX_SPLITS and 2 * s * EXACT_MIN_ROWS <= M
           and B * slabs * s < EXACT_MIN_BLOCKS):
        s *= 2
    return s


def tile_boxes(dst):
    """Plain version of the kernel's tile boxes: ``(B, ceil(M/256), 6)``
    (lo xyz, hi xyz) over each 256-row tile's valid rows
    (``ops/nn_pallas._tile_boxes``). FAR rows are left out, so an all-masked
    tile gets the empty box (+inf, -inf)."""
    B, M, _ = dst.shape
    mt = -(-M // BOUNDED_TILE)
    t = F.pad(dst, (0, 0, 0, mt * BOUNDED_TILE - M), value=FAR)
    t = t.reshape(B, mt, BOUNDED_TILE, 3)
    valid = t[..., :1] < FAR / 2.0
    inf = torch.tensor(float("inf"), device=dst.device)
    lo = torch.where(valid, t, inf).amin(2)
    hi = torch.where(valid, t, -inf).amax(2)
    return torch.cat([lo, hi], -1).contiguous()


def bounded_splits(B: int, N: int, M: int) -> int:
    """Dst splits per src sub-slab of the bounded kernel, from the shape
    alone: doubled from 1 while the grid has fewer than
    ``BOUNDED_MIN_BLOCKS`` blocks, up to 8 and to one tile a split
    (1 at 16 x 4,096; 2 at 1 x 512; 4 at 1 x 4,096). Split ``s`` scans
    tiles ``s * tps .. s * tps + tps - 1``, ``tps = ceil(tiles / splits)``."""
    slabs, mt = -(-N // BOUNDED_SLAB), -(-M // BOUNDED_TILE)
    s = 1
    while (s < BOUNDED_MAX_SPLITS and 2 * s <= mt
           and B * slabs * s < BOUNDED_MIN_BLOCKS):
        s *= 2
    return s


def _boxes(dst):
    """The tile boxes of a checked CUDA dst: one launch."""
    B, M, _ = dst.shape
    boxes = torch.empty((B, -(-M // BOUNDED_TILE), 6), device=dst.device,
                        dtype=torch.float32)
    err = _build.kernels().scream_nn_tile_boxes(dst.data_ptr(), boxes.data_ptr(), B, M,
                                                _build.stream_ptr(dst))
    _build.check(err, "nn_tile_boxes")
    return boxes


def nn_tile_boxes(dst):
    """Per-tile boxes of ``dst`` ``(B, M, 3)`` (masked rows at ``FAR``) for
    the bounded NN: ``(B, ceil(M/256), 6)``, one launch of
    ``tile_boxes_kernel`` for a CUDA tensor, :func:`tile_boxes` for a CPU
    one. ICP calls it once per call: its dst does not change across steps."""
    if not _build.route(dst):
        return tile_boxes(dst)
    B, M, _ = dst.shape
    _build.check_tensor(dst, "dst", torch.float32, (B, M, 3))
    boxes = _boxes(dst)
    nn_tile_boxes.launches += 1
    return boxes


nn_tile_boxes.launches = 0


def _launch_bounded(src, dst, thresh_sq: float, dead, boxes):
    """The bounded kernel on ``(B, N, 3)`` x ``(B, M, 3)`` CUDA tensors;
    returns ``(min_d2, xyz, device launches)``."""
    B, N, _ = src.shape
    M = dst.shape[1]
    f32 = torch.float32
    _build.check_tensor(src, "src", f32, (B, N, 3))
    _build.check_tensor(dst, "dst", f32, (B, M, 3))
    launched = 1
    if boxes is None:
        boxes = _boxes(dst)
        launched = 2
    else:
        _build.check_tensor(boxes, "boxes", f32, (B, -(-M // BOUNDED_TILE), 6))
    if dead is not None:  # read as the bool tensor's bytes
        _build.check_tensor(dead, "dead", torch.bool, (B,))
    out = torch.empty(4 * B * N, device=src.device, dtype=f32)
    min_d2, xyz = out[:B * N].view(B, N), out[B * N:].view(B, N, 3)
    err = _build.kernels().scream_nn_bounded(
        src.data_ptr(), dst.data_ptr(), boxes.data_ptr(),
        None if dead is None else dead.data_ptr(), float(thresh_sq), min_d2.data_ptr(),
        xyz.data_ptr(), B, N, M, bounded_splits(B, N, M), _build.stream_ptr(src))
    _build.check(err, "nn_bounded")
    return min_d2, xyz, launched


def nn_bounded(src, dst, thresh_sq: float, dead=None, boxes=None):
    """Batched threshold-bounded NN (kernel 4): ``(min_d2 (B, N), xyz
    (B, N, 3))``. ``dst`` has masked rows at ``FAR``; ``thresh_sq`` is a
    Python float; ``dead`` an optional ``(B,)`` bool lane flag; ``boxes``
    the optional :func:`nn_tile_boxes` of ``dst`` (made here if None)."""
    if not _build.route(src):
        return nn_bounded_plain(src, dst, thresh_sq, dead)
    d2, xyz, launched = _launch_bounded(src, dst, thresh_sq, dead, boxes)
    nn_bounded.launches += 1
    nn_bounded.device_launches += launched
    return d2, xyz


nn_bounded.launches = 0
nn_bounded.device_launches = 0


def nn_bounded_single(src, dst, thresh_sq: float, dead=None, boxes=None):
    """Threshold-bounded NN of one pair (kernel 6), the B = 1 launch of the
    bounded kernel: ``src`` ``(1, N, 3)``, ``dst`` ``(1, M, 3)`` with masked
    rows at ``FAR``, ``dead`` an optional ``(1,)`` bool, ``boxes`` as in
    :func:`nn_bounded` -> ``(min_d2 (1, N), xyz (1, N, 3))``."""
    if not _build.route(src):
        return nn_bounded_plain(src, dst, thresh_sq, dead)
    if src.shape[0] != 1:
        raise ValueError(f"nn_bounded_single takes one lane, got {src.shape[0]}")
    d2, xyz, launched = _launch_bounded(src, dst, thresh_sq, dead, boxes)
    nn_bounded_single.launches += 1
    nn_bounded_single.device_launches += launched
    return d2, xyz


nn_bounded_single.launches = 0
nn_bounded_single.device_launches = 0


def nearest_neighbor_full(
    src: torch.Tensor,
    dst: torch.Tensor,
    dst_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ``(distance, index, winner_xyz)``: the exact NN kernel, then
    one gather of the winners from the unmasked dst
    (``ops/nn_pallas.nearest_neighbor_full``)."""
    d, idx = nn_exact(src.float().contiguous(), mask_far(dst, dst_mask))
    coords = torch.gather(dst.float(), 1, idx[..., None].expand(-1, -1, 3))
    return d, idx, coords


def nearest_neighbor_bounded(
    src: torch.Tensor,
    dst: torch.Tensor,
    thresh_sq: float,
    dst_mask: Optional[torch.Tensor] = None,
    dead: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unbatched threshold-bounded NN ``(min_sq_dist (N,), winner_xyz
    (N, 3))`` of ``src`` ``(N, 3)`` in ``dst`` ``(M, 3)``, exact for every
    src point whose true NN lies within ``thresh_sq``
    (``ops/nn_pallas.nearest_neighbor_bounded``); ``dead`` a bool scalar."""
    d2, xyz = nn_bounded_single(src.float().contiguous()[None],
                                mask_far(dst, dst_mask)[None], thresh_sq,
                                None if dead is None else dead.reshape(1))
    return d2[0], xyz[0]


def nearest_neighbor_bounded_batched(
    src: torch.Tensor,
    dst: torch.Tensor,
    thresh_sq: float,
    dst_mask: Optional[torch.Tensor] = None,
    dead: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched threshold-bounded NN over ``(B, N, 3)`` x ``(B, M, 3)``
    (``ops/nn_pallas._bounded_batched``, what the vmapped ICP lowers to);
    ``dead`` a ``(B,)`` lane flag."""
    return nn_bounded(src.float().contiguous(), mask_far(dst, dst_mask),
                      thresh_sq, dead)
