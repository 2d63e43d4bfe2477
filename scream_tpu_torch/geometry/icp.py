"""Point-to-point ICP (port of ``scream_tpu/geometry/icp.py``).

Two entry points, as in the JAX package:

* :func:`registration_icp` refines ONE pair, ``(N, 3)`` clouds and a
  ``(4, 4)`` init, and stops on Open3D's convergence test like the TPU's
  ``lax.while_loop``: a host loop reads one flag back from the device per
  iteration (the TPU evaluates the same test on the device). Its NN is the
  unbatched bounded kernel (``nn_cuda.nn_bounded_single``).
* :func:`registration_icp_batched` refines ``B`` pairs at once, the
  ``vmap``ped loop of the JAX package (its ``chunk=None`` path): all lanes
  run the fixed ``max_iteration`` steps with a per-lane ``alive`` flag; a
  lane that converged or ran out of iterations is frozen with
  ``torch.where`` and passed to the batched bounded NN kernel as ``dead``,
  so its tiles cost nothing. It never reads a value back to the host, so
  it cannot wait on a flag the device never sets.

Both build their steps from one :func:`_make_icp_fns`, as the JAX package's
two loops do. Each step (Open3D's ``registration_icp`` with point-to-point
estimation, reference ``evaluate_3d_match.py:109-114``): transform src by
the pending estimate, threshold-bounded NN in tgt, fitness and inlier RMSE
at that transform, then an absolute weighted-Kabsch re-estimate from the
original src. The load-bearing semantics of ``_make_icp_fns`` and
``registration_icp:255-287`` are kept:

* metrics are taken at the post-update transform;
* convergence uses strict ``<`` on both relative changes and needs ``it > 1``;
* an early break returns ``T_meas`` (the transform that was measured),
  running out of iterations returns ``T_pending``;
* with no inliers the transform is kept;
* src is sorted along the INIT-ROTATED x axis (``src @ R_init[0]``), the
  frame the kernel tiles, and tgt along plain x.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from scream_tpu_torch.geometry.kabsch import kabsch
from scream_tpu_torch.geometry.metrics import transformation_error
from scream_tpu_torch.ops.nn_cuda import (mask_far, nn_bounded, nn_bounded_single,
                                          nn_tile_boxes)


def _spatial_sort(pts, mask, axis_dir: Optional[torch.Tensor] = None):
    """Sort each lane's points along one direction, masked rows last.

    ``pts`` ``(B, N, 3)``, ``mask`` ``(B, N)``, ``axis_dir`` ``(B, 3)`` or
    None for the x axis. The bounded NN kernel prunes (sub-slab, tile)
    pairs by box distance, which only bites on spatially coherent tiles;
    every consumer downstream is permutation-invariant.
    """
    if axis_dir is None:
        key = pts[..., 0]
    else:
        key = (pts @ axis_dir[..., None])[..., 0]
    key = torch.where(mask, key, torch.full_like(key, 3e38))
    order = torch.argsort(key, dim=-1, stable=True)
    return (torch.gather(pts, 1, order[..., None].expand(-1, -1, 3)),
            torch.gather(mask, 1, order))


class ICPResult(NamedTuple):
    transformation: torch.Tensor  # (4, 4), batched (B, 4, 4)
    fitness: torch.Tensor  # inlier fraction of valid src points, (B,)
    inlier_rmse: torch.Tensor  # scalar, (B,)
    iterations: torch.Tensor  # scalar int, (B,)


class _State(NamedTuple):
    # T_meas: the transform whose correspondences produced (fitness, rmse);
    # T_pending: the Kabsch update computed from those correspondences.
    T_meas: torch.Tensor
    T_pending: torch.Tensor
    fitness: torch.Tensor
    rmse: torch.Tensor
    prev_fitness: torch.Tensor
    prev_rmse: torch.Tensor
    it: torch.Tensor


def _init_icp_state(init: torch.Tensor) -> _State:
    B = init.shape[0]
    full = lambda v: torch.full((B,), v, dtype=torch.float32, device=init.device)
    T0 = init.float()
    return _State(T0, T0, full(-1.0), full(-1.0), full(-2.0), full(-2.0),
                  torch.zeros((B,), dtype=torch.int32, device=init.device))


def _f32_square(x: float) -> float:
    """``x**2`` rounded as the JAX package rounds it (fp32 in, fp32 out)."""
    x32 = np.float32(x)
    return float(x32 * x32)


def _make_icp_fns(src, tgt, src_mask, tgt_mask, thresh_sq: float,
                  relative_fitness: float, relative_rmse: float, nn=nn_bounded):
    """The per-iteration machinery ``(step, converged, measure)`` over the
    (sorted, fp32) batched clouds; ``nn`` is the bounded NN wrapper (the
    batched kernel, or ``nn_bounded_single`` for a one-lane batch), given
    tgt with its masked rows at ``FAR`` and its tile boxes, made once here:
    tgt does not change across iterations, so a step is one NN launch."""
    n_valid_src = torch.clamp_min(src_mask.float().sum(-1), 1.0)
    dst = mask_far(tgt, tgt_mask)
    boxes = nn_tile_boxes(dst)

    def measure(T, dead=None):
        src_t = src @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
        nn_dist, corr_tgt = nn(src_t, dst, thresh_sq, dead, boxes=boxes)
        valid = (nn_dist < thresh_sq) & src_mask
        w = valid.float()
        n_inlier = w.sum(-1)
        fitness = n_inlier / n_valid_src
        rmse = torch.sqrt((nn_dist * w).sum(-1) / torch.clamp_min(n_inlier, 1.0))
        return corr_tgt, w, n_inlier, fitness, rmse

    def step(T, dead=None):
        corr_tgt, w, n_inlier, fitness, rmse = measure(T, dead=dead)
        # Absolute re-estimate from the original src (point-to-point).
        T_new = kabsch(src, corr_tgt, w)
        # No inliers: keep the current estimate.
        T_new = torch.where((n_inlier > 0)[:, None, None], T_new, T)
        return T_new, fitness, rmse

    def converged(s: _State):
        # STRICT <, as Open3D's RegistrationICP break condition.
        return ((torch.abs(s.fitness - s.prev_fitness) < relative_fitness)
                & (torch.abs(s.rmse - s.prev_rmse) < relative_rmse)
                & (s.it > 1))

    return step, converged, measure


def _prepare(src, tgt, init, src_mask, tgt_mask):
    """fp32 batched clouds sorted for the bounded kernel's tile pruning:
    src along its init-rotated x axis, tgt along x."""
    dev = src.device
    if src_mask is None:
        src_mask = torch.ones(src.shape[:-1], dtype=torch.bool, device=dev)
    if tgt_mask is None:
        tgt_mask = torch.ones(tgt.shape[:-1], dtype=torch.bool, device=dev)
    src, src_mask = _spatial_sort(src.float(), src_mask, axis_dir=init[:, 0, :3])
    tgt, tgt_mask = _spatial_sort(tgt.float(), tgt_mask)
    return src, tgt, src_mask, tgt_mask


def _finish(s: _State, converged, measure) -> ICPResult:
    """Open3D breaks right after measuring: on early convergence it returns
    the measured transform; on exhaustion every update stands. Final
    metrics at the returned transform."""
    early = converged(s)
    T_final = torch.where(early[:, None, None], s.T_meas, s.T_pending)
    iters = torch.where(early, s.it - 1, s.it)
    _, _, _, fitness, rmse = measure(T_final)
    return ICPResult(T_final, fitness, rmse, iters)


def registration_icp(
    src: torch.Tensor,
    tgt: torch.Tensor,
    max_correspondence_distance: float,
    init: Optional[torch.Tensor] = None,
    max_iteration: int = 30,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
    relative_fitness: float = 1e-6,
    relative_rmse: float = 1e-6,
) -> ICPResult:
    """Refine an initial pose aligning ``src`` ``(N, 3)`` onto ``tgt``
    ``(M, 3)`` (padded ok, with masks); ``init`` ``(4, 4)``, identity if
    None. Stops when Open3D's convergence test holds or after
    ``max_iteration`` updates; each iteration reads the test's flag back to
    the host. Returns an unbatched :class:`ICPResult` whose
    ``transformation`` maps src -> tgt frame.
    """
    if init is None:
        init = torch.eye(4, device=src.device)
    init = init.float()[None]
    src, tgt, src_mask, tgt_mask = _prepare(
        src[None], tgt[None], init,
        None if src_mask is None else src_mask[None],
        None if tgt_mask is None else tgt_mask[None])
    step, converged, measure = _make_icp_fns(
        src, tgt, src_mask, tgt_mask, _f32_square(max_correspondence_distance),
        relative_fitness, relative_rmse, nn=nn_bounded_single)

    s = _init_icp_state(init)
    for _ in range(max_iteration):
        if bool(converged(s)[0]):  # the one host read per iteration
            break
        # One NN pass serves both the metrics at T_pending and the next update.
        T_new, fitness, rmse = step(s.T_pending)
        s = _State(s.T_pending, T_new, fitness, rmse, s.fitness, s.rmse, s.it + 1)
    return ICPResult(*(x[0] for x in _finish(s, converged, measure)))


def registration_icp_batched(
    src: torch.Tensor,
    tgt: torch.Tensor,
    max_correspondence_distance: float,
    init: Optional[torch.Tensor] = None,
    max_iteration: int = 30,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
    relative_fitness: float = 1e-6,
    relative_rmse: float = 1e-6,
) -> ICPResult:
    """Refine initial poses aligning ``src`` onto ``tgt``, batched: the
    JAX package's ``registration_icp_batched`` with ``chunk=None``.

    ``src``/``tgt`` ``(B, N, 3)``/``(B, M, 3)`` (padded, with masks),
    ``init`` ``(B, 4, 4)`` (identity if None). Every lane runs until the
    slowest converges or ``max_iteration``; converged lanes are frozen and
    skip their NN tiles. Returns a batched :class:`ICPResult`.
    """
    B = src.shape[0]
    if init is None:
        init = torch.eye(4, device=src.device).expand(B, 4, 4)
    init = init.float()
    src, tgt, src_mask, tgt_mask = _prepare(src, tgt, init, src_mask, tgt_mask)
    step, converged, measure = _make_icp_fns(
        src, tgt, src_mask, tgt_mask, _f32_square(max_correspondence_distance),
        relative_fitness, relative_rmse)

    s = _init_icp_state(init)
    for _ in range(max_iteration):
        alive = (s.it < max_iteration) & ~converged(s)
        # One NN pass serves both the metrics at T_pending and the next
        # update; dead lanes skip their tiles and keep their state.
        T_new, fitness, rmse = step(s.T_pending, dead=~alive)
        new = _State(s.T_pending, T_new, fitness, rmse, s.fitness, s.rmse,
                     s.it + 1)
        s = _State(*(torch.where(alive.reshape(-1, *([1] * (o.dim() - 1))), n, o)
                     for n, o in zip(new, s)))
    return _finish(s, converged, measure)


def icp_refine_if_better(
    src: torch.Tensor,
    tgt: torch.Tensor,
    init_T: torch.Tensor,
    gt_T: torch.Tensor,
    max_correspondence_distance: float,
    max_iteration: int = 30,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
):
    """Batched ICP refinement kept only where RE *and* TE both improve
    against ground truth (reference ``evaluate_3d_match.py:116-119``).
    Returns ``(T, re_deg, te)``."""
    re0, te0 = transformation_error(init_T, gt_T)
    result = registration_icp_batched(
        src, tgt, max_correspondence_distance, init=init_T,
        max_iteration=max_iteration, src_mask=src_mask, tgt_mask=tgt_mask)
    re1, te1 = transformation_error(result.transformation, gt_T)
    better = (re1 <= re0) & (te1 <= te0)
    T = torch.where(better[:, None, None], result.transformation, init_T)
    return T, torch.where(better, re1, re0), torch.where(better, te1, te0)
