"""Point-to-point ICP (port of ``scream_tpu/geometry/icp.py``).

Two entry points, as in the JAX package:

* :func:`registration_icp` refines ONE pair, ``(N, 3)`` clouds and a
  ``(4, 4)`` init, and stops on Open3D's convergence test like the TPU's
  ``lax.while_loop``: a host loop reads one flag back from the device per
  iteration (the TPU evaluates the same test on the device), with the loop
  state, so that a loop caught in an exact cycle of states leaves at once
  with the result of running to ``max_iteration``. Its NN is the
  unbatched bounded kernel (``nn_cuda.nn_bounded_single``).
* :func:`registration_icp_batched` refines ``B`` pairs at once, the
  ``vmap``ped loop of the JAX package (its ``chunk=None`` path): all lanes
  step with a per-lane ``alive`` flag; a lane that converged or ran out of
  iterations is frozen with ``torch.where`` and passed to the batched
  bounded NN kernel as ``dead``, so its tiles cost nothing. Like the JAX
  ``while_loop``, which stops once no lane is left, the loop leaves when
  no lane is alive, read on the host once every :data:`EXIT_EVERY` steps
  (frozen lanes do not change, so the result is that of the loop that
  runs every step; a 30-step loop never reads it). With ``chunk=K`` it is
  the JAX package's chunked loop (``_icp_chunk`` / ``_icp_finalize``):
  the host advances the lanes K steps at a time, finishes the lanes that
  are done, and compacts the rest into a power-of-two lane count.

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

from scream_tpu_torch.geometry.kabsch import kabsch, weighted_point_sum
from scream_tpu_torch.geometry.metrics import transformation_error
from scream_tpu_torch.ops.nn_cuda import (mask_far, nn_bounded, nn_bounded_single,
                                          nn_tile_boxes)

# The batched loop reads "any lane alive?" on the host once every this many
# steps (KITTI's 1,000-step budget; the 30-step protocols never read it).
EXIT_EVERY = 32


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
        n_inlier = w.sum(-1)  # a count: exact in any order
        fitness = n_inlier / n_valid_src
        d_sum = weighted_point_sum(w, nn_dist[..., None])[..., 0, 0]
        rmse = torch.sqrt(d_sum / torch.clamp_min(n_inlier, 1.0))
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
    ``max_iteration`` updates; each iteration reads the test's flag and the
    loop state back to the host. A loop whose state repeats exactly is in a
    cycle that never converges; it is answered at once with the state the
    loop would hold after ``max_iteration`` updates (KITTI's GT refinement
    allows 50,000). Returns an unbatched :class:`ICPResult` whose
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

    def advance(s):
        # One NN pass serves both the metrics at T_pending and the next update.
        T_new, fitness, rmse = step(s.T_pending)
        return _State(s.T_pending, T_new, fitness, rmse, s.fitness, s.rmse, s.it + 1)

    s = _init_icp_state(init)
    seen = {}  # the loop state's bytes (all but `it`) -> the step it was seen at
    for n in range(max_iteration):
        # The one host read per iteration: the convergence flag and the state.
        host = torch.cat([converged(s).float(), *(x.reshape(-1) for x in s[:-1])]).cpu()
        if host[0]:
            break
        key = host.numpy().tobytes()
        if key in seen:
            # The state repeats: the loop is in a cycle of period n - seen[key]
            # whose every state failed the convergence test, so it runs to
            # max_iteration. Take the cycle's state at that step (the same
            # bits: each step is a deterministic function of the state).
            for _ in range((max_iteration - n) % (n - seen[key])):
                s = advance(s)
            s = s._replace(it=torch.full_like(s.it, max_iteration))
            break
        seen[key] = n
        s = advance(s)
    return ICPResult(*(x[0] for x in _finish(s, converged, measure)))


def _iterate(s: _State, step, converged, n_steps: int, limit: int) -> _State:
    """Up to ``n_steps`` steps of the lanes with ``it < limit`` that have not
    converged; the others keep their state and skip their NN tiles. Leaves
    early once no lane is alive, read every :data:`EXIT_EVERY` steps."""
    for k in range(n_steps):
        alive = (s.it < limit) & ~converged(s)
        if k and k % EXIT_EVERY == 0 and not bool(alive.any()):
            break
        # One NN pass serves both the metrics at T_pending and the next update.
        T_new, fitness, rmse = step(s.T_pending, dead=~alive)
        new = _State(s.T_pending, T_new, fitness, rmse, s.fitness, s.rmse, s.it + 1)
        s = _State(*(torch.where(alive.reshape(-1, *([1] * (o.dim() - 1))), n, o)
                     for n, o in zip(new, s)))
    return s


def _pow2_bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _pad_lanes(idx: np.ndarray) -> np.ndarray:
    """``idx`` padded to a power-of-two length with its first lane."""
    return np.concatenate([idx, np.repeat(idx[:1], _pow2_bucket(len(idx)) - len(idx))])


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
    chunk: Optional[int] = None,
) -> ICPResult:
    """Refine initial poses aligning ``src`` onto ``tgt``, batched (the JAX
    package's ``registration_icp_batched``).

    ``src``/``tgt`` ``(B, N, 3)``/``(B, M, 3)`` (padded, with masks),
    ``init`` ``(B, 4, 4)`` (identity if None). ``chunk=None``: every lane
    rides until the slowest converges or ``max_iteration``; converged lanes
    are frozen and skip their NN tiles. ``chunk=K``: the host advances the
    lanes K iterations at a time, finishes the lanes that converged, and
    compacts the survivors into the next power-of-two lane count (padded
    with the first survivor), rebuilding the dst tile boxes for each
    compacted set. The carried state keeps the continuous loop's iterates;
    a convergence delta within fp noise of the 1e-6 criteria may cost one
    extra iteration at the fixed point, with the same transform. Returns a
    batched :class:`ICPResult` in input lane order.
    """
    B = src.shape[0]
    if init is None:
        init = torch.eye(4, device=src.device).expand(B, 4, 4)
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    init = init.float()
    src, tgt, src_mask, tgt_mask = _prepare(src, tgt, init, src_mask, tgt_mask)
    thresh_sq = _f32_square(max_correspondence_distance)
    fns = lambda *clouds: _make_icp_fns(*clouds, thresh_sq, relative_fitness,
                                        relative_rmse)
    step, converged, measure = fns(src, tgt, src_mask, tgt_mask)
    s = _init_icp_state(init)
    if chunk is None:
        s = _iterate(s, step, converged, max_iteration, max_iteration)
        return _finish(s, converged, measure)

    dev = src.device
    out = ICPResult(torch.zeros((B, 4, 4), device=dev), torch.zeros((B,), device=dev),
                    torch.zeros((B,), device=dev),
                    torch.zeros((B,), dtype=torch.int32, device=dev))
    # Host bookkeeping: which input lanes the device lanes hold (a padded
    # power-of-two set whose first len(lanes) lanes are real).
    lanes = np.arange(B)
    clouds = (src, tgt, src_mask, tgt_mask)
    boundary = 0
    while len(lanes):
        start, boundary = boundary, min(boundary + chunk, max_iteration)
        s = _iterate(s, step, converged, boundary - start, boundary)
        done = (converged(s) | (s.it >= max_iteration))[:len(lanes)].cpu().numpy()
        if boundary >= max_iteration:
            done = np.ones_like(done)  # budget spent: finish every lane
        if not done.any():
            continue
        ret, keep = np.flatnonzero(done), np.flatnonzero(~done)
        sel = torch.as_tensor(_pad_lanes(ret), device=dev)
        _, r_conv, r_measure = fns(*(x[sel] for x in clouds))
        res = _finish(_State(*(x[sel] for x in s)), r_conv, r_measure)
        dst = torch.as_tensor(lanes[ret], device=dev)
        for o, r in zip(out, res):
            o[dst] = r[:len(ret)]
        lanes = lanes[keep]
        if len(lanes):
            sel = torch.as_tensor(_pad_lanes(keep), device=dev)
            clouds = tuple(x[sel] for x in clouds)
            s = _State(*(x[sel] for x in s))
            step, converged, measure = fns(*clouds)
    return out


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
