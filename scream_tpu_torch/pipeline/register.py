"""Registration pipelines (port of ``scream_tpu/pipeline/register.py``;
reference ``evaluate_3d_match.py:53-171``).

* :func:`register_batch`: the protocol path over a padded batch with GT,
  forward -> pose solve -> ICP kept iff better -> metrics;
  :func:`register_batch_requeue` the same with chunked ICP whose finished
  lanes retire between chunks (KITTI's 1,000-iteration budget).
* GT-free serving, "align these two scans": :func:`register_pair` (one
  pair, the single-pair ICP with Open3D's early exit), :func:`register_pairs`
  (a stream of pairs, batched forward and batched ICP),
  :func:`register_pair_robust` / :func:`register_pairs_robust` (multi-start
  search for large unknown poses, post-polish fitness ranking with
  ``score_margin`` and ``ambiguous``). They take a :class:`PointTransformer`
  and raw numpy clouds; normalization uses the union of the clouds as given
  and the model its masked-centroid ``src_center``.

Protocol details kept from the JAX package, each load-bearing:

* the NN validity threshold applies to **squared** distances of the
  de-scaled but not de-centred clouds ``src_pred/s`` vs ``tgt/s``
  (reference ``:94-96``);
* Kabsch runs in the fully de-normalized frame ``x/s + c`` (``:97-101``);
* zero-overlap mode ("src_pred") pairs ``src`` with ``src_pred`` itself;
* the GT pose is re-derived in the de-normalized frame as
  ``[R | t/s + c - R c]`` (``:90``);
* ICP (threshold 0.1, 30 iterations) is kept only if RE *and* TE both
  improve (``:109-119``); GT-free, there is no GT to gate on and ICP is
  always accepted.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from scream_tpu_torch.data.batching import pad_cloud
from scream_tpu_torch.geometry.icp import (icp_refine_if_better,
                                           registration_icp,
                                           registration_icp_batched)
from scream_tpu_torch.geometry.kabsch import kabsch
from scream_tpu_torch.geometry.metrics import (registration_recall_rmse,
                                               transformation_error)
from scream_tpu_torch.ops.nn_cuda import nearest_neighbor_full
from scream_tpu_torch.utils.device import resolve_device


def _default_capacity(n: int) -> int:
    """Round ``n`` up to the padding-bucket ladder of the trainers (256,
    512, ..., 16384), then to 256-multiples above it."""
    for b in (256, 512, 1024, 2048, 4096, 8192, 16384):
        if n <= b:
            return b
    return (n + 255) // 256 * 256


class PoseSolution(NamedTuple):
    transform: torch.Tensor  # (B, 4, 4) in the de-normalized frame
    n_corr: torch.Tensor  # (B,) number of valid correspondences


class RegistrationMetrics(NamedTuple):
    transform: torch.Tensor  # (B, 4, 4)
    re_deg: torch.Tensor  # (B,)
    te: torch.Tensor  # (B,)
    n_corr: torch.Tensor  # (B,)
    rmse: Optional[torch.Tensor] = None  # (B,) redwood RMSE when covariance given


def spread_subsample_indices(n: int, k: int) -> np.ndarray:
    """``k`` evenly spaced indices into ``range(n)``: ``floor(i * n / k)``,
    so a ``k`` that does not divide ``n`` still spans the whole cloud."""
    return np.floor(np.arange(k) * (n / k)).astype(np.int32)


@lru_cache(maxsize=16)
def _subsample_index(n: int, k: int, device: torch.device) -> torch.Tensor:
    """:func:`spread_subsample_indices` as a long tensor on ``device``, made
    once: a copy from the host per batch would make the host wait."""
    return torch.as_tensor(spread_subsample_indices(n, k), dtype=torch.long, device=device)


def _icp_view(src_dn, src_mask, icp_subsample: Optional[int]):
    """The ICP source: all points, or ``icp_subsample`` evenly spaced ones
    (throughput mode; the reference refines on all points)."""
    if icp_subsample is None or icp_subsample >= src_dn.shape[1]:
        return src_dn, src_mask
    idx = _subsample_index(src_dn.shape[1], icp_subsample, src_dn.device)
    return src_dn[:, idx], src_mask[:, idx]


def denormalized_gt(rot, trans, scale, center) -> torch.Tensor:
    """GT pose in the de-normalized frame: ``[R | t/s + c - R c]``
    (reference ``evaluate_3d_match.py:90``)."""
    t = trans.reshape(*trans.shape[:-2], 3) / scale[..., None]
    t = t + center - torch.einsum("...ij,...j->...i", rot, center)
    T = torch.zeros(*rot.shape[:-2], 4, 4, dtype=torch.float32, device=rot.device)
    T[..., :3, :3] = rot
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def solve_pose(src, src_pred, tgt, src_mask, tgt_mask, scale, center,
               dis_thresh: float = 0.1, corr: str = "tgt") -> PoseSolution:
    """Batched rigid pose from the predicted source cloud: exact NN of
    ``src_pred/s`` in ``tgt/s``, inliers below ``dis_thresh`` (squared),
    weighted Kabsch in the de-normalized frame. ``corr="src_pred"`` pairs
    src with src_pred directly (ZeroMatch)."""
    inv_s = (1.0 / scale)[:, None, None]
    nn_d2, _, nn_xyz = nearest_neighbor_full(src_pred * inv_s, tgt * inv_s, tgt_mask)
    valid = (nn_d2 < dis_thresh) & src_mask

    src_dn = src * inv_s + center[:, None, :]
    if corr == "tgt":
        # nn_xyz is already de-scaled (the search saw tgt/s).
        partner = nn_xyz + center[:, None, :]
    elif corr == "src_pred":
        partner = src_pred * inv_s + center[:, None, :]
    else:
        raise ValueError(f"unknown corr mode {corr!r}")

    T = kabsch(src_dn, partner, weights=valid.float())
    return PoseSolution(T, valid.sum(-1))


def in_forward_transform(src, src_pred, filt, src_mask, filt_mask, scale,
                         dis_thresh: float = 0.075) -> torch.Tensor:
    """The training-time pose estimate in the *normalized* frame (reference
    ``models/pointnet.py:67-74``): exact NN of ``src_pred/s`` in ``filt/s``
    (the GT-aligned source), valid iff the squared distance is below
    ``dis_thresh``, then Kabsch of ``src[valid]`` onto the winners scaled
    back by ``s``. Returns ``(B, 4, 4)``."""
    inv_s = (1.0 / scale)[:, None, None]
    nn_d2, _, nn_xyz = nearest_neighbor_full(src_pred * inv_s, filt * inv_s, filt_mask)
    valid = (nn_d2 < dis_thresh) & src_mask
    partner = nn_xyz * scale[:, None, None]
    return kabsch(src, partner, weights=valid.float())


def gt_aligned_src(src, rot, trans):
    """The source under its GT transform, ``R src + t`` ``(B, N, 3)``: the
    point loss's target and what the discriminator step renders as real."""
    return torch.einsum("bij,bnj->bni", rot, src) + trans.transpose(-1, -2)


def gt_center_hint(rot, trans, mode: str = "trans"):
    """The GT-derived ``src_center`` hint the protocols feed the model,
    ``(B, 1, 3)``: ``t`` for 3DMatch (``"trans"``, reference
    ``evaluate_3d_match.py:84``), ``-R^T t`` for KITTI (``"neg_rt"``,
    ``evaluate_kitti.py:39``), None for the model's masked centroid."""
    if mode == "none":
        return None
    if mode == "trans":
        return trans.transpose(-1, -2)
    if mode == "neg_rt":
        return -torch.einsum("bji,bjk->bik", rot, trans).transpose(-1, -2)
    raise ValueError(f"unknown center mode {mode!r}")


def _register_solve_stage(model, batch, dis_thresh, corr, center_mode):
    """Forward + pose solve + de-normalization (the pre-ICP prefix)."""
    src, tgt = batch["src"], batch["tgt"]
    src_mask, tgt_mask = batch["src_mask"], batch["tgt_mask"]
    rot, trans = batch["rot"], batch["trans"]
    scale, center = batch["scale"], batch["center"]

    src_center = gt_center_hint(rot, trans, center_mode)
    src_pred = model(src, tgt, src_mask, tgt_mask, src_center)
    sol = solve_pose(src, src_pred.float(), tgt, src_mask, tgt_mask, scale,
                     center, dis_thresh, corr)
    gt_T = denormalized_gt(rot, trans, scale, center)
    inv_s = (1.0 / scale)[:, None, None]
    src_dn = src * inv_s + center[:, None, :]
    tgt_dn = tgt * inv_s + center[:, None, :]
    return sol, gt_T, src_dn, tgt_dn


# The batch keys register_batch reads; host-only bookkeeping (idx, scene)
# stays behind.
BATCH_KEYS = ("src", "tgt", "src_mask", "tgt_mask", "rot", "trans", "scale", "center",
              "covariance")


def to_device(batch: Dict, device, keys: Optional[Sequence[str]] = None
              ) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy arrays or tensors) as tensors on ``device``:
    every key, or those of ``keys`` that it has. A tensor already there is
    not copied."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()
            if keys is None or k in keys}


def _icp_refine_batch(src_dn, tgt_dn, src_mask, tgt_mask, init_T, gt_T, icp_thresh,
                      icp_max_iter):
    """Batched ICP kept iff RE and TE both improve (the one implementation
    is ``geometry.icp.icp_refine_if_better``)."""
    return icp_refine_if_better(src_dn, tgt_dn, init_T, gt_T, icp_thresh,
                                max_iteration=icp_max_iter, src_mask=src_mask,
                                tgt_mask=tgt_mask)


def _accept_if_better(init_T, refined_T, gt_T):
    """Batched keep-iff-both-improve acceptance (reference
    ``evaluate_kitti.py:74-77``, ``evaluate_3d_match.py:116-119``): returns
    ``(T, re_deg, te)``."""
    re0, te0 = transformation_error(init_T, gt_T)
    re1, te1 = transformation_error(refined_T, gt_T)
    better = (re1 <= re0) & (te1 <= te0)
    T = torch.where(better[:, None, None], refined_T, init_T)
    return T, torch.where(better, re1, re0), torch.where(better, te1, te0)


@torch.no_grad()
def register_batch(
    model: Callable,
    batch: Dict,
    dis_thresh: float = 0.1,
    corr: str = "tgt",
    icp_thresh: float = 0.1,
    icp_max_iter: int = 30,
    use_icp: bool = True,
    icp_subsample: Optional[int] = None,
    center_mode: str = "trans",
    device="cuda",
) -> RegistrationMetrics:
    """Full eval step for one padded batch: forward, solve, refine, measure.

    ``batch`` uses the loader schema (src/tgt/masks/rot/trans/scale/center,
    optional covariance), as numpy arrays or tensors; it is moved to
    ``device``. ``model(src, tgt, src_mask, tgt_mask, src_center)`` returns
    ``src_pred`` (a :class:`PointTransformer` on ``device``). As in the
    reference protocol, ``src_center`` is the GT-derived hint.

    ``icp_subsample=k`` refines on ``k`` evenly spaced src points
    (throughput mode; the reference refines on all points).
    """
    dev = resolve_device(device)
    batch = to_device(batch, dev, BATCH_KEYS)
    src_mask, tgt_mask = batch["src_mask"], batch["tgt_mask"]
    sol, gt_T, src_dn, tgt_dn = _register_solve_stage(
        model, batch, dis_thresh, corr, center_mode)

    if use_icp:
        icp_src, icp_src_mask = _icp_view(src_dn, src_mask, icp_subsample)
        T, re, te = _icp_refine_batch(icp_src, tgt_dn, icp_src_mask, tgt_mask,
                                      sol.transform, gt_T, icp_thresh, icp_max_iter)
    else:
        T = sol.transform
        re, te = transformation_error(T, gt_T)

    rmse = None
    if "covariance" in batch:
        rmse = registration_recall_rmse(T, gt_T, batch["covariance"])
    return RegistrationMetrics(T, re, te, sol.n_corr, rmse)


@torch.no_grad()
def register_batch_requeue(
    model: Callable,
    batch: Dict,
    dis_thresh: float = 0.1,
    corr: str = "tgt",
    icp_thresh: float = 0.1,
    icp_max_iter: int = 30,
    icp_chunk: int = 50,
    icp_subsample: Optional[int] = None,
    center_mode: str = "trans",
    device="cuda",
    presolved=None,
) -> RegistrationMetrics:
    """:func:`register_batch` with chunked ICP
    (``registration_icp_batched(chunk=icp_chunk)``): lanes advance
    ``icp_chunk`` iterations at a time and the converged ones retire, so
    one straggler does not hold the batch to KITTI's 1,000 iterations.
    The iterates, the acceptance and the metrics are those of
    :func:`register_batch`. The chunk boundaries read the device from the
    host; a caller that streams batches passes the next batch's
    :func:`_register_solve_stage` (launched before this batch's chunks) as
    ``presolved``, so the device has the next forward queued meanwhile.
    """
    dev = resolve_device(device)
    batch = to_device(batch, dev, BATCH_KEYS)
    if presolved is None:
        presolved = _register_solve_stage(model, batch, dis_thresh, corr, center_mode)
    sol, gt_T, src_dn, tgt_dn = presolved
    icp_src, icp_src_mask = _icp_view(src_dn, batch["src_mask"], icp_subsample)
    res = registration_icp_batched(icp_src, tgt_dn, icp_thresh, init=sol.transform,
                                   max_iteration=icp_max_iter, src_mask=icp_src_mask,
                                   tgt_mask=batch["tgt_mask"], chunk=icp_chunk)
    T, re, te = _accept_if_better(sol.transform, res.transformation, gt_T)
    rmse = None
    if "covariance" in batch:
        rmse = registration_recall_rmse(T, gt_T, batch["covariance"])
    return RegistrationMetrics(T, re, te, sol.n_corr, rmse)


class PairRegistration(NamedTuple):
    transform: np.ndarray  # (4, 4) mapping src points into the tgt frame
    fitness: float  # ICP inlier fraction of src points
    inlier_rmse: float  # ICP inlier RMSE (same units as the input clouds)
    n_corr: int  # correspondences behind the initial Kabsch solve
    # Ambiguity channel (robust path only; NaN/False elsewhere): the best
    # post-polish fitness among lanes whose pose is DISTINCT from the
    # winner's, score_margin = (fitness - runner_up) / fitness, and
    # ``ambiguous`` when the margin lies inside the near-symmetry band.
    runner_up_fitness: float = float("nan")
    score_margin: float = float("nan")
    ambiguous: bool = False


def _normalize_union(src: np.ndarray, tgt: np.ndarray, normalize: str):
    """GT-free union normalization ``(c, s)``, points mapping as
    ``s * (x - c)``: unit_sphere is the 3DMatch loader's centroid + max
    radius (reference ``datasets/three_d_match.py:183-190``), unit_cube the
    KITTI one (bbox centre + 2 / max extent); 1e-12 clamps guard degenerate
    clouds. :func:`register_pair` and :func:`register_pairs` share it."""
    union = np.concatenate([src, tgt], axis=0)
    if normalize == "unit_sphere":
        c = union.mean(axis=0)
        s = 1.0 / max(float(np.max(np.linalg.norm(union - c, axis=1))), 1e-12)
    elif normalize == "unit_cube":
        lo, hi = union.min(axis=0), union.max(axis=0)
        c = (lo + hi) / 2.0
        s = 2.0 / max(float(np.max(hi - lo)), 1e-12)
    else:
        raise ValueError(f"unknown normalize mode {normalize!r}")
    return c.astype(np.float32), np.float32(s)


def _normalized_batch(pairs, normalize: str, cap: int, dev) -> Dict[str, torch.Tensor]:
    """Pairs ``(src, tgt)`` as given -> a padded GT-free batch on ``dev``
    (src/tgt/masks in each pair's union-normalized frame, its scale and
    centre)."""
    cols = {k: [] for k in ("src", "src_mask", "tgt", "tgt_mask", "scale", "center")}
    for src, tgt in pairs:
        c, s = _normalize_union(src, tgt, normalize)
        sp, sm = pad_cloud((s * (src - c)).astype(np.float32), cap)
        tp, tm = pad_cloud((s * (tgt - c)).astype(np.float32), cap)
        for k, v in zip(cols, (sp, sm, tp, tm, s, c)):
            cols[k].append(v)
    return {k: torch.as_tensor(np.stack(v)).to(dev) for k, v in cols.items()}


def _gt_free_solve(model, b, dis_thresh, corr):
    """Forward without a GT hint (the model's masked-centroid src_center),
    pose solve, and the de-normalized clouds for ICP."""
    src_pred = model(b["src"], b["tgt"], b["src_mask"], b["tgt_mask"], None).float()
    sol = solve_pose(b["src"], src_pred, b["tgt"], b["src_mask"], b["tgt_mask"],
                     b["scale"], b["center"], dis_thresh, corr)
    inv_s = (1.0 / b["scale"])[:, None, None]
    src_dn = b["src"] * inv_s + b["center"][:, None, :]
    tgt_dn = b["tgt"] * inv_s + b["center"][:, None, :]
    return sol, src_dn, tgt_dn


def _better(new: PairRegistration, old: PairRegistration) -> bool:
    """The passes gate: keep iff ICP fitness does not drop, RMSE breaking ties."""
    return new.fitness > old.fitness or (
        new.fitness == old.fitness and new.inlier_rmse < old.inlier_rmse)


@torch.no_grad()
def _register_pair_once(model, src, tgt, normalize, dis_thresh, corr,
                        icp_thresh, icp_max_iter, capacity, dev
                        ) -> PairRegistration:
    """One GT-free pass: normalize as given, forward, Kabsch, single-pair ICP."""
    cap = capacity or _default_capacity(max(len(src), len(tgt)))
    b = _normalized_batch([(src, tgt)], normalize, cap, dev)
    sol, src_dn, tgt_dn = _gt_free_solve(model, b, dis_thresh, corr)
    res = registration_icp(src_dn[0], tgt_dn[0], icp_thresh, init=sol.transform[0],
                           max_iteration=icp_max_iter, src_mask=b["src_mask"][0],
                           tgt_mask=b["tgt_mask"][0])
    return PairRegistration(
        transform=res.transformation.cpu().numpy(),
        fitness=float(res.fitness),
        inlier_rmse=float(res.inlier_rmse),
        n_corr=int(sol.n_corr[0]),
    )


def register_pair(
    model: Callable,
    src: np.ndarray,
    tgt: np.ndarray,
    normalize: str = "unit_sphere",
    dis_thresh: float = 0.1,
    corr: str = "tgt",
    icp_thresh: float = 0.1,
    icp_max_iter: int = 30,
    capacity: Optional[int] = None,
    passes: int = 2,
    device="cuda",
) -> PairRegistration:
    """GT-FREE registration of two raw clouds ``(N, 3)`` / ``(M, 3)``.

    Normalization uses the union of the clouds as given, the model its
    masked-centroid ``src_center`` (no GT hint: use a checkpoint trained
    with ``center_mode="none"``, such as the shipped hint-free one), and
    ICP from the Kabsch initialization is always accepted. ``passes``:
    pass 1 registers the raw clouds; each later pass re-runs on the source
    aligned by the accumulated transform and composes; a pass is kept only
    if ICP fitness does not drop, and the loop stops at the first rejected
    pass. ``capacity`` pads both clouds (default: the bucket ladder).
    ``model`` is a :class:`PointTransformer` on ``device``.

    Returns a :class:`PairRegistration`; ``transform`` is in the ORIGINAL
    input frame (apply as ``src @ R.T + t``).
    """
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    dev = resolve_device(device)
    src = np.asarray(src, np.float32)
    tgt = np.asarray(tgt, np.float32)

    best: Optional[PairRegistration] = None
    cur_src = src
    for _ in range(passes):
        res = _register_pair_once(model, cur_src, tgt, normalize, dis_thresh,
                                  corr, icp_thresh, icp_max_iter, capacity, dev)
        if best is not None:
            # res.transform maps the ALIGNED source: compose back first.
            res = res._replace(transform=res.transform @ best.transform)
            if not _better(res, best):
                break
        best = res
        R, t = best.transform[:3, :3], best.transform[:3, 3]
        cur_src = (src @ R.T + t).astype(np.float32)
    return best


@torch.no_grad()
def _register_pairs_batch(model, b, dis_thresh, corr, icp_thresh, icp_max_iter):
    """Batched GT-free forward + solve + always-accepted batched ICP."""
    sol, src_dn, tgt_dn = _gt_free_solve(model, b, dis_thresh, corr)
    res = registration_icp_batched(src_dn, tgt_dn, icp_thresh, init=sol.transform,
                                   max_iteration=icp_max_iter,
                                   src_mask=b["src_mask"], tgt_mask=b["tgt_mask"])
    return res.transformation, res.fitness, res.inlier_rmse, sol.n_corr


def register_pairs(
    model: Callable,
    pairs,
    normalize: str = "unit_sphere",
    dis_thresh: float = 0.1,
    corr: str = "tgt",
    icp_thresh: float = 0.1,
    icp_max_iter: int = 30,
    capacity: Optional[int] = None,
    batch_size: int = 8,
    passes: int = 1,
    device="cuda",
) -> list:
    """GT-free registration of MANY raw ``(src, tgt)`` pairs, the serving
    path: ``batch_size`` pairs per forward and per batched ICP, the
    trailing batch padded with its last pair. Per pair, the semantics of
    :func:`register_pair` at the same ``passes`` (a rejected pass freezes
    that pair). ``capacity`` defaults to the longest cloud on the bucket
    ladder. Returns :class:`PairRegistration` s in input order, transforms
    in each pair's original frame.
    """
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    dev = resolve_device(device)
    pairs = [(np.asarray(s, np.float32), np.asarray(t, np.float32)) for s, t in pairs]
    if not pairs:
        return []
    cap = capacity or _default_capacity(max(max(len(s), len(t)) for s, t in pairs))

    def one_pass(srcs):
        items = [(s, t) for s, (_, t) in zip(srcs, pairs)]
        out = []
        for lo in range(0, len(items), batch_size):
            chunk = items[lo:lo + batch_size]
            n_real = len(chunk)
            chunk += [chunk[-1]] * (batch_size - n_real)
            b = _normalized_batch(chunk, normalize, cap, dev)
            T, fit, rmse, n_corr = (x.cpu().numpy() for x in _register_pairs_batch(
                model, b, dis_thresh, corr, icp_thresh, icp_max_iter))
            out += [PairRegistration(transform=T[k], fitness=float(fit[k]),
                                     inlier_rmse=float(rmse[k]), n_corr=int(n_corr[k]))
                    for k in range(n_real)]
        return out

    best = one_pass([s for s, _ in pairs])
    frozen = [False] * len(pairs)
    for _ in range(passes - 1):
        if all(frozen):
            break
        cur = [(pairs[i][0] @ best[i].transform[:3, :3].T
                + best[i].transform[:3, 3]).astype(np.float32)
               for i in range(len(pairs))]
        for i, r in enumerate(one_pass(cur)):
            if frozen[i]:
                continue
            composed = r._replace(transform=r.transform @ best[i].transform)
            if _better(composed, best[i]):
                best[i] = composed
            else:
                frozen[i] = True
    return best


def _rotation_starts(kind: str = "axis7") -> list:
    """Rotation seeds of the multi-start robust search (worst / median
    residual rotation over random SO(3) poses): ``"axis7"`` identity + the
    six 90-degree axis rotations (129 / 69 deg); ``"oct24"`` the chiral
    octahedral group (62 / 42); ``"ico60"`` the chiral icosahedral group,
    scipy ``Rotation.create_group("I")`` (44 / 31)."""
    starts = [np.eye(3, dtype=np.float32)]
    for axis in range(3):
        for sign in (1.0, -1.0):
            R = np.zeros((3, 3), dtype=np.float32)
            i, j = [(1, 2), (2, 0), (0, 1)][axis]
            R[axis, axis] = 1.0
            R[i, j] = -sign
            R[j, i] = sign
            starts.append(R)
    if kind == "axis7":
        return starts
    if kind == "ico60":
        from scipy.spatial.transform import Rotation

        return [np.asarray(R, np.float32)
                for R in Rotation.create_group("I").as_matrix()]
    if kind != "oct24":
        raise ValueError(f"unknown rotation-start set {kind!r} "
                         "(expected axis7, oct24 or ico60)")
    import itertools

    out = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1.0, -1.0), repeat=3):
            R = np.zeros((3, 3), dtype=np.float32)
            for row, (col, s) in enumerate(zip(perm, signs)):
                R[row, col] = s
            if np.linalg.det(R) > 0.5:
                out.append(R)
    return out


def register_pair_robust(
    model: Callable,
    src: np.ndarray,
    tgt: np.ndarray,
    normalize: str = "unit_sphere",
    dis_thresh: float = 0.1,
    corr: str = "tgt",
    icp_thresh: float = 0.1,
    icp_max_iter: int = 30,
    capacity: Optional[int] = None,
    final_icp_max_iter: int = 100,
    starts: str = "axis7",
    device="cuda",
) -> PairRegistration:
    """GT-free registration hardened for LARGE unknown poses: the one-pair
    case of :func:`register_pairs_robust` (never fork the two)."""
    return register_pairs_robust(
        model, [(src, tgt)], normalize=normalize, dis_thresh=dis_thresh,
        corr=corr, icp_thresh=icp_thresh, icp_max_iter=icp_max_iter,
        capacity=capacity, final_icp_max_iter=final_icp_max_iter,
        starts=starts, device=device)[0]


def register_pairs_robust(
    model: Callable,
    pairs: Sequence,
    normalize: str = "unit_sphere",
    dis_thresh: float = 0.1,
    corr: str = "tgt",
    icp_thresh: float = 0.1,
    icp_max_iter: int = 30,
    capacity: Optional[int] = None,
    final_icp_max_iter: int = 100,
    starts: str = "axis7",
    batch_size: Optional[int] = None,
    ambiguity_band: float = 0.05,
    device="cuda",
    return_lanes: bool = False,
):
    """Multi-start robust search over MANY pairs (``register --robust``).

    1. Lanes ``pairs x seeds``, each seed rotation taken about its pair's
       source centroid (:func:`_rotation_starts`).
    2. Per lane, one :func:`register_pairs` pass at ``3 * icp_thresh``, then
       two at ``icp_thresh``, the second kept iff it does not lower the
       lane's fitness.
    3. Per pair, the S model lanes plus S centroid-matched raw seeds go
       through one batched ICP ladder (3x radius 30 it, radius 30 it,
       half radius ``final_icp_max_iter``) and are ranked by POST-polish
       fitness (ties: lower RMSE). ``score_margin`` compares the winner
       with the best lane whose pose is distinct (> 30 deg or a translation
       gap beyond ``icp_thresh``); ``ambiguous`` when it is below
       ``ambiguity_band``.

    ``batch_size`` defaults to whole seed groups, capped near 120 lanes.
    Returns :class:`PairRegistration` s in input order; with
    ``return_lanes=True``, ``(results, lanes)``, where ``lanes[p]`` lists the
    (post-polish fitness, polished transform) of every candidate lane of
    pair p (a diagnostic: no lane in the basin, or the ranking chose a
    wrong one).
    """
    dev = resolve_device(device)
    pairs = [(np.asarray(s, np.float32), np.asarray(t, np.float32)) for s, t in pairs]
    if not pairs:
        return []
    seeds = _rotation_starts(starts)
    S, P = len(seeds), len(pairs)
    tight = icp_thresh / 2.0
    bs = batch_size or S * min(P, max(1, 120 // S))

    # Lane p * S + k carries pair p under seed k, about its source centroid.
    Ts = []
    for src, _ in pairs:
        c0 = src.mean(axis=0)
        for R0 in seeds:
            T0 = np.eye(4, dtype=np.float32)
            T0[:3, :3] = R0
            T0[:3, 3] = c0 - R0 @ c0
            Ts.append(T0)

    def batched_pass(Ts, thr):
        cur = [(pairs[i // S][0] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
               for i, T in enumerate(Ts)]
        res = register_pairs(
            model, [(c, pairs[i // S][1]) for i, c in enumerate(cur)],
            normalize=normalize, dis_thresh=dis_thresh, corr=corr,
            icp_thresh=thr, icp_max_iter=icp_max_iter, capacity=capacity,
            batch_size=bs, device=dev)
        return [r.transform @ T for r, T in zip(res, Ts)], res

    Ts, _ = batched_pass(Ts, 3.0 * icp_thresh)
    Ts, res1 = batched_pass(Ts, icp_thresh)
    Ts2, res2 = batched_pass(Ts, icp_thresh)
    lanes = [(T2, r2.n_corr) if _better(r2, r1) else (T1, r1.n_corr)
             for T1, r1, T2, r2 in zip(Ts, res1, Ts2, res2)]

    out, lane_diag = [], []
    for p, (src, tgt) in enumerate(pairs):
        pls = lanes[p * S:(p + 1) * S]
        cap = capacity or _default_capacity(max(len(src), len(tgt)))
        src_p, src_m = pad_cloud(src, cap)
        tgt_p, tgt_m = pad_cloud(tgt, cap)
        c0, c1 = src.mean(axis=0), tgt.mean(axis=0)
        cands = [T for T, _ in pls]
        for R0 in seeds:  # centroid-matched raw seeds: a pure-geometry lane
            T0 = np.eye(4, dtype=np.float32)
            T0[:3, :3] = R0
            T0[:3, 3] = c1 - R0 @ c0
            cands.append(T0)
        C = len(cands)
        lane = lambda a: torch.as_tensor(a).to(dev).expand(C, *a.shape)
        init = torch.as_tensor(np.stack(cands)).to(dev)
        for thr, it in ((3.0 * icp_thresh, 30), (icp_thresh, 30),
                        (tight, final_icp_max_iter)):
            fin = registration_icp_batched(
                lane(src_p), lane(tgt_p), thr, init=init, max_iteration=it,
                src_mask=lane(src_m), tgt_mask=lane(tgt_m))
            init = fin.transformation
        fit = fin.fitness.cpu().numpy()
        rmse = fin.inlier_rmse.cpu().numpy()
        Tfin = fin.transformation.cpu().numpy()
        k_best = int(np.lexsort((rmse, -fit))[0])
        # Distinct lanes: rotation > 30 deg from the winner or a translation
        # gap beyond the ICP radius (lanes that polished into the winner's
        # basin are duplicates, not competitors).
        Rb = Tfin[k_best, :3, :3]
        tr = np.einsum("ij,kij->k", Rb, Tfin[:, :3, :3])  # trace(Rb^T Rk)
        ang = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
        t_gap = np.linalg.norm(Tfin[:, :3, 3] - Tfin[k_best, :3, 3], axis=-1)
        distinct = (ang > 30.0) | (t_gap > icp_thresh)
        distinct[k_best] = False
        f_best = float(fit[k_best])
        if distinct.any() and f_best > 0.0:
            runner = float(fit[distinct].max())
            margin = (f_best - runner) / f_best
        elif f_best > 0.0:
            runner, margin = 0.0, 1.0  # every lane agrees with the winner
        else:
            runner, margin = 0.0, 0.0  # nothing locked anywhere
        out.append(PairRegistration(
            transform=Tfin[k_best], fitness=f_best, inlier_rmse=float(rmse[k_best]),
            n_corr=int(pls[min(k_best, S - 1)][1]), runner_up_fitness=runner,
            score_margin=margin, ambiguous=bool(margin < ambiguity_band)))
        lane_diag.append([(float(fit[k]), Tfin[k]) for k in range(C)])
    return (out, lane_diag) if return_lanes else out
