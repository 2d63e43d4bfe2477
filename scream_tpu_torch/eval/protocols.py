"""Benchmark evaluation protocols: 3DMatch / 3DLoMatch / 3DZeroMatch,
KITTI and OpenGF (port of ``scream_tpu/eval/protocols.py``). Every protocol
detail is kept:

* reference ``evaluate_3d_match.py:53-195``: registration recall is redwood
  RMSE < 0.2; per-scene statistics count only pairs with frame-index gap
  > 1 (PREDATOR protocol); per-scene RRE/RTE is the median (3DMatch,
  3DLoMatch) or mean (3DZeroMatch) over ALL counted pairs, successes plus
  RE = TE = 0 for every failed counted pair (``:136-138``); the reported
  RRE/RTE/RR are means over the 8 test scenes. NN squared-distance
  threshold 0.1 (match / lo) or 0.2 with ``corr="src_pred"`` (zero); ICP
  distance 0.1.
* reference ``evaluate_kitti.py:20-111``: success iff RE <= 5 deg and
  TE <= 2 m; NN threshold 1.5, ICP threshold 1.0 and 1,000 iterations;
  items 124 and 142 skipped.
* reference ``evaluate_open_gf.py:44-76``: chamfer, height MAE and height
  MSE, all x1000.

The inner loop is ``register_batch`` on the device, the model a
:class:`~scream_tpu_torch.models.PointTransformer` (or ``DEMTransformer``)
on ``device``; this module keeps the host-side statistics. Batches are
staged on the device ahead of use (``prefetch_to_device``) and each
result's copy to the host starts as soon as its work is queued
(``fetch_async``), so that the next batch is queued before the host waits
on the last (:func:`_lag1`).

``mesh=`` (a bound ``parallel.Mesh``; every rank calls the protocol with the
same loader): each rank evaluates its rows of each batch with the model
broadcast from rank 0 and the kernels of a single process (the JAX package
sends the NN searches to XLA under a mesh only because GSPMD cannot
partition them); the per-pair results are gathered in batch order and
every rank aggregates them as the single-process path does, so the metrics
are the single process's. A batch that does not divide the data axis runs
whole on every rank.
"""

from __future__ import annotations

import warnings
from typing import Dict, Sequence

import numpy as np
import torch

from scream_tpu_torch.config import EvalConfig
from scream_tpu_torch.data.loader import prefetch_to_device
from scream_tpu_torch.geometry.metrics import chamfer_distance, height_mae, height_mse
from scream_tpu_torch.pipeline.register import (_register_solve_stage, register_batch,
                                                register_batch_requeue)
from scream_tpu_torch.utils.device import fetch_async, resolve_device

# Scene display names in scene-index order (reference evaluate_3d_match.py:61).
SCENE_NAMES = ["Kitchen", "Home_1", "Home_2", "Hotel_1", "Hotel_2", "Hotel_3",
               "Study", "MIT_Lab"]
# Host-only bookkeeping a batch carries: it stays numpy. "_cut" marks a
# batch cut to this rank's rows under a mesh.
_HOST_KEYS = ("idx", "scene", "_cut")


class SkipDataset:
    """Dataset view that drops the given indices: the KITTI evaluation skips
    items 124 and 142 (reference ``evaluate_kitti.py:31-34``)."""

    def __init__(self, dataset, skip: Sequence[int]):
        self._dataset = dataset
        skip = set(skip)
        self._index = [i for i in range(len(dataset)) if i not in skip]

    def __len__(self):
        return len(self._index)

    def __getitem__(self, i):
        return self._dataset[self._index[i]]

    def _unwrap(self, i):
        """Size-probe delegation (``data.loader._default_size_fn``)."""
        return self._dataset, self._index[i]


def _lag1(loader, dispatch):
    """Dispatch batch k+1 before the host waits for batch k's result, so
    the wait overlaps device work. Yields ``(result, batch)`` in order."""
    pending = None
    for batch in loader:
        out = dispatch(batch)
        if pending is not None:
            yield pending
        pending = (out, batch)
    if pending is not None:
        yield pending


def _staged(loader, device, mesh=None):
    return prefetch_to_device(_local_rows(loader, mesh), size=2, device=device,
                              skip=_HOST_KEYS)


def _local_rows(loader, mesh):
    """Each batch cut to this rank's rows where it divides the mesh's data
    axis (host bookkeeping stays whole), marked ``_cut``."""
    if mesh is None:
        yield from loader
        return
    n, i = mesh.axis_size("data"), mesh.coord("data")
    for batch in loader:
        b = next(v for k, v in batch.items() if k not in _HOST_KEYS).shape[0]
        if n == 1 or b % n:
            yield batch
            continue
        m = b // n
        out = {k: v if k in _HOST_KEYS else v[i * m:(i + 1) * m] for k, v in batch.items()}
        out["_cut"] = True
        yield out


def _gathered(result: dict, batch, mesh) -> dict:
    """A batch's per-pair host results of every data rank, concatenated in
    batch order (as they are where the batch was not cut)."""
    if not batch.get("_cut"):
        return result
    from scream_tpu_torch.parallel.mesh import gather_objects

    parts = gather_objects(result, mesh.group("data"))
    return {k: np.concatenate([p[k] for p in parts]) for k in result}


def _replicated(model, mesh):
    if mesh is not None:
        from scream_tpu_torch.parallel.mesh import replicate

        replicate(model, mesh)
    return model


def _metrics_fetch(m):
    """Start the host copy of a ``RegistrationMetrics``' RE, TE (and RMSE)."""
    out = {"re": m.re_deg, "te": m.te}
    if m.rmse is not None:
        out["rmse"] = m.rmse
    return fetch_async(out)


@torch.no_grad()
def evaluate_registration_per_scene(
    model,
    loader,
    dis_thresh: float = 0.1,
    corr: str = "tgt",
    icp_thresh: float = 0.1,
    icp_max_iter: int = 30,
    re_stat: str = "median",
    rmse_thresh: float = 0.2,
    center_mode: str = "trans",
    n_scenes: int = 8,
    device="cuda",
    mesh=None,
) -> Dict[str, float]:
    """The 3DMatch-family benchmark with per-scene aggregation. The loader's
    batches must carry ``idx``, ``covariance`` and ``scene``. Returns the
    overall and per-scene RR / RRE / RTE."""
    dev = resolve_device(device)
    _replicated(model, mesh)
    scene_re = [[] for _ in range(n_scenes)]
    scene_te = [[] for _ in range(n_scenes)]
    scene_success = np.zeros(n_scenes, dtype=np.int64)
    scene_valid = np.zeros(n_scenes, dtype=np.int64)
    total = 0
    success_total = 0
    sum_re, sum_te = 0.0, 0.0

    def dispatch(batch):
        return _metrics_fetch(register_batch(
            model, batch, dis_thresh=dis_thresh, corr=corr, icp_thresh=icp_thresh,
            icp_max_iter=icp_max_iter, center_mode=center_mode, device=dev))

    for fetch, batch in _lag1(_staged(loader, dev, mesh), dispatch):
        m = _gathered(fetch(), batch, mesh)
        if "rmse" not in m:
            raise ValueError(
                "the per-scene protocol scores pairs by redwood RMSE and needs the "
                "covariance sidecars in every batch: build the dataset with info "
                "sidecars (PairDataset(with_info=True))")
        re, te, rmse = m["re"], m["te"], m["rmse"]
        idx = np.asarray(batch["idx"])
        scene = np.asarray(batch["scene"])

        ok = rmse < rmse_thresh
        total += len(re)
        success_total += int(ok.sum())
        sum_re += float(re[ok].sum())
        sum_te += float(te[ok].sum())

        # PREDATOR protocol: per-scene stats only for |idx1 - idx0| > 1;
        # FAILED pairs append zeros so the per-scene statistic covers every
        # counted pair (reference evaluate_3d_match.py:128-138).
        gap = np.abs(idx[:, 1] - idx[:, 0]) > 1
        for i in range(len(re)):
            if not gap[i]:
                continue
            sc = int(scene[i])
            scene_valid[sc] += 1
            if ok[i]:
                scene_success[sc] += 1
                scene_re[sc].append(float(re[i]))
                scene_te[sc].append(float(te[i]))
            else:
                scene_re[sc].append(0.0)
                scene_te[sc].append(0.0)

    # Per-scene statistic over all counted pairs, then a plain mean over
    # the scenes (reference evaluate_3d_match.py:152-169), which always
    # divides by all 8: a scene without counted pairs means a truncated
    # split, so warn rather than quietly shrink the denominator.
    if int(np.count_nonzero(scene_valid)) == 0:
        raise ValueError(
            "no counted (idx gap>1) pairs in any scene: the split is empty or fully "
            "filtered, and the protocol metrics are undefined "
            "(reference evaluate_3d_match.py:128-138)")
    if int(np.count_nonzero(scene_valid)) != n_scenes:
        empty = [SCENE_NAMES[s] for s in range(n_scenes) if scene_valid[s] == 0]
        warnings.warn(
            f"scenes with no counted (gap>1) pairs: {empty}; the reference protocol "
            f"averages over all {n_scenes} scenes (evaluate_3d_match.py:152-169), the "
            "metrics below average the populated scenes only and are not comparable "
            "to full-split numbers (possibly a truncated download).")
    stat = np.median if re_stat == "median" else np.mean
    per_scene_rr, per_scene_re, per_scene_te = [], [], []
    for s in range(n_scenes):
        if scene_valid[s] == 0:
            continue
        per_scene_rr.append(scene_success[s] / scene_valid[s])
        per_scene_re.append(float(stat(scene_re[s])))
        per_scene_te.append(float(stat(scene_te[s])))

    out = {
        "registration_recall": float(np.mean(per_scene_rr)),
        "rre": float(np.mean(per_scene_re)),
        "rte": float(np.mean(per_scene_te)),
        "pair_recall": success_total / max(total, 1),
        "success_rre": sum_re / max(success_total, 1),
        "success_rte": sum_te / max(success_total, 1),
        "n_pairs": total,
    }
    for s in range(n_scenes):
        if scene_valid[s]:
            out[f"rr/{SCENE_NAMES[s]}"] = scene_success[s] / scene_valid[s]
    return out


def evaluate_registration(model, loader, cfg: EvalConfig, device="cuda",
                          mesh=None) -> Dict[str, float]:
    """Config-driven entry (what the CLI calls with ``eval_preset``): every
    :class:`EvalConfig` knob is honoured."""
    return evaluate_registration_per_scene(
        model, loader, dis_thresh=cfg.dis_thresh, corr=cfg.corr,
        icp_thresh=cfg.icp_thresh, icp_max_iter=cfg.icp_max_iter, re_stat=cfg.re_stat,
        rmse_thresh=cfg.rmse_thresh, center_mode=cfg.center_mode, device=device,
        mesh=mesh)


def evaluate_3d_match(model, loader, dis_thresh: float = 0.1, device="cuda"):
    """3DMatch: NN threshold 0.1, correspondences in tgt, median per-scene
    statistics (reference evaluate_3d_match.py:174-178)."""
    return evaluate_registration_per_scene(model, loader, dis_thresh=dis_thresh,
                                           corr="tgt", re_stat="median", device=device)


def evaluate_3d_lo_match(model, loader, dis_thresh: float = 0.1, device="cuda"):
    """3DLoMatch: the thresholds of 3DMatch (evaluate_3d_match.py:180-183)."""
    return evaluate_registration_per_scene(model, loader, dis_thresh=dis_thresh,
                                           corr="tgt", re_stat="median", device=device)


def evaluate_3d_zero_match(model, loader, dis_thresh: float = 0.2, device="cuda"):
    """3DZeroMatch: correspondences are src_pred itself, threshold 0.2, mean
    per-scene statistics (evaluate_3d_match.py:193-195)."""
    return evaluate_registration_per_scene(model, loader, dis_thresh=dis_thresh,
                                           corr="src_pred", re_stat="mean", device=device)


@torch.no_grad()
def evaluate_kitti(
    model,
    loader,
    dis_thresh: float = 1.5,
    icp_thresh: float = 1.0,
    icp_max_iter: int = 1000,
    success_re_deg: float = 5.0,
    success_te: float = 2.0,
    center_mode: str = "neg_rt",
    icp_chunk: int | None = None,
    device="cuda",
    mesh=None,
) -> Dict[str, float]:
    """KITTI success-rate protocol (reference ``evaluate_kitti.py:20-111``):
    build the loader over ``SkipDataset(dataset, (124, 142))`` for the
    reference's skipped items. ICP runs to ``max_iteration=1000`` (``:69``)
    and the model hint is ``-R^T t`` (``:39``).

    ``icp_chunk``: route each batch through :func:`register_batch_requeue`
    (chunked ICP, finished lanes retire; the same protocol numbers). Batch
    k+1's forward and pose solve are queued before batch k's chunks start
    reading the device from the host.
    """
    dev = resolve_device(device)
    _replicated(model, mesh)
    total = 0
    succ, succ_re, succ_te = 0, 0.0, 0.0

    def consume(m):
        nonlocal total, succ, succ_re, succ_te
        re, te = m["re"], m["te"]
        ok = (re <= success_re_deg) & (te <= success_te)
        total += len(re)
        succ += int(ok.sum())
        succ_re += float(re[ok].sum())
        succ_te += float(te[ok].sum())

    if icp_chunk is not None:
        def solve(batch):
            return _register_solve_stage(model, batch, dis_thresh, "tgt", center_mode)

        for pre, batch in _lag1(_staged(loader, dev, mesh), solve):
            consume(_gathered(_metrics_fetch(register_batch_requeue(
                model, batch, dis_thresh=dis_thresh, corr="tgt", icp_thresh=icp_thresh,
                icp_max_iter=icp_max_iter, icp_chunk=icp_chunk, center_mode=center_mode,
                device=dev, presolved=pre))(), batch, mesh))
    else:
        def dispatch(batch):
            return _metrics_fetch(register_batch(
                model, batch, dis_thresh=dis_thresh, corr="tgt", icp_thresh=icp_thresh,
                icp_max_iter=icp_max_iter, center_mode=center_mode, device=dev))

        for fetch, batch in _lag1(_staged(loader, dev, mesh), dispatch):
            consume(_gathered(fetch(), batch, mesh))
    return {
        "success_rate": succ / max(total, 1),
        "success_rre": succ_re / max(succ, 1),
        "success_rte": succ_te / max(succ, 1),
        "n_pairs": total,
    }


@torch.no_grad()
def evaluate_open_gf(model, loader, device="cuda", mesh=None) -> Dict[str, float]:
    """OpenGF DEM-generation metrics x1000 (reference
    ``evaluate_open_gf.py:44-76``): chamfer distance, height MAE and MSE of
    the model's DEM against the ground truth, averaged over patches."""
    dev = resolve_device(device)
    _replicated(model, mesh)
    tot_cd, tot_mae, tot_mse, n = 0.0, 0.0, 0.0, 0

    def dispatch(b):
        dem_pred = model(b["dsm"], b["dem_coarse"], b["dsm_mask"],
                         b["dem_coarse_mask"]).float()
        both = b["dsm_mask"] & b["dem_mask"]
        return fetch_async({
            "cd": chamfer_distance(dem_pred, b["dem"], b["dsm_mask"], b["dem_mask"]),
            "mae": height_mae(dem_pred, b["dem"], both),
            "mse": height_mse(dem_pred, b["dem"], both)})

    for fetch, batch in _lag1(_staged(loader, dev, mesh), dispatch):
        m = _gathered(fetch(), batch, mesh)
        tot_cd += float(m["cd"].sum())
        tot_mae += float(m["mae"].sum())
        tot_mse += float(m["mse"].sum())
        n += int(m["cd"].shape[0])
    return {
        "chamfer_x1000": tot_cd / max(n, 1) * 1000.0,
        "height_mae_x1000": tot_mae / max(n, 1) * 1000.0,
        "height_mse_x1000": tot_mse / max(n, 1) * 1000.0,
        "n_patches": n,
    }
