"""Offline preprocessors (port of ``scream_tpu/data/preprocess.py``): raw
pairs -> the ``.npy`` artifact layout that ``PairDataset`` and
``OpenGFDataset`` read.

Re-implements the behavior of the reference's ``process_3d_match.py``,
``process_kitti.py`` and ``process_open_gf.py`` without Open3D: voxel
downsampling and radius searches run in the port's native library
(``scream_tpu_torch/native``, the same C++ as the JAX package's, so the
3DMatch and OpenGF artifacts are the JAX package's bit for bit), and the
KITTI GT refinement runs the port's ICP on ``device``.

Split rules (all from the reference):
  * train: every pair; pairs with overlap <= 0.3 additionally emit a
    de-overlapped ("zero overlap") copy (``process_3d_match.py:43-47``),
  * 3DMatch test: keep overlap > 0.3 (``:125``),
  * 3DLoMatch test: keep overlap > 0.1 (``:166``),
  * 3DZeroMatch test: de-overlapped copies of overlap <= 0.3 pairs (``:173-177``),
  * voxel sizes: 3DMatch 0.0625, KITTI 0.7 (``process_3d_match.py:30``,
    ``process_kitti.py:55``).

The QA helpers (``check_saved_pairs``, ``check_opengf_test``) return the
JAX module's stats and draw their PNGs with matplotlib, imported only when
a PNG is asked for.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from scream_tpu_torch.native import (highest_in_radius_2d, radius_has_neighbor,
                                     voxel_downsample)

THREEDMATCH_VOXEL = 0.0625
KITTI_VOXEL = 0.7
# PREDATOR overlap radius for 3DMatch: the reference computes
# src_overlap_ind at 0.03 (reference ``datasets/three_d_match.py:112``)
# — the single value raw.py also uses; a different default here would flip
# pairs across the 0.3/0.1 overlap gates.
OVERLAP_RADIUS = 0.03


def overlap_indices(
    src: np.ndarray, tgt: np.ndarray, rot: np.ndarray, trans: np.ndarray,
    radius: float = OVERLAP_RADIUS,
) -> np.ndarray:
    """Indices of src points with a tgt point within ``radius`` after GT
    alignment — the KD-tree radius search of
    reference ``utils.py:94-108`` on the host."""
    src_t = src @ rot.T + trans.reshape(3)
    hits = radius_has_neighbor(src_t, tgt, radius)
    return np.flatnonzero(hits).astype(np.int64)


def make_pair_artifacts(
    src: np.ndarray,
    tgt: np.ndarray,
    rot: np.ndarray,
    trans: np.ndarray,
    overlap_ind: Optional[np.ndarray] = None,
    voxel_size: float = THREEDMATCH_VOXEL,
) -> Dict[str, np.ndarray]:
    """Voxel-downsampled pair + de-overlapped source + overlap ratio."""
    if overlap_ind is None:
        overlap_ind = overlap_indices(src, tgt, rot, trans)
    overlap_ratio = len(overlap_ind) / max(len(src), 1)

    non_overlap = np.setdiff1d(np.arange(len(src)), overlap_ind)
    src_zero = src[non_overlap] if len(non_overlap) else src[:1]

    T = np.eye(4)
    T[:3, :3] = rot
    T[:3, 3] = np.reshape(trans, 3)
    return {
        "src": voxel_downsample(src, voxel_size),
        "tgt": voxel_downsample(tgt, voxel_size),
        "src_zero": voxel_downsample(src_zero, voxel_size),
        "T": T.astype(np.float64),
        "overlap_ratio": overlap_ratio,
    }


def _save_triple(out_dir: str, item: int, src, tgt, T):
    np.save(os.path.join(out_dir, f"src{item}.npy"), src)
    np.save(os.path.join(out_dir, f"tgt{item}.npy"), tgt)
    np.save(os.path.join(out_dir, f"T{item}.npy"), T)


def save_train_split(pairs: Iterable[Tuple], out_dir: str,
                     voxel_size: float = THREEDMATCH_VOXEL) -> int:
    """Training artifacts: every pair, plus a zero-overlap copy for pairs with
    overlap <= 0.3 (reference ``process_3d_match.py:8-50``).

    ``pairs`` yields ``(src, tgt, rot, trans[, overlap_ind])``.
    """
    os.makedirs(out_dir, exist_ok=True)
    item = 0
    for pair in pairs:
        a = make_pair_artifacts(*pair, voxel_size=voxel_size)
        _save_triple(out_dir, item, a["src"], a["tgt"], a["T"])
        item += 1
        if a["overlap_ratio"] <= 0.3:
            _save_triple(out_dir, item, a["src_zero"], a["tgt"], a["T"])
            item += 1
    return item


def save_test_splits(
    pairs: Iterable[Tuple],
    match_dir: Optional[str] = None,
    lo_dir: Optional[str] = None,
    zero_dir: Optional[str] = None,
    voxel_size: float = THREEDMATCH_VOXEL,
) -> Dict[str, int]:
    """Test artifacts with the reference's overlap gates: match > 0.3,
    lo > 0.1, zero <= 0.3 de-overlapped
    (reference ``process_3d_match.py:96-177``).

    The reference builds the three splits from TWO pair lists: 3DMatch_test
    from the "test 3DMatch" metadata (`:96-133`) and 3DLoMatch_test +
    3DZeroMatch_test both from "test 3DLoMatch" (`:135-177`) — call this
    once per source list with only the matching dirs, never all three dirs
    from one list.

    ``pairs`` may yield ``(src, tgt, rot, trans[, overlap_ind])`` tuples OR
    the raw item dicts of ``ThreeDMatchPredator`` (streamed, one pass); in
    the dict form the ``idx``/``covariance``/``scene`` fields of each gated
    pair are written as the split's ``info/`` sidecars
    (`raw.save_info_sidecars`), keeping artifact and sidecar numbering
    aligned.
    """
    from scream_tpu_torch.data.raw import save_info_sidecars

    counts = {"match": 0, "lo": 0, "zero": 0}
    gated: Dict[str, list] = {"match": [], "lo": [], "zero": []}
    wrote_infos = False
    for d in (match_dir, lo_dir, zero_dir):
        if d:
            os.makedirs(d, exist_ok=True)
    for pair in pairs:
        info = None
        if isinstance(pair, dict):
            info = pair
            pair = (pair["src"], pair["tgt"], pair["rot"], pair["trans"],
                    pair.get("overlap_ind"))
            wrote_infos = True
        a = make_pair_artifacts(*pair, voxel_size=voxel_size)
        r = a["overlap_ratio"]
        if match_dir and r > 0.3:
            _save_triple(match_dir, counts["match"], a["src"], a["tgt"], a["T"])
            counts["match"] += 1
            gated["match"].append(info)
        if lo_dir and r > 0.1:
            _save_triple(lo_dir, counts["lo"], a["src"], a["tgt"], a["T"])
            counts["lo"] += 1
            gated["lo"].append(info)
        if zero_dir and r <= 0.3:
            _save_triple(zero_dir, counts["zero"], a["src_zero"], a["tgt"], a["T"])
            counts["zero"] += 1
            gated["zero"].append(info)
    if wrote_infos:
        for key, d in (("match", match_dir), ("lo", lo_dir), ("zero", zero_dir)):
            if d and gated[key]:
                save_info_sidecars(gated[key], d)
    return counts


def refine_gt_icp(
    src: np.ndarray, tgt: np.ndarray, init_T: np.ndarray,
    max_correspondence_distance: float = 0.2, max_iteration: int = 50000,
    device: str = "cuda",
) -> np.ndarray:
    """ICP-refined GT pose, the stand-in for the reference's Open3D
    refinement of KITTI odometry GT (reference ``datasets/kitti.py:105-126``),
    on ``device`` (the card unless the caller asks for the CPU). The default
    cap matches the reference's ``ICPConvergenceCriteria(max_iteration=50000)``;
    like Open3D, the loop exits on the relative fitness/RMSE criteria long
    before it. The single-pair loop reads its convergence flag on the host
    once a step; the steps taken are logged to stderr.

    Clouds are padded (with masks) to the next power-of-two size, as the JAX
    package pads them for its jitted ICP, so that the bounded NN kernel sees
    the shapes the JAX package gives its kernel. Masked padding is exact
    (padded rows carry zero Kabsch weight and are excluded from fitness and
    RMSE), so the refined pose is unchanged."""
    import torch

    from scream_tpu_torch.geometry.icp import registration_icp

    def _pad(p):
        n = len(p)
        cap = 1 << max(n - 1, 1).bit_length()
        out = np.zeros((cap, 3), np.float32)
        out[:n] = p
        mask = np.zeros((cap,), bool)
        mask[:n] = True
        return torch.as_tensor(out, device=device), torch.as_tensor(mask, device=device)

    t0 = time.perf_counter()
    src_p, src_m = _pad(np.asarray(src, np.float32))
    tgt_p, tgt_m = _pad(np.asarray(tgt, np.float32))
    res = registration_icp(
        src_p, tgt_p, max_correspondence_distance,
        init=torch.as_tensor(np.asarray(init_T, np.float32), device=device),
        max_iteration=max_iteration, src_mask=src_m, tgt_mask=tgt_m,
    )
    T = res.transformation.cpu().numpy().astype(np.float64)
    print(f"[refine_gt_icp] {len(src)} x {len(tgt)} points (padded {len(src_p)} x "
          f"{len(tgt_p)}) on {device}: {int(res.iterations)} ICP steps of "
          f"{max_iteration}, fitness {float(res.fitness):.6f}, rmse "
          f"{float(res.inlier_rmse):.6f}, {time.perf_counter() - t0:.3f} s",
          file=sys.stderr, flush=True)
    return T


def save_kitti_split(pairs: Iterable[Tuple], out_dir: str,
                     voxel_size: float = KITTI_VOXEL,
                     skip_items: Tuple[int, ...] = ()) -> int:
    """KITTI artifacts at voxel 0.7 (reference ``process_kitti.py:39-77``).

    ``skip_items``: source-dataset indices to drop BEFORE artifact numbering
    — the reference's test split skips dataset item 1
    (`process_kitti.py:44-45`: ``if mode == "test" and i == 1: continue``)
    on top of the (8, 15, 58) bad-pair removal, giving the canonical 554
    test pairs with every later artifact index shifted down by one.
    """
    os.makedirs(out_dir, exist_ok=True)
    skip = set(skip_items)
    item = 0
    for i, (src, tgt, rot, trans) in enumerate(pairs):
        if i in skip:
            continue
        T = np.eye(4)
        T[:3, :3] = rot
        T[:3, 3] = np.reshape(trans, 3)
        _save_triple(
            out_dir, item,
            voxel_downsample(src, voxel_size),
            voxel_downsample(tgt, voxel_size),
            T,
        )
        item += 1
    return item


# --- OpenGF tiling (reference ``process_open_gf.py:70-261``) ---

OPENGF_TILE = 100.0
OPENGF_TRAIN_STRIDE = 25.0
OPENGF_VOXEL = 1.0
DSM_RADIUS = 0.8


def extract_dsm(points: np.ndarray, dem: np.ndarray,
                radius: float = DSM_RADIUS) -> np.ndarray:
    """For each DEM point, the highest raw point within 2-D ``radius``.

    Host KD-tree version of the reference's GPU loop
    (reference ``process_open_gf.py:217-231``).
    """
    idx = highest_in_radius_2d(dem, points, radius)
    out = np.where(idx[:, None] >= 0, points[np.clip(idx, 0, None)], dem)
    return out.astype(dem.dtype)


def tile_opengf_scene(
    points: np.ndarray,
    classes: np.ndarray,
    ground_classes=(2,),
    tile: float = OPENGF_TILE,
    stride: Optional[float] = None,
    voxel: float = OPENGF_VOXEL,
) -> Iterable[Dict[str, np.ndarray]]:
    """Tile a scene into ``tile``-meter patches; per tile voxel-downsample,
    split ground (DEM) vs all (for DSM extraction), center, and yield
    ``{dsm, dem, center}`` (reference ``process_open_gf.py:70-261``).

    ``stride`` defaults to non-overlapping tiles (test); pass 25.0 for the
    overlapping train tiling.
    """
    stride = stride or tile
    lo = points[:, :2].min(axis=0)
    hi = points[:, :2].max(axis=0)
    # floor((extent - tile)/stride) + 1 starts per axis (min 1): the
    # reference's FIXED window grids (train 17x17 @ stride 25 on 500 m
    # files, `process_open_gf.py:83-91`; val 5x5 @ 100; test 26x25 @ 100 on
    # the 2600x2500 m scene, `:160-165`) fall out of this formula at the
    # canonical scene sizes — windows start at coor_min, cover
    # [x0, x0+tile), last start at extent - tile. The 1e-3 slack absorbs
    # fp/survey jitter in the scene extent (the old `hi - tile/2` bound
    # emitted an extra row+column of partial edge tiles per axis).
    def _starts(lo1, hi1):
        n = max(int(np.floor((hi1 - lo1 - tile + 1e-3) / stride)) + 1, 1)
        return lo1 + stride * np.arange(n)

    xs = _starts(lo[0], hi[0])
    ys = _starts(lo[1], hi[1])
    is_ground = np.isin(classes, ground_classes)

    for x0 in xs:
        for y0 in ys:
            in_tile = (
                (points[:, 0] >= x0) & (points[:, 0] < x0 + tile)
                & (points[:, 1] >= y0) & (points[:, 1] < y0 + tile)
            )
            tile_pts = points[in_tile]
            tile_ground = points[in_tile & is_ground]
            # The reference saves EVERY window (no minimum-count gate,
            # `process_open_gf.py:193-263`) — silently dropping sparse
            # windows would renumber all later patches away from reference
            # artifacts. A window with no ground at all cannot produce a
            # DEM (the reference's DSM loop would crash on it too): fail
            # loudly instead of renumbering.
            if len(tile_ground) == 0:
                raise ValueError(
                    f"OpenGF window at ({x0:.1f}, {y0:.1f}) contains no "
                    f"ground points (classes {ground_classes}) — every "
                    "window must hold ground; check the class channel and "
                    "scene bounds"
                )
            dem = voxel_downsample(tile_ground, voxel)
            # The reference extracts the DSM from the voxel-DOWNSAMPLED
            # patch (`process_open_gf.py:211-231`), not the raw returns:
            # the highest point is a voxel centroid, not a raw outlier.
            patch_ds = voxel_downsample(tile_pts, voxel)
            dsm = extract_dsm(patch_ds, dem)
            # Center on the 3-D bbox center of dsm+dem INCLUDING elevation
            # (`process_open_gf.py:237-242`) — x/y-only centering at the
            # tile midpoint would leave absolute terrain height in z and
            # shift the whole input distribution after the /50 scale.
            allp = np.concatenate([dsm, dem], axis=0)
            center = (allp.min(axis=0) + allp.max(axis=0)) * 0.5
            yield {
                "dsm": (dsm - center).astype(np.float32),
                "dem": (dem - center).astype(np.float32),
                "center": center.astype(np.float32),
            }


def save_opengf_split(patches: Iterable[Dict[str, np.ndarray]], out_dir: str,
                      save_centers: bool = False) -> int:
    """Write ``[dsm | dem]`` concatenated patches (1-indexed) and optional
    centers, the artifact layout OpenGFDataset reads
    (reference ``datasets/open_gf.py:18-28``)."""
    os.makedirs(out_dir, exist_ok=True)
    if save_centers:
        os.makedirs(os.path.join(out_dir, "centers"), exist_ok=True)
    n = 0
    for patch in patches:
        dsm, dem = patch["dsm"], patch["dem"]
        m = min(len(dsm), len(dem))
        block = np.concatenate([dsm[:m], dem[:m]], axis=1)
        n += 1
        np.save(os.path.join(out_dir, f"{n}.npy"), block)
        if save_centers:
            np.save(os.path.join(out_dir, "centers", f"{n}.npy"), patch["center"])
    return n


def check_saved_pairs(
    artifact_dir: str,
    out_dir: Optional[str] = None,
    items: Optional[Iterable[int]] = None,
    max_images: int = 4,
    verbose: bool = True,
):
    """Headless QA sweep over saved pair artifacts.

    The reference's ``check_saved_pairs`` (reference ``process_kitti.py:80-96``)
    walks the saved triples, prints the bbox extents of the GT-registered
    union and opens before/after Open3D windows. Here: same per-item extent
    report (returned as dicts, printed when ``verbose``), with the windows
    replaced by overlay PNGs for the first ``max_images`` items when
    ``out_dir`` is given.
    """
    from scream_tpu_torch.utils.viz import plot_registration

    if items is None:
        n = 0
        while os.path.exists(os.path.join(artifact_dir, f"src{n}.npy")):
            n += 1
        items = range(n)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    stats = []
    for j, i in enumerate(items):
        src = np.load(os.path.join(artifact_dir, f"src{i}.npy"))
        tgt = np.load(os.path.join(artifact_dir, f"tgt{i}.npy"))
        T = np.load(os.path.join(artifact_dir, f"T{i}.npy"))
        src_reg = src @ T[:3, :3].T + T[:3, 3]
        all_pts = np.concatenate([src_reg, tgt], axis=0)
        lo, hi = all_pts.min(axis=0), all_pts.max(axis=0)
        rec = {"item": int(i), "min": lo, "max": hi, "extent": hi - lo,
               "n_src": len(src), "n_tgt": len(tgt)}
        stats.append(rec)
        if verbose:
            print(
                "x: %.3f - %.3f, %.3f   y: %.3f - %.3f, %.3f  "
                "z: %.3f - %.3f, %.3f  %d"
                % (lo[0], hi[0], hi[0] - lo[0], lo[1], hi[1], hi[1] - lo[1],
                   lo[2], hi[2], hi[2] - lo[2], i)
            )
        if out_dir and j < max_images:
            plot_registration(
                src, tgt, path=os.path.join(out_dir, f"pair{i}_raw.png"))
            plot_registration(
                src, tgt, transform=T,
                path=os.path.join(out_dir, f"pair{i}_registered.png"))
    return stats


def check_opengf_test(
    artifact_dir: str,
    out_path: Optional[str] = None,
    n_items: Optional[int] = None,
    verbose: bool = True,
) -> Dict[str, float]:
    """Headless QA of OpenGF test artifacts.

    The reference's ``check_test`` (reference ``process_open_gf.py:266-296``)
    re-assembles all test tiles via their saved centers, JET-colormaps each
    DEM point by its (globally max-normalized) DSM-above-DEM height and shows
    the scene in Open3D. Here: same accumulation and normalization, rendered
    to a top-down PNG when ``out_path`` is given; returns summary stats.
    """
    if n_items is None:
        n_items = 0
        while os.path.exists(os.path.join(artifact_dir, f"{n_items + 1}.npy")):
            n_items += 1
    if n_items == 0:
        return {"n_patches": 0.0, "n_points": 0.0, "max_height": 0.0}
    dsm_all, dem_all, high_all = [], [], []
    for i in range(1, n_items + 1):
        block = np.load(os.path.join(artifact_dir, f"{i}.npy"))
        center = np.load(os.path.join(artifact_dir, "centers", f"{i}.npy")).ravel()
        if center.size == 2:  # (x, y) tile centers: z was never shifted
            center = np.concatenate([center, [0.0]])
        dsm, dem = block[:, :3], block[:, 3:]
        dsm_all.append(dsm + center)
        dem_all.append(dem + center)
        high_all.append(dsm[:, 2] - dem[:, 2])
        if verbose:
            print("\r%d / %d" % (i, n_items), end="")
    if verbose:
        print()
    dsm_all = np.concatenate(dsm_all, axis=0)
    dem_all = np.concatenate(dem_all, axis=0)
    high = np.concatenate(high_all, axis=0)
    max_high = float(high.max()) if len(high) else 0.0
    if out_path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 10))
        sc = ax.scatter(dem_all[:, 0], dem_all[:, 1],
                        c=high / max(max_high, 1e-9), cmap="jet", s=1.0)
        fig.colorbar(sc, ax=ax, label="normalized DSM-above-DEM height")
        ax.set_aspect("equal")
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
    return {
        "n_patches": float(n_items),
        "n_points": float(len(dem_all)),
        "max_height": max_high,
    }
