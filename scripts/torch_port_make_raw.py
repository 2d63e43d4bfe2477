"""Generate synthetic RAW-format dataset trees at real-dataset scale (the
port's copy of ``scripts/make_synthetic_raw.py``: the same arguments,
seeds and tree, built on ``scream_tpu_torch`` alone, so it runs where the
JAX package cannot; it also prints the split sizes the tree yields).

The preprocessors' raw ingestion (PREDATOR ``.pth`` fragments + pkl
metadata -> ``preprocess 3dmatch``; KITTI odometry ``velodyne/*.bin`` +
poses -> ``preprocess kitti``; OpenGF ``.las`` tiles -> ``preprocess
opengf``) runs on these trees before any real download does. At
``--scale 1`` their PAIR/PATCH counts land at the true split sizes
(reference ``datasets/three_d_match.py:226,252,278``, ``kitti.py:333``,
``open_gf.py:16,56``): overlap gating, de-overlap copies, redwood gt.info
sidecars, D3Feat pair selection, ICP-refined GT caching, LAS ingestion and
the 100 m tiling grids.

Layouts written (matching what ``python -m scream_tpu_torch preprocess`` consumes):

  <out>/3dmatch_raw/
    indoor/{train_info,val_info,3DMatch,3DLoMatch}.pkl
    info/{3DMatch,3DLoMatch}/<scene>/gt.info
    <scene>/cloud_bin_<i>.pth            (torch-saved float32 (N, 3))
  <out>/kitti_raw/
    dataset/sequences/%02d/velodyne/%06d.bin   (x y z refl float32)
    dataset/poses/%02d.txt
  <out>/opengf_raw/
    train/S{7,8}_{1..9}.las  train/S9_{1..19}.las
    val/S{7,8,9}_v.las       test/test.las

Overlap is controlled EXACTLY for the 3DMatch family: fragments share
literal points in their overlap region (each shared src point has a
0-distance tgt neighbor, far inside the 0.03 overlap radius,
reference ``datasets/three_d_match.py:112``), so the measured ratio is
the constructed one and the >0.3 / >0.1 / <=0.3 gates
(`process_3d_match.py:125,166,173`) classify deterministically.

Usage:
    python scripts/torch_port_make_raw.py --out raw_trees \
        [--parts 3dmatch kitti opengf] [--scale 1.0]

``--scale`` shrinks every count proportionally for smoke runs. The last
line of stdout is ``{"expected_splits": {...}}``: each artifact split's
size as ``preprocess`` must produce it from this tree (the overlap gates
classify deterministically by construction).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scream_tpu_torch.data.raw import SCENE_NAME_TO_ABBR  # noqa: E402

SCENES = list(SCENE_NAME_TO_ABBR)


# --- 3DMatch (PREDATOR layout) ---------------------------------------------

def _fragment_pair(rng, n=6000, share_frac=0.6, extent=1.5):
    """Two fragments sharing exactly ``share_frac`` of the src points (the
    shared block is identical coordinates in the tgt frame), plus a random
    SE(3) moving src into its own frame. Returns (src, tgt, rot, trans)
    with GT tgt = R src + t and overlap ratio == share_frac by construction."""
    n_share = int(n * share_frac)
    shared = rng.uniform(-extent, extent, (n_share, 3))
    # Disjoint remainders FAR apart along x so no accidental 0.03-hits.
    src_only = rng.uniform(-extent, extent, (n - n_share, 3)) + [4 * extent, 0, 0]
    tgt_only = rng.uniform(-extent, extent, (n - n_share, 3)) - [4 * extent, 0, 0]
    src_world = np.concatenate([shared, src_only]).astype(np.float32)
    tgt = np.concatenate([shared, tgt_only]).astype(np.float32)

    ang = rng.uniform(0, np.pi / 3)
    ax = rng.standard_normal(3)
    ax /= np.linalg.norm(ax)
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
    t = rng.uniform(-0.5, 0.5, 3)
    Ti_R, Ti_t = R.T, -R.T @ t  # src = R^T (world - t)
    src = (src_world @ Ti_R.T + Ti_t).astype(np.float32)
    return src, tgt, R.astype(np.float32), t.astype(np.float32)[:, None]


def make_3dmatch_raw(out, rng, scale=1.0, n_points=6000):
    """PREDATOR tree: shared-fragment pools per scene + pair metadata pkls
    + redwood gt.info covariance files for the test pairs. Returns the sizes
    of the five 3DMatch artifact splits it yields."""
    import torch

    root = os.path.join(out, "3dmatch_raw")
    pkl_dir = os.path.join(root, "indoor")
    os.makedirs(pkl_dir, exist_ok=True)

    frag_counter = {s: 0 for s in SCENES}

    def write_frag(scene, pts):
        i = frag_counter[scene]
        frag_counter[scene] += 1
        d = os.path.join(root, scene)
        os.makedirs(d, exist_ok=True)
        torch.save(torch.from_numpy(pts), os.path.join(d, f"cloud_bin_{i}.pth"))
        return i, f"{scene}/cloud_bin_{i}.pth"

    ratios = {}  # split -> the overlap ratio of each pair, as preprocess measures it

    def build_split(n_pairs, overlap_fn, gap1_frac=0.12):
        """n_pairs rows; per pair a fresh fragment pair at the requested
        overlap. ~gap1_frac of pairs get CONSECUTIVE fragment indices (the
        protocol's idx-gap<=1 filter must exercise at scale)."""
        infos = {"rot": [], "trans": [], "src": [], "tgt": []}
        pair_keys = []  # (scene, tgt_idx, src_idx)
        shares = []
        for p in range(n_pairs):
            scene = SCENES[p % len(SCENES)]
            share = overlap_fn(p)
            shares.append(int(n_points * share) / n_points)
            src, tgt, R, t = _fragment_pair(rng, n=n_points, share_frac=share)
            if rng.random() < gap1_frac:
                si, s_rel = write_frag(scene, src)
                ti, t_rel = write_frag(scene, tgt)  # consecutive: gap 1
            else:
                si, s_rel = write_frag(scene, src)
                # burn an index so tgt_idx - src_idx >= 2
                frag_counter[scene] += int(rng.integers(1, 4))
                ti, t_rel = write_frag(scene, tgt)
            infos["rot"].append(R)
            infos["trans"].append(t)
            infos["src"].append(s_rel)
            infos["tgt"].append(t_rel)
            pair_keys.append((scene, ti, si))
        ratios[len(ratios)] = shares
        return infos, pair_keys

    def write_info_tree(sub, pair_keys):
        by_scene = {}
        for scene, ti, si in pair_keys:
            by_scene.setdefault(scene, []).append((ti, si))
        for scene, keys in by_scene.items():
            d = os.path.join(root, "info", sub, scene)
            os.makedirs(d, exist_ok=True)
            lines = []
            for ti, si in keys:
                lines.append(f"{ti}\t{si}\t{frag_counter[scene]}")
                a = rng.standard_normal((6, 6))
                cov = a @ a.T * n_points + np.eye(6) * n_points  # SPD
                for row in cov:
                    lines.append("\t".join(f"{x:.6e}" for x in row))
            with open(os.path.join(d, "gt.info"), "w") as f:
                f.write("\n".join(lines) + "\n")

    t0 = time.time()
    # Test 3DMatch: 1,253 pairs, all overlap > 0.3 -> match gate keeps all.
    n_match = max(int(1253 * scale), 8)
    infos, keys = build_split(n_match, lambda p: float(rng.uniform(0.4, 0.85)))
    with open(os.path.join(pkl_dir, "3DMatch.pkl"), "wb") as f:
        pickle.dump(infos, f)
    write_info_tree("3DMatch", keys)

    # Test 3DLoMatch: 1,518 rows at overlap > 0.1 of which 1,389 also pass
    # the zero gate (<= 0.3): first n_zero rows in (0.12, 0.28], the rest in
    # (0.32, 0.38] (lo-only).
    n_zero = max(int(1389 * scale), 6)
    n_lo = max(int(1518 * scale), 8)

    def lo_overlap(p):
        return float(rng.uniform(0.12, 0.28) if p < n_zero
                     else rng.uniform(0.32, 0.38))

    infos, keys = build_split(n_lo, lo_overlap)
    with open(os.path.join(pkl_dir, "3DLoMatch.pkl"), "wb") as f:
        pickle.dump(infos, f)
    write_info_tree("3DLoMatch", keys)

    # Train: 27,730 pairs (`three_d_match.py:173`), mixed overlap so the
    # <=0.3 de-overlap copy rule runs at scale; val: a small fraction.
    n_train = max(int(27730 * scale), 16)
    infos, _ = build_split(n_train, lambda p: float(rng.uniform(0.15, 0.85)))
    with open(os.path.join(pkl_dir, "train_info.pkl"), "wb") as f:
        pickle.dump(infos, f)
    n_val = max(int(1000 * scale), 8)
    infos, _ = build_split(n_val, lambda p: float(rng.uniform(0.3, 0.8)))
    with open(os.path.join(pkl_dir, "val_info.pkl"), "wb") as f:
        pickle.dump(infos, f)

    n_frags = sum(frag_counter.values())
    print(f"3dmatch_raw: {n_match}+{n_lo} test, {n_train} train, {n_val} val "
          f"pairs; {n_frags} fragment slots in {time.time() - t0:.0f}s",
          flush=True)
    match, lo, train, val = (ratios[k] for k in range(4))  # the build order above
    return {"3DMatch_test": sum(r > 0.3 for r in match),
            "3DLoMatch_test": sum(r > 0.1 for r in lo),
            "3DZeroMatch_test": sum(r <= 0.3 for r in lo),
            "3DMatch_train": len(train) + sum(r <= 0.3 for r in train),
            "3DMatch_val": len(val) + sum(r <= 0.3 for r in val)}


# --- KITTI odometry ---------------------------------------------------------

def make_kitti_raw(out, rng, scale=1.0, pts_per_frame=15000):
    """All 11 odometry sequences with translation-only camera poses laid out
    so D3Feat selection (>10 m within 100 frames, with the reference's
    off-by-one) yields pair counts near the true splits: train ~1,358,
    test 555 raw -> 554 after the test-mode item-1 drop
    (reference ``process_kitti.py:44-45``). Returns the KITTI split sizes."""
    from scream_tpu_torch.data.raw import KITTI_SEQUENCES, velo2cam_matrix

    root = os.path.join(out, "kitti_raw")
    seq_pairs = {}
    # Pair count per sequence is exact: at 6 m frame spacing D3Feat selects
    # one pair per 2 frames (incl. the reference off-by-one), so a sequence
    # of 2p+2 frames yields exactly p pairs. Targets: train 1,358
    # (`three_d_match.py` BASELINE train sizes), test 555 raw -> 554 after
    # the test-mode item-1 drop.
    targets = {"train": 1358, "val": 200, "test": 555}
    for mode, seqs in KITTI_SEQUENCES.items():
        tot = max(int(targets[mode] * scale), 4)
        base, rem = divmod(tot, len(seqs))
        for k, s in enumerate(seqs):
            seq_pairs[s] = base + (1 if k < rem else 0)

    t0 = time.time()
    v2c_R = velo2cam_matrix().T[:3, :3]
    for drive, n_pairs in sorted(seq_pairs.items()):
        n_frames = 2 * n_pairs + 2
        seq_dir = os.path.join(root, "dataset", "sequences", "%02d" % drive,
                               "velodyne")
        os.makedirs(seq_dir, exist_ok=True)
        # World strip along x: persistent structure so consecutive frames
        # overlap and the ICP GT refinement has real correspondences.
        length = n_frames * 6.0 + 120.0
        n_world = int(length * 100.0 * 0.35)  # ~0.35 pts/m^2 over 100 m width
        world = np.empty((n_world, 3), np.float32)
        world[:, 0] = rng.uniform(-60, length - 60, n_world)
        world[:, 1] = rng.uniform(-50, 50, n_world)
        # ground plane + walls/clutter height profile
        world[:, 2] = np.where(rng.random(n_world) < 0.7,
                               rng.uniform(-2.0, -1.5, n_world),
                               rng.uniform(-1.5, 6.0, n_world))
        poses = []
        for tt in range(n_frames):
            pos = np.array([tt * 6.0, 0.0, 0.0])
            near = world[np.abs(world[:, 0] - pos[0]) < 55.0]
            d2 = ((near - pos) ** 2).sum(-1)
            near = near[d2 < 50.0 ** 2]
            if len(near) > pts_per_frame:
                near = near[rng.choice(len(near), pts_per_frame, replace=False)]
            velo = (near - pos).astype(np.float32)
            xyzr = np.concatenate(
                [velo, np.zeros((len(velo), 1), np.float32)], axis=1)
            xyzr.tofile(os.path.join(seq_dir, "%06d.bin" % tt))
            T = np.eye(4)
            T[:3, 3] = v2c_R @ pos  # camera-frame pose (cf. raw.py fixture)
            poses.append(T[:3].reshape(-1))
        pose_dir = os.path.join(root, "dataset", "poses")
        os.makedirs(pose_dir, exist_ok=True)
        np.savetxt(os.path.join(pose_dir, "%02d.txt" % drive),
                   np.asarray(poses))
        print(f"  seq {drive:02d}: {n_frames} frames", flush=True)
    print(f"kitti_raw: 11 sequences in {time.time() - t0:.0f}s", flush=True)
    # The test split drops dataset item 1 (reference process_kitti.py:44-45).
    return {f"KITTI_{mode}": sum(seq_pairs[s] for s in seqs) - (mode == "test")
            for mode, seqs in KITTI_SEQUENCES.items()}


# --- OpenGF .las scenes -----------------------------------------------------

def _terrain(rng, x0, y0, w, h, density):
    """Ground (class 2) + above-ground clutter (class 1) over [x0,x0+w) x
    [y0,y0+h) with a smooth height field; every 100 m window is guaranteed
    ground points (tile_opengf_scene hard-errors on ground-free windows)."""
    n = int(w * h * density)
    xy = np.empty((n, 2))
    xy[:, 0] = rng.uniform(x0, x0 + w, n)
    xy[:, 1] = rng.uniform(y0, y0 + h, n)
    # Pin the scene bbox to the EXACT nominal extent: the tiling grid
    # derives its window count from the point min/max
    # (`process_open_gf.py:83-91` fixed 17x17 / 26x25 grids assume the
    # full span), and a random bbox undershoots by ~1/density — measured
    # 16x16 grids and 9,488/10,693 train patches before this pin.
    xy[0] = (x0, y0)
    xy[1] = (x0 + w, y0 + h)
    z_ground = (8.0 * np.sin(xy[:, 0] / 180.0) * np.cos(xy[:, 1] / 150.0)
                + 3.0 * np.sin(xy[:, 0] / 41.0))
    is_ground = rng.random(n) < 0.65
    z = np.where(is_ground, z_ground,
                 z_ground + rng.uniform(0.5, 25.0, n))
    cls = np.where(is_ground, 2, 1).astype(np.uint8)
    # a sprinkle of never-classified points (class 0) that ingestion drops
    drop = rng.random(n) < 0.02
    cls = np.where(drop, 0, cls).astype(np.uint8)
    # The bbox-pinning corner points must survive ingestion (class != 0) or
    # the extent pin above is void; make them ground.
    cls[:2] = 2
    z[:2] = z_ground[:2]
    return np.column_stack([xy, z]), cls


def make_opengf_raw(out, rng, scale=1.0, density=0.35):
    """The reference's scene lists (`process_open_gf.py:16-20,42`) as .las:
    train 9+9+19 500 m files (17x17 tiles @ stride 25 each -> 10,693
    patches), val 3 files, test one 2600x2500 m scene (26x25 -> 650).
    Returns the OpenGF split sizes."""
    from scream_tpu_torch.data.las import (OPENGF_TEST_FILES, OPENGF_TRAIN_FILES,
                                           OPENGF_VAL_FILES, write_las)

    root = os.path.join(out, "opengf_raw")
    t0 = time.time()
    train_files = OPENGF_TRAIN_FILES
    if scale < 1.0:
        train_files = train_files[:max(int(len(train_files) * scale), 1)]
    for rel in train_files + OPENGF_VAL_FILES:
        path = os.path.join(root, rel)[:-4] + ".las"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        pts, cls = _terrain(rng, 0.0, 0.0, 500.0, 500.0, density)
        write_las(path, pts, cls)
    test_w = 2600.0 if scale >= 1.0 else 100.0 * max(int(26 * scale), 2)
    test_h = 2500.0 if scale >= 1.0 else 100.0 * max(int(25 * scale), 2)
    pts, cls = _terrain(rng, 0.0, 0.0, test_w, test_h, density)
    path = os.path.join(root, OPENGF_TEST_FILES[0])[:-4] + ".las"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_las(path, pts, cls)
    print(f"opengf_raw: {len(train_files)} train + {len(OPENGF_VAL_FILES)} "
          f"val + 1 test ({test_w:.0f}x{test_h:.0f} m) .las files in "
          f"{time.time() - t0:.0f}s", flush=True)

    def windows(extent, stride, tile=100.0):  # preprocess.tile_opengf_scene's grid
        return max(int(np.floor((extent - tile + 1e-3) / stride)) + 1, 1)

    return {"OpenGF_train": len(train_files) * windows(500.0, 25.0) ** 2,
            "OpenGF_val": len(OPENGF_VAL_FILES) * windows(500.0, 100.0) ** 2,
            "OpenGF_test": windows(test_w, 100.0) * windows(test_h, 100.0)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="raw_trees")
    ap.add_argument("--parts", nargs="+",
                    default=["3dmatch", "kitti", "opengf"])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink all counts proportionally (smoke: 0.01)")
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out, exist_ok=True)
    expected = {}
    for part in args.parts:
        if part == "3dmatch":
            expected.update(make_3dmatch_raw(args.out, rng, scale=args.scale))
        elif part == "kitti":
            expected.update(make_kitti_raw(args.out, rng, scale=args.scale))
        elif part == "opengf":
            expected.update(make_opengf_raw(args.out, rng, scale=args.scale))
        else:
            raise SystemExit(f"unknown part {part}")
    print(json.dumps({"expected_splits": expected}), flush=True)


if __name__ == "__main__":
    main()
