"""Raw-dataset parsers (port of ``scream_tpu/data/raw.py``): PREDATOR-format
3DMatch and KITTI odometry.

Host-side re-implementations (no Open3D, no torch Dataset machinery) of:

  * ``read_info_file``: the redwood ``gt.info`` parser, blocks of 7 lines, a
    header ``tgt_idx src_idx num_fragments`` followed by a 6x6 covariance
    (reference ``datasets/three_d_match.py:11-27``).
  * ``ThreeDMatchDataset_PREDATOR``: pkl metadata (rot/trans/src/tgt fragment
    paths), ``.pth`` fragment loading, GT-correspondence overlap indices at
    radius 0.03, per-pair (tgt_idx, src_idx) + covariance + scene sidecars
    (reference ``datasets/three_d_match.py:30-126``).
  * ``KITTI_PREDATOR``: KITTI odometry, sequences 0-5/6-7/8-10 per split,
    D3Feat pair selection (next frame > 10 m away within a 100-frame window,
    including its off-by-one ``next_time[0] + curr_time - 1``), bad test pair
    (8, 15, 58) dropped, velo2cam-chained GT refined by ICP and cached,
    voxel-0.3 downsample, optional noise/rotate/scale/shift augmentation
    (reference ``datasets/kitti.py:14-230``).

The GT refinement is the port's ICP (``data/preprocess.py:refine_gt_icp``)
on ``device``, the card unless the caller asks for the CPU; its NN is the
bounded kernel's one-pair launch (``ops/nn_cuda.py:nn_bounded_single``).
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from scream_tpu_torch.data.datasets import _PerItemSeeds
from scream_tpu_torch.data.preprocess import overlap_indices, refine_gt_icp
from scream_tpu_torch.native import voxel_downsample

THREEDMATCH_OVERLAP_RADIUS = 0.03  # reference datasets/three_d_match.py:112

# Abbreviated display names per scene (reference datasets/three_d_match.py:66-75).
SCENE_NAME_TO_ABBR = {
    "7-scenes-redkitchen": "Kitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1": "Home_1",
    "sun3d-home_md-home_md_scan9_2012_sep_30": "Home_2",
    "sun3d-hotel_uc-scan3": "Hotel_1",
    "sun3d-hotel_umd-maryland_hotel1": "Hotel_2",
    "sun3d-hotel_umd-maryland_hotel3": "Hotel_3",
    "sun3d-mit_76_studyroom-76-1studyroom2": "Study",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika": "MIT_Lab",
}


def read_redwood_info(path: str) -> List[dict]:
    """Parse a redwood ``gt.info`` file into
    ``[{test_pair, num_fragments, covariance}]``."""
    with open(path) as f:
        lines = [line.strip() for line in f]
    out = []
    for i in range(len(lines) // 7):
        head = lines[i * 7].split()
        cov = np.array([lines[i * 7 + j].split() for j in range(1, 7)],
                       dtype=np.float32)
        out.append({
            "test_pair": [int(head[0]), int(head[1])],
            "num_fragments": int(head[2]),
            "covariance": cov,
        })
    return out


def load_covariance_index(info_dir: str) -> Dict[str, np.ndarray]:
    """All scenes' covariances keyed ``"<scene>_<tgtIdx>,<srcIdx>"``
    (reference ``datasets/three_d_match.py:76-81``). ``info_dir`` holds
    ``<scene>/gt.info`` per scene."""
    index: Dict[str, np.ndarray] = {}
    found = 0
    for scene in SCENE_NAME_TO_ABBR:
        path = os.path.join(info_dir, scene, "gt.info")
        if not os.path.exists(path):
            continue
        found += 1
        for rec in read_redwood_info(path):
            t, s = rec["test_pair"]
            index[f"{scene}_{t},{s}"] = rec["covariance"]
    if found == 0:
        # A mistyped info_dir would otherwise yield an empty index and only
        # fail thousands of fragments later (the reference opens the files
        # unconditionally and raises at once, three_d_match.py:77).
        raise FileNotFoundError(
            f"no <scene>/gt.info files found under {info_dir!r} for any of "
            f"the {len(SCENE_NAME_TO_ABBR)} test scenes"
        )
    return index


def _numpy_globals() -> list:
    """What unpickling a numpy array needs, for ``torch.load(weights_only=
    True)``: PREDATOR fragments may be saved numpy arrays (numpy 1.x names
    its reconstructor ``numpy.core.multiarray``, numpy 2.x ``numpy._core``)."""
    from numpy._core.multiarray import _reconstruct

    return [_reconstruct, (_reconstruct, "numpy.core.multiarray._reconstruct"),
            np.ndarray, np.dtype, np.dtypes.Float32DType, np.dtypes.Float64DType]


def _load_fragment(path: str) -> np.ndarray:
    """A PREDATOR fragment (a torch-saved tensor or numpy array) as fp32.
    ``weights_only=True`` is passed explicitly (PyTorch 2.6 changed the
    default): a fragment holds data, never code."""
    import torch

    with torch.serialization.safe_globals(_numpy_globals()):
        data = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(data, "numpy"):
        data = data.numpy()
    return np.asarray(data, dtype=np.float32)


class ThreeDMatchPredator:
    """PREDATOR-format 3DMatch pairs with overlap indices + eval sidecars.

    ``info_pkl`` is one of ``train_info.pkl / val_info.pkl / 3DMatch.pkl /
    3DLoMatch.pkl`` with keys ``rot, trans, src, tgt``; fragment paths are
    relative to ``root``. Pass ``info_dir`` (the ``info/3DMatch`` or
    ``info/3DLoMatch`` directory) on test splits to attach covariances.
    """

    def __init__(self, root: str, info_pkl: str, info_dir: Optional[str] = None):
        self.root = root
        with open(info_pkl, "rb") as f:
            self.infos = pickle.load(f)
        self.covariance = load_covariance_index(info_dir) if info_dir else {}

    def __len__(self) -> int:
        return len(self.infos["rot"])

    def __getitem__(self, item: int) -> dict:
        rot = np.asarray(self.infos["rot"][item], dtype=np.float32)
        trans = np.asarray(self.infos["trans"][item], dtype=np.float32)
        if trans.ndim == 1:
            trans = trans[:, None]
        src_path = os.path.join(self.root, self.infos["src"][item])
        tgt_path = os.path.join(self.root, self.infos["tgt"][item])
        # Fragment index from '..._<idx>.pth'; scene from the parent dir.
        src_idx = int(src_path.split("_")[-1].replace(".pth", ""))
        tgt_idx = int(tgt_path.split("_")[-1].replace(".pth", ""))
        scene_name = src_path.replace("\\", "/").split("/")[-2]

        src = _load_fragment(src_path)
        tgt = _load_fragment(tgt_path)
        overlap_ind = overlap_indices(
            src, tgt, rot, trans, radius=THREEDMATCH_OVERLAP_RADIUS
        )
        out = {
            "src": src,
            "tgt": tgt,
            "rot": rot,
            "trans": trans,
            "overlap_ind": overlap_ind,
            "idx": np.array([tgt_idx, src_idx], dtype=np.int64),
            "scene": scene_name,
        }
        key = f"{scene_name}_{tgt_idx},{src_idx}"
        if key in self.covariance:
            out["covariance"] = self.covariance[key]
        return out


def save_info_sidecars(items: Sequence[dict], out_dir: str) -> None:
    """Write the per-pair ``info/`` sidecars the test readers expect:
    ``idx%d.npy``, ``covariance%d.npy`` and ``scene_names.txt``
    (reference ``process_3d_match.py:182-234``)."""
    info_dir = os.path.join(out_dir, "info")
    os.makedirs(info_dir, exist_ok=True)
    names = []
    for i, it in enumerate(items):
        if "covariance" not in it:
            # Every kept test pair must have a redwood gt.info entry (the
            # reference indexes infos["<scene>_<tgt>,<src>"] unconditionally,
            # three_d_match.py:80); name the offender instead of KeyError.
            raise KeyError(
                f"pair {i} (scene {it.get('scene')}, idx "
                f"{it.get('idx')}) has no covariance — no matching "
                "<scene>/gt.info entry; check the info tree passed to "
                "ThreeDMatchPredator(info_dir=...)")
        np.save(os.path.join(info_dir, f"idx{i}.npy"), it["idx"])
        np.save(os.path.join(info_dir, f"covariance{i}.npy"), it["covariance"])
        names.append(it["scene"])
    with open(os.path.join(info_dir, "scene_names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")


# --- KITTI odometry ---

KITTI_SEQUENCES = {"train": [0, 1, 2, 3, 4, 5], "val": [6, 7], "test": [8, 9, 10]}
KITTI_BAD_TEST_PAIR = (8, 15, 58)


def extrinsic_zyx_rotation(euler: np.ndarray) -> np.ndarray:
    """Extrinsic z-y-x Euler angles ``(3,)`` -> rotation matrix.

    Equals ``scipy.spatial.transform.Rotation.from_euler('zyx', e)``, the
    KITTI augmentation convention (reference ``datasets/kitti.py:164-165``):
    scipy's lowercase axis string means *extrinsic* rotations, about fixed
    z first, then fixed y, then fixed x, i.e. ``R = Rx @ Ry @ Rz``.
    """
    cz, sz = np.cos(euler[0]), np.sin(euler[0])
    cy, sy = np.cos(euler[1]), np.sin(euler[1])
    cx, sx = np.cos(euler[2]), np.sin(euler[2])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return Rx @ Ry @ Rz


def velo2cam_matrix() -> np.ndarray:
    """The fixed velodyne->camera calibration, TRANSPOSED as the reference
    stores it (reference ``datasets/kitti.py:192-203``)."""
    R = np.array([
        7.533745e-03, -9.999714e-01, -6.166020e-04, 1.480249e-02, 7.280733e-04,
        -9.998902e-01, 9.998621e-01, 7.523790e-03, 1.480755e-02,
    ]).reshape(3, 3)
    T = np.array([-4.069766e-03, -7.631618e-02, -2.717806e-01]).reshape(3, 1)
    return np.vstack((np.hstack([R, T]), [0, 0, 0, 1])).T


def select_kitti_pairs(
    positions: np.ndarray, frame_ids: Sequence[int], min_dist: float = 10.0,
    window: int = 100,
) -> List[Tuple[int, int]]:
    """D3Feat pair selection: for each start frame, the first frame further
    than ``min_dist`` within the next ``window`` frames, reproducing the
    reference's exact indexing, including the documented off-by-one
    (reference ``datasets/kitti.py:67-82``)."""
    Ts = positions[:, :3, 3]
    pdist = np.sqrt(((Ts[None] - Ts[:, None]) ** 2).sum(-1))
    more_than = pdist > min_dist
    inames = set(frame_ids)
    pairs = []
    curr = min(frame_ids)
    while curr in inames:
        nxt = np.where(more_than[curr][curr:curr + window])[0]
        if len(nxt) == 0:
            curr += 1
            continue
        nxt = int(nxt[0]) + curr - 1
        if nxt in inames:
            pairs.append((curr, nxt))
            curr = nxt + 1
        else:
            break
    return pairs


class KittiOdometry:
    """Raw KITTI odometry pairs with ICP-refined GT, PREDATOR-style.

    Expects ``root/dataset/sequences/%02d/velodyne/%06d.bin`` and
    ``root/dataset/poses/%02d.txt``; refined GT caches to ``root/icp/``.
    ``icp_max_iteration`` defaults to the reference's 50,000 cap (reference
    ``datasets/kitti.py:116-118``); convergence exits long before it.

    ``gt_icp_voxel``: the refinement runs on the clouds voxel-downsampled
    at this size (0.3, the JAX package's default), or on the raw clouds
    with None, as the reference does ("for ICP we don't voxelize the point
    clouds", reference ``datasets/kitti.py:105-118``): about 120,000
    against 120,000 points a pair, which the tiled bounded kernel handles
    on the card; the plain CPU version forms the full N x M matrix and
    cannot. ``device``: where the refinement runs.
    """

    def __init__(self, root: str, mode: str = "train",
                 data_augmentation: bool = False, seed: int = 0,
                 icp_max_iteration: int = 50000, strict: bool = True,
                 gt_icp_voxel: Optional[float] = 0.3, device: str = "cuda"):
        self.root = os.path.join(root, "dataset")
        self.strict = strict
        self.icp_path = os.path.join(root, "icp")
        os.makedirs(self.icp_path, exist_ok=True)
        self.voxel_size = 0.3
        self.data_augmentation = data_augmentation
        self.augment_noise = 0.01
        self.augment_shift_range = 2.0
        self.augment_scale_min, self.augment_scale_max = 0.8, 1.2
        self.icp_max_iteration = icp_max_iteration
        self.gt_icp_voxel = gt_icp_voxel
        self.device = device
        # Per-(item, visit) seeded streams, not one shared Generator: loader
        # worker threads call __getitem__ concurrently.
        self._seeds = _PerItemSeeds(seed)
        self._pose_cache: Dict[int, np.ndarray] = {}

        self.files: List[Tuple[int, int, int]] = []
        for drive in KITTI_SEQUENCES[mode]:
            frame_ids = self._frame_ids(drive)
            # Fail fast on a partially downloaded root: silently skipping a
            # drive would shrink the canonical split (the reference asserts,
            # datasets/kitti.py:57). strict=False admits subset roots.
            if not frame_ids:
                if self.strict:
                    raise AssertionError(
                        f"no velodyne frames for KITTI sequence {drive:02d} "
                        f"under {self.root!r} — make sure the path has data "
                        "(pass strict=False to allow a subset of sequences)"
                    )
                continue
            poses = self._positions(drive)
            for t0, t1 in select_kitti_pairs(poses, frame_ids):
                self.files.append((drive, t0, t1))
        if mode == "test" and KITTI_BAD_TEST_PAIR in self.files:
            self.files.remove(KITTI_BAD_TEST_PAIR)

    def _frame_ids(self, drive: int) -> List[int]:
        d = os.path.join(self.root, "sequences", "%02d" % drive, "velodyne")
        return sorted(
            int(os.path.basename(f)[:-4]) for f in glob.glob(os.path.join(d, "*.bin"))
        )

    def _positions(self, drive: int) -> np.ndarray:
        if drive not in self._pose_cache:
            odo = np.genfromtxt(os.path.join(self.root, "poses", "%02d.txt" % drive))
            poses = np.tile(np.eye(4), (len(odo), 1, 1))
            poses[:, :3, :] = odo.reshape(-1, 3, 4)
            self._pose_cache[drive] = poses
        return self._pose_cache[drive]

    def _velodyne(self, drive: int, t: int) -> np.ndarray:
        path = os.path.join(
            self.root, "sequences", "%02d" % drive, "velodyne", "%06d.bin" % t
        )
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3]

    def odometry_gt(self, drive: int, t0: int, t1: int) -> np.ndarray:
        """The velo2cam-chained odometry pose of a pair, before ICP
        (reference ``datasets/kitti.py:105-110``)."""
        positions = self._positions(drive)[[t0, t1]]
        v2c = velo2cam_matrix()
        return (v2c @ positions[0].T @ np.linalg.inv(positions[1].T)
                @ np.linalg.inv(v2c)).T

    def _refined_gt(self, drive: int, t0: int, t1: int,
                    xyz0: np.ndarray, xyz1: np.ndarray) -> np.ndarray:
        key = f"{drive}_{t0}_{t1}"
        cache = os.path.join(self.icp_path, key + ".npy")
        if os.path.exists(cache):
            return np.load(cache)
        M = self.odometry_gt(drive, t0, t1)
        if self.gt_icp_voxel is not None:
            s0 = voxel_downsample(xyz0, self.gt_icp_voxel)
            s1 = voxel_downsample(xyz1, self.gt_icp_voxel)
        else:
            s0, s1 = xyz0, xyz1
        reg = refine_gt_icp(s0 @ M[:3, :3].T + M[:3, 3], s1, np.eye(4),
                            max_correspondence_distance=0.2,
                            max_iteration=self.icp_max_iteration, device=self.device)
        M2 = M @ reg
        np.save(cache, M2)
        return M2

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> dict:
        drive, t0, t1 = self.files[idx]
        xyz0 = self._velodyne(drive, t0)
        xyz1 = self._velodyne(drive, t1)
        tsfm = self._refined_gt(drive, t0, t1, xyz0, xyz1)
        rot = tsfm[:3, :3].astype(np.float32)
        trans = tsfm[:3, 3][:, None].astype(np.float32)

        src = voxel_downsample(xyz0, self.voxel_size)
        tgt = voxel_downsample(xyz1, self.voxel_size)

        if self.data_augmentation:
            # PREDATOR-style: uniform noise, z-heavy random rotation of one
            # side, global scale, independent shifts (reference
            # datasets/kitti.py:155-181).
            rng = self._seeds.rng(idx)
            src = src + (rng.random(src.shape) - 0.5) * self.augment_noise
            tgt = tgt + (rng.random(tgt.shape) - 0.5) * self.augment_noise
            euler = rng.random(3) * 2 * np.pi
            R = extrinsic_zyx_rotation(euler)
            if rng.random() > 0.5:
                src = src @ R.T
            else:
                tgt = tgt @ R.T
            scale = rng.uniform(self.augment_scale_min, self.augment_scale_max)
            src, tgt = src * scale, tgt * scale
            src = src + rng.uniform(-self.augment_shift_range,
                                    self.augment_shift_range, 3)
            tgt = tgt + rng.uniform(-self.augment_shift_range,
                                    self.augment_shift_range, 3)

        return {
            "src": src.astype(np.float32),
            "tgt": tgt.astype(np.float32),
            "rot": rot,
            "trans": trans,
            "pair": (drive, t0, t1),
        }
