"""Write synthetic artifact trees at the real split sizes (the port's copy of
``scripts/make_synthetic_splits.py``; imports nothing of JAX).

The real evaluation splits are 1,253 / 1,518 / 1,389 / 554 / 650 items
(``scream_tpu_torch/data/datasets.py:CANONICAL_SIZES``, from the reference's
``datasets/three_d_match.py:226,252,278``, ``kitti.py:333``,
``open_gf.py:56``). This writes trees of those sizes in the on-disk layout
the readers take (``src%d/tgt%d/T%d.npy`` with ``info/`` sidecars; OpenGF
``[dsm|dem]`` blocks with ``centers/``), so that ``python -m
scream_tpu_torch evaluate <protocol> --root <out>`` runs the loaders,
bucket ladders and per-scene sums at full scale
(``scripts/torch_port_run_scale.py``).

Geometry is ``data.synthetic.make_pair`` (known GT, overlap control); cloud
sizes vary over a realistic range so that the bucket ladder ladders. The
draws follow the JAX script's order, so one seed writes the same tree, bit
for bit, as ``make_synthetic_splits.py`` does.

Usage:
    python scripts/torch_port_make_splits.py --out build/scale_splits \
        [--splits 3dmatch 3dlomatch 3dzeromatch kitti opengf]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scream_tpu_torch.data.datasets import CANONICAL_SIZES, SCENE_NAME_TO_IDX  # noqa: E402
from scream_tpu_torch.data.preprocess import _save_triple, save_opengf_split  # noqa: E402
from scream_tpu_torch.data.raw import save_info_sidecars  # noqa: E402
from scream_tpu_torch.data.synthetic import make_dem_patch, make_pair  # noqa: E402

SCENES = list(SCENE_NAME_TO_IDX)


def _registration_split(out_dir, n_items, rng, overlap_range, extent,
                        n_range, with_info, zero=False):
    """``n_items`` pairs of ``make_pair`` under ``out_dir``; with
    ``with_info`` the redwood sidecars (idx pairs, 6 x 6 information
    matrices, scene names)."""
    os.makedirs(out_dir, exist_ok=True)
    infos = []
    for i in range(n_items):
        n_src = int(rng.integers(*n_range))
        n_tgt = int(rng.integers(*n_range))
        ov = 0.0 if zero else float(rng.uniform(*overlap_range))
        p = make_pair(rng, n_src=n_src, n_tgt=n_tgt, overlap=ov, noise=0.002, extent=extent)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = p["rot"]
        T[:3, 3] = p["trans"].reshape(3)
        _save_triple(out_dir, i, p["src"].astype(np.float32), p["tgt"].astype(np.float32), T)
        if with_info:
            # idx gap: most pairs non-consecutive (counted), ~12 % gap 1
            # (left out by the protocol's idx-gap > 1 rule).
            base = int(rng.integers(0, 500))
            gap = 1 if rng.random() < 0.12 else int(rng.integers(2, 30))
            # A redwood-style SPD information matrix at point-count scale.
            a = rng.standard_normal((6, 6)).astype(np.float64)
            cov = a @ a.T * n_src + np.eye(6) * n_src
            infos.append({"idx": np.array([base, base + gap], np.int64),
                          "covariance": cov, "scene": SCENES[i % len(SCENES)]})
    if with_info:
        save_info_sidecars(infos, out_dir)
    return n_items


def _dem_patches(rng, count):
    """``count`` metric patches (extent 50: the reader's /50 scaling lands
    them in the trained unit class), each with a zero center."""
    for _ in range(count):
        pt = make_dem_patch(rng, n_dsm=int(rng.integers(1024, 4096)),
                            n_dem=int(rng.integers(1024, 4096)), extent=50.0)
        pt["center"] = np.zeros(3, np.float32)
        yield pt


def _opengf_split(out_dir, n_items, rng, save_centers=True):
    return save_opengf_split(_dem_patches(rng, n_items), out_dir, save_centers=save_centers)


# split -> (directory, overlap range, extent, cloud-size range or None for
# the 3DMatch family's --n-lo/--n-hi, with_info, zero)
REGISTRATION = {
    "3dmatch": ("3DMatch_test", (0.35, 0.9), 1.5, None, True, False),
    "3dlomatch": ("3DLoMatch_test", (0.12, 0.35), 1.5, None, True, False),
    "3dzeromatch": ("3DZeroMatch_test", (0.0, 0.0), 1.5, None, True, True),
    "kitti": ("KITTI_test", (0.5, 0.9), 40.0, (4096, 8192), False, False),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "scale_splits"))
    ap.add_argument("--splits", nargs="+",
                    default=["3dmatch", "3dlomatch", "3dzeromatch", "kitti", "opengf"])
    ap.add_argument("--n-lo", type=int, default=1024,
                    help="lower cloud-size bound for the 3DMatch family")
    ap.add_argument("--n-hi", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out, exist_ok=True)
    for split in args.splits:
        if split in REGISTRATION:
            name, ov, extent, n_range, with_info, zero = REGISTRATION[split]
            n = _registration_split(os.path.join(args.out, name), CANONICAL_SIZES[name], rng,
                                    ov, extent, n_range or (args.n_lo, args.n_hi),
                                    with_info=with_info, zero=zero)
        elif split == "opengf-train":
            # Train and val patches of the test split's distribution, for a
            # DEM checkpoint trained to a meaningful at-scale number; the
            # counts are a training budget, not a protocol size.
            for sub, count, seed_off in (("OpenGF_train", 2000, 0), ("OpenGF_val", 200, 1)):
                r2 = np.random.default_rng(args.seed + 100 + seed_off)
                n = _opengf_split(os.path.join(args.out, sub), count, r2, save_centers=False)
                print(f"{sub}: wrote {n} items", flush=True)
            continue
        elif split == "opengf":
            n = _opengf_split(os.path.join(args.out, "OpenGF_test"),
                              CANONICAL_SIZES["OpenGF_test"], rng)
        else:
            raise SystemExit(f"unknown split {split}")
        print(f"{split}: wrote {n} items", flush=True)


if __name__ == "__main__":
    main()
