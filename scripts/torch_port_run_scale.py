"""Run every evaluation protocol of the port on a split tree, one protocol
after another, and report wall, pairs/s, peak RSS and peak device memory
(the port's copy of ``scripts/run_scale_protocols.py``; imports nothing of
JAX).

For each protocol it calls ``python -m scream_tpu_torch evaluate`` in this
process (``cli.main``) with the JAX script's flags: ``--bucketed`` for the
3DMatch family; KITTI at ``--max-points 8192`` and batch size 8; the shipped
weights of the port (``scream_tpu_torch/weights/point-generator`` for the
3DMatch family, ``kitti-generator`` for KITTI, ``dem-generator`` for
OpenGF). Each row: the item count of the tree's split, the wall, items/s,
the process's peak RSS so far, the device's peak allocated memory during
the protocol (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``; null off the card) and the protocol's JSON. On
the card the kernel library is built (or loaded) first, on a line of its
own, so that no protocol's wall holds the build.
The trees: ``scripts/torch_port_make_splits.py`` (the real sizes).

Usage:
    python scripts/torch_port_run_scale.py --root build/scale_splits \
        [--protocols 3dmatch 3dlomatch 3dzeromatch kitti opengf] [--device cuda]

One JSON line a protocol; exit 1 if any protocol failed.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import resource
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WEIGHTS = os.path.join(REPO, "scream_tpu_torch", "weights")
PARAMS = {"3dmatch": "point-generator", "3dlomatch": "point-generator",
          "3dzeromatch": "point-generator", "kitti": "kitti-generator",
          "opengf": "dem-generator"}
SPLITS = {"3dmatch": "3DMatch_test", "3dlomatch": "3DLoMatch_test",
          "3dzeromatch": "3DZeroMatch_test", "kitti": "KITTI_test", "opengf": "OpenGF_test"}


def tree_items(root: str, proto: str) -> int:
    """Items of the protocol's split in the tree (0 where it is absent)."""
    d = os.path.join(root, SPLITS[proto])
    pattern = "[0-9]*.npy" if proto == "opengf" else "src[0-9]*.npy"
    return len(glob.glob(os.path.join(d, pattern)))


def evaluate_argv(proto: str, root: str, batch_size: int, max_points: int, device: str):
    argv = ["evaluate", proto, "--root", root, "--params", os.path.join(WEIGHTS, PARAMS[proto]),
            "--batch-size", str(batch_size), "--max-points", str(max_points),
            "--device", device]
    if proto.startswith("3d"):
        argv.append("--bucketed")
    if proto == "kitti":
        argv += ["--max-points", "8192"]  # the voxel-0.7 class
        argv[argv.index("--batch-size") + 1] = "8"
    return argv


def run_protocol(proto: str, root: str, batch_size: int, max_points: int, device: str) -> dict:
    import torch

    from scream_tpu_torch import cli

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    buf, rc, err = io.StringIO(), 0, None
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(evaluate_argv(proto, root, batch_size, max_points, device))
        if on_card:
            torch.cuda.synchronize()
    except SystemExit as e:  # the CLI's refusals
        rc, err = 1, f"SystemExit: {e}"
    except Exception:  # one protocol's failure is reported; the others still run
        rc, err = 1, traceback.format_exc()[-2000:]
    wall = time.perf_counter() - t0
    last = [ln for ln in buf.getvalue().strip().splitlines() if ln.startswith("{")]
    items = tree_items(root, proto)
    row = {"protocol": proto, "rc": rc if last else 1, "items": items,
           "wall_s": wall, "items_per_sec": items / wall if wall > 0 else None,
           "peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
           "peak_device_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                   if on_card else None),
           "device": torch.cuda.get_device_name(0) if on_card else str(device),
           "result": json.loads(last[-1]) if last else {"error": err}}
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join("build", "scale_splits"))
    ap.add_argument("--protocols", nargs="+",
                    default=["3dmatch", "3dlomatch", "3dzeromatch", "kitti", "opengf"])
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--max-points", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the protocols (cpu runs the plain versions)")
    args = ap.parse_args(argv)
    if any(p not in PARAMS for p in args.protocols):
        ap.error(f"--protocols take {sorted(PARAMS)}")
    from scream_tpu_torch.utils.device import resolve_device

    if resolve_device(args.device).type == "cuda":
        # The kernel library's one-time build (nvcc, about a minute on a
        # tree that has none) is set-up, not the first protocol's time.
        from scream_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.kernels()
        print(json.dumps({"kernel_library_s": time.perf_counter() - t0,
                          "built": _build.build_seconds is not None}), flush=True)
    rows = []
    for proto in args.protocols:
        row = run_protocol(proto, args.root, args.batch_size, args.max_points, args.device)
        rows.append(row)
        print(json.dumps(row, default=float), flush=True)
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
