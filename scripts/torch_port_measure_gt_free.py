"""Measure GT-free registration quality of the port with a shipped
hint-free checkpoint (the port's ``scripts/measure_gt_free.py``).

Fresh synthetic pairs (new seeds, never seen in training) are registered
with the port's ``register_pair`` (``--passes N``) or
``register_pair_robust`` (``--passes 0``), with no GT hint and no GT
normalization, and scored against the generator's pose. One JSON row per
pass count, with the JAX script's keys; the model runs in float32, as the
JAX script's does.

Usage:
    python scripts/torch_port_measure_gt_free.py
        [--ckpt scream_tpu_torch/weights/point-generator-hintfree]
        [--pairs 16] [--points 448] [--max-angle-deg 90] [--passes 1 2 3]
        [--starts axis7|oct24|ico60] [--seed 100] [--noise 0] [--overlap 0.7]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

# Runnable from anywhere: put the repository root on the path.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_CKPT = os.path.join(ROOT, "scream_tpu_torch", "weights", "point-generator-hintfree")


def run(argv=None):
    """Parse ``argv``, register the pairs, print one row per pass count;
    returns ``(rows by pass count, (P, 4, 4) transforms by pass count)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--pairs", type=int, default=16)
    ap.add_argument("--points", type=int, default=448)
    ap.add_argument("--max-angle-deg", type=float, default=90.0)
    ap.add_argument("--passes", type=int, nargs="+", default=[1, 2, 3],
                    help="register_pair pass counts to sweep; 0 selects "
                    "register_pair_robust (multi-start + coarse-to-fine)")
    ap.add_argument("--starts", choices=("axis7", "oct24", "ico60"), default="axis7",
                    help="rotation-seed set for the robust path (passes 0)")
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--overlap", type=float, default=0.7)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the kernels (cpu runs the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from scream_tpu_torch.data.synthetic import make_pair
    from scream_tpu_torch.geometry.metrics import transformation_error
    from scream_tpu_torch.models import PointTransformer
    from scream_tpu_torch.pipeline import register_pair, register_pair_robust
    from scream_tpu_torch.utils.checkpoint import load_params
    from scream_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg, normalize, state = load_params(args.ckpt)
    model = PointTransformer(dataclasses.replace(cfg, dtype="float32"), device=dev)
    model.load_state_dict(state, strict=True)
    model.eval()

    rng = np.random.default_rng(args.seed)
    pairs = [make_pair(rng, n_src=args.points, n_tgt=args.points, overlap=args.overlap,
                       noise=args.noise, max_angle=np.deg2rad(args.max_angle_deg))
             for _ in range(args.pairs)]

    results, transforms = {}, {}
    with torch.no_grad():
        for n_passes in args.passes:
            res, tic = [], time.perf_counter()
            for pair in pairs:
                if n_passes == 0:
                    out = register_pair_robust(model, pair["src"], pair["tgt"],
                                               normalize=normalize, starts=args.starts,
                                               device=dev)
                else:
                    out = register_pair(model, pair["src"], pair["tgt"],
                                        normalize=normalize, passes=n_passes, device=dev)
                gt = np.eye(4, dtype=np.float32)
                gt[:3, :3] = pair["rot"]
                gt[:3, 3] = pair["trans"].reshape(3)
                re, te = transformation_error(torch.as_tensor(out.transform),
                                              torch.as_tensor(gt))
                res.append((float(re), float(te), out.fitness, out.score_margin,
                            out.ambiguous, out.transform))
            wall = time.perf_counter() - tic
            re_deg = np.array([r[0] for r in res])
            te = np.array([r[1] for r in res])
            ok = (re_deg <= 15.0) & (te <= 0.3)
            row = {
                "passes": n_passes,
                "starts": args.starts if n_passes == 0 else None,
                "median_re_deg": round(float(np.median(re_deg)), 2),
                "median_te": round(float(np.median(te)), 4),
                "recall_re15_te0.3": round(float(np.mean(ok)), 3),
                "mean_fitness": round(float(np.mean([r[2] for r in res])), 3),
                "wall_s": round(wall, 1),
            }
            if n_passes == 0:
                # The robust path's ambiguity-band calibration data: per-pair
                # score margins split by protocol success.
                margins = np.array([r[3] for r in res])
                row["margin_succ_min"] = (round(float(margins[ok].min()), 3)
                                          if ok.any() else None)
                row["margin_succ_q"] = ([round(float(q), 3) for q in
                                         np.quantile(margins[ok], [0.05, 0.25, 0.5])]
                                        if ok.any() else None)
                row["margin_fail_max"] = (round(float(margins[~ok].max()), 3)
                                          if (~ok).any() else None)
                row["margins_failed"] = [round(float(m), 3) for m in margins[~ok]]
                row["ambiguous_frac"] = round(float(np.mean([r[4] for r in res])), 3)
            results[n_passes] = row
            transforms[n_passes] = np.stack([r[5] for r in res])
            print(json.dumps(row), flush=True)
    return results, transforms


def main(argv=None):
    return run(argv)[0]


if __name__ == "__main__":
    main()
