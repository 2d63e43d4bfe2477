"""Command line of the port (port of ``scream_tpu/cli.py``): the GT-free
``register`` command, "align these two scans".

    python -m scream_tpu_torch register --src a.npy --tgt b.ply \
        --params scream_tpu_torch/weights/point-generator-hintfree

prints one JSON line with the 4x4 transform (src -> tgt frame), the ICP
fitness and inlier RMSE and ``n_corr``; ``--manifest`` registers a file of
``src tgt`` lines batched, one JSON line per pair; ``--robust`` runs the
multi-start search and adds ``runner_up_fitness``, ``score_margin`` and
``ambiguous``. Flags and output follow the JAX package's command. The model
runs on ``--device`` (default ``cuda``); ``--params`` names a torch
checkpoint of the port (``utils/checkpoint.py``), whose
``model_config.json`` sets the architecture and normalization unless a flag
says otherwise. ``--scans`` (multiway) and ``--mesh`` are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional


def _load_cloud(path: str, name: str):
    from scream_tpu_torch.data.ply import load_cloud_any

    try:
        arr = load_cloud_any(path)
    except (ValueError, OSError) as e:
        raise SystemExit(f"{name}: {e}")
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise SystemExit(f"{name}: expected an (N, 3) cloud "
                         f"(.npy/.ply/.las/.laz), got shape {arr.shape}")
    return arr


def _read_manifest(path: str) -> list:
    pairs = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 2:
                raise SystemExit(f"{path}:{ln}: expected 'src.npy tgt.npy'")
            pairs.append((_load_cloud(parts[0], f"line {ln} src"),
                          _load_cloud(parts[1], f"line {ln} tgt")))
    if not pairs:
        raise SystemExit(f"{path}: no pairs")
    return pairs


def _build_model(args):
    """``(model, normalize)``: the checkpoint's sidecar config, explicit
    flags on top, weights loaded (or a seeded random init) on the device."""
    import torch

    from scream_tpu_torch.config import ModelConfig
    from scream_tpu_torch.models import PointTransformer
    from scream_tpu_torch.utils.checkpoint import load_params

    cfg, normalize, state = ModelConfig(), None, None
    if args.params:
        cfg, normalize, state = load_params(args.params)
    normalize = args.normalize or normalize or "unit_sphere"
    over = {k: v for k, v in (("d_model", args.d_model),
                              ("self_layers", args.self_layers),
                              ("cross_layers", args.cross_layers),
                              ("dtype", args.dtype)) if v}
    cfg = dataclasses.replace(cfg, **over)
    model = PointTransformer(cfg, device=args.device)
    if state is not None:
        model.load_state_dict(state, strict=True)
    else:
        print("[cli] no --params given; registering with a randomly "
              "initialized model", file=sys.stderr)
    model.eval()
    torch.set_grad_enabled(False)
    return model, normalize


def cmd_register(args):
    """GT-free registration of two raw clouds or a manifest of pairs."""
    import numpy as np

    from scream_tpu_torch.pipeline import (register_pair, register_pair_robust,
                                           register_pairs, register_pairs_robust)

    if args.scans or args.mesh:
        raise SystemExit("--scans (multiway) and --mesh are not ported yet "
                         "(ROADMAP.md); use the JAX package's command")
    manifest = None
    if args.manifest:
        if args.src or args.tgt:
            raise SystemExit("--manifest and --src/--tgt are exclusive")
        manifest = _read_manifest(args.manifest)
    elif not (args.src and args.tgt):
        raise SystemExit("need --src and --tgt (or --manifest)")
    else:
        src = _load_cloud(args.src, "src")
        tgt = _load_cloud(args.tgt, "tgt")

    model, normalize = _build_model(args)
    kw = dict(normalize=normalize, dis_thresh=args.dis_thresh,
              icp_thresh=args.icp_thresh, icp_max_iter=args.icp_max_iter,
              device=args.device)
    robust_keys = ("runner_up_fitness", "score_margin", "ambiguous")

    def line(res) -> dict:
        out = {"transform": res.transform.tolist(), "fitness": res.fitness,
               "inlier_rmse": res.inlier_rmse, "n_corr": res.n_corr}
        if args.robust:
            out.update({k: getattr(res, k) for k in robust_keys})
        return out

    if manifest is not None:
        if args.robust:
            results = register_pairs_robust(model, manifest,
                                            starts=args.robust_starts, **kw)
        else:
            results = register_pairs(model, manifest, batch_size=args.batch_size,
                                     passes=args.passes, **kw)
        for i, res in enumerate(results):
            print(json.dumps({"pair": i, **line(res)}))
        n_amb = sum(bool(r.ambiguous) for r in results)
        if args.robust and n_amb:
            print(f"[cli] WARNING: {n_amb}/{len(results)} pair(s) flagged "
                  "ambiguous (a distinct pose scored within the "
                  "near-symmetry band of the winner — likely symmetric "
                  "geometry; inspect score_margin)", file=sys.stderr)
        if args.out:
            np.save(args.out, np.stack([r.transform for r in results]))
        return

    if args.robust:
        res = register_pair_robust(model, src, tgt, starts=args.robust_starts, **kw)
        if res.ambiguous:
            print("[cli] WARNING: result flagged ambiguous — a distinct "
                  f"pose scored within {res.score_margin:.0%} of the winner "
                  "(near-symmetric geometry)", file=sys.stderr)
    else:
        res = register_pair(model, src, tgt, passes=args.passes, **kw)
    out = line(res)
    if args.out:
        np.save(args.out, res.transform)
        out["saved"] = args.out
    print(json.dumps(out))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="scream_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser(
        "register",
        help="GT-free: align two raw clouds, print the 4x4 transform")
    r.add_argument("--src", default=None,
                   help="(N, 3) source cloud (.npy/.ply/.las/.laz)")
    r.add_argument("--tgt", default=None,
                   help="(M, 3) target cloud (.npy/.ply/.las/.laz)")
    r.add_argument("--manifest", default=None,
                   help="file of 'src tgt' cloud-path lines: register the "
                        "whole stream batched, one JSON line per pair")
    r.add_argument("--batch-size", type=int, default=8,
                   help="pairs per forward in --manifest mode")
    r.add_argument("--params", default=None,
                   help="torch checkpoint directory of the port (model.pt + "
                        "model_config.json)")
    r.add_argument("--normalize", choices=["unit_sphere", "unit_cube"],
                   default=None,
                   help="match the checkpoint's training convention (read "
                        "from its model_config.json when present; "
                        "unit_sphere otherwise)")
    r.add_argument("--dis-thresh", type=float, default=0.1)
    r.add_argument("--icp-thresh", type=float, default=0.1)
    r.add_argument("--icp-max-iter", type=int, default=30)
    r.add_argument("--passes", type=int, default=2,
                   help="iterative re-registration rounds (fitness-gated)")
    r.add_argument("--robust", action="store_true",
                   help="multi-start + coarse-to-fine search for LARGE "
                        "unknown poses")
    r.add_argument("--robust-starts", choices=("axis7", "oct24", "ico60"),
                   default="axis7", help="rotation-seed set for --robust")
    r.add_argument("--out", default=None,
                   help="save the 4x4 transform here (stacked (P, 4, 4) in "
                        "manifest mode)")
    r.add_argument("--scans", nargs="+", default=None,
                   help="multiway registration: not ported yet")
    r.add_argument("--mesh", default=None, help="sharded serving: not ported yet")
    r.add_argument("--d-model", type=int, default=None)
    r.add_argument("--self-layers", type=int, default=None)
    r.add_argument("--cross-layers", type=int, default=None)
    r.add_argument("--dtype", choices=["bfloat16", "float32"], default=None)
    r.add_argument("--device", default="cuda",
                   help="torch device of the model and the kernels "
                        "(cpu runs the plain PyTorch versions)")
    r.set_defaults(fn=cmd_register)
    return p


def main(argv: Optional[list] = None):
    args = build_parser().parse_args(argv)
    args.fn(args)
