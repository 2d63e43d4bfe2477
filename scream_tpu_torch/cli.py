"""Command line of the port (port of ``scream_tpu/cli.py``): ``train`` and
the GT-free ``register`` command, "align these two scans".

    python -m scream_tpu_torch train opengf --d-model 512 --epochs 2
    python -m scream_tpu_torch train 3dmatch --root data --epochs 45

``train`` takes the JAX command's flags and defaults, plus ``--device``
(default ``cuda``); it falls back to synthetic data where the split
directory is absent, as the JAX command does, saves the best weights under
``<checkpoint-dir>/best`` and the full train state under
``<checkpoint-dir>/state`` after every epoch (``--resume`` continues from
it), and prints ``{"final_val": ...}`` last. ``--init-params`` reads a
weights directory of the port. ``--mesh``, ``--multi-scale`` and
``--sample-img-dir`` are not ported.

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
import os
import sys
from typing import Optional

from scream_tpu_torch.config import kitti_presets, opengf_presets, threedmatch_presets

TASKS = {"3dmatch": threedmatch_presets, "kitti": kitti_presets, "opengf": opengf_presets}


def _registration_loaders(task, data_cfg, train_cfg, root, synthetic_len=64):
    """Train and validation pair loaders: the preprocessed split under
    ``root`` where it exists, else synthetic pairs at half the capacity."""
    from scream_tpu_torch.data import PairDataset, PairLoader, SyntheticPairDataset

    split_train = "3DMatch_train" if task == "3dmatch" else "KITTI_train"
    split_val = "3DMatch_val" if task == "3dmatch" else "KITTI_val"
    cap = data_cfg.max_points

    def make(split, augment):
        path = os.path.join(root, split)
        if os.path.isdir(path):
            ds = PairDataset(
                root, split, normalize=data_cfg.normalize, augment=augment,
                perturb_both_sides=data_cfg.perturb_both_sides,
                perturb_std=data_cfg.augment_perturb_std,
                jitter_std=data_cfg.augment_jitter_std, max_points=cap)
        else:
            print(f"[cli] {path} not found; using synthetic pairs", file=sys.stderr)
            ds = SyntheticPairDataset(length=synthetic_len, n_src=cap // 2,
                                      n_tgt=cap // 2, normalize=data_cfg.normalize,
                                      augment=augment)
        return PairLoader(ds, batch_size=train_cfg.batch_size, src_capacity=cap,
                          shuffle=augment, drop_last=augment)

    return make(split_train, True), make(split_val, False)


class _SyntheticPatches:
    """The OpenGF fallback: ``n`` patches of ``points`` DSM/DEM points, item
    ``i`` from ``default_rng(i)`` (the JAX command's ``_Synth``)."""

    def __init__(self, n: int, points: int):
        self.n, self.points = n, points

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import numpy as np

        from scream_tpu_torch.data import make_dem_patch

        return make_dem_patch(np.random.default_rng(i), n_dsm=self.points,
                              n_dem=self.points)


def _apply_model_overrides(model_cfg, args):
    over = {k: v for k, v in (("d_model", args.d_model),
                              ("self_layers", args.self_layers),
                              ("cross_layers", args.cross_layers),
                              ("dtype", args.dtype)) if v}
    return dataclasses.replace(model_cfg, **over) if over else model_cfg


def cmd_train(args):
    """Train a model (JAX command: ``scream_tpu/cli.py:cmd_train``)."""
    if args.mesh or args.multi_scale or args.sample_img_dir:
        raise SystemExit("--mesh, --multi-scale and --sample-img-dir are not "
                         "ported (ROADMAP.md); use the JAX package's command")
    from scream_tpu_torch.config import RenderConfig, kitti_gan_render_config

    model_cfg, train_cfg, data_cfg, eval_cfg = TASKS[args.task]()
    model_cfg = _apply_model_overrides(model_cfg, args)
    if args.max_points:
        data_cfg = dataclasses.replace(data_cfg, max_points=args.max_points)
    over = {k: v for k, v in (("epochs", args.epochs), ("batch_size", args.batch_size),
                              ("lr_d", args.lr_d), ("lr_g", args.lr_g)) if v}
    if args.gan:
        over["use_gan"] = True
    train_cfg = dataclasses.replace(train_cfg, **over)
    if args.center_mode:
        # "none" trains without the GT src_center hint: the recipe for
        # checkpoints that GT-free register_pair can use.
        eval_cfg = dataclasses.replace(eval_cfg, center_mode=args.center_mode)
    if args.normalize:
        data_cfg = dataclasses.replace(data_cfg, normalize=args.normalize)

    cap = data_cfg.max_points
    if args.task == "opengf":
        from scream_tpu_torch.data import DEMLoader, OpenGFDataset
        from scream_tpu_torch.train import DEMTrainer

        if os.path.isdir(os.path.join(args.root, "OpenGF_train")):
            tr_ds, va_ds = OpenGFDataset(args.root, "train"), OpenGFDataset(args.root, "val")
        else:
            print("[cli] OpenGF data not found; using synthetic patches", file=sys.stderr)
            tr_ds, va_ds = _SyntheticPatches(32, cap // 4), _SyntheticPatches(8, cap // 4)
        mk = lambda ds, sh: DEMLoader(ds, batch_size=train_cfg.batch_size,
                                      dsm_capacity=cap, dem_capacity=cap,
                                      coarse_capacity=max(cap // 8, 64),
                                      shuffle=sh, drop_last=sh)
        trainer = DEMTrainer(mk(tr_ds, True), mk(va_ds, False), model_cfg=model_cfg,
                             train_cfg=train_cfg, checkpoint_dir=args.checkpoint_dir,
                             device=args.device)
    else:
        from scream_tpu_torch.train import RegistrationTrainer

        train_loader, val_loader = _registration_loaders(
            args.task, data_cfg, train_cfg, args.root,
            synthetic_len=args.synthetic_pairs or 64)
        # The reference switches the renderer for KITTI GAN training: rho 48,
        # a single Ry(pi) back view (train_kitti.py:45-48).
        render_cfg = (kitti_gan_render_config() if args.task == "kitti"
                      and train_cfg.use_gan else RenderConfig())
        trainer = RegistrationTrainer(
            train_loader, val_loader, model_cfg=model_cfg, train_cfg=train_cfg,
            eval_cfg=eval_cfg, render_cfg=render_cfg,
            checkpoint_dir=args.checkpoint_dir, device=args.device)
    trainer.init()
    state_dir = os.path.join(args.checkpoint_dir, "state")
    if args.resume:
        if os.path.isdir(state_dir):
            trainer.restore_state(state_dir)
            print(f"[cli] resumed full train state from {state_dir}", file=sys.stderr)
        else:
            print(f"[cli] --resume: no saved state at {state_dir}; starting fresh",
                  file=sys.stderr)
    elif args.init_params:
        # Warm start from a weights directory (fresh optimizer and step:
        # fine-tuning, not a resume).
        from scream_tpu_torch.utils.checkpoint import load_params

        _, _, state = load_params(args.init_params)
        trainer.model.load_state_dict(state, strict=True)
        print(f"[cli] initialized generator params from {args.init_params}",
              file=sys.stderr)
    final = trainer.fit(profile_dir=args.profile_dir)
    print(json.dumps({"final_val": final}))


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
    cfg = _apply_model_overrides(cfg, args)
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

    t = sub.add_parser("train", help="train a model")
    t.add_argument("task", choices=sorted(TASKS))
    t.add_argument("--root", default="data")
    t.add_argument("--epochs", type=int, default=None,
                   help="exclusive bound, reference convention: N runs N-1 "
                        "training epochs (train_3d_match.py:159)")
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--gan", action="store_true")
    t.add_argument("--lr-d", type=float, default=None,
                   help="discriminator LR override (the GAN-balance knob)")
    t.add_argument("--lr-g", type=float, default=None,
                   help="generator LR override (e.g. for --init-params fine-tuning)")
    t.add_argument("--checkpoint-dir", default="checkpoints")
    t.add_argument("--resume", action="store_true",
                   help="restore the full train state (params+optimizer+step)"
                        " from <checkpoint-dir>/state and continue at the"
                        " next epoch")
    t.add_argument("--init-params", default=None,
                   help="warm-start the generator from a weights directory of "
                        "the port (model.pt + model_config.json; fresh optimizer)")
    t.add_argument("--synthetic-pairs", type=int, default=None,
                   help="pair count for the synthetic fallback")
    t.add_argument("--multi-scale", action="store_true",
                   help="size-bucketed loader: not ported yet")
    t.add_argument("--max-points", type=int, default=None,
                   help="padding bucket; oversize clouds are subsampled")
    t.add_argument("--d-model", type=int, default=None)
    t.add_argument("--self-layers", type=int, default=None)
    t.add_argument("--cross-layers", type=int, default=None)
    t.add_argument("--mesh", default=None, help="multi-GPU training: not ported yet")
    t.add_argument("--dtype", choices=["bfloat16", "float32"], default=None,
                   help="compute dtype override (bf16 is the default)")
    t.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the first epoch here")
    t.add_argument("--sample-img-dir", default=None,
                   help="GAN sample-image dump: not ported yet")
    t.add_argument("--center-mode", choices=["trans", "neg_rt", "none"], default=None,
                   help="src_center hint fed to the model (preset default; "
                        "'none' trains hint-free for GT-free register)")
    t.add_argument("--normalize",
                   choices=["unit_sphere", "unit_sphere_raw", "unit_cube",
                            "unit_cube_raw"],
                   default=None, help="pair normalization (preset default)")
    t.add_argument("--device", default="cuda",
                   help="torch device of the model and the kernels "
                        "(cpu runs the plain PyTorch versions)")
    t.set_defaults(fn=cmd_train)
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
