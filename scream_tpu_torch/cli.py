"""Command line of the port (port of ``scream_tpu/cli.py``): ``train``,
``evaluate``, ``bench``, ``preprocess``, the GT-free ``register`` command
("align these two scans"), ``selftest``, ``convert`` and ``visualize``.

    python -m scream_tpu_torch train opengf --d-model 512 --epochs 2
    python -m scream_tpu_torch train 3dmatch --root data --epochs 45

``train`` takes the JAX command's flags and defaults, plus ``--device``
(default ``cuda``); it falls back to synthetic data where the split
directory is absent, as the JAX command does, saves the best weights under
``<checkpoint-dir>/best`` and the full train state under
``<checkpoint-dir>/state`` after every epoch (``--resume`` continues from
it), and prints ``{"final_val": ...}`` last. ``--init-params`` reads a
weights directory of the port. ``--multi-scale`` trains on the size-bucketed
loader (per-bucket synthetic pairs where the split is absent).
``--sample-img-dir`` dumps GAN sample renders as PNGs. ``--mesh data=N``
(``data=4,seq=2``, ``data=2,model=2``, ``data=2,pipe=2``, ``auto``) trains
on a mesh of ranks, the default batch 8 per data rank (see below).

    python -m scream_tpu_torch evaluate 3dmatch --root data \
        --params scream_tpu_torch/weights/point-generator --bucketed
    python -m scream_tpu_torch evaluate kitti --center-mode none \
        --params scream_tpu_torch/weights/kitti-generator-hintfree
    python -m scream_tpu_torch evaluate opengf \
        --params scream_tpu_torch/weights/dem-generator

``evaluate`` runs a benchmark protocol (3dmatch, 3dlomatch, 3dzeromatch,
kitti, opengf) with the JAX command's flags and defaults, plus
``--device`` (default ``cuda``), and prints one JSON line of metrics; the
split under ``--root`` where it exists, else synthetic data. ``--params``
names a torch checkpoint of the port whose ``model_config.json`` sets the
architecture and the normalization (explicit flags win); without it the
task preset's model runs from a seeded random init. ``--mesh`` evaluates
each batch's rows on the data ranks of a mesh. ``bench`` is
``scream_tpu_torch/bench.py``.

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
says otherwise.

    python -m scream_tpu_torch register --scans s0.npy s1.npy s2.npy \
        --params scream_tpu_torch/weights/point-generator-hintfree \
        --refine-rounds 1 --out poses.npy

registers N scans into scan 0's frame (``pipeline/multiway.py``): pairwise
serving over each scan and the next ``--window`` scans, pose-graph
synchronization, and ``--refine-rounds`` rounds of scan-to-map ICP; one JSON
line per scan with its 4x4 pose, the edges' fitness on stderr, ``--out`` the
(N, 4, 4) stack. ``--mesh`` cuts each dispatch of ``--manifest`` and
``--scans`` over the data ranks of a mesh (``--batch-size`` must divide by
it; refused with ``--robust`` and single pairs).

``--mesh`` runs one process per rank over ``torch.distributed``
(``scream_tpu_torch/parallel``): without ``torchrun`` the command spawns its
ranks itself, under ``torchrun`` it joins the world it is in; NCCL where
each rank has a card of its own, gloo on the CPU (``--device cpu``) and
where ranks share a card. Rank 0 alone prints, so the output is a single
process's. On a seq, model or pipe mesh the fused kernels are off.

    python -m scream_tpu_torch train 3dmatch --mesh data=2 --device cpu
    torchrun --nproc-per-node 4 -m scream_tpu_torch train 3dmatch --mesh data=4

    python -m scream_tpu_torch preprocess 3dmatch --root raw/3dmatch --out data
    python -m scream_tpu_torch preprocess kitti --root raw/kitti --out data
    python -m scream_tpu_torch preprocess opengf --root raw/opengf --out data
    python -m scream_tpu_torch preprocess collate --root data --out cache \
        --protocol kitti

turns a raw dataset tree (PREDATOR 3DMatch, KITTI odometry, OpenGF
``.las``) into the splits that ``evaluate``, ``train`` and ``bench`` read,
or pre-builds an evaluation split's collated cache, with the JAX command's
tasks, flags, stdout lines and errors. KITTI's ICP-refined GT runs on
``--device`` (default ``cuda``). The host point ops build with ``g++`` at
first use (``scream_tpu_torch/native``).

    python -m scream_tpu_torch selftest
    python -m scream_tpu_torch convert --pth point-generator.pth \
        --out weights/point-generator --model point
    python -m scream_tpu_torch visualize --root data --split 3DMatch_test \
        --item 0 --params scream_tpu_torch/weights/point-generator --html

``selftest`` holds every Hopper kernel to its plain version on the card
(one JSON line, nonzero exit on a miss or without a GPU). ``convert`` maps
a reference ``.pth`` state_dict to a weights directory of the port
(``point``, ``dem`` or ``disc``). ``visualize`` writes a pair's before / GT
PNGs (matplotlib; where it is missing each PNG key says so) and with
``--params`` the model views, RE/TE and the display gate, computed on
``--device``; ``--html`` an interactive scene (numpy only).
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
EVAL_SPLITS = {
    "3dmatch": ("3DMatch_test", "unit_sphere"),
    "3dlomatch": ("3DLoMatch_test", "unit_sphere"),
    "3dzeromatch": ("3DZeroMatch_test", "unit_sphere"),
    "kitti": ("KITTI_test", "unit_cube"),
    "opengf": ("OpenGF_test", None),
}


def _buckets_for(cap: int, smallest: int = 256):
    """The padding buckets up to ``cap``, with ``cap`` itself appended when
    it falls between them, so that no cloud exceeds every bucket."""
    buckets = tuple(b for b in (256, 512, 1024, 2048, 4096, 8192, 16384)
                    if smallest <= b <= cap)
    if not buckets or buckets[-1] < cap:
        buckets = buckets + (cap,)
    return buckets


def _registration_loaders(task, data_cfg, train_cfg, root, synthetic_len=64,
                          multi_scale=False):
    """Train and validation pair loaders: the preprocessed split under
    ``root`` where it exists, else synthetic pairs at half the capacity.
    ``multi_scale``: the size-bucketed loader over :func:`_buckets_for`,
    and where the split is absent per-bucket synthetic pairs sized just
    under each bucket, two overlap tiers for training (the JAX command's
    recipe of the multi-scale checkpoints)."""
    from scream_tpu_torch.data import (BucketedPairLoader, ConcatDataset, PairDataset,
                                       PairLoader, SyntheticPairDataset)

    split_train = "3DMatch_train" if task == "3dmatch" else "KITTI_train"
    split_val = "3DMatch_val" if task == "3dmatch" else "KITTI_val"
    cap = data_cfg.max_points
    buckets = _buckets_for(cap)

    def synth_multi(augment, seed0):
        overlaps = (0.7, 0.85) if augment else (0.7,)
        length = synthetic_len if augment else max(synthetic_len // 4, 8)
        return ConcatDataset([
            SyntheticPairDataset(length=length, n_src=b * 7 // 8, n_tgt=b * 15 // 16,
                                 overlap=ov, normalize=data_cfg.normalize,
                                 augment=augment, seed=seed0 + 10 * k + j)
            for k, b in enumerate(buckets) for j, ov in enumerate(overlaps)])

    def make(split, augment):
        path = os.path.join(root, split)
        if os.path.isdir(path):
            ds = PairDataset(
                root, split, normalize=data_cfg.normalize, augment=augment,
                perturb_both_sides=data_cfg.perturb_both_sides,
                perturb_std=data_cfg.augment_perturb_std,
                jitter_std=data_cfg.augment_jitter_std, max_points=cap)
        elif multi_scale:
            print(f"[cli] {path} not found; multi-scale synthetic pairs", file=sys.stderr)
            ds = synth_multi(augment, seed0=10 if augment else 900)
        else:
            print(f"[cli] {path} not found; using synthetic pairs", file=sys.stderr)
            ds = SyntheticPairDataset(length=synthetic_len, n_src=cap // 2,
                                      n_tgt=cap // 2, normalize=data_cfg.normalize,
                                      augment=augment)
        if multi_scale:
            return BucketedPairLoader(ds, batch_size=train_cfg.batch_size, buckets=buckets,
                                      shuffle=augment, drop_last=augment)
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


def _parse_mesh(args):
    """``--mesh data=N[,seq=M|,model=K|,pipe=P]`` -> a mesh plan (or None
    when the flag is absent); the ranks it needs are spawned by
    :func:`_on_mesh`."""
    spec = getattr(args, "mesh", None)
    if not spec:
        return None
    from scream_tpu_torch.parallel import parse_mesh_spec

    try:
        return parse_mesh_spec(spec, device=getattr(args, "device", "cpu"))
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}")


def _disable_unpartitionable_fusion(model_cfg, mesh):
    """The fused kernels stay on for data-only meshes (each rank runs them on
    its rows); seq / model / pipe meshes take the unfused blocks."""
    from scream_tpu_torch.train.trainer import disable_unpartitionable_fusion

    return disable_unpartitionable_fusion(model_cfg, mesh)


def _rank_entry(mesh, command: str, args):
    """One rank of a ``--mesh`` command: the command's body with the bound
    mesh."""
    globals()[command](args, mesh)


def _on_mesh(command: str, args, mesh) -> bool:
    """Run ``command(args, mesh)`` on the ranks of ``--mesh`` (spawned here,
    or this process's ``torchrun`` world); False when there is no mesh or
    this process already is one of its ranks."""
    if mesh is None or mesh.bound:
        return False
    from scream_tpu_torch.parallel import launch

    launch(_rank_entry, mesh.shape if "WORLD_SIZE" not in os.environ else args.mesh,
           args.device, args=(command, args))
    return True


def cmd_train(args, mesh=None):
    """Train a model (JAX command: ``scream_tpu/cli.py:cmd_train``)."""
    if mesh is None:
        mesh = _parse_mesh(args)
        if mesh is not None and args.batch_size is None:
            # Keep the reference batch of 8 on each data rank.
            args.batch_size = 8 * mesh.shape["data"]
        if _on_mesh("cmd_train", args, mesh):
            return
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
                             sample_img_dir=args.sample_img_dir, mesh=mesh,
                             device=args.device)
    else:
        from scream_tpu_torch.train import RegistrationTrainer

        train_loader, val_loader = _registration_loaders(
            args.task, data_cfg, train_cfg, args.root,
            synthetic_len=args.synthetic_pairs or 64, multi_scale=args.multi_scale)
        # The reference switches the renderer for KITTI GAN training: rho 48,
        # a single Ry(pi) back view (train_kitti.py:45-48).
        render_cfg = (kitti_gan_render_config() if args.task == "kitti"
                      and train_cfg.use_gan else RenderConfig())
        trainer = RegistrationTrainer(
            train_loader, val_loader, model_cfg=model_cfg, train_cfg=train_cfg,
            eval_cfg=eval_cfg, render_cfg=render_cfg,
            checkpoint_dir=args.checkpoint_dir, sample_img_dir=args.sample_img_dir,
            mesh=mesh, device=args.device)
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
        trainer.load_weights(state)
        print(f"[cli] initialized generator params from {args.init_params}",
              file=sys.stderr)
    final = trainer.fit(profile_dir=args.profile_dir)
    print(json.dumps({"final_val": final}))


def _load_model(task, model_cfg, params_dir, args, device, mesh=None):
    """``(model, normalize)`` for ``evaluate``: the checkpoint's architecture
    (its sidecar) and weights, or without ``params_dir`` the task preset's
    ``model_cfg`` from a seeded random init, explicit flags on top (and the
    mesh's fusion rule); in eval mode on ``device``. ``normalize`` is the
    sidecar's (None if it names none)."""
    import torch

    from scream_tpu_torch.models import DEMTransformer, PointTransformer
    from scream_tpu_torch.utils.checkpoint import load_params

    normalize, state = None, None
    if params_dir:
        model_cfg, normalize, state = load_params(params_dir)
    model_cfg = _disable_unpartitionable_fusion(_apply_model_overrides(model_cfg, args), mesh)
    cls = DEMTransformer if task == "opengf" else PointTransformer
    model = cls(model_cfg, device=device, generator=torch.Generator().manual_seed(0))
    if state is not None:
        model.load_state_dict(state, strict=True)
    else:
        print("[cli] no --params given; evaluating a randomly initialized model",
              file=sys.stderr)
    model.eval()
    return model, None if normalize in (None, "none") else normalize


def cmd_evaluate(args, mesh=None):
    """Run a benchmark protocol (JAX command: ``scream_tpu/cli.py:cmd_evaluate``)."""
    from scream_tpu_torch import eval as protocols
    from scream_tpu_torch.config import eval_preset
    from scream_tpu_torch.data import (BucketedPairLoader, DEMLoader, OpenGFDataset,
                                       PairDataset, PairLoader, SyntheticPairDataset,
                                       collated_or_build)

    if mesh is None and _on_mesh("cmd_evaluate", args, _parse_mesh(args)):
        return
    task = "opengf" if args.protocol == "opengf" else (
        "kitti" if args.protocol == "kitti" else "3dmatch")
    model_cfg, _, data_cfg, _ = TASKS[task]()
    eval_cfg = eval_preset(args.protocol)
    over = {f: getattr(args, f) for f in ("dis_thresh", "rmse_thresh", "icp_thresh",
                                          "icp_max_iter", "re_stat", "center_mode")
            if getattr(args, f) is not None}
    if over:
        eval_cfg = dataclasses.replace(eval_cfg, **over)
    if args.icp_chunk is not None:
        # Fail before the model and data load, not inside the evaluation.
        if args.protocol != "kitti":
            raise SystemExit(
                "--experimental-icp-chunk applies to the kitti protocol only (the other "
                "protocols run ICP at the Open3D default budget of 30)")
        if args.icp_chunk < 1:
            raise SystemExit(f"--experimental-icp-chunk must be >= 1, got {args.icp_chunk}")
    if args.max_points:
        data_cfg = dataclasses.replace(data_cfg, max_points=args.max_points)
    split, normalize = EVAL_SPLITS[args.protocol]
    root, cap = args.root, data_cfg.max_points
    model, side_normalize = _load_model(task, model_cfg, args.params, args, args.device,
                                        mesh)

    if args.protocol == "opengf":
        if os.path.isdir(os.path.join(root, "OpenGF_test")):
            ds = OpenGFDataset(root, "test")
        else:
            print("[cli] OpenGF data not found; synthetic patches", file=sys.stderr)
            ds = _SyntheticPatches(8, 256)
        loader = DEMLoader(ds, batch_size=args.batch_size, dsm_capacity=cap,
                           dem_capacity=cap, coarse_capacity=max(cap // 8, 64))
        out = protocols.evaluate_open_gf(model, loader, device=args.device, mesh=mesh)
    else:
        normalize = side_normalize or normalize
        with_info = args.protocol.startswith("3d")
        if os.path.isdir(os.path.join(root, split)):
            ds = PairDataset(root, split, normalize=normalize, with_info=with_info,
                             max_points=cap)
        else:
            print(f"[cli] {split} not found; synthetic pairs", file=sys.stderr)
            ds = SyntheticPairDataset(length=16, n_src=cap // 2, n_tgt=cap // 2,
                                      normalize=normalize, with_info=with_info)
        if args.protocol == "kitti" and not isinstance(ds, SyntheticPairDataset):
            ds = protocols.SkipDataset(ds, (124, 142))
        buckets = _buckets_for(cap, smallest=1024)
        if args.cache_dir:
            # The pre-collated bucket-shard cache (data/collated.py), built
            # on first use: the ladder and padding of --bucketed.
            loader = collated_or_build(ds, args.cache_dir, batch_size=args.batch_size,
                                       buckets=buckets)
        elif args.bucketed:
            loader = BucketedPairLoader(ds, batch_size=args.batch_size, buckets=buckets)
        else:
            loader = PairLoader(ds, batch_size=args.batch_size, src_capacity=cap)
        if args.protocol == "kitti":
            out = protocols.evaluate_kitti(
                model, loader, dis_thresh=eval_cfg.dis_thresh,
                icp_thresh=eval_cfg.icp_thresh, icp_max_iter=eval_cfg.icp_max_iter,
                success_re_deg=eval_cfg.success_re_deg, success_te=eval_cfg.success_te,
                center_mode=eval_cfg.center_mode, icp_chunk=args.icp_chunk,
                device=args.device, mesh=mesh)
        else:
            out = protocols.evaluate_registration(model, loader, eval_cfg,
                                                  device=args.device, mesh=mesh)
    print(json.dumps(out, default=float))


def cmd_bench(args):
    """The throughput benchmark (``scream_tpu_torch/bench.py``)."""
    from scream_tpu_torch import bench

    bench.run(run_suite=args.suite, write=args.write, device=args.device)


def cmd_preprocess(args):
    """Raw data -> the ``.npy`` artifact splits (JAX command:
    ``scream_tpu/cli.py:cmd_preprocess``): the same tasks, arguments,
    stdout lines, skips and hard errors. KITTI's GT refinement runs on
    ``--device``."""
    import glob

    from scream_tpu_torch.data import preprocess as pp

    if args.task == "collate":
        # Pre-build the bucket-shard cache for an already-preprocessed eval
        # split (same dataset construction as `evaluate --cache-dir`).
        from scream_tpu_torch import eval as protocols
        from scream_tpu_torch.data import PairDataset, build_collated_cache

        split, normalize = EVAL_SPLITS[args.protocol]
        if args.protocol == "opengf":
            raise SystemExit("preprocess collate supports the registration "
                             "protocols (the OpenGF eval is not loader-bound)")
        ds = PairDataset(args.root, split, normalize=normalize,
                         with_info=args.protocol.startswith("3d"),
                         max_points=args.max_points)
        if args.protocol == "kitti":
            ds = protocols.SkipDataset(ds, (124, 142))
        meta = build_collated_cache(
            ds, args.out, buckets=_buckets_for(args.max_points, smallest=1024))
        print(json.dumps(meta))
        return
    if args.task == "kitti":
        from scream_tpu_torch.data.raw import KittiOdometry

        for mode in ("train", "val", "test"):
            ds = KittiOdometry(args.root, mode=mode, device=args.device)
            pairs = ((it["src"], it["tgt"], it["rot"], it["trans"])
                     for it in (ds[i] for i in range(len(ds))))
            n = pp.save_kitti_split(
                pairs, os.path.join(args.out, f"KITTI_{mode}"),
                # Reference test split drops dataset item 1
                # (reference process_kitti.py:44-45).
                skip_items=(1,) if mode == "test" else (),
            )
            print(f"KITTI_{mode}: {n} pairs")
    elif args.task == "3dmatch":
        from scream_tpu_torch.data.raw import ThreeDMatchPredator

        pkl_dir = os.path.join(args.root, "indoor")
        for mode, pkl, out_split in (
            ("train", "train_info.pkl", "3DMatch_train"),
            ("val", "val_info.pkl", "3DMatch_val"),
        ):
            pkl_path = os.path.join(pkl_dir, pkl)
            if not os.path.exists(pkl_path):
                print(f"skip {mode}: {pkl_path} missing")
                continue
            ds = ThreeDMatchPredator(args.root, pkl_path)
            pairs = ((it["src"], it["tgt"], it["rot"], it["trans"], it["overlap_ind"])
                     for it in (ds[i] for i in range(len(ds))))
            n = pp.save_train_split(pairs, os.path.join(args.out, out_split))
            print(f"{out_split}: {n} pairs")
        # Test splits: 3DMatch_test from the 3DMatch metadata; 3DLoMatch +
        # 3DZeroMatch both from the 3DLoMatch metadata, with the redwood
        # idx/covariance/scene sidecars the per-scene protocol needs
        # (reference process_3d_match.py:96-234).
        for pkl, info_sub, split_kwargs in (
            ("3DMatch.pkl", "3DMatch",
             {"match_dir": os.path.join(args.out, "3DMatch_test")}),
            ("3DLoMatch.pkl", "3DLoMatch",
             {"lo_dir": os.path.join(args.out, "3DLoMatch_test"),
              "zero_dir": os.path.join(args.out, "3DZeroMatch_test")}),
        ):
            pkl_path = os.path.join(pkl_dir, pkl)
            if not os.path.exists(pkl_path):
                print(f"skip test splits from {pkl}: {pkl_path} missing")
                continue
            # The redwood covariance sidecars live at
            # <root>/info/{3DMatch,3DLoMatch}/<scene>/gt.info (the reference
            # opens them unconditionally per test pair, reference
            # datasets/three_d_match.py:54-57,76-81): without them the
            # per-scene protocol cannot run, so a missing info tree is a
            # hard error, not a silent drop.
            info_dir = os.path.join(args.root, "info", info_sub)
            if not os.path.isdir(info_dir):
                raise SystemExit(
                    f"preprocess 3dmatch: {info_dir} missing — the test "
                    "splits need the redwood <scene>/gt.info covariance "
                    "files (reference layout datasets/3DMatch/info/"
                    f"{info_sub}/<scene>/gt.info)")
            ds = ThreeDMatchPredator(args.root, pkl_path, info_dir=info_dir)
            # Stream item dicts: save_test_splits takes the pair fields and
            # the sidecar info from each dict in one pass.
            counts = pp.save_test_splits((ds[i] for i in range(len(ds))), **split_kwargs)
            print(f"test splits from {pkl}: "
                  + " ".join(f"{k}={v}" for k, v in counts.items() if v))
    else:
        # OpenGF: .las/.laz scenes -> tiled [dsm | dem] patches (reference
        # process_open_gf.py:13-261). The canonical S7/S8/S9 file names are
        # tried first; otherwise every .las/.laz under <root>/<split>/ is
        # ingested, in sorted order (it numbers the patches).
        from scream_tpu_torch.data import las

        for split, canonical, stride, centers in (
            ("train", las.OPENGF_TRAIN_FILES, pp.OPENGF_TRAIN_STRIDE, False),
            ("val", las.OPENGF_VAL_FILES, None, False),
            ("test", las.OPENGF_TEST_FILES, None, True),
        ):
            paths = las._existing(args.root, canonical)
            if not paths:
                paths = sorted(glob.glob(os.path.join(args.root, split, "*.la[sz]")))
            if not paths:
                print(f"skip OpenGF_{split}: no .las/.laz under "
                      f"{os.path.join(args.root, split)}")
                continue

            def patches(paths=paths, stride=stride):
                for p in paths:
                    pts, cls = las.read_opengf_cloud(p)
                    yield from pp.tile_opengf_scene(pts, cls, stride=stride)

            n = pp.save_opengf_split(patches(), os.path.join(args.out, f"OpenGF_{split}"),
                                     save_centers=centers)
            print(f"OpenGF_{split}: {n} patches from {len(paths)} scenes")


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


def _build_model(args, mesh=None):
    """``(model, normalize)``: the checkpoint's sidecar config, explicit
    flags on top (and the mesh's fusion rule), weights loaded (or a seeded
    random init) on the device."""
    import torch

    from scream_tpu_torch.config import ModelConfig
    from scream_tpu_torch.models import PointTransformer
    from scream_tpu_torch.utils.checkpoint import load_params

    cfg, normalize, state = ModelConfig(), None, None
    if args.params:
        cfg, normalize, state = load_params(args.params)
    normalize = args.normalize or normalize or "unit_sphere"
    cfg = _disable_unpartitionable_fusion(_apply_model_overrides(cfg, args), mesh)
    model = PointTransformer(cfg, device=args.device)
    if state is not None:
        model.load_state_dict(state, strict=True)
    else:
        print("[cli] no --params given; registering with a randomly "
              "initialized model", file=sys.stderr)
    model.eval()
    torch.set_grad_enabled(False)
    return model, normalize


def cmd_register(args, mesh=None):
    """GT-free registration of two raw clouds, a manifest of pairs, or N
    scans into one frame (``--scans``)."""
    import numpy as np

    from scream_tpu_torch.pipeline import (default_edges, register_multiway,
                                           register_pair, register_pair_robust,
                                           register_pairs, register_pairs_robust)

    scans = None
    if args.scans:
        if args.src or args.tgt or args.manifest:
            raise SystemExit("--scans is exclusive with --src/--tgt/--manifest")
        if args.robust:
            raise SystemExit(
                "--scans uses the batched serving path; --robust is a "
                "single-pair search (see pipeline.register_multiway)")
        if len(args.scans) < 2:
            raise SystemExit("--scans needs at least two clouds")
        if args.window < 1:
            raise SystemExit(f"--window must be >= 1, got {args.window}")
        scans = [_load_cloud(p, f"scan {k}") for k, p in enumerate(args.scans)]

    manifest = None
    if args.manifest:
        if args.src or args.tgt:
            raise SystemExit("--manifest and --src/--tgt are exclusive")
        manifest = _read_manifest(args.manifest)
    elif scans is None and not (args.src and args.tgt):
        raise SystemExit("need --src and --tgt (or --manifest / --scans)")
    elif scans is None:
        src = _load_cloud(args.src, "src")
        tgt = _load_cloud(args.tgt, "tgt")

    # Mesh validation before the model build and the checkpoint load.
    if args.mesh and (manifest is None and scans is None or args.robust):
        raise SystemExit(
            "--mesh shards the batched manifest/scans paths only "
            "(single-pair and --robust dispatches are not sharded; see "
            "pipeline.register_pairs)")
    if mesh is None:
        mesh = _parse_mesh(args)
        if mesh is not None and args.batch_size % mesh.shape["data"] != 0:
            raise SystemExit(
                f"--mesh: --batch-size {args.batch_size} must divide by the mesh "
                f"data axis ({mesh.shape['data']})")
        if _on_mesh("cmd_register", args, mesh):
            return
    model, normalize = _build_model(args, mesh)
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

    if scans is not None:
        # Pairwise serving over chain + skip edges, pose-graph
        # synchronization, then the scan-to-map polish: one line a scan.
        res = register_multiway(
            model, scans, edges=default_edges(len(scans), window=args.window),
            refine_rounds=args.refine_rounds, batch_size=args.batch_size,
            passes=args.passes, mesh=mesh, **kw)
        for k, pose in enumerate(res.poses):
            print(json.dumps({"scan": k, "pose": pose.tolist()}))
        print(f"[cli] {len(res.edges)} pairwise edges, fitness "
              f"min/median {float(np.min(res.edge_fitness)):.3f}/"
              f"{float(np.median(res.edge_fitness)):.3f}", file=sys.stderr)
        if args.out and _is_rank0(mesh):
            np.save(args.out, res.poses)
        return

    if manifest is not None:
        if args.robust:
            results = register_pairs_robust(model, manifest,
                                            starts=args.robust_starts, **kw)
        else:
            results = register_pairs(model, manifest, batch_size=args.batch_size,
                                     passes=args.passes, mesh=mesh, **kw)
        for i, res in enumerate(results):
            print(json.dumps({"pair": i, **line(res)}))
        n_amb = sum(bool(r.ambiguous) for r in results)
        if args.robust and n_amb:
            print(f"[cli] WARNING: {n_amb}/{len(results)} pair(s) flagged "
                  "ambiguous (a distinct pose scored within the "
                  "near-symmetry band of the winner — likely symmetric "
                  "geometry; inspect score_margin)", file=sys.stderr)
        if args.out and _is_rank0(mesh):
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


def _is_rank0(mesh) -> bool:
    import torch

    return mesh is None or torch.distributed.get_rank() == 0


def cmd_convert(args):
    """Reference ``.pth`` -> a weights directory of the port (JAX command:
    ``scream_tpu/cli.py:cmd_convert``)."""
    from scream_tpu_torch.utils.torch_convert import convert_torch_checkpoint, tree_size

    tree = convert_torch_checkpoint(args.pth, args.out, model=args.model)
    print(json.dumps({"out": args.out, "model": args.model, "n_params": tree_size(tree)}))


def cmd_selftest(args):
    """Every Hopper kernel against its plain version on the card
    (``scream_tpu_torch/selftest.py``)."""
    from scream_tpu_torch.selftest import main as selftest_main

    raise SystemExit(selftest_main())


def _have_matplotlib() -> bool:
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def _png(path, draw, *a, **kw):
    """``path`` after ``draw(..., path=path)``, or where matplotlib is not
    installed the note that the PNG was skipped."""
    if not _have_matplotlib():
        return {"png_skipped": "matplotlib not installed"}
    draw(*a, path=path, **kw)
    return path


def cmd_visualize(args):
    """Render a pair to PNGs and an interactive HTML (JAX command:
    ``scream_tpu/cli.py:cmd_visualize``); the model views, RE/TE and the
    display gate are computed on ``--device``."""
    import numpy as np
    import torch

    from scream_tpu_torch.config import ModelConfig
    from scream_tpu_torch.data import PairDataset, PairLoader
    from scream_tpu_torch.utils import viz

    # KITTI splits carry their own protocol: unit-cube normalization
    # (reference datasets/kitti.py:268-273), the -R^T t center hint
    # (train_kitti.py:156), NN 1.5 / ICP 1.0 at max_iteration 1000
    # (evaluate_kitti.py:106-110).
    is_kitti = args.split.upper().startswith("KITTI")
    ds = PairDataset(args.root, args.split, with_info=False,
                     normalize="unit_cube" if is_kitti else "unit_sphere",
                     max_points=args.max_points)
    item = ds[args.item]
    T_gt = np.eye(4)
    T_gt[:3, :3] = item["rot"]
    T_gt[:3, 3] = item["trans"].reshape(3)
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.join(args.out, f"{args.split}_{args.item}")
    out = {"before": _png(stem + "_before.png", viz.plot_registration, item["src"],
                          item["tgt"], None),
           "gt": _png(stem + "_gt.png", viz.plot_registration, item["src"], item["tgt"],
                      T_gt)}

    if args.params:
        # Model views: predicted source, estimated registration, prediction
        # error (the reference's look() / visualize_3d_match flows).
        from scream_tpu_torch.geometry.pairwise import square_distance
        from scream_tpu_torch.pipeline.register import (gt_center_hint, register_batch,
                                                        to_device)

        model, _ = _load_model("3dmatch", ModelConfig(), args.params, args, args.device)
        # Capacity must cover both clouds: src/tgt sizes are independent.
        cap = args.max_points or (max(len(item["src"]), len(item["tgt"])) + 64)
        b = next(iter(PairLoader([item], batch_size=1, src_capacity=cap, tgt_capacity=cap)))
        dev = to_device(b, args.device)
        center_mode = "neg_rt" if is_kitti else "trans"
        zero = args.mode == "zero"
        with torch.no_grad():
            src_pred = model(dev["src"], dev["tgt"], dev["src_mask"], dev["tgt_mask"],
                             gt_center_hint(dev["rot"], dev["trans"], center_mode))
            # Zero-overlap protocol: corr = src_pred itself, thresh 0.2
            # (reference evaluate_3d_match.py:193-195); the match flow: NN
            # 0.1 and ICP 0.1 at Open3D's default 30 iterations
            # (visualize_3d_match.py:73-76,139-151); KITTI its own.
            m = register_batch(model, dev,
                               dis_thresh=1.5 if is_kitti else (0.2 if zero else 0.1),
                               corr="src_pred" if zero else "tgt",
                               icp_thresh=1.0 if is_kitti else 0.1,
                               icp_max_iter=1000 if is_kitti else 30,
                               center_mode=center_mode, device=args.device)
        n = int(b["src_mask"][0].sum())
        n_tgt = int(b["tgt_mask"][0].sum())
        pred = src_pred[0, :n].float().cpu().numpy()
        src_np = b["src"][0, :n]
        gt_pos = src_np @ item["rot"].T + item["trans"].reshape(3)
        out["re_deg"] = float(m.re_deg[0])
        out["te"] = float(m.te[0])
        # The zero-match flow shows only pairs with RE < --re-gate
        # (visualize_3d_match.py:117); the match flow shows every pair.
        gated = zero and out["re_deg"] >= args.re_gate
        out["display_gated"] = gated
        if not gated:
            T_est = m.transform[0].cpu().numpy()
            out["predicted"] = _png(stem + "_predicted.png", viz.plot_registration,
                                    item["src"], item["tgt"], None, src_pred=pred)
            out["estimated"] = _png(stem + "_estimated.png", viz.plot_registration,
                                    src_np, b["tgt"][0, :n_tgt], T_est)
            out["pred_error"] = _png(stem + "_pred_error.png", viz.plot_prediction_error,
                                     pred, gt_pos, tgt=item["tgt"])
            if zero:
                # Flow lines and the selected correspondences: squared
                # distances in the de-scaled frame below 0.2
                # (visualize_3d_match.py:62-64,98-116).
                inv_s = 1.0 / dev["scale"][0]
                with torch.no_grad():
                    d2 = square_distance(src_pred[:, :n].float() * inv_s,
                                         dev["tgt"][:, :n_tgt] * inv_s)[0].min(-1).values
                selected = (d2 < 0.2).cpu().numpy()
                out["flow"] = _png(stem + "_flow.png", viz.plot_prediction_flow, src_np,
                                   pred, selected=selected)
    if args.html:
        # The interactive counterpart of the reference's draw_geometries
        # windows (visualize_3d_match.py:118-124,184-188).
        from scream_tpu_torch.utils.viz_html import export_registration_html

        kw = {}
        if args.params and not out.get("display_gated"):
            kw["T_est"] = T_est
            kw["src_pred"] = pred
            if zero:
                sel = np.flatnonzero(selected)[:400]
                kw["corr"] = (src_np[sel], pred[sel])
        out["html"] = export_registration_html(
            stem + "_interactive.html", item["src"], item["tgt"], T_gt=T_gt,
            title=f"{args.split} item {args.item}", **kw)
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
                   help="size-bucketed loader (256 .. max-points buckets) and, "
                        "without data, per-bucket synthetic pairs in two overlap "
                        "tiers: the recipe of the multi-scale checkpoints")
    t.add_argument("--max-points", type=int, default=None,
                   help="padding bucket; oversize clouds are subsampled")
    t.add_argument("--d-model", type=int, default=None)
    t.add_argument("--self-layers", type=int, default=None)
    t.add_argument("--cross-layers", type=int, default=None)
    t.add_argument("--mesh", default=None,
                   help="multi-GPU mesh, e.g. 'data=8', 'data=4,seq=2', 'data=4,model=2' "
                        "(Megatron tensor parallelism), 'data=2,pipe=4' (GPipe) or 'auto' "
                        "(every card on the data axis): one process a rank over "
                        "torch.distributed, batches cut over the data ranks")
    t.add_argument("--dtype", choices=["bfloat16", "float32"], default=None,
                   help="compute dtype override (bf16 is the default)")
    t.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the first epoch here")
    t.add_argument("--sample-img-dir", default=None,
                   help="dump GAN sample images here every save_img_iter steps")
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
    e = sub.add_parser("evaluate", help="run a benchmark protocol")
    e.add_argument("protocol", choices=sorted(EVAL_SPLITS))
    e.add_argument("--root", default="data")
    e.add_argument("--params", default=None,
                   help="torch checkpoint directory of the port (model.pt + "
                        "model_config.json)")
    e.add_argument("--batch-size", type=int, default=8)
    e.add_argument("--max-points", type=int, default=None,
                   help="padding bucket; oversize clouds are subsampled")
    e.add_argument("--d-model", type=int, default=None)
    e.add_argument("--self-layers", type=int, default=None)
    e.add_argument("--cross-layers", type=int, default=None)
    e.add_argument("--bucketed", action="store_true",
                   help="group pairs by cloud size (one padded shape per bucket)")
    e.add_argument("--cache-dir", default=None,
                   help="pre-collated bucket-shard cache dir (built on first use): "
                        "batches stream as memmap slices, no per-item host work")
    e.add_argument("--dis-thresh", type=float, default=None,
                   help="NN correspondence threshold (protocol preset default)")
    e.add_argument("--rmse-thresh", type=float, default=None,
                   help="redwood RMSE recall criterion (default 0.2)")
    e.add_argument("--icp-thresh", type=float, default=None,
                   help="ICP max correspondence distance")
    e.add_argument("--icp-max-iter", type=int, default=None,
                   help="ICP iteration cap (30 for 3DMatch, 1000 for KITTI)")
    e.add_argument("--experimental-icp-chunk", dest="icp_chunk", type=int, default=None,
                   help="kitti only: chunked ICP whose finished lanes retire between "
                        "chunks (the same protocol numbers)")
    e.add_argument("--re-stat", choices=["median", "mean"], default=None,
                   help="per-scene RE/TE statistic")
    e.add_argument("--center-mode", choices=["trans", "neg_rt", "none"], default=None,
                   help="src_center hint (preset default; 'none' evaluates a "
                        "hint-free-trained checkpoint)")
    e.add_argument("--mesh", default=None,
                   help="multi-GPU mesh for eval, e.g. 'data=8' or 'auto'")
    e.add_argument("--dtype", choices=["bfloat16", "float32"], default=None,
                   help="compute dtype override")
    e.add_argument("--device", default="cuda",
                   help="torch device of the model and the kernels "
                        "(cpu runs the plain PyTorch versions)")
    e.set_defaults(fn=cmd_evaluate)

    b = sub.add_parser("bench", help="run the throughput benchmark", allow_abbrev=False)
    b.add_argument("--suite", action="store_true",
                   help="also time the other workload classes")
    b.add_argument("--write", default=None, metavar="PATH",
                   help="persist every emitted metric to this JSON file")
    b.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the plain PyTorch versions)")
    b.set_defaults(fn=cmd_bench)

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
                   help="pairs per forward in --manifest and --scans modes")
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
                        "manifest mode, the (N, 4, 4) poses with --scans)")
    r.add_argument("--scans", nargs="+", default=None,
                   help="multiway: N scan paths -> absolute poses in scan 0's "
                        "frame (pairwise serving + pose-graph synchronization, "
                        "pipeline.register_multiway)")
    r.add_argument("--window", type=int, default=2,
                   help="multiway edge window: pair each scan with the next W "
                        "scans (chain + skip loop closures)")
    r.add_argument("--refine-rounds", type=int, default=0,
                   help="multiway: scan-to-map ICP polish rounds after the "
                        "pose-graph synchronization")
    r.add_argument("--mesh", default=None,
                   help="manifest/scans modes: cut each dispatch's pairs over the "
                        "mesh's data axis, e.g. 'data=4' (--batch-size must divide by it)")
    r.add_argument("--d-model", type=int, default=None)
    r.add_argument("--self-layers", type=int, default=None)
    r.add_argument("--cross-layers", type=int, default=None)
    r.add_argument("--dtype", choices=["bfloat16", "float32"], default=None)
    r.add_argument("--device", default="cuda",
                   help="torch device of the model and the kernels "
                        "(cpu runs the plain PyTorch versions)")
    r.set_defaults(fn=cmd_register)

    pr = sub.add_parser("preprocess", help="raw data -> .npy artifacts")
    pr.add_argument("task", choices=["3dmatch", "kitti", "opengf", "collate"])
    pr.add_argument("--root", required=True)
    pr.add_argument("--out", default="data")
    pr.add_argument("--protocol", choices=sorted(EVAL_SPLITS), default="3dmatch",
                    help="(collate) which eval split/normalization to collate")
    pr.add_argument("--max-points", type=int, default=4096,
                    help="(collate) padding-bucket ceiling")
    pr.add_argument("--device", default="cuda",
                    help="(kitti) torch device of the GT-refining ICP and its "
                         "bounded NN kernel (cpu runs the plain PyTorch version)")
    pr.set_defaults(fn=cmd_preprocess)

    st = sub.add_parser(
        "selftest",
        help="every Hopper kernel against its plain version on the card "
             "(one JSON line; nonzero exit on a miss or without a GPU)")
    st.set_defaults(fn=cmd_selftest)

    c = sub.add_parser("convert",
                       help="reference .pth checkpoint -> weights directory of the port")
    c.add_argument("--pth", required=True,
                   help="e.g. point-generator.pth from the reference")
    c.add_argument("--out", required=True,
                   help="output directory (model.pt + model_config.json)")
    c.add_argument("--model", choices=["point", "dem", "disc"], default="point",
                   help="point (point/kitti-generator), dem (dem-generator), "
                        "disc (discriminator)")
    c.set_defaults(fn=cmd_convert)

    v = sub.add_parser("visualize", help="render a pair to PNGs")
    v.add_argument("--root", default="data")
    v.add_argument("--split", default="3DMatch_test")
    v.add_argument("--item", type=int, default=0)
    v.add_argument("--out", default="viz_out")
    v.add_argument("--params", default=None,
                   help="weights directory of the port for the model views")
    v.add_argument("--mode", choices=["match", "zero"], default="match",
                   help="zero = zero-overlap flow (corr=src_pred, flow lines)")
    v.add_argument("--re-gate", type=float, default=3.0,
                   help="emit model-view PNGs only when RE < this (deg), the "
                        "reference's display gate (visualize_3d_match.py:117); "
                        "set large to always emit")
    v.add_argument("--html", action="store_true",
                   help="also write an interactive self-contained HTML scene "
                        "(utils/viz_html.py)")
    v.add_argument("--max-points", type=int, default=None)
    v.add_argument("--d-model", type=int, default=None)
    v.add_argument("--self-layers", type=int, default=None)
    v.add_argument("--cross-layers", type=int, default=None)
    v.add_argument("--device", default="cuda",
                   help="torch device of the model, the registration and the kernels "
                        "(cpu runs the plain PyTorch versions)")
    v.set_defaults(fn=cmd_visualize, dtype=None)
    return p


def main(argv: Optional[list] = None):
    args = build_parser().parse_args(argv)
    args.fn(args)
