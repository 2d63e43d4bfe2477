#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, the CUDA toolkit (``nvcc``) and ``nvidia-smi``; it
imports nothing of JAX or of the JAX package. Phases, one line each:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: the kernels from ``scream_tpu_torch/csrc``, one ``nvcc`` process a
   source, all at once, then the link (compiler report in
   ``chip_smoke_build.log`` of the output directory, ``OUT_DIR``);
3. kernels @ d=256: each kernel against its plain PyTorch version on the
   card, at the ``register_batch`` path's shapes, with its time, the plain
   version's time and the least time the card could take for the same work;
   the stats kernel also launched twice (bit identical) and with one batch's
   mask all zero (exactly 0), gated at 0.25 ms; the exact NN gated at
   0.177 ms, beside ``torch.cdist(src, dst).min(-1)`` (a reference line);
   the bounded NN with the tile boxes given (the boxes kernel against its
   plain version) and made per call (identical), gated at 0.10 ms; both on
   exact ties (16 lanes, one dead for the bounded NN: the lowest index
   wins, bit for bit); the stats projection alone as one ``torch.matmul``
   (a reference line); ptxas's lines, with no spill allowed in the splat,
   exact-NN and fp32 kernels; apply gated at 0.50 ms at path 1's shape;
4. path 1, ``register_batch`` at 16 pairs x 4,096 points, the shipped
   full-width point-generator (``scream_tpu_torch/weights/point-generator``:
   d 256, 6 + 6 layers), 30 ICP iterations, distinct
   inputs per call, with and without ``icp_subsample=1024``; pairs/s, each
   kernel's launches (all of the path's must be > 0) and finiteness;
5. oracle pose: the pose solve and ICP fed the GT-posed source plus noise
   must recover the pose; the same solve on the CPU path must agree;
6. kernels at the GT-free serving path's shapes against their plain
   versions: d=128 (head dim 16) attention (stats gated at 0.12 ms), the
   exact NN at B = 1, 7, 8, the batched bounded NN at B = 7, 8, 14 and the
   unbatched one at B = 1 (gated at 0.06 ms at 512 and 4,096 points), both
   NN kernels on exact ties at B = 1; ICP's NN launches a step, read from
   the wrappers' device-launch counts (one a step, one box launch a call);
7. path 2, GT-free serving with the shipped hint-free checkpoint
   (``scream_tpu_torch/weights/point-generator-hintfree``): 16 fresh
   448-point pairs (seed 100, poses <= 30 deg) through
   ``register_pair(passes=2)``, ``register_pairs`` (batch 8) and
   ``register_pair_robust`` on the card and on the CPU path (per API,
   recall and transforms must agree); launches (all five kernels > 0);
8. the CLI (``python -m scream_tpu_torch register``) in a subprocess, its
   transform against the in-process one;
9. serving times (ungated): ``register_pairs`` pairs/s at 8 x 512 and
   8 x 4,096, ``register_pair`` latency at 512 and 4,096 points, the robust
   latency, and the stage times of one pass;
10. path 3, the GAN training step (``threedmatch_presets`` with
    ``use_gan``: full-width generator from a seeded random init, the
    shipped discriminator ``scream_tpu_torch/weights/discriminator``):
    the splat kernel against its plain version at the 3DMatch shape
    (48 images x 8,192 points x 64 x 64, rho 24; gated at 1.6378 ms) and
    the KITTI GAN shape (8 back views x 16,384 points, rho 48), forward and
    argmax bit for bit, VJP, the shares of work its tests leave (from its
    counting build), its bound from the work the data needs (counted from
    the plain output), and on adversarial scenes (duplicated and
    equidistant points, v <= 0, all-zero pixels, points around its
    thresholds, very large and small values, values just above e^-16) bit
    for bit, beside a check of ``expf`` over every non-positive fp32 that
    its skip rule rests on; one
    generator step (GAN on) and one discriminator step on the card and on
    the CPU path (2 pairs x 1,024 points); the shipped discriminator's mean
    logits on real and fake renders (8 pairs x 512 points) on both; then
    timed training at 8 pairs x 4,096 points, G + D iterations and G-only
    steps, pairs/s, stage times and launches (splat, stats, apply > 0); the
    stats and apply kernels also on that input cut to 4,000 rows a pair
    (stats at 8 x 4,096 gated at 0.15 ms and below its plain version);
11. path 4, OpenGF training (``opengf_presets()`` at d_model 512: 8 heads
    of 64, 6 + 6 layers, separate stems, seeded random init, GAN off), where
    every attention block runs the tail kernel: ``csrc/tail.cu`` against its
    plain version on the first DSM and coarse-DEM stem blocks' real tail
    inputs (8 x 8,192 and 8 x 1,024), forward and gradients, on the DSM
    input cut to 65,536 - 37 and 8,192 + 5 rows, and at d 256 on
    path 1's batch through ``ModelConfig(fused_attention=False)``; the
    kernel forward against the literal plain forward; one
    ``make_dem_train_step`` on the card and on the CPU path (2 x 1,024);
    timed training through ``DEMTrainer.train_epoch`` at 8 x 8,192
    (patches/s, stage times, launches: ``block_tail`` > 0), ``evaluate``,
    save / restore / one more step on both; then the ``train`` CLI in
    subprocesses (``opengf --d-model 512``, its ``--resume``, ``3dmatch``);
    its d 256 tail check runs a seeded random init on path 1's batch;
12. path 5, the evaluate protocols and the bench with the shipped
    checkpoints, on a split tree written with numpy under ``build/``
    (3DMatch_test: 40 pairs over 8 scenes, clouds of 900-4,096 points
    filling the 1,024, 2,048 and 4,096 buckets; KITTI_test: 8 pairs of up
    to 8,192 points, extent 40; OpenGF_test: 8 patches): the host waits
    inside one ``register_batch`` (``torch.cuda.set_sync_debug_mode``),
    ``evaluate_registration`` (3dmatch) through ``BucketedPairLoader`` and
    through ``collated_or_build`` (equal metrics), 3dzeromatch, the 1,024
    bucket pair by pair on the card and the CPU path (recall equal, at most
    2 pairs with RE or TE off by > 5e-2), ``python -m scream_tpu_torch
    evaluate 3dmatch --bucketed`` in a subprocess (its JSON equal to the
    in-process dict), ``evaluate_kitti`` with the hint-free KITTI
    checkpoint and ``center_mode="none"``, fused and with ``icp_chunk=50``
    (counts equal, one batch's transforms within 1e-5, the ICP steps taken
    of the 1,000 allowed), ``evaluate_open_gf`` with the DEM generator
    (finite, within 2e-2 of the CPU path on 2 patches, peak memory), and
    ``bench`` and ``bench --suite`` in subprocesses (every metric > 0, the
    shipped checkpoint named, median RE beside the CPU path's on 4 pairs,
    the path's kernels launched: stats, apply, both NNs, and the splat in
    the suite);
13. path 6, ingestion on the card: the host point-ops library built with
    ``g++`` from ``scream_tpu_torch/native`` (against its plain versions);
    a raw tree from ``scripts/torch_port_make_raw.py`` (scale 0.002) through
    ``python -m scream_tpu_torch preprocess 3dmatch|kitti|opengf`` at once
    and then ``collate`` (3dmatch, kitti) in subprocesses on the CLI's
    defaults, every split opened with the port's readers at the size the
    generator built, each refined KITTI GT within 1e-3 of the generator's
    pose, ``evaluate`` 3dmatch (on the collated cache), kitti and opengf
    with the shipped checkpoints on the produced splits (finite metrics,
    the path's kernels launched); then one KITTI pair of two 120,000-point
    frames sharing their points, the pose file wrong by 0.1 deg and 4 cm,
    through ``KittiOdometry(gt_icp_voxel=None)``: ``nn_bounded_single`` at
    1 x 131,072 against its plain version on 4,096 src rows, timed, its
    live tiles per sub-slab, the refinement's steps, wall, peak memory and
    launches, ICP's pose within 0.01 deg and 1 mm of its truth;
14. path 7, the float32 configuration (the shipped weights loaded with
    ``dtype="float32"``; ``csrc/attn_f32.cu`` and ``csrc/tail_f32.cu``):
    fp32 stats and apply against their plain versions at path 1's 16 x
    4,096 (stats bit identical across launches, a zero-mask batch exactly
    0), at 8 x 4,000 and at the serving shape 8 x 512 (d 128), the fused
    block against the literal plain block; the fp32 tail at d 384 on a
    seeded random-init DEMTransformer's first block (8 x 4,096, and 65,536
    - 37 rows) and at d 256 through ``fused_attention=False``; the tail's
    products as fp32 ``torch.matmul`` (a reference line); the card's fp32
    forwards of the point-generator and the hint-free model against the JAX
    package's (``tests/data/torch_port_fp32_reference.npz``) and the CPU
    path's; ``register_batch`` at 16 x 4,096 (pairs/s, median RE, launches)
    and the 1,024 bucket of path 5's tree card vs CPU; ``evaluate 3dmatch
    --bucketed --dtype float32`` in a subprocess; path 2's GT-free serving
    on the card and the CPU path, with its bistable pairs; the ``register``
    CLI and ``train opengf --d-model 384`` with ``--dtype float32`` in
    subprocesses (the train CLI's tail launches > 0);
15. path 8, bf16 at d 384 (8 heads of 48) and the other head counts: a
    seeded random-init ``opengf_presets()`` DEMTransformer at d 384, stats
    and apply against their plain versions on the first DSM stem block's
    real input (8 x 8,192, and 65,536 - 37 rows as one sequence; stats bit
    identical across launches, a zero-mask batch exactly 0), the fused
    block against the literal plain block and its gradients against the
    plain block's; one DEM step on the card and the CPU path; timed
    ``DEMTrainer.train_epoch`` at 8 x 8,192 (patches/s, stage times,
    stats and apply launches); every other (d, heads, dtype) cell of the
    kernels against its plain version at its path's shape (bf16 d 128 at
    8 x 512, d 256 at 16 x 4,096, d 384 at 8 x 4,096; fp32 under path 7's
    bars), with its launches in one ``ModelConfig(num_heads=...)``
    forward; then in subprocesses ``train opengf|3dmatch --d-model 384``,
    and on the 3DMatch checkpoint train wrote ``evaluate 3dmatch
    --bucketed --d-model 384 --params`` and ``register --d-model 384
    --params`` (stats and apply launches > 0 in each);
16. path 9, multiway registration, the robust GT-free measurement,
    multi-scale training and the geometry library: (a) 16 seeded scans of
    4,096 points of one ``make_scene`` scene (consecutive views <= 10 deg
    and 0.1 apart) through ``register_multiway`` with the hint-free
    checkpoint (window 2: 29 edges, one scan-to-map round; launches, wall,
    pose errors), ``synchronize_poses`` twice on the card (bit for bit, its
    host waits), ``refine_to_map`` of the synchronized poses perturbed by
    0.03 rad / 0.03 (must lower the largest pose errors), the bounded NN at
    the map's shape (4,096 x 65,536) against its plain version on 1,024 src
    rows, and ``register --scans`` in a subprocess (poses within 1e-5 of
    the in-process ones); (b) ``scripts/torch_port_measure_gt_free.py`` at
    16 x 448 with ``--starts oct24 --max-angle-deg 90`` and ``--starts ico60
    --max-angle-deg 180`` (finite rows), stats and apply (fp32) at the ico60
    passes' 60 lanes x 512 against their plain versions; (c) the 3DMatch
    preset's steps on the ``--multi-scale`` loader's 256- and 4,096-point
    batches, stats and apply at the 8 x 256 bucket's first-block input, pairs/s
    by bucket, ``train 3dmatch --multi-scale`` in a subprocess; (d) normals,
    the voxel downsample (against the native library), so3 / se3 exp and
    log on the card against the CPU path. The CPU path's sides (the first
    dispatch of 8 edges, the first 4 ico60 pairs, the bucketed steps) run
    in a child process at nice 19 from path 4 on; the card's results are
    held to them at the end (path 2's transform bar on at most 1 of 8 edges
    and 1 of 4 pairs, ``synchronize_poses`` 1e-4, the steps' point_loss 2e-2
    and gradient norm 5e-2);
17. the kernel list (JSON), the ``nvidia-smi`` line, and last the result
    line ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the result line. A watchdog turns a hang
into a stack dump and exit code 1. Every printed line also goes to
``chiprun_out/chip_smoke.log``.

``python3 chip_smoke.py --only splat,nn_exact`` runs phases 1-2 and then
only the named kernels' checks (the splat's of phase 10, the exact NN's of
phase 3 and its ties), on the same inputs, gates included: the short
build-and-compare after a change to either kernel. ``--only tail`` checks
the tail kernel at every width it takes (bf16 d 128-512 at ragged and the
DEM path's row counts, fp32 d 128-384), ``--only apply`` stats and apply at
path 1's shape (gates included) and at every (d, heads, dtype) cell;
``--only ingest`` runs phases 1-2 and path 6, ``--only fp32`` path 7,
``--only d384`` path 8, ``--only multiway`` path 9 (its CPU references'
child started with it). None prints a result line.
"""

import faulthandler
import json
import math
import os
import subprocess
import sys
import time

WATCHDOG_S = 1080
B, CAP, N_SRC, N_TGT = 16, 4096, 3840, 4032  # bench.py's headline shape
ICP_ITERS, ICP_SUB = 30, 1024
TIMED_BATCHES = 3
HINTFREE = os.path.join("scream_tpu_torch", "weights", "point-generator-hintfree")
GT_FREE_PAIRS, GT_FREE_POINTS, GT_FREE_SEED = 16, 448, 100  # measure_gt_free.py
SERVE_BATCH, SERVE_PAIRS = 8, 64  # the README's serving shape: 8 x 512
TRANSFORM_TOL = 5e-2  # card vs CPU path, per transform entry (bf16 forward)
# Kernels against their plain versions, relative to the largest value: in
# bf16 one ulp of the output is 4e-3..8e-3 of it; in fp32 only the order of
# the fp32 sums differs (the JAX fp32 tail's CPU bar is 2e-5). fp32 forwards
# on the card against the JAX package's and the port's CPU forwards: 1e-4.
BF16_BARS = {"stats": 5e-3, "apply": 1e-2, "block": 5e-2}
FP32_BARS = {"stats": 1e-5, "apply": 2e-5, "block": 2e-5, "tail": 2e-5, "forward": 1e-4}
PATH1_KERNELS = ("attn_stats", "attn_apply", "nn_exact", "nn_bounded", "nn_tile_boxes")
PATH2_KERNELS = PATH1_KERNELS + ("nn_bounded_single",)
# Path 3: threedmatch_presets() (batch 8, max_points 4,096) with use_gan;
# KITTI's max_points 8,192 for the KITTI GAN render shape.
TRAIN_B, TRAIN_CAP, KITTI_CAP = 8, 4096, 8192
TRAIN_ITERS = 5  # timed iterations per mode, after one warm-up
DISC = os.path.join("scream_tpu_torch", "weights", "discriminator")
PATH3_KERNELS = ("attn_stats", "attn_apply", "max_splat")
# Path 4: opengf_presets() (batch 8, max_points 8,192) at d_model 512; the
# coarse DEM at the CLI's max(cap // 8, 64) capacity.
DEM_D, DEM_B, DEM_CAP, DEM_COARSE = 512, 8, 8192, 1024
DEM_ITERS = 5  # timed iterations, after one warm-up
# Ragged row counts: apply at 4,000 rows a pair (8 pairs), the tail at
# 65,536 - 37 and 8,192 + 5 rows.
RAGGED_L, RAGGED_TAIL_ROWS = 4000, (65536 - 37, 8192 + 5)
WORK_DIR = os.path.join("build", "chip_smoke_work")  # checkpoints; removed at the end
# Path 1's trained weights; path 5's KITTI and OpenGF checkpoints.
POINT_GEN = os.path.join("scream_tpu_torch", "weights", "point-generator")
KITTI_HINTFREE = os.path.join("scream_tpu_torch", "weights", "kitti-generator-hintfree")
DEM_GEN = os.path.join("scream_tpu_torch", "weights", "dem-generator")
# Path 5: the split tree (3DMatch_test 40 pairs over 8 scenes, clouds of
# 900-4,096 points spread over the 1,024 / 2,048 / 4,096 buckets; KITTI_test
# 8 pairs of up to 8,192 points, extent 40; OpenGF_test 8 patches), the
# evaluate CLI's batch of 8, the KITTI chunk, and the card-vs-CPU bars.
EVAL_PAIRS, EVAL_BATCH, KITTI_PAIRS, OPENGF_PATCHES, KITTI_CHUNK = 40, 8, 8, 8, 50
PATH5_KERNELS = ("attn_stats", "attn_apply", "nn_exact", "nn_bounded")
OPENGF_CPU_PATCHES, OPENGF_TOL = 2, 2e-2
# Path 6: the raw tree of scripts/torch_port_make_raw.py at this scale (12
# KITTI pairs, 8 + 8 3DMatch test pairs, 289 + 75 + 4 OpenGF patches); each
# refined KITTI GT within KITTI_GT_TOL per entry of the generator's pose
# (on these frames the 0.3-voxel clouds' ICP optimum sits up to ~3e-4 from
# it, their centroids not being the shared points). The raw-frame pair:
# frames of ~RAW_POINTS points (an HDL-64 sweep) 6 m apart, sharing world
# points; the pose file wrong by RAW_POSE_ERR (deg, m); the refined pose
# within RAW_RE_TOL deg and RAW_TE_TOL m of the truth; the kernel held to
# its plain version on RAW_CHECK_ROWS src rows against the full dst.
INGEST_SCALE, KITTI_GT_TOL = 0.002, 1e-3
RAW_POINTS, RAW_POSE_ERR, RAW_RE_TOL, RAW_TE_TOL = 120_000, (0.1, 0.04), 0.01, 1e-3
RAW_CHECK_ROWS, RAW_THRESH = 4096, 0.2
# Path 7, the float32 configuration: the fp32 tail at d 384 on the first DSM
# stem block of a seeded random-init DEMTransformer at 16 x 4,096 (the first
# 8 pairs, and all rows cut to 65,536 - 37); the train CLI at d 384, two
# steps of 16 patches at capacity 2,048; path 2's bistable pairs (PERF.md);
# the JAX package's fp32 forwards, written by the script below.
F32_TAIL_D, F32_TAIL_B, F32_TAIL_CAP, F32_TAIL_RAGGED = 384, 16, 4096, 65536 - 37
F32_CLI_BATCH, F32_CLI_CAP = 16, 2048
BISTABLE_PAIRS = (0, 4, 15)
REFERENCE_SCRIPT = os.path.join("scripts", "torch_port_make_fp32_reference.py")
# Path 8, bf16 at d 384 (8 heads of 48) and the other head counts: path 4's
# DEM model at d 384 (8 x 8,192, and 65,536 - 37 rows in one sequence); every
# (d, heads) cell of the kernels (csrc/attn.cu ATTN_CELLS, csrc/attn_f32.cu
# ATTN_F32_CELLS) at its path's shape: d 128 at the serving 8 x 512, d 256 at
# path 1's 16 x 4,096, d 384 at 8 x 4,096; the launches of each cell from one
# forward of a ModelConfig(d_model=d, num_heads=heads) PointTransformer (1 + 1
# layers, 2 x 1,024 points).
D384, D384_RAGGED = 384, 65536 - 37
CELL_SHAPES = {128: (SERVE_BATCH, 512), 256: (B, CAP), 384: (8, 4096)}
CELL_HEADS = {"bfloat16": {128: (8, 4, 2), 256: (16, 8, 4), 384: (24, 12, 8, 6)},
              "float32": {128: (8, 4, 2), 256: (16, 8, 4)}}
CELL_FORWARD_B, CELL_FORWARD_N = 2, 1024
# The tail kernel's rows for --only tail (every width, ragged counts, the
# DEM path's 65,536 and 8,192 with one-off counts).
TAIL_ROWS = {128: (300,), 256: (1000, 65536), 384: (777, 8192), 512: (33, 8192, 8192 + 5,
                                                                      65536, 65536 - 37)}
# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, fp32 CUDA cores (an
# FMA counted as two operations), HBM3.
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12
# Rates for work counted in issued instructions: an fp32 instruction that is
# not an FMA takes a whole dispatch slot (132 SMs x 128 lanes x 1.98 GHz), and
# the special-function units take 16 MUFU.EX2 a clock per SM.
INSTR_FP32, INSTR_SFU = 132 * 128 * 1.98e9, 132 * 16 * 1.98e9
# Issued instructions of the NN kernels per (src, dst) pair: cross 5 (three
# products, two adds), |d|^2 + |s|^2 1, the fmaf 1, compare 1, two selects;
# per staged dst row, |d|^2 5.
NN_INSTR_PER_PAIR, NN_INSTR_PER_ROW = 10, 5
# Issued instructions of the splat per (point, pixel, channel) it
# evaluates: the exact test 9 (cross 3, |xy|^2 + |pix|^2 1, fmaf 1, max 1,
# scale 1, add 1, compare 1), expf and after it 11 (range reduction ~7
# around one MUFU.EX2, the product, compare, two selects); a dense sweep 22
# per (point, pixel) for both channels (cross 3, d^2 3, scale 1, expf 7, two
# products, two compares and four selects) and one MUFU.EX2.
SPLAT_INSTR_EXACT, SPLAT_INSTR_EXP, SPLAT_INSTR_DENSE = 9, 11, 22
# The splat's bound counts the (pair, channel)s within this log-domain band
# of their pixel's max (splat_needed_pairs): 2^-12, the relative width in
# which a bound built from fp32 log and exp may not separate two values.
SPLAT_NEED_BAND = 2.0 ** -12
# Time gates (ms): the stats kernel at each path's shape (the training
# shape also below its plain version), the bounded NN as ICP calls it. A
# gated kernel's ms and its plain version's are each the best of
# TIME_ROUNDS timing rounds, so that one round slowed by the host's
# neighbours does not decide it; every round is logged. Other rows time
# one round on both sides.
STATS_GATE_MS = {"": 0.25, "_train": 0.15, "_d128": 0.12}
# Apply at path 1's 16 x 4,096, d 256: above the runs of PRs 8-13
# (0.3918-0.4418 ms), so that generalizing the kernel cannot slow it unseen.
APPLY_GATE_MS = {"": 0.50}
NN_SINGLE_GATE_MS, NN_BATCHED_GATE_MS = 0.06, 0.10
# The splat at 48 x 8,192 x 64^2, rho 24, and the exact NN at 16 x 4,096:
# below the best of their first versions (PERF.md), so that a redesign that
# loses to them fails.
SPLAT_GATE_MS, NN_EXACT_GATE_MS = 1.6378, 0.177
TIME_ROUNDS = 3
# Path 9, multiway registration, the robust GT-free measurement, multi-scale
# training and the geometry library. Multiway: MW_SCANS views of one
# make_scene scene, MW_POINTS points each (a 70 % subset), consecutive views
# at most MW_STEP_DEG and MW_STEP_T apart, MW_WINDOW edges a scan (29 edges);
# the scan-to-map polish of the synchronized poses perturbed by MW_PERTURB
# rad and MW_PERTURB, MW_REFINE_ROUNDS rounds (tests/test_multiway.py's); the
# bounded NN at the map's shape held to its plain version on MAP_CHECK_ROWS
# src rows. The measurement script at MEASURE_PAIRS x MEASURE_POINTS for each
# of MEASURE_RUNS. Multi-scale: the 3DMatch preset's steps on the loader's
# MS_BUCKETS batches (the CPU path's step at 4,096 on MS_CPU_PAIRS pairs),
# MS_ITERS timed steps a bucket, the CLI on MS_CLI_PAIRS synthetic pairs a
# bucket and tier. The CPU path's sides of the comparisons (EDGE_CPU_DISPATCH
# edges, ROBUST_CPU_PAIRS ico60 pairs, the two steps) run in a child process
# at nice 19 from path 4 on (path9_cpu); the card waits at most
# PATH9_CPU_WAIT_S for it after its own work.
WORK9 = os.path.join("build", "chip_smoke_path9")
MW_SCANS, MW_POINTS, MW_WINDOW, MW_STEP_DEG, MW_STEP_T, MW_SEED = 16, 4096, 2, 10.0, 0.1, 1500
MW_PERTURB, MW_REFINE_ROUNDS, MAP_CHECK_ROWS, SYNC_TOL = 0.03, 2, 1024, 1e-4
MEASURE_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                              "torch_port_measure_gt_free.py")
MEASURE_PAIRS, MEASURE_POINTS = 16, 448
MEASURE_RUNS = (("oct24", 90.0), ("ico60", 180.0))
MS_BUCKETS, MS_CPU_PAIRS, MS_ITERS, MS_CLI_PAIRS = (256, 4096), 2, 5, 8
EDGE_CPU_DISPATCH, ROBUST_CPU_PAIRS, PATH9_CPU_WAIT_S, VOXEL = 8, 4, 420, 0.05
OUT_DIR = "chiprun_out"
ONLY_KERNELS = ("splat", "nn_exact", "tail", "apply")  # kernels --only can check alone
ONLY_PATHS = ("ingest", "fp32", "d384", "multiway")  # paths --only can run alone
DEV = "cuda"  # every phase runs on the card


def log(msg):
    """Print a line; every line also goes to ``chiprun_out/chip_smoke.log``,
    so the whole log survives a runner that keeps only the end of stdout."""
    print(msg, flush=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.log"), "a") as f:
        f.write(f"{msg}\n")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def bound(bytes_moved, ops_by_rate, overlap=False):
    """Least time (ms) for the work: the larger of bytes over HBM rate and
    the operations over their type's peak, summed over the types or, with
    ``overlap`` (units that run at once), the largest; returns (ms,
    "bytes"|"operations")."""
    t_bytes = bytes_moved / PEAK_BYTES
    t_ops = [ops / rate for ops, rate in ops_by_rate]
    t_ops = max(t_ops) if overlap else sum(t_ops)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn, rounds=TIME_ROUNDS, **kw):
    """(best, all): ``rounds`` runs of :func:`cuda_ms`."""
    t = [cuda_ms(fn, **kw) for _ in range(rounds)]
    return min(t), t


def rel_err(got, want, rows=None):
    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def repo_env():
    """(repository root, environment) for a subprocess that imports the port."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return root, env


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    smi = smi.strip().splitlines()[0]
    log(f"device: {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return smi


def phase_build():
    from scream_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.kernels()
    secs = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(_build.build_log)
    log(f"build: {secs:.1f} s, one nvcc process a source at once, then the link -> "
        f"{path.name}")
    fn, spills = None, {}
    for ln in _build.build_log.splitlines():
        if "Function properties for" in ln or "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln.split()[-1]
        elif "registers" in ln or "spill" in ln:
            log(f"  ptxas: {ln.strip()}")
            if "spill" in ln and fn:
                spills[fn] = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()][1:]
    # The kernels redesigned last, and the fp32 kernels, keep their
    # registers: no spills.
    for name in ("max_splat_kernel", "nn_exact_kernel", "attn_stats_f32_kernel",
                 "attn_apply_f32_kernel", "tail_f32_kernel"):
        hits = {f: v for f, v in spills.items() if name in f}
        check(hits and all(not any(v) for v in hits.values()),
              f"ptxas: {name} spills or is missing from the report: {hits}")


def make_batches(n_batches, seed, batch=B, n_src=N_SRC, n_tgt=N_TGT, cap=CAP):
    from scream_tpu_torch.data import PairLoader, SyntheticPairDataset

    ds = SyntheticPairDataset(length=batch * n_batches, n_src=n_src, n_tgt=n_tgt, seed=seed)
    return list(PairLoader(ds, batch_size=batch, src_capacity=cap, tgt_capacity=cap,
                           num_workers=8, prefetch=4))


def oracle_pred(batch, noise, seed, device):
    """The GT-posed source (normalized frame) plus Gaussian noise."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    pred = np.einsum("bij,bnj->bni", batch["rot"], batch["src"]) \
        + batch["trans"].transpose(0, 2, 1)
    pred = pred + rng.standard_normal(pred.shape) * noise
    return torch.as_tensor(pred.astype(np.float32), device=device)


def check_pack(Wm, W1, W2, Wq=None, suffix=""):
    """The weight pack of the tail and apply wrappers on the card
    (``tail_cuda.pack_weights``, one launch of ``csrc/tail.cu:pack_kernel``)
    against its plain version, the permuted copies on the CPU: bit-identical.
    Its time is part of both wrappers' times."""
    import torch

    from scream_tpu_torch.ops import tail_cuda

    pack = lambda *ws: tail_cuda.pack_weights(*ws[:3], Wq=ws[3] if Wq is not None else None)
    ws = (Wm, W1, W2, Wq)
    got = pack(*ws)
    want = pack(*(None if w is None else w.cpu() for w in ws))
    same = torch.equal(got.cpu(), want)
    check(same, f"pack_weights{suffix}: the card's blob differs from the plain pack")
    log(f"kernel pack_weights{suffix} ({W1.dtype}, d {W1.shape[0]}, hidden "
        f"{W1.shape[1]}{', with Wq' if Wq is not None else ''}): identical to the plain "
        f"pack {same} | {cuda_ms(lambda: pack(*ws)):.4f} ms")


def check_attention(blk, m_bool, suffix="", x=None, dtype=None):
    """Kernels 1 and 2 against their plain versions on the card, for the
    attention block ``blk`` on the input ``x`` (B, L, d), seeded random if
    None, with the mask ``m_bool`` (B, L); and the whole fused block against
    the literal plain block. In bf16 (``csrc/attn.cu``), or with ``dtype``
    fp32 the fp32 kernels (``csrc/attn_f32.cu``) under the fp32 bars.
    Returns records."""
    import torch

    from scream_tpu_torch.ops import attn_cuda

    dev = torch.device(DEV)
    bf, f32 = torch.bfloat16, torch.float32
    cd = dtype or bf
    fp32 = cd == f32
    bars = FP32_BARS if fp32 else BF16_BARS
    isz, peak = (4, PEAK_FP32) if fp32 else (2, PEAK_BF16)
    src = "scream_tpu_torch/csrc/attn_f32.cu" if fp32 else "scream_tpu_torch/csrc/attn.cu"
    records = []
    H, d = blk.num_heads, blk.d_model
    hid = d * blk.ffn_mult
    g = torch.Generator(device=dev).manual_seed(0)
    Bx, L = m_bool.shape
    if x is None:
        x = torch.randn((Bx, L, d), generator=g, device=dev)
    x = x.to(cd).contiguous()
    m = m_bool.float().contiguous()
    c = lambda w: w.detach().to(cd).contiguous()
    p = lambda w: w.detach().float().contiguous()
    Wq, Wk, Wv, Wm = (c(blk.q_proj.kernel), c(blk.k_proj.kernel),
                      c(blk.v_proj.kernel), c(blk.merge.kernel))
    W1, W2 = c(blk.ffn_in.kernel), c(blk.ffn_out.kernel)
    g1, b1, g2, b2 = (p(blk.norm1.scale), p(blk.norm1.bias), p(blk.norm2.scale),
                      p(blk.norm2.bias))

    # Kernel 1: attention statistics, against the plain version; two
    # launches bit identical (the sums add in row order); a batch
    # whose mask is all zero gives exactly 0; the time gate of the shape.
    KV, ks = attn_cuda.attn_stats(x, m, Wk, Wv, num_heads=H)
    KVp, ksp = attn_cuda.attn_stats_plain(x, m, Wk, Wv, num_heads=H)
    torch.cuda.synchronize()
    err = max(rel_err(KV, KVp), rel_err(ks, ksp))
    abs_err = max(float((KV - KVp).abs().max()), float((ks - ksp).abs().max()))
    check(err <= bars["stats"], f"attn_stats{suffix}: relative error {err:.3g} > "
          f"{bars['stats']}")
    KV2, ks2 = attn_cuda.attn_stats(x, m, Wk, Wv, num_heads=H)
    same = bool(torch.equal(KV, KV2) and torch.equal(ks, ks2))
    m0 = m.clone()
    m0[0] = 0.0
    KV0, ks0 = attn_cuda.attn_stats(x, m0, Wk, Wv, num_heads=H)
    zero = bool((KV0[0] == 0).all() and (ks0[0] == 0).all())
    err0 = max(rel_err(KV0[1:], KVp[1:]), rel_err(ks0[1:], ksp[1:])) if Bx > 1 else 0.0
    check(same and zero and err0 <= bars["stats"],
          f"attn_stats{suffix}: two launches identical {same}, all-masked batch zero "
          f"{zero}, the other batches' relative error {err0:.3g}")
    ms, ms_all = timed(lambda: attn_cuda.attn_stats(x, m, Wk, Wv, num_heads=H))
    pms, pms_all = timed(lambda: attn_cuda.attn_stats_plain(x, m, Wk, Wv, num_heads=H))
    gate = STATS_GATE_MS.get(suffix)
    if gate is not None:
        check(ms <= gate and (suffix != "_train" or ms < pms),
              f"attn_stats{suffix}: {ms:.4f} ms (rounds {ms_all}) against the {gate} ms "
              f"gate{' and its plain version ' + f'{pms:.4f} ms' if suffix == '_train' else ''}")
    log(f"kernel attn_stats{suffix} ({Bx} x {L}, d {d}, {attn_cuda.stats_tiles(L)} tiles a "
        f"batch): two launches bit identical {same}, all-masked batch exactly 0 {zero} | "
        f"timing rounds {', '.join(f'{t:.4f}' for t in ms_all)} ms, plain "
        f"{', '.join(f'{t:.4f}' for t in pms_all)} ms"
        + (f" (gate {gate} ms on the best)" if gate is not None else ""))
    hd = d // H
    b_ms, b_by = bound(Bx * L * d * isz + Bx * L * 4 + 2 * d * d * isz
                       + Bx * (H * hd * hd + d) * 4,
                       [(2 * Bx * L * d * 2 * d + 2 * Bx * L * H * hd * hd, peak)])
    records.append(dict(name="attn_stats" + suffix, err=err, max_abs_err=abs_err, ms=ms,
                        plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                        bar=f"{bars['stats']} rel", route="cuda", source=src,
                        replaces="scream_tpu/ops/attn_pallas.py:117"))

    # Kernel 2: attention apply + block tail (fed the plain stats).
    if not fp32:  # the fp32 kernels read the weights as they are
        check_pack(Wm, W1, W2, Wq, suffix="_apply" + suffix)
    args = (x, m, KVp, ksp, Wq, Wm, g1, b1, W1, W2, g2, b2)
    kw = dict(attn_eps=1e-6, ln_eps=1e-5, norm_dtype=f32)
    out = attn_cuda.attn_apply(*args, **kw)
    outp = attn_cuda.attn_apply_plain(*args, **kw)
    torch.cuda.synchronize()
    err = rel_err(out, outp, rows=m_bool)
    abs_err = float((out.float() - outp.float())[m_bool].abs().max())
    # bf16: one ulp at the output's largest values is 2^-8..2^-7 of them, so a
    # single final-rounding flip reaches 4e-3..8e-3.
    check(err <= bars["apply"], f"attn_apply{suffix}: relative error {err:.3g} > "
          f"{bars['apply']}")
    gate = APPLY_GATE_MS.get(suffix)
    if gate is None:
        ms = cuda_ms(lambda: attn_cuda.attn_apply(*args, **kw))
        pms = cuda_ms(lambda: attn_cuda.attn_apply_plain(*args, **kw))
    else:
        ms, ms_all = timed(lambda: attn_cuda.attn_apply(*args, **kw))
        pms, pms_all = timed(lambda: attn_cuda.attn_apply_plain(*args, **kw))
        check(ms <= gate, f"attn_apply{suffix}: {ms:.4f} ms (rounds {ms_all}) against the "
              f"{gate} ms gate")
        log(f"kernel attn_apply{suffix} ({Bx} x {L}, d {d}): timing rounds "
            f"{', '.join(f'{t:.4f}' for t in ms_all)} ms (gate {gate} ms on the best), plain "
            f"{', '.join(f'{t:.4f}' for t in pms_all)} ms")
    b_ms, b_by = bound(2 * Bx * L * d * isz + Bx * L * 4 + (2 * d * d + 2 * d * hid) * isz
                       + Bx * (H * hd * hd + d) * 4 + 4 * d * 4,
                       [(2 * Bx * L * d * (2 * d + 2 * hid), peak),
                        (2 * Bx * L * H * hd * hd, PEAK_FP32)])
    records.append(dict(name="attn_apply" + suffix, err=err, max_abs_err=abs_err, ms=ms,
                        plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                        bar=f"{bars['apply']} rel", route="cuda", source=src,
                        replaces="scream_tpu/ops/attn_pallas.py:147"))

    # The whole fused block against the literal plain block; in bf16 the
    # comparison the TPU selftest gates the Pallas kernels at (5e-2).
    weights = (blk.q_proj.kernel, blk.k_proj.kernel, blk.v_proj.kernel,
               blk.merge.kernel, blk.norm1.scale, blk.norm1.bias, blk.ffn_in.kernel,
               blk.ffn_out.kernel, blk.norm2.scale, blk.norm2.bias)
    with torch.no_grad():
        fused = attn_cuda.attention_block_fused(x, x, m_bool, m_bool, *weights,
                                                num_heads=H, dtype=cd, norm_dtype=f32)
        plain = attn_cuda.block_plain(x, x, m_bool, m_bool, *weights, num_heads=H,
                                      cd=cd, nd=f32, attn_eps=1e-6, ln_eps=1e-5)
    torch.cuda.synchronize()
    blk_err = rel_err(fused, plain, rows=m_bool)
    check(blk_err <= bars["block"], f"fused block{suffix} vs plain block: {blk_err:.3g} > "
          f"{bars['block']}")
    log(f"kernel fused_block_vs_plain_block{suffix} (d {d}, {H} heads of {hd}, {Bx} x {L}, "
        f"{cd}): rel_err {blk_err:.3e} (bar {bars['block']})")
    return records


def stats_matmul_reference():
    """A reference line, not ``library_ms``: the stats kernel's projection
    alone, one bf16 ``torch.matmul`` of (B S, d) x (d, 2 d), at path 1's
    65,536 rows and path 3's 32,768 (d 256)."""
    import torch

    g = torch.Generator(device=DEV).manual_seed(5)
    parts = []
    for rows in (65536, 32768):
        x = torch.randn((rows, 256), generator=g, device=DEV).to(torch.bfloat16)
        W = torch.randn((256, 512), generator=g, device=DEV).to(torch.bfloat16)
        parts.append(f"{rows} x 256 x 512 {cuda_ms(lambda: x @ W):.4f} ms")
    log("reference (not library_ms): the stats projection alone as one bf16 torch.matmul: "
        + ", ".join(parts))


def log_records(records):
    for r in records:
        log(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
            f"(err {r['err']:.3e}, bar {r['bar']}) | {r['ms']:.4f} ms | plain "
            f"{r['plain_ms']:.4f} ms | bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            + (f" | live tile share {r['live_share']:.3f}" if "live_share" in r else ""))


def live_tiles(s_t, dst, thresh_sq):
    """(per (lane, 128-point sub-slab) count of the 256-row tiles whose
    boxes pass the bounded kernel's threshold test on these inputs, tiles
    per sub-slab)."""
    import torch

    from scream_tpu_torch.ops import nn_cuda

    Bx, n = s_t.shape[:2]
    slabs = s_t.reshape(Bx, n // 128, 128, 3)
    boxes = nn_cuda.tile_boxes(dst)
    gap = torch.clamp_min(torch.maximum(
        slabs.amin(2)[:, :, None] - boxes[:, None, :, 3:],
        boxes[:, None, :, :3] - slabs.amax(2)[:, :, None]), 0.0)
    return ((gap * gap).sum(-1) <= thresh_sq).sum(-1), boxes.shape[1]


def live_pairs(s_t, dst, thresh_sq):
    """(live, total): the (128-point sub-slab, 256-row tile) pairs whose
    boxes pass the bounded kernel's threshold test on these inputs."""
    per_slab, tiles = live_tiles(s_t, dst, thresh_sq)
    return int(per_slab.sum()), per_slab.numel() * tiles


def check_exact(src, dst, label):
    """Kernel 3 against its plain version: equal indices, distances to 1e-6.
    Returns the largest distance error."""
    import torch

    from scream_tpu_torch.ops import nn_cuda

    d2, idx = nn_cuda.nn_exact(src, dst)
    d2p, idxp = nn_cuda.nn_exact_plain(src, dst)
    torch.cuda.synchronize()
    mism = int((idx != idxp).sum())
    abs_err = float((d2 - d2p).abs().max())
    check(mism == 0 and abs_err <= 1e-6,
          f"{label}: {mism} index mismatches, distance error {abs_err:.3g}")
    return abs_err


def check_bounded(fn, s_t, dst, thresh_sq, dead, label):
    """A bounded-NN wrapper ``fn`` against ``nn_bounded_plain``: exact
    distances (1e-6) and equal winners within the threshold, at least the
    threshold outside it, the sentinel on dead lanes; the tile boxes kernel
    equal to its plain version, and the call with those boxes given (as ICP
    makes it) bit identical to the call that makes its own. Returns the
    largest distance error."""
    import torch

    from scream_tpu_torch.ops import nn_cuda

    d2, xyz = fn(s_t, dst, thresh_sq, dead)
    boxes = nn_cuda.nn_tile_boxes(dst)
    d2b, xyzb = fn(s_t, dst, thresh_sq, dead, boxes=boxes)
    d2p, xyzp = nn_cuda.nn_bounded_plain(s_t, dst, thresh_sq, dead)
    torch.cuda.synchronize()
    boxes_ok = bool(torch.equal(boxes, nn_cuda.tile_boxes(dst)))
    given_ok = bool(torch.equal(d2b, d2) and torch.equal(xyzb, xyz))
    live = ~dead[:, None].expand_as(d2)
    within = (d2p < thresh_sq) & live
    abs_err = float((d2 - d2p)[within].abs().max())
    coords_equal = bool(torch.equal(xyz[within], xyzp[within]))
    dead_ok = bool((d2[~live] == nn_cuda.NO_HIT).all())
    outside_ok = bool((d2[live & ~within] >= thresh_sq).all())
    check(abs_err <= 1e-6 and coords_equal and dead_ok and outside_ok and boxes_ok
          and given_ok and int(within.sum()) > 0,
          f"{label}: distance error {abs_err:.3g}, coords equal {coords_equal}, "
          f"dead lanes ok {dead_ok}, outside ok {outside_ok}, boxes equal {boxes_ok}, "
          f"given boxes identical {given_ok}")
    return abs_err


def tie_scene(n_lanes, n_grid, device):
    """Exact ties with distinct winners: src on a 1/4 grid (each point
    twice), dst the grid moved by -1/32 in x (first half) and +1/32 (second
    half). All values are short dyadic fractions, so both candidates' d2 are
    equal bit for bit and the -1/32 copy, the lower index, must win."""
    import numpy as np
    import torch

    k = np.arange(n_grid)
    g = np.stack([(k % 16) / 4, (k // 16 % 16) / 4, (k // 256) / 4], -1).astype(np.float32)
    e = np.array([1 / 32, 0, 0], np.float32)
    rep = lambda a: torch.as_tensor(np.repeat(a[None], n_lanes, 0), device=device)
    return rep(np.concatenate([g, g])), rep(np.concatenate([g - e, g + e]))


def check_ties(n_lanes, n_grid, dead_lane=None):
    """The bounded NN on exact ties (:func:`tie_scene`), ``nn_bounded_single``
    at one lane, else ``nn_bounded``: distances and winners bit for bit
    against the plain version, every winner the lowest dst index, dead lanes
    at the sentinel. Returns a log fragment."""
    import torch

    from scream_tpu_torch.ops import nn_cuda

    src, dst = tie_scene(n_lanes, n_grid, DEV)
    dead = torch.zeros(n_lanes, dtype=torch.bool, device=DEV)
    if dead_lane is not None:
        dead[dead_lane] = True
    fn = nn_cuda.nn_bounded_single if n_lanes == 1 else nn_cuda.nn_bounded
    thresh_sq = float(torch.tensor(0.1, dtype=torch.float32) ** 2)
    d2, xyz = fn(src, dst, thresh_sq, dead, boxes=nn_cuda.nn_tile_boxes(dst))
    d2p, xyzp = nn_cuda.nn_bounded_plain(src, dst, thresh_sq, dead)
    torch.cuda.synchronize()
    live = ~dead
    M = dst.shape[1]
    exact = bool(torch.equal(d2[live], d2p[live]) and torch.equal(xyz[live], xyzp[live]))
    lowest = bool(torch.equal(xyz[live], dst[:, :M // 2].repeat(1, 2, 1)[live]))
    sentinel = bool((d2[dead] == nn_cuda.NO_HIT).all() and (xyz[dead] == 0).all())
    splits = nn_cuda.bounded_splits(n_lanes, src.shape[1], M)
    check(exact and lowest and sentinel,
          f"bounded NN ties {n_lanes} x {src.shape[1]}: bit-identical {exact}, lowest "
          f"index {lowest}, dead lanes at the sentinel {sentinel}")
    return f"ties {n_lanes} x {src.shape[1]} ({splits} splits) exact, lowest index"


def check_exact_ties(n_lanes, n_grid):
    """The exact NN on exact ties (:func:`tie_scene`): bit for bit against
    its plain version (:func:`check_exact`, 0.0 error), every winner the
    lower of two equally distant dst rows, which lie in different splits.
    Returns a log fragment."""
    import torch

    from scream_tpu_torch.ops import nn_cuda

    src, dst = tie_scene(n_lanes, n_grid, DEV)
    err = check_exact(src, dst, f"nn_exact ties {n_lanes} x {src.shape[1]}")
    _, idx = nn_cuda.nn_exact(src, dst)
    M = dst.shape[1]
    lowest = bool((idx == torch.arange(src.shape[1], device=DEV) % (M // 2)).all())
    check(err == 0.0 and lowest,
          f"nn_exact ties {n_lanes} x {src.shape[1]}: error {err}, lowest index {lowest}")
    return (f"nn_exact ties {n_lanes} x {src.shape[1]} "
            f"({nn_cuda.exact_splits(n_lanes, src.shape[1], M)} splits) exact, lowest index")


def icp_view(src_dn, tgt_dn, src_mask, tgt_mask, T):
    """The bounded NN's inputs as ICP builds them: src sorted on the
    init-rotated axis and moved by ``T``, tgt sorted on x with its masked
    rows at FAR."""
    from scream_tpu_torch.geometry.icp import _spatial_sort
    from scream_tpu_torch.ops import nn_cuda

    s_sorted, _ = _spatial_sort(src_dn, src_mask, T[:, 0, :3])
    t_sorted, t_mask = _spatial_sort(tgt_dn, tgt_mask)
    s_t = (s_sorted @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]).contiguous()
    return s_t, nn_cuda.mask_far(t_sorted, t_mask)


def check_exact_path1(batch):
    """Kernel 3 at path 1's shape, on the pose solve's inputs (src_pred/s
    against tgt/s, masked rows at FAR): against its plain version, timed
    (gated), with its bound and ``torch.cdist`` as a reference line.
    Returns a record."""
    import torch

    from scream_tpu_torch.ops import nn_cuda
    from scream_tpu_torch.pipeline.register import to_device

    dev = torch.device("cuda")
    tb = to_device(batch, dev)
    inv_s = (1.0 / tb["scale"])[:, None, None]
    pred = oracle_pred(batch, 0.01, 0, dev)
    src = (pred * inv_s).contiguous()
    dst = nn_cuda.mask_far(tb["tgt"] * inv_s, tb["tgt_mask"])
    abs_err = check_exact(src, dst, "nn_exact")
    ms, ms_all = timed(lambda: nn_cuda.nn_exact(src, dst))
    pms, pms_all = timed(lambda: nn_cuda.nn_exact_plain(src, dst), reps=3)
    check(ms <= NN_EXACT_GATE_MS,
          f"nn_exact {B} x {CAP}: {ms:.4f} ms (rounds {ms_all}) > {NN_EXACT_GATE_MS} ms")
    b_ms, b_by = bound(B * CAP * 12 * 2 + B * CAP * 12,
                       [(NN_INSTR_PER_PAIR * B * CAP * CAP + NN_INSTR_PER_ROW * B * CAP,
                         INSTR_FP32)])
    # A reference line, not library_ms: cdist forms d2 otherwise (other bits).
    ref_ms = cuda_ms(lambda: torch.cdist(src, dst).min(-1))
    log(f"kernel nn_exact {B} x {CAP} ({nn_cuda.exact_splits(B, CAP, CAP)} splits): timing "
        f"rounds {', '.join(f'{t:.4f}' for t in ms_all)} ms (gate {NN_EXACT_GATE_MS} ms on the "
        f"best); plain {', '.join(f'{t:.4f}' for t in pms_all)} ms; torch.cdist(src, dst)"
        f".min(-1) {ref_ms:.4f} ms (reference)")
    return dict(name="nn_exact", err=0.0, max_abs_err=abs_err, ms=ms, plain_ms=pms,
                bound_ms=b_ms, bound_by=b_by, bar="0 index mismatches, 1e-6 abs",
                route="cuda", source="scream_tpu_torch/csrc/nn.cu",
                replaces="scream_tpu/ops/nn_pallas.py:59")


def phase_kernels(model, batch):
    """Each kernel against its plain version on the card; returns records."""
    import torch

    from scream_tpu_torch.ops import nn_cuda
    from scream_tpu_torch.pipeline.register import (solve_pose,
                                                    spread_subsample_indices,
                                                    to_device)

    dev = torch.device("cuda")
    f32 = torch.float32
    tb = to_device(batch, dev)
    m_bool = tb["tgt_mask"]
    records = check_attention(model.trunk.stem_0, m_bool)
    stats_matmul_reference()
    records.append(check_exact_path1(batch))

    # Kernel 4: bounded NN as ICP calls it: de-normalized clouds, src sorted
    # on the init-rotated axis and moved by the solved pose, tgt sorted on x.
    inv_s = (1.0 / tb["scale"])[:, None, None]
    pred = oracle_pred(batch, 0.01, 0, dev)
    sol = solve_pose(tb["src"], pred, tb["tgt"], tb["src_mask"], m_bool,
                     tb["scale"], tb["center"])
    src_dn = tb["src"] * inv_s + tb["center"][:, None, :]
    tgt_dn = tb["tgt"] * inv_s + tb["center"][:, None, :]
    thresh_sq = float(torch.tensor(0.1, dtype=f32) ** 2)
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    dead[-2:] = True
    for n in (CAP, ICP_SUB):
        idx = torch.as_tensor(spread_subsample_indices(CAP, n), dtype=torch.long, device=dev)
        s_t, dst = icp_view(src_dn[:, idx], tgt_dn, tb["src_mask"][:, idx], m_bool,
                            sol.transform)
        abs_err = check_bounded(nn_cuda.nn_bounded, s_t, dst, thresh_sq, dead,
                                f"nn_bounded n={n}")
        alive = torch.zeros(B, dtype=torch.bool, device=dev)
        boxes = nn_cuda.nn_tile_boxes(dst)
        # Timed as ICP calls it: the boxes made once per ICP call, given.
        ms, ms_all = timed(lambda: nn_cuda.nn_bounded(s_t, dst, thresh_sq, alive,
                                                      boxes=boxes))
        own = cuda_ms(lambda: nn_cuda.nn_bounded(s_t, dst, thresh_sq, alive))
        pms, pms_all = timed(lambda: nn_cuda.nn_bounded_plain(s_t, dst, thresh_sq, alive),
                             reps=3)
        if n == CAP:
            check(ms <= NN_BATCHED_GATE_MS,
                  f"nn_bounded {B} x {n}: {ms:.4f} ms (rounds {ms_all}) > "
                  f"{NN_BATCHED_GATE_MS} ms")
            log(f"kernel nn_bounded {B} x {n} ({nn_cuda.bounded_splits(B, n, CAP)} split): "
                f"timing rounds {', '.join(f'{t:.4f}' for t in ms_all)} ms with the boxes "
                f"given (gate {NN_BATCHED_GATE_MS} ms on the best), {own:.4f} ms making them; "
                f"plain {', '.join(f'{t:.4f}' for t in pms_all)} ms")
            check_boxes(dst)
        # Work this run's data needs: the live (sub-slab, tile) pairs.
        live, total = live_pairs(s_t, dst, thresh_sq)
        b_ms, b_by = bound(B * n * 12 + B * CAP * 12 + B * n * 16,
                           [(NN_INSTR_PER_PAIR * live * 128 * 256
                             + NN_INSTR_PER_ROW * live * 256, INSTR_FP32)])
        rec = dict(name="nn_bounded" if n == CAP else "nn_bounded_sub1024", err=0.0,
                   max_abs_err=abs_err, ms=ms, plain_ms=pms, bound_ms=b_ms,
                   bound_by=b_by, bar="exact within threshold", route="cuda",
                   source="scream_tpu_torch/csrc/nn.cu",
                   replaces="scream_tpu/ops/nn_pallas.py:376",
                   live_share=live / total)
        records.append(rec)
    log("kernels at path 1's batch on exact ties: "
        + ", ".join([check_ties(B, 2048, dead_lane=3), check_exact_ties(B, 2048)]))

    log_records(records)
    return records


def check_boxes(dst):
    """The tile boxes kernel (``nn_tile_boxes``, a helper of the bounded NN
    that ports no TPU kernel; its launches are in the path's counts) at
    ``dst``'s shape: equal to its plain version, timed, logged."""
    import torch

    from scream_tpu_torch.ops import nn_cuda

    got = nn_cuda.nn_tile_boxes(dst)
    want = nn_cuda.tile_boxes(dst)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, want))
    check(same, "nn_tile_boxes: boxes differ from the plain version")
    log(f"kernel nn_tile_boxes {tuple(dst.shape[:2])}: equal to the plain version {same} | "
        f"{cuda_ms(lambda: nn_cuda.nn_tile_boxes(dst)):.4f} ms, plain "
        f"{cuda_ms(lambda: nn_cuda.tile_boxes(dst)):.4f} ms")


def phase_forward(model, batch):
    """The fused-kernel forward against the plain-body forward, same weights,
    both bf16 on the card (24 blocks compound each block's rounding)."""
    import torch

    from scream_tpu_torch.config import ModelConfig
    from scream_tpu_torch.models import PointTransformer
    from scream_tpu_torch.pipeline.register import gt_center_hint, to_device

    plain = PointTransformer(ModelConfig(fused_attention=False, fused_block_tail=False),
                             device="cuda")
    plain.load_state_dict(model.state_dict())
    tb = to_device({k: v[:2, :1024] if v.ndim > 1 and v.shape[1] == CAP else v[:2]
                    for k, v in batch.items()}, "cuda")
    args = (tb["src"], tb["tgt"], tb["src_mask"], tb["tgt_mask"],
            gt_center_hint(tb["rot"], tb["trans"]))
    with torch.no_grad():
        a, b = model(*args), plain(*args)
    err = rel_err(a, b, rows=tb["src_mask"])
    check(math.isfinite(err) and err <= 5e-2, f"forward fused vs plain: {err:.3g} > 5e-2")
    log(f"forward (2 x 1024, full width): fused kernels vs plain body rel_err "
        f"{err:.3e} (bar 5e-2)")


def run_path(model, batches, icp_subsample, label="trained point-generator"):
    """register_batch over distinct batches; returns (pairs/s, launch
    counts, median RE in degrees)."""
    import torch

    from scream_tpu_torch.ops import launch_counts, reset_launch_counts
    from scream_tpu_torch.pipeline.register import register_batch

    kw = dict(icp_max_iter=ICP_ITERS, icp_subsample=icp_subsample, device="cuda")
    register_batch(model, batches[0], **kw).transform.cpu()  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = []
    for b in batches[1:]:
        m = register_batch(model, b, **kw)
        m.transform.cpu()  # fetch to the host: the batch is done
        outs.append(m)
    elapsed = time.perf_counter() - t0
    counts = launch_counts()
    from scream_tpu_torch.ops import nn_cuda

    nn_dev = nn_cuda.nn_bounded.device_launches
    pps = B * len(outs) / elapsed
    finite = all(bool(torch.isfinite(x).all()) for m in outs
                 for x in (m.transform, m.re_deg, m.te))
    check(finite, "register_batch: non-finite output")
    check(all(counts[k] > 0 for k in PATH1_KERNELS), f"a kernel was not launched: {counts}")
    check(all(m.transform.shape == (B, 4, 4) for m in outs), "bad output shape")
    re = torch.cat([m.re_deg for m in outs])
    log(f"main path register_batch B={B} cap={CAP} icp_iters={ICP_ITERS} "
        f"icp_subsample={icp_subsample}: {pps:.2f} pairs/s over {len(outs)} batches "
        f"({elapsed / len(outs) * 1e3:.1f} ms/batch) | launches {json.dumps(counts)}, bounded "
        f"NN device launches {nn_dev} | "
        f"all finite | median RE {float(re.median()):.2f} deg ({label})")
    return pps, counts, float(re.median())


def phase_oracle(batch):
    """Pose solve + ICP from the GT-posed source plus 0.01 noise: RE < 1 deg
    and TE < 0.02 on every pair; the CPU path (plain versions) on the first
    four pairs agrees within 2e-2 with equal n_corr."""
    import torch

    from scream_tpu_torch.pipeline.register import register_batch

    pred_gpu = oracle_pred(batch, 0.01, 1, "cuda")
    m = register_batch(lambda *a: pred_gpu, batch, device="cuda")
    re, te = m.re_deg.cpu(), m.te.cpu()
    check(bool((re < 1.0).all() and (te < 0.02).all()),
          f"oracle pose: max RE {float(re.max()):.3f} deg, max TE {float(te.max()):.4f}")
    small = {k: v[:4, :1024] if v.ndim > 1 and v.shape[1] == CAP else v[:4]
             for k, v in batch.items()}
    p_small = oracle_pred(small, 0.01, 2, "cpu")
    mc = register_batch(lambda *a: p_small, small, device="cpu")
    mg = register_batch(lambda *a: p_small.cuda(), small, device="cuda")
    t_err = float((mg.transform.cpu() - mc.transform).abs().max())
    same_corr = bool(torch.equal(mg.n_corr.cpu(), mc.n_corr))
    check(t_err <= 2e-2 and same_corr,
          f"GPU vs CPU path: transform error {t_err:.3g}, n_corr equal {same_corr}")
    log(f"oracle pose (noise 0.01): max RE {float(re.max()):.4f} deg (bar 1), max TE "
        f"{float(te.max()):.5f} (bar 0.02) | GPU vs CPU path (4 x 1024): transform "
        f"err {t_err:.2e} (bar 2e-2), n_corr equal {same_corr}")


def make_gt_free_pairs(n_pairs, n_points, seed, max_angle_deg=30.0):
    """Fresh synthetic pairs as ``scripts/measure_gt_free.py`` makes them."""
    import numpy as np

    from scream_tpu_torch.data.synthetic import make_pair

    rng = np.random.default_rng(seed)
    return [make_pair(rng, n_src=n_points, n_tgt=n_points, overlap=0.7, noise=0.0,
                      max_angle=np.deg2rad(max_angle_deg)) for _ in range(n_pairs)]


def gt_transform(pair):
    import numpy as np

    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = pair["rot"]
    T[:3, 3] = pair["trans"].reshape(3)
    return T


def load_hintfree(device, dtype=None):
    """The shipped hint-free checkpoint as a PointTransformer on ``device``
    (its sidecar's compute dtype, or ``dtype``)."""
    return load_weights(HINTFREE, device, dtype=dtype)


def phase_kernels_gt_free(model, normalize, pairs, pair_4096):
    """Kernels at the GT-free serving path's shapes against their plain
    versions: stats and apply at d=128 / head dim 16 on a register_pairs
    batch (8 x 512, 448 valid rows); the exact NN of the pose solve at the
    single-pair, robust-pass and register_pairs batches (B = 1, 7, 8); the
    batched bounded NN as the batched ICP calls it at the robust-pass,
    register_pairs and robust-ladder batches (B = 7, 8, 14; two lanes
    dead); the unbatched bounded NN (B = 1) as the single-pair ICP calls
    it, at 512 and 4,096 points. Inputs: ``pairs`` through the model and
    its pose solve, as the GT-free path builds them."""
    import numpy as np
    import torch

    from scream_tpu_torch.data import pad_cloud
    from scream_tpu_torch.ops import nn_cuda
    from scream_tpu_torch.pipeline import register as reg

    dev = torch.device(DEV)
    m_bool = torch.zeros((SERVE_BATCH, 512), dtype=torch.bool, device=dev)
    m_bool[:, :GT_FREE_POINTS] = True
    records = check_attention(model.trunk.stem_0, m_bool, suffix="_d128")

    thresh_sq = float(torch.tensor(0.1, dtype=torch.float32) ** 2)
    checked = []
    for n_lanes in (1, 7, 8, 14):
        items = [(p["src"], p["tgt"]) for p in pairs[:n_lanes]]
        b = reg._normalized_batch(items, normalize, 512, dev)
        with torch.no_grad():
            sol, src_dn, tgt_dn = reg._gt_free_solve(model, b, 0.1, "tgt")
            pred = model(b["src"], b["tgt"], b["src_mask"], b["tgt_mask"], None).float()
        inv_s = (1.0 / b["scale"])[:, None, None]
        if n_lanes != 14:
            err = check_exact((pred * inv_s).contiguous(),
                              nn_cuda.mask_far(b["tgt"] * inv_s, b["tgt_mask"]),
                              f"nn_exact B={n_lanes}")
            checked.append(f"nn_exact B={n_lanes} err {err:.1e}")
        s_t, dst = icp_view(src_dn, tgt_dn, b["src_mask"], b["tgt_mask"], sol.transform)
        dead = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
        if n_lanes == 1:
            err = check_bounded(nn_cuda.nn_bounded_single, s_t, dst, thresh_sq, dead,
                                "nn_bounded_single B=1")
            gone = nn_cuda.nn_bounded_single(s_t, dst, thresh_sq, ~dead)[0]
            check(bool((gone == nn_cuda.NO_HIT).all()),
                  "nn_bounded_single: a dead lane is not at the sentinel")
            checked.append(f"nn_bounded_single B=1 err {err:.1e}")
            continue
        dead[-2:] = True
        err = check_bounded(nn_cuda.nn_bounded, s_t, dst, thresh_sq, dead,
                            f"nn_bounded B={n_lanes}")
        checked.append(f"nn_bounded B={n_lanes} err {err:.1e}")
    log("kernels at the GT-free batches (hint-free model, 512 cap), all within "
        "their path-1 bars: " + ", ".join(checked))

    # The single-pair ICP's NN at 512 and 4,096 points, timed: a 2-degree,
    # 0.01 perturbation of the GT pose, an ICP iteration's view.
    c, s = np.cos(np.deg2rad(2.0)), np.sin(np.deg2rad(2.0))
    nudge = np.array([[c, -s, 0, 0.01], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                     np.float32)
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    on = lambda a: torch.as_tensor(a, device=dev)[None]
    for pair, cap in ((pairs[0], 512), (pair_4096, 4096)):
        (sp, sm), (tp, tm) = pad_cloud(pair["src"], cap), pad_cloud(pair["tgt"], cap)
        T = on(gt_transform(pair) @ nudge)
        s_t, dst = icp_view(on(sp), on(tp), on(sm), on(tm), T)
        abs_err = check_bounded(nn_cuda.nn_bounded_single, s_t, dst, thresh_sq, no,
                                f"nn_bounded_single n={cap}")
        boxes = nn_cuda.nn_tile_boxes(dst)
        # Timed as the single-pair ICP calls it: the boxes given.
        ms, ms_all = timed(lambda: nn_cuda.nn_bounded_single(s_t, dst, thresh_sq,
                                                             boxes=boxes))
        own = cuda_ms(lambda: nn_cuda.nn_bounded_single(s_t, dst, thresh_sq))
        pms, pms_all = timed(lambda: nn_cuda.nn_bounded_plain(s_t, dst, thresh_sq, None),
                             reps=3)
        check(ms <= NN_SINGLE_GATE_MS,
              f"nn_bounded_single 1 x {cap}: {ms:.4f} ms (rounds {ms_all}) > "
              f"{NN_SINGLE_GATE_MS} ms")
        log(f"kernel nn_bounded_single 1 x {cap} "
            f"({nn_cuda.bounded_splits(1, cap, cap)} splits): timing rounds "
            f"{', '.join(f'{t:.4f}' for t in ms_all)} ms with the boxes given (gate "
            f"{NN_SINGLE_GATE_MS} ms on the best), {own:.4f} ms making them; plain "
            f"{', '.join(f'{t:.4f}' for t in pms_all)} ms")
        live, total = live_pairs(s_t, dst, thresh_sq)
        b_ms, b_by = bound(cap * 12 + cap * 12 + cap * 16,
                           [(NN_INSTR_PER_PAIR * live * 128 * 256
                             + NN_INSTR_PER_ROW * live * 256, INSTR_FP32)])
        records.append(dict(
            name="nn_bounded_single" if cap == 512 else "nn_bounded_single_4096",
            err=0.0, max_abs_err=abs_err, ms=ms, plain_ms=pms, bound_ms=b_ms,
            bound_by=b_by, bar="exact within threshold", route="cuda",
            source="scream_tpu_torch/csrc/nn.cu",
            replaces="scream_tpu/ops/nn_pallas.py:162", live_share=live / total))
    log("bounded and exact NN on exact ties: " + ", ".join(
        [check_ties(1, 256), check_ties(1, 2048), check_exact_ties(1, 256),
         check_exact_ties(1, 2048)]))
    log_icp_launches(model, normalize, pairs[0])
    log_records(records)
    return records


def log_icp_launches(model, normalize, pair):
    """ICP's NN launches read from the wrappers' counts: one single-pair and
    one batched ICP call on the GT-free pass's inputs. Each must make its
    tile boxes once (one ``nn_tile_boxes`` launch) and run one device launch
    of the bounded NN per NN call (steps + the final measure)."""
    import torch

    from scream_tpu_torch.geometry.icp import registration_icp, registration_icp_batched
    from scream_tpu_torch.ops import nn_cuda, reset_launch_counts
    from scream_tpu_torch.pipeline import register as reg

    b = reg._normalized_batch([(pair["src"], pair["tgt"])] * 2, normalize, 512, DEV)
    with torch.no_grad():
        sol, src_dn, tgt_dn = reg._gt_free_solve(model, b, 0.1, "tgt")
    parts = []
    for name, fn, run in (
            ("registration_icp", nn_cuda.nn_bounded_single, lambda: registration_icp(
                src_dn[0], tgt_dn[0], 0.1, init=sol.transform[0], src_mask=b["src_mask"][0],
                tgt_mask=b["tgt_mask"][0])),
            ("registration_icp_batched", nn_cuda.nn_bounded, lambda: registration_icp_batched(
                src_dn, tgt_dn, 0.1, init=sol.transform, src_mask=b["src_mask"],
                tgt_mask=b["tgt_mask"]))):
        torch.cuda.synchronize()
        reset_launch_counts()
        r = run()
        iters = int(r.iterations.max())
        calls, dev_launches = fn.launches, fn.device_launches
        boxes = nn_cuda.nn_tile_boxes.launches
        check(calls > 0 and dev_launches == calls and boxes == 1,
              f"{name}: {calls} NN calls, {dev_launches} NN device launches, {boxes} box "
              "launches (one a step and one box launch a call expected)")
        parts.append(f"{name}: {iters} iterations, {calls} NN calls, {dev_launches} NN "
                     f"device launches ({dev_launches / calls:.2f} a step), {boxes} box launch")
    reset_launch_counts()
    log("ICP NN launches (GT-free pass, 448 points): " + "; ".join(parts))


def phase_gt_free(model, model_cpu, normalize, pairs, label="path 2"):
    """Path 2: GT-free serving with the trained hint-free weights, each API
    on the card and on the CPU path over the same pairs:
    register_pair(passes=2), register_pairs (batch SERVE_BATCH) and
    register_pair_robust (axis7). Recall (RE <= 15 deg, TE <= 0.3) and
    median RE/TE of each; per API the card may trail the CPU path's recall
    by at most 2/16 and its transforms may leave TRANSFORM_TOL on at most
    2/16 of the pairs; how many of the bistable pairs (``BISTABLE_PAIRS``)
    agree within it is logged. Returns the launch counts of the card's run."""
    import numpy as np
    import torch

    from scream_tpu_torch.geometry.metrics import transformation_error
    from scream_tpu_torch.ops import launch_counts, reset_launch_counts
    from scream_tpu_torch.pipeline import (register_pair, register_pair_robust,
                                           register_pairs)

    gt = torch.as_tensor(np.stack([gt_transform(p) for p in pairs]))
    items = [(p["src"], p["tgt"]) for p in pairs]
    apis = (
        ("register_pair(passes=2)", lambda m, dev: [
            register_pair(m, s, t, normalize=normalize, passes=2, device=dev)
            for s, t in items]),
        (f"register_pairs(batch {SERVE_BATCH})", lambda m, dev: register_pairs(
            m, items, normalize=normalize, batch_size=SERVE_BATCH, device=dev)),
        ("register_pair_robust(axis7)", lambda m, dev: [
            register_pair_robust(m, s, t, normalize=normalize, device=dev)
            for s, t in items]),
    )

    def score(results):
        T = torch.as_tensor(np.stack([r.transform for r in results]))
        re, te = (x.numpy() for x in transformation_error(T, gt))
        return float(((re <= 15.0) & (te <= 0.3)).mean()), float(np.median(re)), \
            float(np.median(te))

    reset_launch_counts()
    card = {}
    for name, run in apis:
        t0 = time.perf_counter()
        card[name] = (run(model, DEV), time.perf_counter() - t0)
    counts = launch_counts()
    check(all(counts[k] > 0 for k in PATH2_KERNELS), f"a kernel was not launched: {counts}")

    n_tol = 2 / 16
    for name, run in apis:
        t0 = time.perf_counter()
        cpu, t_cpu = run(model_cpu, "cpu"), time.perf_counter() - t0
        got, t_card = card[name]
        check(all(np.isfinite(r.transform).all() and 0.0 <= r.fitness <= 1.0
                  for r in got), f"{name}: non-finite transform or fitness out of [0, 1]")
        rc, rcpu = score(got), score(cpu)
        diff = [float(np.abs(a.transform - b.transform).max()) for a, b in zip(got, cpu)]
        n_far = sum(d > TRANSFORM_TOL for d in diff)
        check(rc[0] >= rcpu[0] - n_tol - 1e-9 and n_far <= n_tol * len(pairs),
              f"GT-free {name} card vs CPU path: recall {rc[0]:.4f} vs {rcpu[0]:.4f}, "
              f"{n_far} of {len(pairs)} transforms beyond {TRANSFORM_TOL}")
        extra = ""
        if "robust" in name:
            check(all(0.0 <= r.score_margin <= 1.0 for r in got),
                  f"{name}: score_margin out of [0, 1]")
            extra = (f" | ambiguous card {sum(r.ambiguous for r in got)} CPU "
                     f"{sum(r.ambiguous for r in cpu)}, median margin card "
                     f"{float(np.median([r.score_margin for r in got])):.4f} CPU "
                     f"{float(np.median([r.score_margin for r in cpu])):.4f}")
        bistable = sum(diff[i] <= TRANSFORM_TOL for i in BISTABLE_PAIRS)
        log(f"{label} GT-free {name}, hint-free d128 checkpoint, {model.cfg.dtype}, "
            f"{len(pairs)} x {GT_FREE_POINTS} pts, seed {GT_FREE_SEED}, poses <= 30 deg: "
            f"card recall "
            f"{rc[0]:.4f}, median RE {rc[1]:.4f} deg, TE {rc[2]:.5f} ({t_card:.2f} s) | "
            f"CPU path recall {rcpu[0]:.4f}, median RE {rcpu[1]:.4f} deg, TE "
            f"{rcpu[2]:.5f} ({t_cpu:.2f} s) | transforms card vs CPU: max "
            f"{max(diff):.3e}, median {float(np.median(diff)):.3e}, {n_far} beyond "
            f"{TRANSFORM_TOL} (bar <= {n_tol * len(pairs):g}), bistable pairs "
            f"{BISTABLE_PAIRS} within it {bistable} of {len(BISTABLE_PAIRS)}{extra}")
    log(f"{label} launches: {json.dumps(counts)}")
    return counts


def phase_cli(model, normalize, pair, dtype=None):
    """``python -m scream_tpu_torch register`` in a subprocess on two .npy
    clouds (``--dtype`` if given); its transform against the in-process
    register_pair (1e-5)."""
    import numpy as np

    from scream_tpu_torch.pipeline import register_pair

    root, env = repo_env()
    os.makedirs(OUT_DIR, exist_ok=True)
    src, tgt = (os.path.join(root, OUT_DIR, f"cli_{k}.npy") for k in ("src", "tgt"))
    np.save(src, pair["src"])
    np.save(tgt, pair["tgt"])
    cmd = [sys.executable, "-m", "scream_tpu_torch", "register", "--src", src,
           "--tgt", tgt, "--params", HINTFREE, "--device", DEV]
    cmd += ["--dtype", dtype] if dtype else []
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=root,
                          env=env)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"CLI exit {proc.returncode}:\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    ref = register_pair(model, pair["src"], pair["tgt"], normalize=normalize,
                        passes=2, device=DEV)
    err = float(np.abs(np.asarray(out["transform"], np.float32) - ref.transform).max())
    check(err <= 1e-5 and out["n_corr"] == ref.n_corr,
          f"CLI vs in-process: transform error {err:.3g}, n_corr {out['n_corr']} "
          f"vs {ref.n_corr}")
    log(f"cli: python -m scream_tpu_torch register --params {HINTFREE}"
        f"{' --dtype ' + dtype if dtype else ''} ({wall:.1f} s "
        f"wall, subprocess): transform vs in-process max err {err:.2e} (bar 1e-5), "
        f"n_corr {out['n_corr']} equal, fitness {out['fitness']:.4f}")


def phase_serving_times(model, normalize, pairs_512, pairs_4096):
    """Ungated serving times on the card, distinct inputs per call, results
    on the host: register_pairs pairs/s (SERVE_PAIRS pairs at batch
    SERVE_BATCH), register_pair latency, the robust latency, and the stage
    times (CUDA events) of one register_pair pass and one register_pairs
    batch. Returns a dict."""
    import torch

    from scream_tpu_torch.geometry.icp import (registration_icp,
                                               registration_icp_batched)
    from scream_tpu_torch.pipeline import register as reg

    dev = torch.device(DEV)
    out = {}
    for cap, pairs in ((512, pairs_512), (4096, pairs_4096)):
        as_pairs = [(p["src"], p["tgt"]) for p in pairs]
        reg.register_pairs(model, as_pairs[:SERVE_BATCH], normalize=normalize,
                           batch_size=SERVE_BATCH, device=dev)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reg.register_pairs(model, as_pairs[SERVE_BATCH:], normalize=normalize,
                           batch_size=SERVE_BATCH, device=dev)
        out[f"register_pairs_pairs_per_s_{SERVE_BATCH}x{cap}"] = \
            (len(as_pairs) - SERVE_BATCH) / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for p in pairs[:4]:
            reg.register_pair(model, p["src"], p["tgt"], normalize=normalize,
                              passes=2, device=dev)
        out[f"register_pair_ms_{cap}"] = (time.perf_counter() - t0) / 4 * 1e3

        # Stage times: one register_pair pass and one register_pairs batch.
        for name, items in (("register_pair", as_pairs[4:5]),
                            ("register_pairs", as_pairs[8:8 + SERVE_BATCH])):
            b = reg._normalized_batch(items, normalize, cap, dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            with torch.no_grad():
                ev[0].record()
                pred = model(b["src"], b["tgt"], b["src_mask"], b["tgt_mask"], None).float()
                ev[1].record()
                sol = reg.solve_pose(b["src"], pred, b["tgt"], b["src_mask"],
                                     b["tgt_mask"], b["scale"], b["center"])
                ev[2].record()
                inv_s = (1.0 / b["scale"])[:, None, None]
                sdn = b["src"] * inv_s + b["center"][:, None, :]
                tdn = b["tgt"] * inv_s + b["center"][:, None, :]
                if name == "register_pair":
                    r = registration_icp(sdn[0], tdn[0], 0.1, init=sol.transform[0],
                                         src_mask=b["src_mask"][0],
                                         tgt_mask=b["tgt_mask"][0])
                else:
                    r = registration_icp_batched(sdn, tdn, 0.1, init=sol.transform,
                                                 src_mask=b["src_mask"],
                                                 tgt_mask=b["tgt_mask"])
                r.transformation.cpu()
                ev[3].record()
            torch.cuda.synchronize()
            out[f"stages_ms_{name}_{cap}"] = {
                "forward": ev[0].elapsed_time(ev[1]), "solve": ev[1].elapsed_time(ev[2]),
                "icp": ev[2].elapsed_time(ev[3]),
                "icp_iterations": r.iterations.cpu().tolist()}
    t0 = time.perf_counter()
    for p in pairs_512[1:4]:
        reg.register_pair_robust(model, p["src"], p["tgt"], normalize=normalize, device=dev)
    out["register_pair_robust_ms_512"] = (time.perf_counter() - t0) / 3 * 1e3
    log("serving times (ungated): " + json.dumps(out))
    return out


def gt_aligned(tb):
    """The GT-aligned source of a batch: what the discriminator step renders
    as "real"."""
    from scream_tpu_torch.pipeline.register import gt_aligned_src

    return gt_aligned_src(tb["src"], tb["rot"], tb["trans"])


def phase_kernels_train(model, batch):
    """Kernels 1 and 2 at the training path's shape against their plain
    versions: ``model``'s first block on its real input from the training
    batch (8 pairs x 4,096 points, d 256; the target's self-attention, as
    the generator step's forward first calls it), under path 1's bars."""
    import torch

    from scream_tpu_torch.pipeline.register import gt_center_hint, to_device

    tb = to_device(batch, DEV)
    seen = []
    hook = model.trunk.stem_0.register_forward_pre_hook(
        lambda mod, args: seen.append((args[0].detach(), args[3])) if not seen else None)
    try:
        with torch.no_grad():
            model(tb["src"], tb["tgt"], tb["src_mask"], tb["tgt_mask"],
                  gt_center_hint(tb["rot"], tb["trans"]))
    finally:
        hook.remove()
    x, m_bool = seen[0]
    records = check_attention(model.trunk.stem_0, m_bool, suffix="_train", x=x)
    # Ragged rows: the same input cut to 4,000 rows a pair, so the apply
    # kernel's last 128-row tile of each pair is part-filled.
    records += check_attention(model.trunk.stem_0, m_bool[:, :RAGGED_L].contiguous(),
                               suffix="_train_L4000", x=x[:, :RAGGED_L].contiguous())
    log_records(records)
    return records


def check_splat(batch, rcfg, name):
    """The splat kernel against its plain version on the card at one render
    shape: the batch's GT-aligned source (plus 0.01 noise) beside its target
    under ``rcfg``'s views. Forward images and argmax bit for bit; the VJP
    with respect to the points through the renderer (kernel route, argmax
    backward, vs the plain renderer under autograd) within 1e-3 of the
    largest gradient (``selftest.py``'s bar). Its time and its plain
    version's are each the best of ``TIME_ROUNDS`` rounds, gated at path
    3's shape; the kernel's counting build logs the shares of work its
    tests left; the bound counts the work the data needs
    (:func:`splat_needed_pairs`, from the plain output, independent of the
    kernel), the dense sweep's bound logged beside it. Returns a record."""
    import torch

    from scream_tpu_torch.ops import render, splat_cuda
    from scream_tpu_torch.pipeline.register import to_device

    dev = torch.device(DEV)
    tb = to_device(batch, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    src = gt_aligned(tb) + 0.01 * torch.randn(tb["src"].shape, generator=g, device=dev)
    views = render.view_matrices(rcfg.multi_view, rcfg.view_mode, dev)
    with torch.no_grad():
        xy, vals = render.splat_inputs(src, tb["tgt"], tb["src_mask"], tb["tgt_mask"], views)
        xy, vals = xy.contiguous(), vals.contiguous()
        img, arg = splat_cuda.splat_forward(xy, vals, rcfg.rho, rcfg.width)
        img_p, arg_p = splat_cuda.max_splat_plain(xy, vals, rcfg.rho, rcfg.width)
        img_c, arg_c, cnt = splat_cuda.splat_cull_counts(xy, vals, rcfg.rho, rcfg.width)
    torch.cuda.synchronize()
    fwd_err = float((img - img_p).abs().max())
    mism = int((arg != arg_p).sum())
    same = bool(torch.equal(img, img_p) and torch.equal(arg, arg_p)
                and torch.equal(img_c, img) and torch.equal(arg_c, arg))
    zero_share = float((img_p == 0).float().mean())

    # VJP through the renderer, as selftest.py measures it.
    kw = dict(rho=rcfg.rho, width=rcfg.width, multi_view=rcfg.multi_view,
              view_mode=rcfg.view_mode)
    grads = []
    for use_pallas in (True, False):
        p = src.clone().requires_grad_(True)
        q = tb["tgt"].clone().requires_grad_(True)
        out = render.render_depth_images(p, q, tb["src_mask"], tb["tgt_mask"],
                                         use_pallas=use_pallas, **kw)
        cot = torch.cos(torch.arange(out.numel(), device=dev, dtype=torch.float32)
                        * 0.01).reshape(out.shape)
        grads.append(torch.autograd.grad(out, (p, q), cot))
    torch.cuda.synchronize()
    vjp_err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(*grads))
    check(same and vjp_err < 1e-3,
          f"{name}: bit for bit {same} (forward error {fwd_err:.3g}, {mism} argmax "
          f"mismatches), VJP relative error {vjp_err:.3g} (bar 1e-3)")
    I, N = xy.shape[0], xy.shape[1]
    P = rcfg.width * rcfg.width
    ms, ms_all = timed(lambda: splat_cuda.splat_forward(xy, vals, rcfg.rho, rcfg.width))
    with torch.no_grad():
        pms, pms_all = timed(
            lambda: splat_cuda.max_splat_plain(xy, vals, rcfg.rho, rcfg.width), reps=3)
    gated = name == "max_splat"
    if gated:
        check(ms <= SPLAT_GATE_MS,
              f"{name}: {ms:.4f} ms (rounds {ms_all}) > {SPLAT_GATE_MS} ms")
    # Work this run's data needs, counted from the plain output: each input
    # read once, each output written once, and the exact test and expf for
    # every (pair, channel) that no bound can separate from its pixel's max.
    nbytes = I * N * 16 + I * 2 * P * 8
    need = splat_needed_pairs(xy, vals, rcfg.rho, rcfg.width, img_p)
    b_ms, b_by = bound(nbytes, [((SPLAT_INSTR_EXACT + SPLAT_INSTR_EXP) * need, INSTR_FP32),
                                (need, INSTR_SFU)], overlap=True)
    dense_ms, _ = bound(nbytes, [(SPLAT_INSTR_DENSE * I * N * P, INSTR_FP32),
                                 (I * N * P, INSTR_SFU)], overlap=True)
    log(f"kernel {name} ({I} images x {N} points x {rcfg.width}^2, rho {rcfg.rho:g}, "
        f"{splat_cuda.splat_splits(N)} splits): bit for bit, VJP rel err {vjp_err:.3e} (bar "
        f"1e-3); timing rounds {', '.join(f'{t:.4f}' for t in ms_all)} ms"
        + (f" (gate {SPLAT_GATE_MS} ms on the best)" if gated else "")
        + f"; plain {', '.join(f'{t:.4f}' for t in pms_all)} ms; kept by the tile test "
        f"{cnt['tile_kept'] / cnt['staged']:.4f} of (point, channel)s, by the warp test "
        f"{cnt['warp_kept'] / cnt['warp_staged']:.4f}; (pair, channel)s reaching expf "
        f"{cnt['exp_pairs'] / cnt['pairs']:.5f};"
        f" all-zero pixel share {zero_share:.3f}; (pair, channel)s the data needs "
        f"{need / cnt['pairs']:.6f}, their bound {b_ms:.4f} ms, a dense sweep's {dense_ms:.4f} ms")
    return dict(name=name, err=fwd_err, max_abs_err=fwd_err, ms=ms, plain_ms=pms,
                bound_ms=b_ms, bound_by=b_by, bar="bit for bit (0.0, 0 argmax mismatches)",
                route="cuda", source="scream_tpu_torch/csrc/splat.cu",
                replaces="scream_tpu/ops/splat_pallas.py:36")


def splat_needed_pairs(xy, vals, rho, width, img):
    """The (point, pixel, channel)s that any exact splat must evaluate, from
    the data and the plain output ``img``, independent of the kernel: those
    whose contribution (the plain version's expression) is within
    ``SPLAT_NEED_BAND`` of the pixel's positive max, where no fp32 bound on
    ``log`` and ``exp`` can tell them from the winner, and one (the winner)
    for each pixel and channel whose max is <= 0."""
    import torch

    from scream_tpu_torch.ops import splat_cuda

    pix = splat_cuda.pixel_grid(width, xy.device)
    p_sq = xy[..., 0] * xy[..., 0] + xy[..., 1] * xy[..., 1]
    floor = torch.where(img > 0, img * math.exp(-SPLAT_NEED_BAND), math.inf)
    need = int((img <= 0).sum())
    with torch.no_grad():
        for t0 in range(0, pix.shape[0], 256):
            pt = pix[t0:t0 + 256]
            x_sq = pt[:, 0] * pt[:, 0] + pt[:, 1] * pt[:, 1]
            cross = xy[..., 0:1] * pt[:, 0] + xy[..., 1:2] * pt[:, 1]
            wgt = torch.exp(torch.clamp_min((p_sq[..., None] + x_sq) - 2.0 * cross, 0.0)
                            * (-0.5 * rho * rho))
            for c in (0, 1):
                need += int((vals[..., c:c + 1] * wgt
                             >= floor[:, c, None, t0:t0 + 256]).sum())
    return need


def splat_scene(kind, n, seed):
    """One adversarial scene for the splat (2 images x ``n`` points, 64^2
    pixels): ``(xy, vals)`` as numpy fp32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w, half = 64, 32
    pix = (np.stack(np.meshgrid(np.arange(w), np.arange(w)), -1).reshape(-1, 2)
           - half + 0.5) / half
    xy = rng.uniform(-0.8, 0.8, (2, n, 2))
    vals = rng.uniform(0, 1, (2, n, 2)) * (rng.random((2, n, 1)) > 0.5)
    if kind == "duplicates":  # later copies of earlier points: ties
        xy[:, n // 2:], vals[:, n // 2:] = xy[:, :n - n // 2], vals[:, :n - n // 2]
    elif kind == "equidistant":  # dyadic points +-1/128 around pixel centres
        base = pix[rng.choice(len(pix), n // 4)]
        offs = np.array([[1, 0], [-1, 0], [0, 1], [0, -1]]) / 128.0
        xy[:] = (base[:, None] + offs[None]).reshape(-1, 2)[None]
        v = np.repeat(rng.choice([0.25, 0.5, 1.0], n // 4), 4)
        vals[:] = np.stack([v, v[::-1]], -1)[None]
    elif kind == "signs":  # v = 0, -0.0 and < 0; a channel of negatives only
        vals = rng.choice([0.0, -0.0, -0.5, 0.3, 1.0, -2.0], (2, n, 2))
        xy[1] = rng.uniform(-0.15, 0.15, (n, 2))
        vals[1, :, 1] = -rng.uniform(0.1, 1.0, n)
    elif kind == "zero_pixels":  # points in one corner: most pixels won at 0
        xy = rng.uniform(0.55, 0.95, (2, n, 2))
    elif kind == "radius":
        # Bright points on pixel centres, then points with v = 1.0001 at
        # distances around where they overtake 1 (rho 24), and points at
        # exp's underflow distance.
        k = n // 10
        c = pix[rng.choice(len(pix), k)]
        r = np.sqrt(np.log(1.0001) / 288.0) * rng.choice([0.97, 0.99, 1.0, 1.01, 1.03], (k, 9))
        r[:, 7:] = np.sqrt(np.array([103.0, 105.0]) / 288.0)
        a = rng.uniform(0, 2 * np.pi, (k, 9))
        ring = c[:, None] + r[..., None] * np.stack([np.cos(a), np.sin(a)], -1)
        pts = np.concatenate([c[:, None], ring], 1).reshape(-1, 2)
        v = np.concatenate([np.ones((k, 1)), np.full((k, 7), 1.0001), np.ones((k, 2))], 1)
        xy[:, :len(pts)] = pts
        vals[:, :len(pts)] = v.reshape(-1)[:, None]
    elif kind == "band":
        # Values in [1.13e-7, 1.19e-7] (above e^-16, below 2^-23) around 9
        # centres 0.6 apart, in random order: later points beat the running
        # best by a few hundredths in the log domain at many pixels.
        c = np.array([-0.6, 0.0, 0.6])
        centres = np.stack(np.meshgrid(c, c), -1).reshape(-1, 2)[rng.integers(0, 9, n)]
        r, a = rng.uniform(0.12, 0.2, n), rng.uniform(0, 2 * np.pi, n)
        xy[:] = (centres + r[:, None] * np.stack([np.cos(a), np.sin(a)], -1))[None]
        vals = rng.uniform(1.13e-7, 1.19e-7, (2, n, 2))
    elif kind == "magnitudes":  # very large and very small values
        vals = rng.choice([1e-30, 1e-8, 3e6, 5e20, 0.5], (2, n, 2)) * rng.uniform(0.5, 1, (2, n, 2))
    return xy.astype(np.float32), vals.astype(np.float32)


def check_splat_scenes():
    """The splat kernel bit for bit against its plain version on adversarial
    scenes (:func:`splat_scene`) at rho 24 and 48, with 2 and 4 point splits
    (5,000 and 9,000 points), and the ``expf`` property its skip rule rests
    on over every non-positive fp32. Returns a log fragment."""
    import torch

    from scream_tpu_torch.ops import splat_cuda

    non_mono, non_zero = splat_cuda.expf_zero_check()
    check(non_zero == 0, f"expf is nonzero at {non_zero} fp32 x <= {splat_cuda.EXP_ZERO}")
    done = []
    for i, kind in enumerate(("duplicates", "equidistant", "signs", "zero_pixels", "radius",
                              "magnitudes", "band")):
        for n in (5000, 9000):
            xy, vals = (torch.as_tensor(a, device=DEV) for a in splat_scene(kind, n, i))
            for rho in (24.0, 48.0):
                with torch.no_grad():
                    img, arg = splat_cuda.splat_forward(xy, vals, rho, 64)
                    img_p, arg_p = splat_cuda.max_splat_plain(xy, vals, rho, 64)
                torch.cuda.synchronize()
                err = float((img - img_p).abs().max())
                mism = int((arg != arg_p).sum())
                check(torch.equal(img, img_p) and mism == 0,
                      f"splat scene {kind} n={n} rho {rho:g}: error {err:.3g}, "
                      f"{mism} argmax mismatches")
        done.append(kind)
    return (f"splat on adversarial scenes ({', '.join(done)}; 2 and 4 splits, rho 24 and "
            f"48) bit for bit; expf over every fp32 x <= 0: {non_zero} nonzero at x <= "
            f"{splat_cuda.EXP_ZERO}, {non_mono} not monotone")


def phase_splat(batch_3dm, batch_kitti):
    """Kernel 9 at the 3DMatch GAN shape and the KITTI GAN shape, and on
    adversarial scenes."""
    from scream_tpu_torch.config import RenderConfig, kitti_gan_render_config

    records = [check_splat(batch_3dm, RenderConfig(), "max_splat"),
               check_splat(batch_kitti, kitti_gan_render_config(), "max_splat_kitti")]
    log(check_splat_scenes())
    log_records(records)
    return records


def gan_steps(device, init_state, batch, fake=None):
    """One generator step with the GAN on and one discriminator step on
    ``device``, from the generator weights ``init_state`` and the shipped
    discriminator; the discriminator scores ``fake`` if given, else the
    generator step's render. Returns the step's outputs on the CPU."""
    import torch

    from scream_tpu_torch.config import ModelConfig, RenderConfig, TrainConfig
    from scream_tpu_torch.models import PointTransformer
    from scream_tpu_torch.ops.render import render_from_config
    from scream_tpu_torch.pipeline.register import to_device
    from scream_tpu_torch.train import (DiscState, discriminator_optimizer,
                                        generator_optimizer, init_train_state,
                                        make_disc_logit_fn, make_discriminator_step,
                                        make_registration_train_step)
    from scream_tpu_torch.utils.checkpoint import load_discriminator

    tcfg, rcfg = TrainConfig(use_gan=True), RenderConfig()
    model = PointTransformer(ModelConfig(), device=device)
    model.load_state_dict(init_state)
    disc = load_discriminator(DISC, device)
    opt, sched = generator_optimizer(model.parameters(), tcfg, steps_per_epoch=1000)
    step = make_registration_train_step(model, use_gan=tcfg.use_gan,
                                        disc_apply=make_disc_logit_fn(), render_cfg=rcfg,
                                        gan_weight=tcfg.gan_weight)
    tb = to_device(batch, device)
    _, metrics, fake_g = step(init_train_state(opt, sched), tb, disc)
    gnorm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in model.parameters()))
    with torch.no_grad():
        real = render_from_config(gt_aligned(tb), tb["tgt"], rcfg, tb["src_mask"],
                                  tb["tgt_mask"])
    fake = fake_g if fake is None else fake.to(device)
    dstate = DiscState(disc, discriminator_optimizer(disc.parameters(), tcfg))
    _, d_loss = make_discriminator_step(rcfg)(dstate, fake, tb["src"], tb["tgt"],
                                              tb["src_mask"], tb["tgt_mask"], tb["rot"],
                                              tb["trans"])
    out = {k: float(v) for k, v in metrics.items()}
    out.update(grad_norm=float(gnorm), d_loss=float(d_loss), fake=fake_g.cpu(),
               real=real.cpu(), bn3_var=disc.bn_3.running_var.cpu())
    return out


def phase_train_card_vs_cpu(init_state, batch):
    """Path 3 on the card against the port's CPU path (bf16 plain bodies):
    one GAN generator step and one discriminator step at full width on
    2 pairs x 1,024 points. Bars: real renders (the same points, kernel vs
    plain) 1e-4; the discriminator step on the same fake images: d_loss and
    the BatchNorm running variance 1e-4 relative (fp32 convolutions without
    TF32 on both); the generator step, whose bf16 forward rounds at other
    places in the fused kernels than in the plain body (the forward's bar
    is 5e-2): point_loss 2e-2 relative, g_loss within 5e-2 (1 + |g_loss|),
    the gradient norm 5e-2 relative, the fake renders 5e-2 in mean."""
    import torch

    log(f"tf32: torch.backends.cuda.matmul.allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32 "
        f"{torch.backends.cudnn.allow_tf32} (set by scream_tpu_torch: the "
        f"discriminator's fp32 convolutions run in full fp32)")
    card = gan_steps(DEV, init_state, batch)
    cpu = gan_steps("cpu", init_state, batch, fake=card["fake"])
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    real_err = float((card["real"] - cpu["real"]).abs().max())
    fake_mean = float((card["fake"] - cpu["fake"]).abs().mean())
    fake_max = float((card["fake"] - cpu["fake"]).abs().max())
    var_err = float(((card["bn3_var"] - cpu["bn3_var"]).abs().max()
                     / cpu["bn3_var"].abs().max()))
    errs = dict(point_loss=rel(card["point_loss"], cpu["point_loss"]),
                g_loss=abs(card["g_loss"] - cpu["g_loss"]) / (1 + abs(cpu["g_loss"])),
                grad_norm=rel(card["grad_norm"], cpu["grad_norm"]),
                d_loss=rel(card["d_loss"], cpu["d_loss"]))
    finite = all(math.isfinite(v) for d in (card, cpu) for k, v in d.items()
                 if isinstance(v, float))
    check(finite and real_err <= 1e-4 and errs["d_loss"] <= 1e-4 and var_err <= 1e-4
          and errs["point_loss"] <= 2e-2 and errs["g_loss"] <= 5e-2
          and errs["grad_norm"] <= 5e-2 and fake_mean <= 5e-2,
          f"path 3 card vs CPU path: real renders {real_err:.3g}, fake renders mean "
          f"{fake_mean:.3g}, bn var {var_err:.3g}, {errs}, finite {finite}")
    log(f"path 3 GAN step card vs CPU path (full width, 2 x 1,024): point_loss "
        f"{card['point_loss']:.6f} / {cpu['point_loss']:.6f} (rel {errs['point_loss']:.2e}, "
        f"bar 2e-2), g_loss {card['g_loss']:.6f} / {cpu['g_loss']:.6f} "
        f"({errs['g_loss']:.2e}, bar 5e-2), grad norm {card['grad_norm']:.6f} / "
        f"{cpu['grad_norm']:.6f} (rel {errs['grad_norm']:.2e}, bar 5e-2), d_loss "
        f"{card['d_loss']:.6f} / {cpu['d_loss']:.6f} (rel {errs['d_loss']:.2e}, bar 1e-4), "
        f"bn_3 running var rel {var_err:.2e} (bar 1e-4), real renders max "
        f"{real_err:.2e} (bar 1e-4), fake renders mean {fake_mean:.2e} (bar 5e-2) max "
        f"{fake_max:.2e}")


def phase_disc_separation(model, batch):
    """The shipped discriminator's mean logits (batch-stats mode, as the
    generator step queries it) on real renders (GT-aligned source) and fake
    renders (``model``'s prediction, computed once on the card) of 8 pairs
    x 512 points, on the card and on the CPU path: the card within 1e-3 of
    the CPU path; real > fake on the card wherever the CPU path shows it
    (the JAX package shows it on the same pairs,
    ``scripts/torch_port_disc_separation.py``)."""
    import torch

    from scream_tpu_torch.config import RenderConfig
    from scream_tpu_torch.models import images_to_nhwc
    from scream_tpu_torch.ops.render import render_from_config
    from scream_tpu_torch.pipeline.register import gt_center_hint, to_device
    from scream_tpu_torch.utils.checkpoint import load_discriminator

    tb = to_device(batch, DEV)
    with torch.no_grad():
        pred = model(tb["src"], tb["tgt"], tb["src_mask"], tb["tgt_mask"],
                     gt_center_hint(tb["rot"], tb["trans"])).float()
    out = {}
    for device in (DEV, "cpu"):
        b = to_device(batch, device)
        disc = load_discriminator(DISC, device)
        with torch.no_grad():
            for kind, pts in (("real", gt_aligned(b)), ("fake", pred.to(device))):
                imgs = render_from_config(pts, b["tgt"], RenderConfig(), b["src_mask"],
                                          b["tgt_mask"])
                logits = disc(images_to_nhwc(imgs), train=True, update_stats=False)
                out[(device, kind)] = float(logits.mean())
    diff = max(abs(out[(DEV, k)] - out[("cpu", k)]) for k in ("real", "fake"))
    check(diff <= 1e-3, f"shipped discriminator card vs CPU path: mean logits {out}")
    if out[("cpu", "real")] > out[("cpu", "fake")]:
        check(out[(DEV, "real")] > out[(DEV, "fake")],
              f"shipped discriminator: real <= fake on the card: {out}")
    log(f"path 3 shipped discriminator (8 x 512, batch-stats mode): mean logit real "
        f"{out[(DEV, 'real')]:.4f} vs fake {out[(DEV, 'fake')]:.4f} on the card, "
        f"{out[('cpu', 'real')]:.4f} vs {out[('cpu', 'fake')]:.4f} on the CPU path "
        f"(max diff {diff:.2e}, bar 1e-3)")


def run_training(model, disc, batches, use_gan):
    """Timed training iterations at full width on distinct batches (the
    first a warm-up): generator steps with the GAN on, each followed by a
    discriminator step, or generator steps alone. Losses come to the host
    every iteration. Returns (pairs/s, launch counts, stage ms, losses)."""
    import torch

    from scream_tpu_torch.config import RenderConfig, TrainConfig
    from scream_tpu_torch.ops import launch_counts, reset_launch_counts
    from scream_tpu_torch.pipeline.register import to_device
    from scream_tpu_torch.train import (DiscState, discriminator_optimizer,
                                        generator_optimizer, init_train_state,
                                        make_disc_logit_fn, make_discriminator_step,
                                        make_registration_train_step)

    tcfg, rcfg = TrainConfig(use_gan=use_gan), RenderConfig()
    opt, sched = generator_optimizer(model.parameters(), tcfg, steps_per_epoch=1000)
    state = init_train_state(opt, sched)
    gstep = make_registration_train_step(model, use_gan=tcfg.use_gan,
                                         disc_apply=make_disc_logit_fn(), render_cfg=rcfg,
                                         gan_weight=tcfg.gan_weight)
    dstate = DiscState(disc, discriminator_optimizer(disc.parameters(), tcfg))
    dstep = make_discriminator_step(rcfg)
    tbs = [to_device(b, DEV) for b in batches]
    events = []

    def one(tb, timed):
        nonlocal state, dstate
        ev = {"start": torch.cuda.Event(enable_timing=True)}
        ev["start"].record()

        def hook(name):
            ev[name] = torch.cuda.Event(enable_timing=True)
            ev[name].record()

        state, metrics, fake = gstep(state, tb, disc, hook)
        losses = {k: float(v) for k, v in metrics.items()}
        if tcfg.use_gan:
            dstate, d_loss = dstep(dstate, fake, tb["src"], tb["tgt"], tb["src_mask"],
                                   tb["tgt_mask"], tb["rot"], tb["trans"])
            hook("d_step")
            losses["d_loss"] = float(d_loss)
        if timed:
            events.append(ev)
        return losses

    one(tbs[0], False)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = [one(tb, True) for tb in tbs[1:]]
    elapsed = time.perf_counter() - t0
    counts = launch_counts()
    torch.cuda.synchronize()
    names = [n for n in events[0] if n != "start"]
    stages = {}
    for i, n in enumerate(names):
        prev = "start" if i == 0 else names[i - 1]
        stages[n] = sum(e[prev].elapsed_time(e[n]) for e in events) / len(events)
    finite = all(math.isfinite(v) for d in losses for v in d.values()) and all(
        bool(torch.isfinite(p).all()) for m in (model, disc) for p in m.parameters())
    check(finite, f"training use_gan={use_gan}: a loss or a parameter is not finite")
    return TRAIN_B * len(losses) / elapsed, counts, stages, losses


def phase_training(model, disc, batches):
    """Path 3's main path: timed GAN iterations (G + D), then timed G-only
    steps (the default recipe), at 8 pairs x 4,096 points."""
    n = TRAIN_ITERS + 1
    pps, counts, stages, losses = run_training(model, disc, batches[:n], True)
    iters = len(losses)
    check(all(counts[k] > 0 for k in PATH3_KERNELS),
          f"path 3: a kernel of the training path was not launched: {counts}")
    per_iter = {k: v / iters for k, v in counts.items()}
    log(f"path 3 training, GAN on, {TRAIN_B} x {TRAIN_CAP}, full width: {pps:.2f} pairs/s "
        f"over {iters} iterations (G + D step) | stage ms (CUDA events) "
        f"{json.dumps({k: round(v, 3) for k, v in stages.items()})} | launches per "
        f"iteration {json.dumps(per_iter)} | last losses {json.dumps(losses[-1])} | all finite")
    pps_off, _, stages_off, losses_off = run_training(model, disc, batches[n:2 * n], False)
    log(f"path 3 training, GAN off, {TRAIN_B} x {TRAIN_CAP}: {pps_off:.2f} pairs/s over "
        f"{len(losses_off)} G steps | stage ms "
        f"{json.dumps({k: round(v, 3) for k, v in stages_off.items()})} | last losses "
        f"{json.dumps(losses_off[-1])}")
    return counts, dict(train_pairs_per_s_gan=pps, train_pairs_per_s_no_gan=pps_off,
                        train_stage_ms_gan=stages, train_stage_ms_no_gan=stages_off,
                        train_launches_per_iteration_gan=per_iter)


def dem_config(d=DEM_D):
    """``opengf_presets()`` at d_model ``d`` (8 heads): the model config and
    the train config (batch 8, GAN off)."""
    import dataclasses

    from scream_tpu_torch.config import opengf_presets

    model_cfg, train_cfg, _, _ = opengf_presets()
    return dataclasses.replace(model_cfg, d_model=d), train_cfg


def make_dem_items(n_batches, seed, batch=DEM_B, points=DEM_CAP):
    """``n_batches`` lists of ``batch`` ``make_dem_patch`` patches (``points``
    DSM/DEM points, points // 16 coarse), made on the host."""
    import numpy as np

    from scream_tpu_torch.data import make_dem_patch

    rng = np.random.default_rng(seed)
    return [[make_dem_patch(rng, n_dsm=points, n_dem=points) for _ in range(batch)]
            for _ in range(n_batches)]


def dem_batch(items, cap=DEM_CAP, coarse=DEM_COARSE):
    from scream_tpu_torch.data import collate_dem

    return collate_dem(items, cap, cap, coarse)


def block_input(model, block, args):
    """The input q and the row mask of ``block``'s first call in
    ``model(*args)``, taken by a pre-hook."""
    import torch

    seen = []
    hook = block.register_forward_pre_hook(
        lambda mod, a: seen.append((a[0].detach(), a[3])) if not seen else None)
    try:
        with torch.no_grad():
            model(*args)
    finally:
        hook.remove()
    return seen[0]


def tail_inputs(model, block, args):
    """The tail input (x, q) and the row mask of ``block`` on ``model(*args)``:
    q and the mask from :func:`block_input`; x is the block's plain
    attention message of q."""
    import torch

    q, m_bool = block_input(model, block, args)
    with torch.no_grad():
        x = block.message(q, q, q, m_bool, m_bool)
    return x, q, m_bool


def check_tail(block, x, q, m_bool, suffix="", dtype=None):
    """The tail kernel against its plain version on the card, on the block's
    weights and the real input (x, q): the forward within 1e-2 of the
    largest output on the valid rows (one bf16 ulp at the output scale, the
    apply kernel's bar); the gradients with respect to x, q and the seven
    weights through ``_FusedTail`` against those through ``tail_plain``,
    same upstream gradient, each within 3e-2 of its largest (the TPU
    selftest's tail bar). With ``dtype`` fp32 the fp32 kernel
    (``csrc/tail_f32.cu``), forward and gradients within 2e-5. Returns a
    record."""
    import torch

    from scream_tpu_torch.ops import tail_cuda
    from scream_tpu_torch.ops.ffn import tail_plain

    bf, f32 = torch.bfloat16, torch.float32
    cd = dtype or bf
    fp32 = cd == f32
    bar, g_bar = (FP32_BARS["tail"], FP32_BARS["tail"]) if fp32 else (1e-2, 3e-2)
    isz, peak = (4, PEAK_FP32) if fp32 else (2, PEAK_BF16)
    w = [t.detach() for t in (block.merge.kernel, block.norm1.scale, block.norm1.bias,
                              block.ffn_in.kernel, block.ffn_out.kernel,
                              block.norm2.scale, block.norm2.bias)]
    if not fp32:
        check_pack(w[0], w[3], w[4], suffix="_tail" + suffix)
    kern = lambda *a: tail_cuda.block_tail(*a, dtype=cd, norm_dtype=f32)
    plain = lambda *a: tail_plain(*a, cd=cd, nd=f32, eps=1e-5)
    with torch.no_grad():
        out, ref = kern(x, q, *w), plain(x, q, *w)
    torch.cuda.synchronize()
    err = rel_err(out, ref, rows=m_bool)
    abs_err = float((out.float() - ref.float())[m_bool].abs().max())
    g = torch.Generator(device=DEV).manual_seed(4)
    up = (torch.randn(out.shape, generator=g, device=DEV) * m_bool[..., None]).to(cd)
    grads = []
    for fn in (kern, plain):
        ins = [t.clone().requires_grad_(True) for t in (x, q, *w)]
        grads.append(torch.autograd.grad(fn(*ins), ins, up))
    torch.cuda.synchronize()
    g_err = max(rel_err(a, b) for a, b in zip(*grads))
    check(err <= bar and g_err <= g_bar and bool(torch.isfinite(out.float()).all()),
          f"block_tail{suffix}: forward relative error {err:.3g} (bar {bar}), gradient "
          f"relative error {g_err:.3g} (bar {g_bar})")
    with torch.no_grad():
        ms = cuda_ms(lambda: kern(x, q, *w))
        pms = cuda_ms(lambda: plain(x, q, *w))
    d, hid = x.shape[-1], w[3].shape[1]
    R = x.numel() // d
    b_ms, b_by = bound((3 * R * d + d * d + 2 * d * hid) * isz + 4 * d * 4,
                       [(2 * R * d * (d + 2 * hid), peak)])
    log(f"kernel block_tail{suffix} (d {d}, {tuple(x.shape[:-1])} rows, {cd}): gradient "
        f"rel err {g_err:.3e} (bar {g_bar})")
    return dict(name="block_tail" + suffix, err=err, max_abs_err=abs_err, ms=ms,
                plain_ms=pms, bound_ms=b_ms, bound_by=b_by, bar=f"{bar} rel", route="cuda",
                source=f"scream_tpu_torch/csrc/{'tail_f32' if fp32 else 'tail'}.cu",
                replaces="scream_tpu/ops/ffn_pallas.py:86")


def phase_kernels_dem(model, batch, path1_model, path1_batch):
    """The tail kernel on the first DSM stem block's real tail input
    (8 x 8,192, d 512) and the first coarse-DEM stem block's (8 x 1,024);
    then at d 256 through ``ModelConfig(fused_attention=False)`` with path
    1's weights on path 1's batch, whose forward must run the tail kernel in
    all 24 blocks (the JAX package's rule) and the fused kernels in none."""
    import torch

    from scream_tpu_torch.config import ModelConfig
    from scream_tpu_torch.models import PointTransformer
    from scream_tpu_torch.ops import launch_counts, reset_launch_counts
    from scream_tpu_torch.pipeline.register import gt_center_hint, to_device

    tb = to_device(batch, DEV)
    args = (tb["dsm"], tb["dem_coarse"], tb["dsm_mask"], tb["dem_coarse_mask"])
    x, q, m_bool = tail_inputs(model, model.trunk.stem_src_0, args)
    records = [check_tail(model.trunk.stem_src_0, x, q, m_bool),
               check_tail(model.trunk.stem_tgt_0, *tail_inputs(
                   model, model.trunk.stem_tgt_0, args), suffix="_coarse")]
    # Ragged rows: the DSM stem's input cut to row counts that leave the
    # last 64-row tile part-filled.
    d = x.shape[-1]
    for rows in RAGGED_TAIL_ROWS:
        records.append(check_tail(model.trunk.stem_src_0, x.reshape(-1, d)[:rows],
                                  q.reshape(-1, d)[:rows], m_bool.reshape(-1)[:rows],
                                  suffix=f"_r{rows}"))

    unfused = PointTransformer(ModelConfig(fused_attention=False), device=DEV)
    unfused.load_state_dict(path1_model.state_dict())
    pb = to_device(path1_batch, DEV)
    pargs = (pb["src"], pb["tgt"], pb["src_mask"], pb["tgt_mask"],
             gt_center_hint(pb["rot"], pb["trans"]))
    reset_launch_counts()
    with torch.no_grad():
        unfused(*pargs)
    counts = launch_counts()
    check(counts["block_tail"] == 24 and counts["attn_apply"] == 0,
          f"ModelConfig(fused_attention=False) at d 256: launches {counts}, expected "
          "24 tail kernels and no fused block")
    records.append(check_tail(unfused.trunk.stem_0, *tail_inputs(
        unfused, unfused.trunk.stem_0, pargs), suffix="_d256"))
    log(f"fused_attention=False at d 256 ({B} x {CAP}): one forward launched "
        f"{counts['block_tail']} tail kernels, {counts['attn_apply']} fused blocks")
    log_records(records)
    return records


def phase_dem_forward(model, batch):
    """The DEM forward through the tail kernel (fused_block_tail None)
    against the literal plain forward (fused_block_tail False), same
    weights, bf16 on the card, on the valid DSM rows: 5e-2 (the fused-block
    bar)."""
    import dataclasses

    import torch

    from scream_tpu_torch.models import DEMTransformer
    from scream_tpu_torch.pipeline.register import to_device

    plain = DEMTransformer(dataclasses.replace(model.cfg, fused_block_tail=False),
                           device=DEV)
    plain.load_state_dict(model.state_dict())
    tb = to_device(batch, DEV)
    args = (tb["dsm"], tb["dem_coarse"], tb["dsm_mask"], tb["dem_coarse_mask"])
    with torch.no_grad():
        a, b = model(*args), plain(*args)
    del plain
    err = rel_err(a, b, rows=tb["dsm_mask"])
    check(math.isfinite(err) and err <= 5e-2, f"DEM forward kernel vs plain: {err:.3g} > 5e-2")
    log(f"path 4 DEM forward ({DEM_B} x {DEM_CAP}, d {DEM_D}): tail kernel vs plain body "
        f"rel_err {err:.3e} (bar 5e-2)")


def dem_step(device, init_state, batch, d=DEM_D):
    """One ``make_dem_train_step`` (GAN off) at d_model ``d`` on ``device``
    from the weights ``init_state``: (point_loss, gradient norm)."""
    import torch

    from scream_tpu_torch.models import DEMTransformer
    from scream_tpu_torch.pipeline.register import to_device
    from scream_tpu_torch.train import (generator_optimizer, init_train_state,
                                        make_dem_train_step)

    model_cfg, tcfg = dem_config(d)
    model = DEMTransformer(model_cfg, device=device)
    model.load_state_dict(init_state)
    opt, sched = generator_optimizer(model.parameters(), tcfg, steps_per_epoch=1000)
    _, metrics, _ = make_dem_train_step(model)(init_train_state(opt, sched),
                                               to_device(batch, device))
    gnorm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in model.parameters()))
    return float(metrics["point_loss"]), float(gnorm)


def phase_dem_card_vs_cpu(init_state, batch, d=DEM_D, label="path 4"):
    """A DEM path on the card against the port's CPU path (plain bodies,
    bf16): one DEM step at full depth, d_model ``d``, 2 x 1,024 (coarse
    128). Bars, path 3's: point_loss 2e-2 relative, the gradient norm 5e-2
    relative."""
    t0 = time.perf_counter()
    card = dem_step(DEV, init_state, batch, d)
    cpu = dem_step("cpu", init_state, batch, d)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    e_loss, e_grad = rel(card[0], cpu[0]), rel(card[1], cpu[1])
    check(all(math.isfinite(v) for v in card + cpu) and e_loss <= 2e-2 and e_grad <= 5e-2,
          f"{label} card vs CPU path: point_loss {card[0]} / {cpu[0]}, grad norm "
          f"{card[1]} / {cpu[1]}")
    log(f"{label} DEM step card vs CPU path (d {d}, 2 x 1,024, coarse 128): point_loss "
        f"{card[0]:.6f} / {cpu[0]:.6f} (rel {e_loss:.2e}, bar 2e-2), grad norm "
        f"{card[1]:.6f} / {cpu[1]:.6f} (rel {e_grad:.2e}, bar 5e-2) "
        f"({time.perf_counter() - t0:.1f} s)")


class ListData:
    """A map-style dataset over items made up front."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def dem_loader(groups):
    """A DEMLoader over the patch lists ``groups``, one batch each, in order."""
    from scream_tpu_torch.data import DEMLoader

    return DEMLoader(ListData([it for g in groups for it in g]), batch_size=DEM_B,
                     dsm_capacity=DEM_CAP, dem_capacity=DEM_CAP,
                     coarse_capacity=DEM_COARSE)


def phase_dem_training(trainer, groups, label="path 4", kernels=("block_tail",)):
    """Path 4's main path (and path 8's at d 384): ``DEMTrainer.train_epoch``
    over 1 warm-up batch,
    then over its own loader of DEM_ITERS distinct batches, timed (the host
    reads the losses every iteration: ``log_every`` 1), stage times by CUDA
    events and the kernels' launches; ``evaluate`` on two batches; then
    save_state, restore_state into a trainer from another seed, and one more
    step on both: loss and parameters within 1e-5 relative. Returns (launch
    counts, results)."""
    import shutil

    import torch

    from scream_tpu_torch.ops import launch_counts, reset_launch_counts
    from scream_tpu_torch.pipeline.register import to_device
    from scream_tpu_torch.train import DEMTrainer

    timed_loader = trainer.train_loader
    trainer.train_loader = dem_loader(groups[:1])
    trainer.train_epoch(0)  # warm-up
    trainer.train_loader = timed_loader
    torch.cuda.synchronize()
    events = []
    step = trainer.train_step

    def timed_step(state, batch, disc=None):
        ev = {"start": torch.cuda.Event(enable_timing=True)}
        ev["start"].record()

        def hook(name):
            ev[name] = torch.cuda.Event(enable_timing=True)
            ev[name].record()

        out = step(state, batch, disc, hook)
        events.append(ev)
        return out

    trainer.train_step = timed_step
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = trainer.train_epoch(1)
    elapsed = time.perf_counter() - t0
    counts = launch_counts()
    trainer.train_step = step
    torch.cuda.synchronize()
    names = [n for n in events[0] if n != "start"]
    stages = {n: sum(e["start" if i == 0 else names[i - 1]].elapsed_time(e[n])
                     for e in events) / len(events) for i, n in enumerate(names)}
    pps = DEM_B * len(events) / elapsed
    check(len(events) == DEM_ITERS and all(counts[k] > 0 for k in kernels)
          and all(math.isfinite(v) for v in losses.values()),
          f"{label} training: {len(events)} iterations, launches {counts}, losses {losses}")
    per_iter = {k: v / DEM_ITERS for k, v in counts.items() if v}
    d = trainer.model_cfg.d_model
    log(f"{label} training, opengf d {d}, {DEM_B} x {DEM_CAP} (coarse {DEM_COARSE}): "
        f"{pps:.2f} patches/s over {DEM_ITERS} iterations ({elapsed / DEM_ITERS * 1e3:.1f} "
        f"ms each) | stage ms (CUDA events) "
        f"{json.dumps({k: round(v, 3) for k, v in stages.items()})} | launches per iteration "
        f"{json.dumps(per_iter)} | mean losses {json.dumps(losses)}")

    t0 = time.perf_counter()
    val = trainer.evaluate()
    check(all(math.isfinite(v) for v in val.values()), f"{label} evaluate: {val}")
    log(f"{label} evaluate ({len(trainer.val_loader)} x {DEM_B} patches): {json.dumps(val)} "
        f"({time.perf_counter() - t0:.1f} s)")

    state_dir = os.path.join(WORK_DIR, "dem_state")
    trainer.save_state(state_dir)
    other = DEMTrainer(trainer.train_loader, trainer.val_loader, model_cfg=trainer.model_cfg,
                       train_cfg=trainer.train_cfg, device=DEV)
    other.init(seed=1)
    other.restore_state(state_dir)
    shutil.rmtree(state_dir)
    tb = to_device(dem_batch(groups[-1]), DEV)
    outs = [float(t.train_step(t.state, tb)[1]["loss"]) for t in (trainer, other)]
    p_err = max(rel_err(a.detach(), b.detach()) for a, b in zip(
        other.model.parameters(), trainer.model.parameters()))
    l_err = abs(outs[1] - outs[0]) / max(abs(outs[0]), 1e-30)
    check(l_err <= 1e-5 and p_err <= 1e-5 and other.state.step == trainer.state.step,
          f"{label} resume: loss {outs}, parameter error {p_err:.3g}, steps "
          f"{other.state.step} / {trainer.state.step}")
    log(f"{label} save_state -> restore_state into a seed-1 trainer -> one more step on "
        f"both: loss {outs[0]:.6f} / {outs[1]:.6f} (rel {l_err:.1e}, bar 1e-5), parameters "
        f"rel {p_err:.1e} (bar 1e-5), step {trainer.state.step}")
    del other
    return counts, dict(dem_train_patches_per_s=pps, dem_train_stage_ms=stages,
                        dem_train_launches_per_iteration=per_iter, dem_val=val)


# The CLI's own entry point, then the kernels' launch counts on stderr.
CLI_COUNTED = ("import json, sys; from scream_tpu_torch import cli; "
               "from scream_tpu_torch.ops import launch_counts; cli.main(sys.argv[1:]); "
               "print('\\n# launches ' + json.dumps(launch_counts()), file=sys.stderr)")


def run_cli(args, label, counted=False):
    """``python -m scream_tpu_torch <args>`` in a subprocess: (final_val,
    stdout, wall seconds); with ``counted`` the same entry point through
    ``CLI_COUNTED``, and stdout is then (stdout, launch counts)."""
    root, env = repo_env()
    t0 = time.perf_counter()
    head = ["-c", CLI_COUNTED] if counted else ["-m", "scream_tpu_torch"]
    proc = subprocess.run([sys.executable, *head, *args],
                          capture_output=True, text=True, timeout=400, cwd=root, env=env)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{label}: exit {proc.returncode}:\n{proc.stderr[-3000:]}")
    final = json.loads(proc.stdout.strip().splitlines()[-1])["final_val"]
    check(bool(final) and all(math.isfinite(v) for v in final.values()),
          f"{label}: final_val {final}")
    if counted:
        line = [ln for ln in proc.stderr.splitlines() if ln.startswith("# launches ")][-1]
        return final, (proc.stdout, json.loads(line[len("# launches "):])), wall
    return final, proc.stdout, wall


def phase_train_cli():
    """The ``train`` CLI on the card, synthetic data: ``opengf --d-model 512
    --epochs 2`` (4 steps and validation), then ``--resume --epochs 3``
    (must resume at epoch 2), then ``3dmatch --epochs 2 --synthetic-pairs
    16`` at the default width (the fused attention kernels; validation runs
    register_batch with ICP)."""
    import shutil

    ck = os.path.join(WORK_DIR, "cli_opengf")
    shutil.rmtree(ck, ignore_errors=True)
    base = ["train", "opengf", "--d-model", str(DEM_D), "--checkpoint-dir", ck]
    final, _, wall = run_cli(base + ["--epochs", "2"], "train opengf")
    log(f"cli: train opengf --d-model {DEM_D} --epochs 2 ({wall:.1f} s): final_val "
        f"{json.dumps(final)}")
    final, out, wall = run_cli(base + ["--epochs", "3", "--resume"], "train opengf --resume")
    check("resuming at epoch 2" in out, f"train --resume did not resume at epoch 2:\n{out}")
    log(f"cli: train opengf --resume --epochs 3 ({wall:.1f} s): resumed at epoch 2, "
        f"final_val {json.dumps(final)}")
    ck3 = os.path.join(WORK_DIR, "cli_3dmatch")
    shutil.rmtree(ck3, ignore_errors=True)
    final, _, wall = run_cli(["train", "3dmatch", "--epochs", "2", "--synthetic-pairs", "16",
                              "--checkpoint-dir", ck3], "train 3dmatch")
    log(f"cli: train 3dmatch --epochs 2 --synthetic-pairs 16 ({wall:.1f} s): final_val "
        f"{json.dumps(final)}")
    shutil.rmtree(WORK_DIR, ignore_errors=True)


def path4(path1_model, path1_batch):
    """Path 4: OpenGF training at d_model 512. Returns (records, launch
    counts of the timed training, results)."""
    import dataclasses

    import torch

    from scream_tpu_torch.train import DEMTrainer

    t0 = time.perf_counter()
    model_cfg, train_cfg = dem_config()
    groups = make_dem_items(DEM_ITERS + 2, seed=800)
    small = dem_batch(make_dem_items(1, seed=1000, batch=2, points=1024)[0], cap=1024,
                      coarse=128)
    trainer = DEMTrainer(dem_loader(groups[1:1 + DEM_ITERS]),
                         dem_loader(make_dem_items(2, seed=900)),
                         model_cfg=model_cfg,
                         train_cfg=dataclasses.replace(train_cfg, log_every=1), device=DEV)
    trainer.init(seed=0)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f"path 4 model: d {DEM_D}, {model_cfg.num_heads} heads, {model_cfg.self_layers} + "
        f"{model_cfg.cross_layers} layers, separate stems, {n_params:,} parameters")
    check_batch = dem_batch(groups[-1])
    records = phase_kernels_dem(trainer.model, check_batch, path1_model, path1_batch)
    phase_dem_forward(trainer.model, check_batch)
    init_state = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    phase_dem_card_vs_cpu(init_state, small)
    counts, results = phase_dem_training(trainer, groups[:-1])
    del trainer
    torch.cuda.empty_cache()
    phase_train_cli()
    log(f"path 4 took {time.perf_counter() - t0:.1f} s")
    return records, counts, results


def write_split_tree(root):
    """The split tree of path 5 under ``root``, in the readers' layout
    (``src%d/tgt%d/T%d.npy``, ``info/`` for 3DMatch; ``[dsm | dem]`` blocks
    and ``centers/`` for OpenGF), from numpy seeds. 3DMatch: a third of the
    pairs in each of the 1,024, 2,048 and 4,096 buckets, every fifth pair
    with an idx gap of 1 (not counted by the protocol)."""
    import numpy as np

    from scream_tpu_torch.data.datasets import SCENE_NAME_TO_IDX
    from scream_tpu_torch.data.synthetic import make_dem_patch, make_pair

    def save(d, i, p):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = p["rot"]
        T[:3, 3] = p["trans"].reshape(3)
        np.save(os.path.join(d, f"src{i}.npy"), p["src"].astype(np.float32))
        np.save(os.path.join(d, f"tgt{i}.npy"), p["tgt"].astype(np.float32))
        np.save(os.path.join(d, f"T{i}.npy"), T)

    rng = np.random.default_rng(1100)
    d = os.path.join(root, "3DMatch_test")
    os.makedirs(os.path.join(d, "info"))
    scenes, ranges = list(SCENE_NAME_TO_IDX), ((900, 1025), (1025, 2049), (2049, 4097))
    for i in range(EVAL_PAIRS):
        lo, hi = ranges[i % 3]
        p = make_pair(rng, n_src=int(rng.integers(lo, hi)), n_tgt=int(rng.integers(lo, hi)),
                      overlap=float(rng.uniform(0.5, 0.9)), noise=0.002, extent=1.5)
        save(d, i, p)
        base = int(rng.integers(0, 500))
        gap = 1 if i % 5 == 4 else int(rng.integers(2, 30))
        a = rng.standard_normal((6, 6))
        np.save(os.path.join(d, "info", f"idx{i}.npy"), np.array([base, base + gap], np.int64))
        np.save(os.path.join(d, "info", f"covariance{i}.npy"),
                a @ a.T * len(p["src"]) + np.eye(6) * len(p["src"]))
    with open(os.path.join(d, "info", "scene_names.txt"), "w") as f:
        f.write("\n".join(scenes[i % 8] for i in range(EVAL_PAIRS)) + "\n")

    d = os.path.join(root, "KITTI_test")
    os.makedirs(d)
    for i in range(KITTI_PAIRS):
        save(d, i, make_pair(rng, n_src=int(rng.integers(6000, 8193)),
                             n_tgt=int(rng.integers(6000, 8193)),
                             overlap=float(rng.uniform(0.5, 0.9)), noise=0.002, extent=40.0))

    d = os.path.join(root, "OpenGF_test")
    os.makedirs(os.path.join(d, "centers"))
    for i in range(1, OPENGF_PATCHES + 1):
        n = int(rng.integers(4096, 8193))
        pt = make_dem_patch(rng, n_dsm=n, n_dem=n, extent=50.0)
        np.save(os.path.join(d, f"{i}.npy"), np.concatenate([pt["dsm"], pt["dem"]], axis=1))
        np.save(os.path.join(d, "centers", f"{i}.npy"), np.zeros(3, np.float32))


def load_weights(path, device, cls=None, dtype=None):
    """A shipped checkpoint as a model in eval mode on ``device`` (its
    sidecar's compute dtype, or ``dtype``: the fp32 weights serve both),
    and its normalization."""
    import dataclasses

    from scream_tpu_torch.models import PointTransformer
    from scream_tpu_torch.utils.checkpoint import load_params

    cfg, normalize, state = load_params(path)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = (cls or PointTransformer)(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return model.eval(), normalize


def log_syncs(model, batch):
    """The host waits inside one steady-state ``register_batch`` on a staged
    batch (:func:`log_sync_waits`)."""
    from scream_tpu_torch.data import prefetch_to_device
    from scream_tpu_torch.pipeline.register import register_batch

    staged = next(prefetch_to_device([batch], device=DEV))
    run = lambda: register_batch(model, staged, icp_max_iter=ICP_ITERS, device=DEV)
    run()
    return log_sync_waits(run, f"path 5 syncs in one steady-state register_batch "
                               f"({B} x {CAP}, staged)")[1]


def phase_eval_3dmatch(model, model_cpu, root):
    """3DMatch through the bucketed loader and the collated cache (equal
    metrics), 3DZeroMatch once, the 1,024 bucket on the CPU path, and the
    evaluate CLI in a subprocess (its dict equal to the in-process one)."""
    from scream_tpu_torch.cli import _buckets_for
    from scream_tpu_torch.config import eval_preset
    from scream_tpu_torch.data import BucketedPairLoader, PairDataset, collated_or_build
    from scream_tpu_torch.eval import evaluate_registration

    ds = PairDataset(root, "3DMatch_test", normalize="unit_sphere", with_info=True,
                     max_points=CAP)
    buckets = _buckets_for(CAP, smallest=1024)
    t0 = time.perf_counter()
    bucketed = evaluate_registration(model, BucketedPairLoader(ds, EVAL_BATCH, buckets),
                                     eval_preset("3dmatch"), device=DEV)
    t_b = time.perf_counter() - t0
    cache = os.path.join(root, "collated")
    t0 = time.perf_counter()
    collated_loader = collated_or_build(ds, cache, EVAL_BATCH, buckets)
    t_build = time.perf_counter() - t0
    caps = sorted({b["src"].shape[1] for b in collated_loader})
    t0 = time.perf_counter()
    collated = evaluate_registration(model, collated_loader, eval_preset("3dmatch"),
                                     device=DEV)
    t_c = time.perf_counter() - t0
    check(caps == list(buckets), f"3DMatch buckets filled {caps}, want {list(buckets)}")
    same = bucketed.keys() == collated.keys() and all(
        math.isclose(bucketed[k], collated[k], rel_tol=1e-12, abs_tol=1e-12)
        for k in bucketed)
    check(same, f"bucketed vs collated metrics:\n{bucketed}\n{collated}")
    t0 = time.perf_counter()
    zero = evaluate_registration(model, BucketedPairLoader(ds, EVAL_BATCH, buckets),
                                 eval_preset("3dzeromatch"), device=DEV)
    t_z = time.perf_counter() - t0
    check(all(math.isfinite(v) for v in zero.values()), f"3dzeromatch: {zero}")
    log(f"path 5 evaluate 3dmatch ({bucketed['n_pairs']} pairs, buckets {caps}, batch "
        f"{EVAL_BATCH}): bucketed {t_b:.2f} s ({bucketed['n_pairs'] / t_b:.2f} pairs/s), "
        f"collated cache build {t_build:.2f} s, collated {t_c:.2f} s "
        f"({collated['n_pairs'] / t_c:.2f} pairs/s); metrics equal (rel 1e-12) | "
        f"{json.dumps(bucketed)}")
    log(f"path 5 evaluate 3dzeromatch: {t_z:.2f} s ({zero['n_pairs'] / t_z:.2f} pairs/s) | "
        f"{json.dumps(zero)}")

    check_bucket(model, model_cpu, collated_loader, buckets[0], "path 5")

    root_repo, env = repo_env()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "scream_tpu_torch", "evaluate", "3dmatch",
                           "--root", root, "--params", POINT_GEN, "--bucketed"],
                          capture_output=True, text=True, timeout=300, cwd=root_repo, env=env)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"evaluate CLI exit {proc.returncode}:\n{proc.stderr[-3000:]}")
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    check(cli == bucketed, f"evaluate CLI vs in-process:\n{cli}\n{bucketed}")
    log(f"path 5 cli: python -m scream_tpu_torch evaluate 3dmatch --params {POINT_GEN} "
        f"--bucketed ({wall:.1f} s wall, subprocess): JSON equal to the in-process dict")
    return dict(eval_3dmatch=bucketed, eval_3dmatch_s=t_b, eval_3dmatch_collated_s=t_c,
                eval_3dzeromatch=zero, eval_3dzeromatch_s=t_z)


def check_bucket(model, model_cpu, loader, cap, label):
    """The ``cap`` bucket of ``loader``, pair by pair, through
    ``register_batch`` on the card and on the CPU path: pair recall (RMSE <
    0.2) equal, at most 2 pairs with RE or TE off by more than
    ``TRANSFORM_TOL``."""
    import numpy as np
    import torch

    from scream_tpu_torch.pipeline.register import register_batch

    card, cpu = [], []
    kw = dict(icp_max_iter=ICP_ITERS)
    for b in loader:
        if b["src"].shape[1] != cap:
            continue
        b = {k: np.array(v) for k, v in b.items()}
        card.append(register_batch(model, b, device=DEV, **kw))
        cpu.append(register_batch(model_cpu, b, device="cpu", **kw))
    cat = lambda ms, f: torch.cat([getattr(m, f).cpu() for m in ms]).numpy()
    rc, rx = cat(card, "rmse") < 0.2, cat(cpu, "rmse") < 0.2
    d_re = np.abs(cat(card, "re_deg") - cat(cpu, "re_deg"))
    d_te = np.abs(cat(card, "te") - cat(cpu, "te"))
    off = int(((d_re > TRANSFORM_TOL) | (d_te > TRANSFORM_TOL)).sum())
    check(int(rc.sum()) == int(rx.sum()) and off <= 2,
          f"{label} {cap:,} bucket, card vs CPU path: recall {int(rc.sum())} / "
          f"{int(rx.sum())}, {off} pairs off by > {TRANSFORM_TOL}")
    log(f"{label} {cap:,} bucket ({len(rc)} pairs, {model.cfg.dtype}) card vs CPU path: "
        f"pair recall {int(rc.sum())} / {int(rx.sum())} (equal), {off} pairs with RE or TE "
        f"off by > {TRANSFORM_TOL} (bar 2), max dRE {float(d_re.max()):.3e} deg, max dTE "
        f"{float(d_te.max()):.3e}")


def phase_eval_kitti(root):
    """KITTI with the hint-free KITTI checkpoint (``center_mode="none"``),
    fused and chunked: the same counts; the transforms of one batch through
    both within 1e-5; the ICP steps taken against the 1,000 allowed."""
    import torch

    from scream_tpu_torch.config import eval_preset
    from scream_tpu_torch.data import PairDataset, PairLoader
    from scream_tpu_torch.eval import SkipDataset, evaluate_kitti
    from scream_tpu_torch.geometry.icp import registration_icp_batched
    from scream_tpu_torch.pipeline.register import (_register_solve_stage, register_batch,
                                                    register_batch_requeue, to_device)

    model, normalize = load_weights(KITTI_HINTFREE, DEV)
    ec = eval_preset("kitti")
    ds = SkipDataset(PairDataset(root, "KITTI_test", normalize=normalize,
                                 max_points=KITTI_CAP), (124, 142))
    loader = PairLoader(ds, batch_size=EVAL_BATCH, src_capacity=KITTI_CAP)
    kw = dict(dis_thresh=ec.dis_thresh, icp_thresh=ec.icp_thresh,
              icp_max_iter=ec.icp_max_iter, center_mode="none")
    out, secs = {}, {}
    for chunk in (None, KITTI_CHUNK):
        t0 = time.perf_counter()
        out[chunk] = evaluate_kitti(model, loader, icp_chunk=chunk, device=DEV, **kw)
        secs[chunk] = time.perf_counter() - t0
    fused, chunked = out[None], out[KITTI_CHUNK]
    succ = lambda o: round(o["success_rate"] * o["n_pairs"])
    check(fused["n_pairs"] == chunked["n_pairs"] == KITTI_PAIRS
          and succ(fused) == succ(chunked), f"KITTI fused vs chunked: {fused} / {chunked}")
    b = to_device(next(iter(loader)), DEV)
    rk = dict(dis_thresh=ec.dis_thresh, icp_thresh=ec.icp_thresh,
              icp_max_iter=ec.icp_max_iter, center_mode="none", device=DEV)
    t_fused = register_batch(model, b, **rk).transform
    t_chunk = register_batch_requeue(model, b, icp_chunk=KITTI_CHUNK, **rk).transform
    err = float((t_fused - t_chunk).abs().max())
    check(err <= 1e-5, f"KITTI transforms fused vs chunked: {err:.3g} > 1e-5")
    with torch.no_grad():
        sol, _, src_dn, tgt_dn = _register_solve_stage(model, b, ec.dis_thresh, "tgt", "none")
        res = registration_icp_batched(src_dn, tgt_dn, ec.icp_thresh, init=sol.transform,
                                       max_iteration=ec.icp_max_iter,
                                       src_mask=b["src_mask"], tgt_mask=b["tgt_mask"])
    its = res.iterations.cpu().tolist()
    log(f"path 5 evaluate kitti ({KITTI_HINTFREE}, center_mode none, {fused['n_pairs']} "
        f"pairs x {KITTI_CAP}): fused {secs[None]:.2f} s "
        f"({fused['n_pairs'] / secs[None]:.2f} pairs/s), icp_chunk {KITTI_CHUNK} "
        f"{secs[KITTI_CHUNK]:.2f} s ({chunked['n_pairs'] / secs[KITTI_CHUNK]:.2f} pairs/s); "
        f"success {succ(fused)} / {succ(chunked)} equal; transforms max err {err:.2e} "
        f"(bar 1e-5); ICP steps per pair {its} of {ec.icp_max_iter} allowed | "
        f"{json.dumps(fused)}")
    return dict(eval_kitti=fused, eval_kitti_s=secs[None], eval_kitti_chunk_s=secs[KITTI_CHUNK],
                kitti_icp_steps=its)


def phase_eval_opengf(root):
    """OpenGF with the shipped DEM generator: finite metrics on the card,
    within 2e-2 relative of the CPU path on 2 patches; peak memory."""
    import torch

    from scream_tpu_torch.data import DEMLoader, OpenGFDataset
    from scream_tpu_torch.eval import evaluate_open_gf
    from scream_tpu_torch.models import DEMTransformer

    model, _ = load_weights(DEM_GEN, DEV, DEMTransformer)
    ds = OpenGFDataset(root, "test")
    mk = lambda d, b: DEMLoader(d, batch_size=b, dsm_capacity=KITTI_CAP,
                                dem_capacity=KITTI_CAP, coarse_capacity=KITTI_CAP // 8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = evaluate_open_gf(model, mk(ds, EVAL_BATCH), device=DEV)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(out["n_patches"] == OPENGF_PATCHES and all(math.isfinite(v) for v in out.values()),
          f"opengf: {out}")
    two = [ds[i] for i in range(OPENGF_CPU_PATCHES)]
    card = evaluate_open_gf(model, mk(two, OPENGF_CPU_PATCHES), device=DEV)
    model_cpu, _ = load_weights(DEM_GEN, "cpu", DEMTransformer)
    cpu = evaluate_open_gf(model_cpu, mk(two, OPENGF_CPU_PATCHES), device="cpu")
    errs = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-30) for k in cpu}
    check(all(e <= OPENGF_TOL for e in errs.values()),
          f"opengf card vs CPU path on {OPENGF_CPU_PATCHES} patches: {card} / {cpu}")
    log(f"path 5 evaluate opengf ({DEM_GEN}, {out['n_patches']} patches x {KITTI_CAP}, "
        f"batch {EVAL_BATCH}): {secs:.2f} s ({out['n_patches'] / secs:.2f} patches/s), "
        f"peak memory {peak:.2f} GiB | {json.dumps(out)} | card vs CPU path on "
        f"{OPENGF_CPU_PATCHES} patches: rel {json.dumps(errs)} (bar {OPENGF_TOL})")
    return dict(eval_opengf=out, eval_opengf_s=secs, eval_opengf_peak_gib=peak)


def run_bench(args):
    """``python -m scream_tpu_torch bench <args>`` in a subprocess: (the JSON
    metric lines of both streams, stderr, wall seconds)."""
    root, env = repo_env()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "scream_tpu_torch", "bench", *args],
                          capture_output=True, text=True, timeout=400, cwd=root, env=env)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"bench {args}: exit {proc.returncode}:\n{proc.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in (proc.stdout + proc.stderr).splitlines()
             if ln.startswith("{")]
    return {r["metric"]: r for r in lines}, proc.stderr, wall


def phase_bench(model_cpu):
    """``bench`` and ``bench --suite`` in subprocesses: every metric line
    parses with a value > 0, the params line names the shipped checkpoint,
    median RE finite (beside the CPU path's on the first 4 pairs of the
    bench's first batch), and the kernels of the path launched."""
    import numpy as np

    from scream_tpu_torch.data import PairLoader, SyntheticPairDataset
    from scream_tpu_torch.pipeline.register import register_batch

    want = {"": ("3dmatch_registration_pairs_per_sec_per_chip",
                 "3dmatch_registration_pairs_per_sec_icp_subsampled"),
            "--suite": ("kitti_registration_pairs_per_sec",
                        "kitti_registration_pairs_per_sec_requeue",
                        "opengf_dem_patches_per_sec", "gt_free_serving_pairs_per_sec",
                        "adversarial_train_pairs_per_sec")}
    results, launches = {}, {}
    for flag, names in want.items():
        metrics, err, wall = run_bench([flag] if flag else [])
        check(all(n in metrics and metrics[n]["value"] > 0 for n in names),
              f"bench {flag}: missing or non-positive metrics {metrics}")
        params = [ln for ln in err.splitlines() if ln.startswith("# params:")]
        check(params and "shipped point-generator checkpoint" in params[0]
              and POINT_GEN in params[0], f"bench {flag}: params line {params}")
        med = [ln for ln in err.splitlines() if "median_re_deg=" in ln][0]
        re_card = float(med.split("median_re_deg=")[1].split()[0])
        check(math.isfinite(re_card), f"bench {flag}: {med}")
        launches[flag or "main"] = json.loads(
            [ln for ln in err.splitlines() if ln.startswith("# launches")][0][11:])
        results.update({n: metrics[n]["value"] for n in names})
        log(f"path 5 bench {flag} ({wall:.1f} s wall, subprocess): "
            + ", ".join(f"{n} {metrics[n]['value']}" for n in names)
            + f" | {params[0]} | {med[2:]} | launches {json.dumps(launches[flag or 'main'])}")
    need = {"main": PATH5_KERNELS, "--suite": PATH5_KERNELS + ("max_splat",)}
    check(all(launches[k][n] > 0 for k, ns in need.items() for n in ns),
          f"bench: a kernel of the path was not launched: {launches}")
    # The CPU path's median RE on the first 4 pairs of the bench's first batch.
    ds = SyntheticPairDataset(length=16 * 11, n_src=CAP - 256, n_tgt=CAP - 64, seed=0)
    first = next(iter(PairLoader(ds, batch_size=16, src_capacity=CAP, num_workers=4)))
    four = {k: np.asarray(v[:4]) for k, v in first.items()}
    m = register_batch(model_cpu, four, icp_max_iter=ICP_ITERS, device="cpu")
    m_card = register_batch(load_weights(POINT_GEN, DEV)[0], four, icp_max_iter=ICP_ITERS,
                            device=DEV)
    log(f"path 5 bench median RE {re_card:.3f} deg (card, the last timed batch); first 4 "
        f"pairs of the first batch: CPU path {float(np.median(m.re_deg.numpy())):.3f} deg, "
        f"card {float(np.median(m_card.re_deg.cpu().numpy())):.3f} deg")
    return results, launches, re_card


def path5():
    """Path 5: the evaluate protocols and the bench with the shipped
    full-width checkpoints. Returns (launch counts of the in-process
    protocols, results)."""
    import shutil
    import tempfile

    import torch

    from scream_tpu_torch.ops import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_splits_", dir="build")
    try:
        write_split_tree(root)
        model, _ = load_weights(POINT_GEN, DEV)
        model_cpu, _ = load_weights(POINT_GEN, "cpu")
        syncs = log_syncs(model, make_batches(1, seed=1200)[0])
        reset_launch_counts()
        results = phase_eval_3dmatch(model, model_cpu, root)
        results.update(phase_eval_kitti(root))
        results.update(phase_eval_opengf(root))
        counts = launch_counts()
        check(all(counts[k] > 0 for k in PATH5_KERNELS),
              f"path 5: a kernel was not launched: {counts}")
        log(f"path 5 launches (in-process protocols): {json.dumps(counts)}")
        del model
        torch.cuda.empty_cache()
        bench, bench_launches, re_card = phase_bench(model_cpu)
        results.update(bench=bench, bench_launches=bench_launches, bench_median_re_deg=re_card,
                       register_batch_syncs=syncs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"path 5 took {time.perf_counter() - t0:.1f} s")
    return counts, results


def run_parallel(commands, timeout=600):
    """Run ``{label: argv}`` as subprocesses at once from the repository
    root; every one must exit 0. Returns ``{label: (stdout, stderr, wall)}``.
    Each process is killed if the call fails."""
    root, env = repo_env()
    procs, out = {}, {}
    try:
        for label, argv in commands.items():
            procs[label] = (subprocess.Popen([sys.executable, *argv], cwd=root, env=env,
                                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                             text=True), time.perf_counter())
        for label, (proc, t0) in procs.items():
            stdout, stderr = proc.communicate(timeout=timeout)
            out[label] = (stdout, stderr, time.perf_counter() - t0)
            check(proc.returncode == 0,
                  f"{label}: exit {proc.returncode}:\n{stdout[-2000:]}\n{stderr[-3000:]}")
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def phase_ingest_build():
    """Path 6 (a): the host point-ops library builds from the checkout's
    source with g++ (a failure raises: there is no numpy path) and agrees
    with its plain versions on a seeded cloud."""
    import numpy as np

    from scream_tpu_torch import native

    t0 = time.perf_counter()
    path = native.build()
    native.library()
    secs = time.perf_counter() - t0
    rng = np.random.default_rng(1300)
    q, r = rng.uniform(-2, 2, (3000, 3)), rng.uniform(-2, 2, (4000, 3))
    same = {
        "voxel_downsample": np.array_equal(native.voxel_downsample(r, 0.1),
                                           native.voxel_downsample_plain(r, 0.1)),
        **{f: np.array_equal(getattr(native, f)(q, r, 0.25),
                             getattr(native, f + "_plain")(q, r, 0.25))
           for f in ("radius_has_neighbor", "radius_count", "highest_in_radius_2d")}}
    check(all(same.values()), f"point ops vs their plain versions: {same}")
    log(f"path 6 build: {secs:.1f} s, g++ -> {path.relative_to(path.parents[2])}; the four "
        f"point ops equal their plain versions: {json.dumps(same)}")


def phase_ingest_cli(root):
    """Path 6 (b): a raw tree from ``scripts/torch_port_make_raw.py``, the
    ``preprocess`` command on it (3dmatch, kitti and opengf at once, then
    collate for 3dmatch and kitti), every split opened with the port's
    readers at the size the generator built, each refined KITTI GT against
    the generator's pose, and ``evaluate`` 3dmatch (on the collated cache
    that ``preprocess collate`` built), kitti and opengf with the shipped
    checkpoints, in process through the CLI's own entry point. Returns
    (the evaluations' launch counts, results)."""
    import contextlib
    import io

    import numpy as np

    from scream_tpu_torch import cli
    from scream_tpu_torch.data import OpenGFDataset, PairDataset
    from scream_tpu_torch.data.raw import KittiOdometry
    from scream_tpu_torch.ops import launch_counts, reset_launch_counts

    raw, data = os.path.join(root, "raw"), os.path.join(root, "data")
    t0 = time.perf_counter()
    gen = run_parallel({"make_raw": ["scripts/torch_port_make_raw.py", "--out", raw,
                                     "--scale", str(INGEST_SCALE)]})["make_raw"]
    expected = json.loads(gen[0].strip().splitlines()[-1])["expected_splits"]
    log(f"path 6 raw tree (torch_port_make_raw.py --scale {INGEST_SCALE}, {gen[2]:.1f} s): "
        f"expected splits {json.dumps(expected)}")
    pre = lambda task, *a: ["-m", "scream_tpu_torch", "preprocess", task, *a]
    tasks = run_parallel({
        "3dmatch": pre("3dmatch", "--root", os.path.join(raw, "3dmatch_raw"), "--out", data),
        "kitti": pre("kitti", "--root", os.path.join(raw, "kitti_raw"), "--out", data),
        "opengf": pre("opengf", "--root", os.path.join(raw, "opengf_raw"), "--out", data)})
    walls = {k: round(v[2], 2) for k, v in tasks.items()}
    icp = [ln for ln in tasks["kitti"][1].splitlines() if ln.startswith("[refine_gt_icp]")]
    steps = [int(ln.split(" ICP steps")[0].split()[-1]) for ln in icp]
    icp_s = [float(ln.rsplit(", ", 1)[1].split()[0]) for ln in icp]
    for task, (stdout, _, _) in tasks.items():
        log(f"path 6 preprocess {task} ({walls[task]:.2f} s wall, subprocess): "
            + " | ".join(stdout.strip().splitlines()))
    check(all(f" on {DEV}:" in ln for ln in icp) and len(icp) == sum(
        expected[f"KITTI_{m}"] + (m == "test") for m in ("train", "val", "test")),
        f"preprocess kitti: GT refinements {icp}")
    log(f"path 6 KITTI GT refinements on the card (0.3 voxel, cap 50,000): steps {steps}, "
        f"seconds {icp_s}")

    got = {s: len(PairDataset(data, s)) for s in expected
           if not s.startswith("OpenGF")}
    got.update({s: len(OpenGFDataset(data, s.split("_")[1])) for s in expected
                if s.startswith("OpenGF")})
    check(got == expected, f"split sizes {got} != the generator's {expected}")
    gt_err = 0.0
    for mode in ("train", "val", "test"):
        ds = KittiOdometry(os.path.join(raw, "kitti_raw"), mode=mode, device=DEV)
        kept = [f for i, f in enumerate(ds.files) if not (mode == "test" and i == 1)]
        for i, pair in enumerate(kept):
            T = np.load(os.path.join(data, f"KITTI_{mode}", f"T{i}.npy"))
            gt_err = max(gt_err, float(np.abs(T - ds.odometry_gt(*pair)).max()))
    check(gt_err <= KITTI_GT_TOL, f"refined KITTI GT vs the generator's poses: {gt_err:.3g}")
    log(f"path 6 splits opened with PairDataset / OpenGFDataset, sizes equal the "
        f"generator's: {json.dumps(got)}; refined KITTI GT vs the generator's poses: max "
        f"|dT| {gt_err:.3e} (bar {KITTI_GT_TOL})")

    cache = {p: os.path.join(root, f"cache_{p}") for p in ("3dmatch", "kitti")}
    coll = run_parallel({p: pre("collate", "--root", data, "--out", c, "--protocol", p)
                         for p, c in cache.items()})
    for p, (stdout, _, wall) in coll.items():
        meta = json.loads(stdout.strip().splitlines()[-1])
        want = expected["3DMatch_test" if p == "3dmatch" else "KITTI_test"]
        check(meta["n_items"] == want, f"collate {p}: {meta} (want {want} items)")
        log(f"path 6 preprocess collate --protocol {p} ({wall:.2f} s wall, subprocess): {meta}")

    evals = {"3dmatch": ["--params", POINT_GEN, "--cache-dir", cache["3dmatch"]],
             "kitti": ["--params", KITTI_HINTFREE, "--center-mode", "none"],
             "opengf": ["--params", DEM_GEN]}
    reset_launch_counts()
    out = {}
    for proto, extra in evals.items():
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["evaluate", proto, "--root", data, *extra, "--device", DEV])
        out[proto] = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(all(math.isfinite(float(v)) for v in out[proto].values()),
              f"evaluate {proto} on the preprocessed split: {out[proto]}")
        log(f"path 6 evaluate {proto} {' '.join(extra)} on the preprocessed split "
            f"({time.perf_counter() - t1:.2f} s): {json.dumps(out[proto])}")
    counts = launch_counts()
    check(all(counts[k] > 0 for k in PATH5_KERNELS),
          f"path 6 evaluate: a kernel was not launched: {counts}")
    log(f"path 6 (b) took {time.perf_counter() - t0:.1f} s; evaluate launches "
        f"{json.dumps(counts)}")
    return counts, dict(ingest_expected_splits=expected, ingest_preprocess_s=walls,
                        ingest_kitti_gt_steps=steps, ingest_kitti_gt_s=icp_s,
                        ingest_kitti_gt_err=gt_err, ingest_evaluate=out)


def write_raw_kitti_pair(root):
    """Three KITTI frames of RAW_POINTS points in the reference layout
    (sequence 08 of ``root/dataset``), their sensors 6 m apart along x, each
    the same world points (those within 50 m of the first pair's midpoint)
    in its sensor's frame, so every point has its exact partner: D3Feat
    selection pairs frames 0 and 1. Frame 1's pose in the pose file is
    wrong by a rotation of RAW_POSE_ERR[0] deg and a shift of
    RAW_POSE_ERR[1] m. Returns the true pose of the pair (frame 0 -> frame
    1, velodyne frame) and the frames' sizes."""
    import numpy as np

    from scream_tpu_torch.data.raw import velo2cam_matrix

    rng = np.random.default_rng(1400)
    r = 50.0 * np.sqrt(rng.random(RAW_POINTS))
    phi = rng.uniform(0.0, 2.0 * np.pi, RAW_POINTS)
    world = np.empty((RAW_POINTS, 3), np.float32)
    world[:, 0] = 3.0 + r * np.cos(phi)
    world[:, 1] = r * np.sin(phi)
    world[:, 2] = np.where(rng.random(RAW_POINTS) < 0.7, rng.uniform(-2.0, -1.5, RAW_POINTS),
                           rng.uniform(-1.5, 6.0, RAW_POINTS))
    seq = os.path.join(root, "dataset", "sequences", "08", "velodyne")
    os.makedirs(seq)
    v2c_R = velo2cam_matrix().T[:3, :3]
    a = np.deg2rad(RAW_POSE_ERR[0])
    axis = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    wrong = np.eye(4)
    wrong[:3, :3] = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
    wrong[:3, 3] = RAW_POSE_ERR[1] * np.array([0.6, 0.0, -0.8])
    poses = []
    for t in range(3):
        pos = np.array([6.0 * t, 0.0, 0.0], np.float32)
        xyzr = np.concatenate([world - pos, np.zeros((RAW_POINTS, 1), np.float32)], axis=1)
        xyzr.astype(np.float32).tofile(os.path.join(seq, "%06d.bin" % t))
        T = np.eye(4)
        T[:3, 3] = v2c_R @ pos
        poses.append((T @ wrong if t == 1 else T)[:3].reshape(-1))
    os.makedirs(os.path.join(root, "dataset", "poses"))
    np.savetxt(os.path.join(root, "dataset", "poses", "08.txt"), np.asarray(poses))
    truth = np.eye(4)
    truth[:3, 3] = [-6.0, 0.0, 0.0]
    return truth


def phase_raw_kitti(root):
    """Path 6 (c): one KITTI pair at raw-frame size through
    ``KittiOdometry(..., gt_icp_voxel=None)``, the reference's refinement on
    the raw clouds: the bounded NN (``nn_bounded_single``) at 1 x 131,072
    against 131,072. The kernel against its plain version at the first ICP
    step (RAW_CHECK_ROWS src rows spread over the cloud against the full
    dst), timed as ICP calls it, with its live-tile share and bound; then
    the whole refinement: steps, wall, peak memory, launches, and the
    refined pose against the truth. Returns (launch counts, record,
    results)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from scream_tpu_torch.data.raw import KittiOdometry
    from scream_tpu_torch.geometry.icp import _prepare
    from scream_tpu_torch.ops import launch_counts, nn_cuda, reset_launch_counts

    t0 = time.perf_counter()
    truth = write_raw_kitti_pair(root)
    ds = KittiOdometry(root, mode="test", strict=False, gt_icp_voxel=None, device=DEV)
    check(ds.files == [(8, 0, 1)], f"raw KITTI pairs: {ds.files}")
    M = ds.odometry_gt(8, 0, 1)
    xyz0, xyz1 = ds._velodyne(8, 0), ds._velodyne(8, 1)

    # The first ICP step's view, built as refine_gt_icp and registration_icp
    # build it: the power-of-two padding with masks, src sorted along x.
    def pad(p):
        cap = 1 << max(len(p) - 1, 1).bit_length()
        out = torch.zeros((1, cap, 3), device=DEV)
        out[0, :len(p)] = torch.as_tensor(p, device=DEV)
        mask = torch.zeros((1, cap), dtype=torch.bool, device=DEV)
        mask[0, :len(p)] = True
        return out, mask

    (sp, sm), (tp, tm) = pad((xyz0 @ M[:3, :3].T + M[:3, 3]).astype(np.float32)), pad(xyz1)
    s_t, tgt, _, tmask = _prepare(sp, tp, torch.eye(4, device=DEV)[None], sm, tm)
    dst = nn_cuda.mask_far(tgt, tmask)
    n_cap = s_t.shape[1]
    thresh_sq = float(torch.tensor(RAW_THRESH, dtype=torch.float32) ** 2)
    boxes = nn_cuda.nn_tile_boxes(dst)
    d2, xyz = nn_cuda.nn_bounded_single(s_t, dst, thresh_sq, boxes=boxes)
    rows = torch.linspace(0, len(xyz0) - 1, RAW_CHECK_ROWS, device=DEV).long()
    sub = s_t[:, rows].contiguous()
    d2p, xyzp = nn_cuda.nn_bounded_plain(sub, dst, thresh_sq, None)
    torch.cuda.synchronize()
    d2k, xyzk = d2[:, rows], xyz[:, rows]
    within = d2p < thresh_sq
    abs_err = float((d2k - d2p)[within].abs().max())
    coords_equal = bool(torch.equal(xyzk[within], xyzp[within]))
    outside_ok = bool((d2k[~within] >= thresh_sq).all())
    check(abs_err <= 1e-6 and coords_equal and outside_ok and int(within.sum()) > 0,
          f"nn_bounded_single 1 x {n_cap} (raw KITTI): distance error {abs_err:.3g}, coords "
          f"equal {coords_equal}, outside ok {outside_ok}, {int(within.sum())} within")
    ms, ms_all = timed(lambda: nn_cuda.nn_bounded_single(s_t, dst, thresh_sq, boxes=boxes))
    pms, pms_all = timed(lambda: nn_cuda.nn_bounded_plain(sub, dst, thresh_sq, None), reps=3)
    per_slab, tiles = live_tiles(s_t, dst, thresh_sq)
    live, total = int(per_slab.sum()), per_slab.numel() * tiles
    b_ms, b_by = bound(n_cap * 12 * 2 + n_cap * 16,
                       [(NN_INSTR_PER_PAIR * live * 128 * 256
                         + NN_INSTR_PER_ROW * live * 256, INSTR_FP32)])
    del d2, xyz, d2p, xyzp, s_t, tgt, dst, boxes, sp, tp

    # The refinement through the dataset, as `preprocess kitti` runs it.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    err = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        item = ds[0]
    wall = time.perf_counter() - t1
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    line = [ln for ln in err.getvalue().splitlines() if ln.startswith("[refine_gt_icp]")][0]
    steps = int(line.split(" ICP steps")[0].split()[-1])
    # The refined GT is M @ reg, as the reference composes it (reference
    # datasets/kitti.py:119), where reg aligns the M-moved frame 0 onto
    # frame 1: ICP's truth is truth @ inv(M), and M @ reg leaves the truth
    # by about the pose file's rotation error times the 6 m baseline.
    refined = np.load(os.path.join(ds.icp_path, "8_0_1.npy"))
    reg = np.linalg.inv(M) @ refined
    reg_truth = truth @ np.linalg.inv(M)

    def pose_err(A, B):
        """(deg, m) between two poses; the angle from the skew part of the
        relative rotation, blind to fp32 rounding of the entries."""
        R = A[:3, :3] @ B[:3, :3].T
        w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
        return (float(np.degrees(np.arcsin(min(np.linalg.norm(w), 1.0)))),
                float(np.linalg.norm(A[:3, 3] - B[:3, 3])))

    (re0, te0), (re1, te1) = pose_err(np.eye(4), reg_truth), pose_err(reg, reg_truth)
    re_gt, te_gt = pose_err(refined, truth)
    check(np.allclose(refined[:3], np.concatenate([item["rot"], item["trans"]], 1), atol=1e-6)
          and re1 <= RAW_RE_TOL and te1 <= RAW_TE_TOL and re0 > 5 * RAW_RE_TOL
          and te0 > 5 * RAW_TE_TOL,
          f"raw KITTI refinement: ICP from RE {re0:.4f} deg TE {te0:.4f} m to RE {re1:.5f} "
          f"deg TE {te1:.5f} m from its truth (bars {RAW_RE_TOL} deg, {RAW_TE_TOL} m)")
    check(counts["nn_bounded_single"] > 0 and counts["nn_tile_boxes"] == 1,
          f"raw KITTI refinement launches: {counts}")
    log(f"kernel nn_bounded_single 1 x {n_cap} (raw KITTI, {len(xyz0)} x {len(xyz1)} points, "
        f"{nn_cuda.bounded_splits(1, n_cap, n_cap)} splits): max_abs_err {abs_err:.3e} on "
        f"{RAW_CHECK_ROWS} rows, {int(within.sum())} within the threshold; timing rounds "
        f"{', '.join(f'{t:.4f}' for t in ms_all)} ms (boxes given); plain on the "
        f"{RAW_CHECK_ROWS}-row slice {', '.join(f'{t:.4f}' for t in pms_all)} ms; bound "
        f"{b_ms:.4f} ms ({b_by}); live tile share {live / total:.5f} ({live} of {total}); "
        f"live tiles per sub-slab: median {int(per_slab.median())}, max {int(per_slab.max())} "
        f"(sub-slab {int(per_slab.argmax())} of {per_slab.numel()}), every block box-tests "
        f"all {tiles}")
    log(f"path 6 raw KITTI refinement (frames of {RAW_POINTS} points, gt_icp_voxel=None): "
        f"{line} | "
        f"wall {wall:.3f} s through KittiOdometry, peak memory {peak:.2f} GiB | ICP from RE "
        f"{re0:.4f} deg TE {te0:.4f} m to RE {re1:.6f} deg TE {te1:.6f} m from its truth; "
        f"the refined GT (M @ reg) RE {re_gt:.6f} deg TE {te_gt:.6f} m from the pair's | "
        f"launches {json.dumps(counts)}, nn_bounded_single device launches "
        f"{nn_cuda.nn_bounded_single.device_launches}")
    rec = dict(name="nn_bounded_single_kitti_raw", err=0.0, max_abs_err=abs_err, ms=ms,
               plain_ms=pms, bound_ms=b_ms, bound_by=b_by, bar="exact within threshold",
               route="cuda", source="scream_tpu_torch/csrc/nn.cu",
               replaces="scream_tpu/ops/nn_pallas.py:162", live_share=live / total)
    log(f"path 6 (c) took {time.perf_counter() - t0:.1f} s")
    return counts, rec, dict(raw_kitti_steps=steps, raw_kitti_refine_s=wall,
                             raw_kitti_peak_gib=peak, raw_kitti_icp_re_deg=re1,
                             raw_kitti_icp_te_m=te1, raw_kitti_gt_re_deg=re_gt,
                             raw_kitti_gt_te_m=te_gt)


def path6():
    """Path 6: ingestion on the card. Returns (launch counts of the raw
    refinement, launch counts of the evaluations, kernel record, results)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_ingest_", dir="build")
    try:
        phase_ingest_build()
        eval_counts, results = phase_ingest_cli(os.path.join(root, "cli"))
        raw_counts, rec, raw = phase_raw_kitti(os.path.join(root, "raw_kitti"))
        results.update(raw)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log_records([rec])
    log(f"path 6 took {time.perf_counter() - t0:.1f} s")
    return raw_counts, eval_counts, rec, results


def reference_module():
    """``scripts/torch_port_make_fp32_reference.py`` as a module: its input
    maker and file path (it imports JAX only inside its writer)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_port_make_fp32_reference",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), REFERENCE_SCRIPT))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_kernels_f32(model, batch, hf):
    """The fp32 kernels against their plain versions on the card: stats and
    apply on ``model``'s first block (the trained point-generator in fp32)
    at path 1's 16 x 4,096 with its mask, cut to 8 x 4,000 (ragged), and on
    the hint-free checkpoint's at the serving shape 8 x 512 (448 valid rows);
    the fused block against the literal plain block at each; the tail at
    d 384 on the first DSM stem block's real input of a seeded random-init
    DEMTransformer (8 x 4,096, and 16 x 4,096 cut to 65,536 - 37 rows), and
    at d 256 through ``ModelConfig(dtype="float32", fused_attention=False)``
    on ``model``'s weights and path 1's batch, whose forward must run the
    tail kernel in all 24 blocks and the fused kernels in none; the tail's
    three products as fp32 ``torch.matmul`` (a reference line)."""
    import dataclasses

    import torch

    from scream_tpu_torch.config import ModelConfig
    from scream_tpu_torch.models import DEMTransformer, PointTransformer
    from scream_tpu_torch.ops import launch_counts, reset_launch_counts
    from scream_tpu_torch.pipeline.register import gt_center_hint, to_device

    f32 = torch.float32
    tb = to_device(batch, DEV)
    m_bool = tb["tgt_mask"]
    blk = model.trunk.stem_0
    records = check_attention(blk, m_bool, suffix="_f32", dtype=f32)
    records += check_attention(blk, m_bool[:8, :RAGGED_L].contiguous(),
                               suffix="_f32_L4000", dtype=f32)
    m_serve = torch.zeros((SERVE_BATCH, 512), dtype=torch.bool, device=DEV)
    m_serve[:, :GT_FREE_POINTS] = True
    records += check_attention(hf.trunk.stem_0, m_serve, suffix="_f32_d128", dtype=f32)

    model_cfg, _ = dem_config()
    dem = DEMTransformer(dataclasses.replace(model_cfg, d_model=F32_TAIL_D, dtype="float32"),
                         device=DEV, generator=torch.Generator().manual_seed(0))
    db = to_device(dem_batch(make_dem_items(1, seed=1300, batch=F32_TAIL_B,
                                            points=F32_TAIL_CAP)[0],
                             cap=F32_TAIL_CAP, coarse=F32_TAIL_CAP // 8), DEV)
    args = (db["dsm"], db["dem_coarse"], db["dsm_mask"], db["dem_coarse_mask"])
    x, q, m = tail_inputs(dem, dem.trunk.stem_src_0, args)
    d = x.shape[-1]
    records.append(check_tail(dem.trunk.stem_src_0, x[:8].contiguous(), q[:8].contiguous(),
                              m[:8], suffix="_f32", dtype=f32))
    records.append(check_tail(dem.trunk.stem_src_0, x.reshape(-1, d)[:F32_TAIL_RAGGED],
                              q.reshape(-1, d)[:F32_TAIL_RAGGED],
                              m.reshape(-1)[:F32_TAIL_RAGGED],
                              suffix=f"_f32_r{F32_TAIL_RAGGED}", dtype=f32))
    refs = [tail_matmul_reference(dem.trunk.stem_src_0, x[:8])]
    del dem, x, q

    unfused = PointTransformer(ModelConfig(dtype="float32", fused_attention=False),
                               device=DEV)
    unfused.load_state_dict(model.state_dict())
    pargs = (tb["src"], tb["tgt"], tb["src_mask"], tb["tgt_mask"],
             gt_center_hint(tb["rot"], tb["trans"]))
    reset_launch_counts()
    with torch.no_grad():
        unfused(*pargs)
    counts = launch_counts()
    check(counts["block_tail"] == 24 and counts["attn_apply"] == 0,
          f"ModelConfig(dtype='float32', fused_attention=False) at d 256: launches "
          f"{counts}, expected 24 tail kernels and no fused block")
    x, q, m = tail_inputs(unfused, unfused.trunk.stem_0, pargs)
    records.append(check_tail(unfused.trunk.stem_0, x, q, m, suffix="_f32_d256", dtype=f32))
    refs.append(tail_matmul_reference(unfused.trunk.stem_0, x))
    log(f"path 7 fused_attention=False at d 256, fp32 ({B} x {CAP}): one forward launched "
        f"{counts['block_tail']} tail kernels, {counts['attn_apply']} fused blocks")
    log("reference (not library_ms): the tail's three products as fp32 torch.matmul: "
        + ", ".join(refs))
    log_records(records)
    return records


def tail_matmul_reference(block, x):
    """The tail's three products (x @ Wm, y @ W1, h @ W2) as fp32
    ``torch.matmul`` on the block's weights: the time of that one line."""
    import torch

    x2 = x.reshape(-1, x.shape[-1]).float()
    Wm, W1, W2 = (w.detach().float() for w in (block.merge.kernel, block.ffn_in.kernel,
                                                block.ffn_out.kernel))
    h = torch.relu(x2 @ W1)
    ms = cuda_ms(lambda: (x2 @ Wm, x2 @ W1, h @ W2))
    return f"d {x2.shape[1]}, {x2.shape[0]} rows {ms:.4f} ms"


def phase_reference_f32(models):
    """The fp32 forwards on the card against the JAX package's (the file
    of ``REFERENCE_SCRIPT``, made on the CPU) and against the port's CPU
    path, both within ``FP32_BARS["forward"]`` of the largest value;
    ``models`` maps the file's keys to (card model, CPU model)."""
    import numpy as np
    import torch

    mod = reference_module()
    bar = FP32_BARS["forward"]
    with np.load(mod.OUT) as f:
        ref = {k: f[k] for k in f.files}
    for key, (card, cpu) in models.items():
        inputs = mod.reference_inputs(key, int(ref["seed"]))
        with torch.no_grad():
            got = card(*(torch.as_tensor(a, device=DEV) for a in inputs))
            on_cpu = cpu(*map(torch.as_tensor, inputs))
        torch.cuda.synchronize()
        want = torch.as_tensor(ref[key], device=DEV)
        e_jax = rel_err(got, want)
        e_cpu = rel_err(got, on_cpu.to(DEV))
        check(got.dtype == torch.float32 and e_jax <= bar and e_cpu <= bar,
              f"path 7 {key} fp32 forward on the card: {e_jax:.3g} from the JAX package's, "
              f"{e_cpu:.3g} from the CPU path's (bar {bar})")
        log(f"path 7 {key} fp32 forward ({tuple(got.shape)}, seed {int(ref['seed'])}): card "
            f"vs the JAX package's (CPU, {REFERENCE_SCRIPT}) rel_err {e_jax:.3e}, vs the "
            f"port's CPU path {e_cpu:.3e} (bar {bar})")


def phase_eval_f32(model, model_cpu, model_bf16):
    """On path 5's split tree: the 1,024 bucket of 3DMatch pair by pair on
    the card and the CPU path in fp32 (path 5's bars), then ``evaluate
    3dmatch --bucketed --dtype float32`` in a subprocess: its JSON finite,
    equal to the in-process fp32 dict, and the bf16 run's pair count."""
    import shutil
    import tempfile

    from scream_tpu_torch.cli import _buckets_for
    from scream_tpu_torch.config import eval_preset
    from scream_tpu_torch.data import BucketedPairLoader, PairDataset
    from scream_tpu_torch.eval import evaluate_registration

    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_f32_splits_", dir="build")
    try:
        write_split_tree(root)
        ds = PairDataset(root, "3DMatch_test", normalize="unit_sphere", with_info=True,
                         max_points=CAP)
        buckets = _buckets_for(CAP, smallest=1024)
        loader = lambda: BucketedPairLoader(ds, EVAL_BATCH, buckets)
        check_bucket(model, model_cpu, loader(), buckets[0], "path 7")
        t0 = time.perf_counter()
        got = evaluate_registration(model, loader(), eval_preset("3dmatch"), device=DEV)
        t_f32 = time.perf_counter() - t0
        bf = evaluate_registration(model_bf16, loader(), eval_preset("3dmatch"), device=DEV)
        root_repo, env = repo_env()
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "scream_tpu_torch", "evaluate",
                               "3dmatch", "--root", root, "--params", POINT_GEN,
                               "--bucketed", "--dtype", "float32", "--device", DEV],
                              capture_output=True, text=True, timeout=300, cwd=root_repo,
                              env=env)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(proc.returncode == 0, f"evaluate --dtype float32 exit {proc.returncode}:\n"
          f"{proc.stderr[-3000:]}")
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    check(all(math.isfinite(v) for v in cli.values()) and cli == got
          and cli["n_pairs"] == bf["n_pairs"],
          f"evaluate --dtype float32: CLI {cli}, in-process {got}, bf16 pairs "
          f"{bf['n_pairs']}")
    log(f"path 7 cli: python -m scream_tpu_torch evaluate 3dmatch --params {POINT_GEN} "
        f"--bucketed --dtype float32 ({wall:.1f} s wall, subprocess): JSON finite, equal to "
        f"the in-process fp32 dict ({t_f32:.2f} s), {cli['n_pairs']} pairs as the bf16 run | "
        f"fp32 {json.dumps(got)} | bf16 {json.dumps(bf)}")
    return got


def phase_train_cli_f32():
    """``train opengf --d-model 384 --dtype float32`` in a subprocess, one
    epoch (``--epochs 2``: the reference's exclusive bound) of two steps of
    16 of the 32 synthetic patches at capacity 2,048, and a validation: the
    only CLI route to the fp32 tail kernel (every block at d 384). Finite
    losses; returns the launch counts of the CLI's run."""
    import shutil

    ck = os.path.join(WORK_DIR, "cli_opengf_f32")
    shutil.rmtree(ck, ignore_errors=True)
    final, (_, counts), wall = run_cli(
        ["train", "opengf", "--d-model", str(F32_TAIL_D), "--dtype", "float32", "--epochs",
         "2", "--batch-size", str(F32_CLI_BATCH), "--max-points", str(F32_CLI_CAP),
         "--checkpoint-dir", ck, "--device", DEV], "train opengf --dtype float32",
        counted=True)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    check(counts["block_tail"] > 0 and counts["attn_apply"] == 0,
          f"train opengf --d-model {F32_TAIL_D} --dtype float32: launches {counts}")
    log(f"path 7 cli: train opengf --d-model {F32_TAIL_D} --dtype float32 --epochs 2 "
        f"--batch-size {F32_CLI_BATCH} --max-points {F32_CLI_CAP} ({wall:.1f} s, "
        f"subprocess): final_val {json.dumps(final)} | launches {json.dumps(counts)}")
    return counts


def path7(smi, path1_re=None):
    """Path 7: the float32 configuration on the card (the shipped weights
    loaded with ``dtype="float32"``). Returns (records, launch counts of
    its main runs, results)."""
    import torch

    t0 = time.perf_counter()
    log(f"path 7 (float32) on {smi}")
    model, _ = load_weights(POINT_GEN, DEV, dtype="float32")
    model_cpu, _ = load_weights(POINT_GEN, "cpu", dtype="float32")
    hf, normalize = load_hintfree(DEV, dtype="float32")
    hf_cpu, _ = load_hintfree("cpu", dtype="float32")
    # Path 1's batches (per-item seeds: the same pairs), so the median RE
    # compares with path 1's bf16 figure pair for pair.
    batches = make_batches(TIMED_BATCHES + 2, seed=0)
    records = phase_kernels_f32(model, batches[-1], hf)
    phase_reference_f32({"point_generator": (model, model_cpu),
                         "point_generator_hintfree": (hf, hf_cpu)})
    pps, counts, re = run_path(model, batches[:TIMED_BATCHES + 1], None,
                               label="trained point-generator, float32")
    log(f"path 7 register_batch fp32 ({B} x {CAP}, {ICP_ITERS} ICP iterations): "
        f"{pps:.2f} pairs/s, median RE {re:.4f} deg | path 1 (bf16) median RE "
        + (f"{path1_re:.4f} deg" if path1_re is not None else "not run") + f" | {smi}")
    model_bf16, _ = load_weights(POINT_GEN, DEV)
    evaluation = phase_eval_f32(model, model_cpu, model_bf16)
    del model_bf16, model_cpu
    pairs = make_gt_free_pairs(GT_FREE_PAIRS, GT_FREE_POINTS, GT_FREE_SEED)
    serve_counts = phase_gt_free(hf, hf_cpu, normalize, pairs, label="path 7")
    phase_cli(hf, normalize, pairs[1], dtype="float32")
    cli_counts = phase_train_cli_f32()
    del model, hf
    torch.cuda.empty_cache()
    log(f"path 7 took {time.perf_counter() - t0:.1f} s")
    return records, {"main": counts, "serving": serve_counts, "train_cli": cli_counts}, dict(
        pairs_per_s_f32=pps, median_re_deg_f32=re, eval_3dmatch_f32=evaluation,
        launches_f32=counts, launches_gt_free_serving_f32=serve_counts,
        launches_train_cli_f32=cli_counts)


def cell_suffix(d, heads, dtype):
    """The suffix of a cell's kernel records: ``_d{d}_h{heads}[_f32]``."""
    return f"_d{d}_h{heads}" + ("_f32" if dtype == "float32" else "")


def attention_cells(new_only):
    """Every (d, heads, dtype) cell the attention kernels take, or only
    those beyond d 128 / 256 with 8 heads and bf16 d 384 with 8 (which
    paths 1-3, 7 and path 8's DEM phase check on real inputs)."""
    return [(d, h, dt) for dt, widths in CELL_HEADS.items() for d, heads in widths.items()
            for h in heads
            if not new_only or not (h == 8 and (d < 384 or dt == "bfloat16"))]


def phase_attention_cells(cells):
    """Kernels 1 and 2 against their plain versions at each (d, heads,
    dtype) of ``cells`` (check_attention, under that dtype's bars), on a
    seeded random-init block and input at the cell's shape, the first
    batch's last 37 rows masked; then the kernels' launches in one forward
    of a ``ModelConfig(d_model=d, num_heads=heads)`` PointTransformer (1 + 1
    layers) at 2 x 1,024 points, the model route a user reaches the cell
    by. Returns (records, launches by record name)."""
    import torch

    from scream_tpu_torch.config import ModelConfig
    from scream_tpu_torch.models import AttentionBlock, PointTransformer
    from scream_tpu_torch.ops import launch_counts, reset_launch_counts

    records, launches = [], {}
    g = torch.Generator(device=DEV).manual_seed(21)
    for d, heads, dt in cells:
        cd = getattr(torch, dt)
        blk = AttentionBlock(d, heads, 4, dtype=cd,
                             generator=torch.Generator().manual_seed(d + heads)).to(DEV)
        Bc, L = CELL_SHAPES[d]
        m = torch.ones((Bc, L), dtype=torch.bool, device=DEV)
        m[0, L - 37:] = False
        x = torch.randn((Bc, L, d), generator=g, device=DEV)
        suffix = cell_suffix(d, heads, dt)
        records += check_attention(blk, m, suffix=suffix, x=x, dtype=cd)
        model = PointTransformer(ModelConfig(d_model=d, num_heads=heads, self_layers=1,
                                             cross_layers=1, dtype=dt), device=DEV,
                                 generator=torch.Generator().manual_seed(heads))
        pts = lambda: torch.rand((CELL_FORWARD_B, CELL_FORWARD_N, 3), generator=g,
                                 device=DEV) * 2 - 1
        mask = torch.ones((CELL_FORWARD_B, CELL_FORWARD_N), dtype=torch.bool, device=DEV)
        reset_launch_counts()
        with torch.no_grad():
            out = model(pts(), pts(), mask, mask)
        counts = launch_counts()
        check(counts["attn_stats"] > 0 and counts["attn_apply"] > 0
              and bool(torch.isfinite(out.float()).all()),
              f"ModelConfig(d_model={d}, num_heads={heads}, dtype={dt}) forward: launches "
              f"{counts}")
        for k in ("attn_stats", "attn_apply"):
            launches[k + suffix] = counts[k]
        log(f"cell d {d}, {heads} heads of {d // heads}, {dt}: one ModelConfig(d_model={d}, "
            f"num_heads={heads}) forward ({CELL_FORWARD_B} x {CELL_FORWARD_N}, 1 + 1 layers) "
            f"launched stats {counts['attn_stats']}, apply {counts['attn_apply']}")
        del blk, model
    log_records(records)
    return records, launches


def check_block_grads(blk, x, m_bool, suffix):
    """The fused block's gradients (``_FusedBlock``, whose backward
    recomputes the plain block) against the literal plain block's, with
    respect to the input and the ten weights, the same upstream gradient:
    each within 3e-2 of its largest (path 4's tail bar)."""
    import torch

    from scream_tpu_torch.ops import attn_cuda

    bf, f32 = torch.bfloat16, torch.float32
    ws = [w.detach() for w in (blk.q_proj.kernel, blk.k_proj.kernel, blk.v_proj.kernel,
                               blk.merge.kernel, blk.norm1.scale, blk.norm1.bias,
                               blk.ffn_in.kernel, blk.ffn_out.kernel, blk.norm2.scale,
                               blk.norm2.bias)]
    H = blk.num_heads
    fused = lambda xx, *w: attn_cuda.attention_block_fused(
        xx, xx, m_bool, m_bool, *w, num_heads=H, dtype=bf, norm_dtype=f32)
    plain = lambda xx, *w: attn_cuda.block_plain(
        xx, xx, m_bool, m_bool, *w, num_heads=H, cd=bf, nd=f32, attn_eps=1e-6, ln_eps=1e-5)
    g = torch.Generator(device=DEV).manual_seed(8)
    up = (torch.randn(x.shape, generator=g, device=DEV) * m_bool[..., None]).to(bf)
    grads = []
    for fn in (fused, plain):
        ins = [t.clone().requires_grad_(True) for t in (x.to(bf), *ws)]
        grads.append(torch.autograd.grad(fn(*ins), ins, up))
    torch.cuda.synchronize()
    g_err = max(rel_err(a, b) for a, b in zip(*grads))
    check(g_err <= 3e-2 and all(bool(torch.isfinite(a.float()).all()) for a in grads[0]),
          f"fused block{suffix} gradients: relative error {g_err:.3g} (bar 3e-2)")
    log(f"fused block{suffix} gradients (input and ten weights) vs the plain block's: rel_err "
        f"{g_err:.3e} (bar 3e-2)")


def phase_kernels_d384(model, batch):
    """Kernels 1 and 2 at d 384 (8 heads of 48) on the first DSM stem block's
    real input of ``model`` (8 x 8,192), and on that input as one sequence
    of 65,536 - 37 rows; the fused block against the literal plain block
    and its gradients against the plain block's."""
    from scream_tpu_torch.pipeline.register import to_device

    tb = to_device(batch, DEV)
    args = (tb["dsm"], tb["dem_coarse"], tb["dsm_mask"], tb["dem_coarse_mask"])
    blk = model.trunk.stem_src_0
    q, m = block_input(model, blk, args)
    records = check_attention(blk, m, suffix="_d384", x=q)
    d = q.shape[-1]
    records += check_attention(blk, m.reshape(1, -1)[:, :D384_RAGGED].contiguous(),
                               suffix=f"_d384_r{D384_RAGGED}",
                               x=q.reshape(1, -1, d)[:, :D384_RAGGED].contiguous())
    check_block_grads(blk, q, m, "_d384")
    log_records(records)
    return records


def cli_launches(stderr, label):
    """The launch counts ``CLI_COUNTED`` printed on stderr."""
    lines = [ln for ln in stderr.splitlines() if ln.startswith("# launches ")]
    check(bool(lines), f"{label}: no launch counts on stderr")
    return json.loads(lines[-1][len("# launches "):])


def phase_cli_d384():
    """The CLI at d 384 in bf16 (the default dtype), in subprocesses:
    ``train opengf --d-model 384`` (one epoch of two steps of 16 patches at
    capacity 2,048) and ``train 3dmatch --d-model 384`` (two steps of 8
    synthetic pairs) at once; then, on the 3DMatch checkpoint that train
    wrote (``<checkpoint-dir>/best``) and path 5's split tree, ``evaluate
    3dmatch --bucketed --d-model 384 --params`` and ``register --d-model 384
    --params`` at once. Each finite, each with stats and apply launches > 0.
    Returns the launch counts by command."""
    import shutil
    import tempfile

    import numpy as np

    ck_o, ck_3 = (os.path.join(WORK_DIR, f"cli_d384_{k}") for k in ("opengf", "3dmatch"))
    for ck in (ck_o, ck_3):
        shutil.rmtree(ck, ignore_errors=True)
    d = ["--d-model", str(D384), "--device", DEV]
    runs = {
        "train opengf": ["-c", CLI_COUNTED, "train", "opengf", *d, "--epochs", "2",
                         "--batch-size", str(F32_CLI_BATCH), "--max-points", str(F32_CLI_CAP),
                         "--checkpoint-dir", ck_o],
        "train 3dmatch": ["-c", CLI_COUNTED, "train", "3dmatch", *d, "--epochs", "2",
                          "--synthetic-pairs", "16", "--checkpoint-dir", ck_3]}
    out = run_parallel(runs, timeout=400)
    best = os.path.join(ck_3, "best")
    root = tempfile.mkdtemp(prefix="chip_smoke_d384_splits_", dir="build")
    try:
        write_split_tree(root)
        rng = np.random.default_rng(1500)
        pair = {k: os.path.join(root, f"{k}.npy") for k in ("src", "tgt")}
        for k, path in pair.items():
            np.save(path, rng.uniform(-1, 1, (2048, 3)).astype(np.float32))
        out.update(run_parallel({
            "evaluate 3dmatch": ["-c", CLI_COUNTED, "evaluate", "3dmatch", "--root", root,
                                 "--params", best, "--bucketed", *d],
            "register": ["-c", CLI_COUNTED, "register", "--src", pair["src"], "--tgt",
                         pair["tgt"], "--params", best, *d]}, timeout=400))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    counts = {}
    for label, (stdout, stderr, wall) in out.items():
        res = json.loads(stdout.strip().splitlines()[-1])
        vals = res.get("final_val", res)
        flat = [v for v in vals.values() if isinstance(v, (int, float))]
        if label == "register":
            flat = [v for row in res["transform"] for v in row] + [res["fitness"]]
        counts[label] = cli_launches(stderr, label)
        check(bool(flat) and all(math.isfinite(v) for v in flat)
              and counts[label]["attn_stats"] > 0 and counts[label]["attn_apply"] > 0
              and (label != "evaluate 3dmatch" or res["n_pairs"] == EVAL_PAIRS),
              f"{label} --d-model {D384}: {res}, launches {counts[label]}")
        log(f"path 8 cli: {label} --d-model {D384} ({wall:.1f} s, subprocess): "
            f"{json.dumps(vals if label != 'register' else {'fitness': res['fitness']})} | "
            f"launches {json.dumps(counts[label])}")
    return counts


def path8(smi):
    """Path 8: bf16 at d 384 (8 heads of 48) and the other head counts.
    Returns (records, launches by record name, results)."""
    import dataclasses

    import torch

    from scream_tpu_torch.train import DEMTrainer

    t0 = time.perf_counter()
    log(f"path 8 (bf16 d {D384}, other head counts) on {smi}")
    model_cfg, train_cfg = dem_config(D384)
    groups = make_dem_items(DEM_ITERS + 2, seed=1400)
    small = dem_batch(make_dem_items(1, seed=1000, batch=2, points=1024)[0], cap=1024,
                      coarse=128)
    trainer = DEMTrainer(dem_loader(groups[1:1 + DEM_ITERS]),
                         dem_loader(make_dem_items(2, seed=900)), model_cfg=model_cfg,
                         train_cfg=dataclasses.replace(train_cfg, log_every=1), device=DEV)
    trainer.init(seed=0)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f"path 8 model: opengf_presets() at d {D384}, {model_cfg.num_heads} heads of "
        f"{D384 // model_cfg.num_heads}, {model_cfg.self_layers} + {model_cfg.cross_layers} "
        f"layers, {model_cfg.dtype}, {n_params:,} parameters")
    records = phase_kernels_d384(trainer.model, dem_batch(groups[-1]))
    init_state = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    phase_dem_card_vs_cpu(init_state, small, d=D384, label="path 8")
    counts, results = phase_dem_training(trainer, groups[:-1], label="path 8",
                                         kernels=("attn_stats", "attn_apply"))
    del trainer
    torch.cuda.empty_cache()
    cell_records, launches = phase_attention_cells(attention_cells(new_only=True))
    launches.update(attn_stats_d384=counts["attn_stats"], attn_apply_d384=counts["attn_apply"])
    cli_counts = phase_cli_d384()
    log(f"path 8 took {time.perf_counter() - t0:.1f} s")
    return records + cell_records, launches, {
        "d384_train_patches_per_s": results["dem_train_patches_per_s"],
        "d384_train_stage_ms": results["dem_train_stage_ms"],
        "d384_train_launches_per_iteration": results["dem_train_launches_per_iteration"],
        "d384_cli_launches": cli_counts}


def phase_tail_widths():
    """``--only tail``: the tail kernel against its plain version at every
    width it takes (check_tail: the pack bit for bit, forward, gradients),
    bf16 at d 128, 256, 384 and 512 on the rows of TAIL_ROWS and fp32 at
    d 128, 256 and 384, on seeded random-init blocks and inputs (one row in
    ten masked)."""
    import torch

    from scream_tpu_torch.models import AttentionBlock
    from scream_tpu_torch.ops import tail_cuda

    g = torch.Generator(device=DEV).manual_seed(31)
    records = []
    for cd, rows_of in ((torch.bfloat16, TAIL_ROWS),
                        (torch.float32, {d: (4096,) for d in tail_cuda.KERNEL_WIDTHS_F32})):
        for d, all_rows in rows_of.items():
            blk = AttentionBlock(d, 8, 4, dtype=cd,
                                 generator=torch.Generator().manual_seed(d)).to(DEV)
            for R in all_rows:
                x, q = (torch.randn((R, d), generator=g, device=DEV) for _ in range(2))
                m = torch.rand((R,), generator=g, device=DEV) > 0.1
                records.append(check_tail(blk, x, q, m, suffix=f"_d{d}_r{R}"
                                          + ("_f32" if cd == torch.float32 else ""), dtype=cd))
    log_records(records)


def phase_apply_cells():
    """``--only apply``: stats and apply at path 1's shape on the trained
    point-generator's first block (apply gated at 0.50 ms, stats at 0.25),
    then at every (d, heads, dtype) cell of the kernels
    (:func:`phase_attention_cells`)."""
    from scream_tpu_torch.pipeline.register import to_device

    model, _ = load_weights(POINT_GEN, DEV)
    batch = make_batches(2 * (TIMED_BATCHES + 1) + 1, seed=0)[-1]
    log_records(check_attention(model.trunk.stem_0, to_device(batch, DEV)["tgt_mask"]))
    del model
    phase_attention_cells(attention_cells(new_only=False))


def make_scans():
    """MW_SCANS seeded views of one ``make_scene`` scene, each MW_POINTS
    points (a 70 % subset of the scene), each in its own frame; consecutive
    views at most MW_STEP_DEG and MW_STEP_T apart. Returns (scans, the
    (N, 4, 4) true scan -> world poses)."""
    import numpy as np

    from scream_tpu_torch.data import make_scene
    from scream_tpu_torch.data.transforms import rodrigues, uniform_2_sphere

    rng = np.random.default_rng(MW_SEED)
    n_scene = round(MW_POINTS / 0.7)
    scene = make_scene(rng, n_scene)
    T = [np.eye(4)]
    for _ in range(MW_SCANS - 1):
        D = np.eye(4)
        D[:3, :3] = rodrigues(uniform_2_sphere(rng) * np.deg2rad(rng.uniform(0, MW_STEP_DEG)))
        D[:3, 3] = uniform_2_sphere(rng) * rng.uniform(0, MW_STEP_T)
        T.append(T[-1] @ D)
    scans = []
    for Tk in T:
        inv = np.linalg.inv(Tk)
        pts = scene[rng.choice(n_scene, MW_POINTS, replace=False)]
        scans.append((pts @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32))
    return scans, np.stack(T).astype(np.float32)


def pose_errors(P, T):
    """(max rotation error in degrees, max translation error) of the poses
    ``P`` against ``T``."""
    import numpy as np

    tr = np.einsum("nij,nij->n", P[:, :3, :3], T[:, :3, :3])
    rot = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    return float(rot.max()), float(np.linalg.norm(P[:, :3, 3] - T[:, :3, 3], axis=-1).max())


def multiscale_batches():
    """The first batch of each bucket (256 .. 4,096 points) of ``train
    3dmatch --multi-scale``'s training loader (synthetic pairs, 8 a bucket
    and overlap tier), as the CLI builds it."""
    from scream_tpu_torch import cli

    _, train_cfg, data_cfg, _ = cli.TASKS["3dmatch"]()
    train, _ = cli._registration_loaders("3dmatch", data_cfg, train_cfg,
                                         os.path.join(WORK9, "no-data"),
                                         synthetic_len=train_cfg.batch_size, multi_scale=True)
    found = {}
    for batch in train:
        found.setdefault(batch["src"].shape[1], batch)
    check(sorted(found) == [256, 512, 1024, 2048, 4096], f"multi-scale buckets {sorted(found)}")
    return found


def ms_init_state():
    """The 3DMatch preset's generator from a seeded init (on the CPU)."""
    import torch

    from scream_tpu_torch.config import ModelConfig
    from scream_tpu_torch.models import PointTransformer

    model = PointTransformer(ModelConfig(), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def ms_step(device, init_state, batch):
    """One generator step (GAN off) of the 3DMatch preset from ``init_state``
    on ``batch``: (point_loss, gradient norm)."""
    import torch

    from scream_tpu_torch.config import ModelConfig, RenderConfig, TrainConfig
    from scream_tpu_torch.models import PointTransformer
    from scream_tpu_torch.pipeline.register import to_device
    from scream_tpu_torch.train import (generator_optimizer, init_train_state,
                                        make_registration_train_step)

    model = PointTransformer(ModelConfig(), device=device)
    model.load_state_dict(init_state)
    opt, sched = generator_optimizer(model.parameters(), TrainConfig(), steps_per_epoch=1000)
    step = make_registration_train_step(model, use_gan=False, render_cfg=RenderConfig())
    _, metrics, _ = step(init_train_state(opt, sched), to_device(batch, device))
    gnorm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in model.parameters()))
    return float(metrics["point_loss"]), float(gnorm)


def ms_cpu_batch(batch, bucket):
    """What the CPU path's step takes of a bucket's batch: all of it at 256
    points, its first MS_CPU_PAIRS pairs at 4,096."""
    if bucket == max(MS_BUCKETS):
        return {k: v[:MS_CPU_PAIRS] for k, v in batch.items()}
    return batch


def measure_argv(starts, max_deg, pairs=None, device=None):
    """The measurement script's arguments: the robust path (passes 0)."""
    return ["--pairs", str(pairs or MEASURE_PAIRS), "--points", str(MEASURE_POINTS),
            "--passes", "0", "--starts", starts, "--max-angle-deg", str(max_deg),
            "--device", device or DEV]


def load_measure_script():
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_port_measure_gt_free",
                                                  MEASURE_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def path9_cpu_refs():
    """The CPU path's side of path 9's comparisons: the bucketed steps at 256
    and 4,096 points, the first dispatch of EDGE_CPU_DISPATCH edges of the
    multiway scans, and the robust ico60 path on the first ROBUST_CPU_PAIRS
    measurement pairs. Returns (arrays, seconds by part)."""
    import numpy as np

    from scream_tpu_torch.pipeline import default_edges, register_pairs

    res, secs = {}, {}
    t0 = time.perf_counter()
    batches, init = multiscale_batches(), ms_init_state()
    for b in MS_BUCKETS:
        res[f"ms_{b}"] = np.asarray(ms_step("cpu", init, ms_cpu_batch(batches[b], b)))
    secs["multiscale"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    scans, _ = make_scans()
    hf, normalize = load_hintfree("cpu")
    edges = default_edges(MW_SCANS, MW_WINDOW)[:EDGE_CPU_DISPATCH]
    got = register_pairs(hf, [(scans[i], scans[j]) for i, j in edges], normalize=normalize,
                         batch_size=EDGE_CPU_DISPATCH, passes=1, device="cpu")
    res["edges_T"] = np.stack([r.transform for r in got])
    res["edges_fitness"] = np.asarray([r.fitness for r in got])
    secs["edges"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, transforms = load_measure_script().run(measure_argv("ico60", 180.0, ROBUST_CPU_PAIRS,
                                                           "cpu"))
    res["robust_T"] = transforms[0]
    secs["robust"] = time.perf_counter() - t0
    return res, secs


def path9_cpu(out):
    """:func:`path9_cpu_refs` in the child process (``--path9-cpu OUT``), at
    the lowest priority, dying with its parent; saves the results to
    ``out``."""
    import ctypes
    import signal

    import numpy as np

    ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG: die with the parent
    os.nice(19)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    res, secs = path9_cpu_refs()
    np.savez(out + ".tmp.npz", seconds=json.dumps(secs), **res)
    os.replace(out + ".tmp.npz", out)
    print(f"path 9 CPU references: {json.dumps(secs)}", flush=True)


def start_path9_cpu():
    """Start :func:`path9_cpu` in a child process; returns (process, output)."""
    import shutil

    shutil.rmtree(WORK9, ignore_errors=True)
    os.makedirs(WORK9)
    os.makedirs(OUT_DIR, exist_ok=True)
    root, env = repo_env()
    out = os.path.join(os.path.abspath(WORK9), "cpu_refs.npz")
    with open(os.path.join(OUT_DIR, "chip_smoke_path9_cpu.log"), "w") as f:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--path9-cpu", out],
                                cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT)
    log(f"path 9: CPU references started in a child process (pid {proc.pid}, nice 19)")
    return proc, out


def stop_child(child):
    """Kill the child process if it still runs (a failed path, a cut run)."""
    proc, _ = child
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def wait_path9_cpu(child):
    """The child's results, once it has finished (it must end within
    PATH9_CPU_WAIT_S of this call)."""
    import numpy as np

    proc, out = child
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=PATH9_CPU_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"path 9 CPU references: not done {PATH9_CPU_WAIT_S} s after "
                             "the card's work")
    with open(os.path.join(OUT_DIR, "chip_smoke_path9_cpu.log")) as f:
        tail = f.read()[-3000:]
    check(rc == 0 and os.path.exists(out), f"path 9 CPU references: exit {rc}:\n{tail}")
    refs = dict(np.load(out))
    log(f"path 9: waited {time.perf_counter() - t0:.1f} s for the CPU references "
        f"({refs.pop('seconds')} s of work at nice 19)")
    return refs


def log_sync_waits(fn, label):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: the host
    waits it asks for, counted by the port's line that asked for them (not
    the debug-mode switch itself). Returns (result, count)."""
    import collections
    import linecache
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    where = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno} "
        f"({linecache.getline(w.filename, w.lineno).strip()[:60]})" for w in caught
        if "synchroniz" in str(w.message) and "scream_tpu_torch" in w.filename)
    log(f"{label}: {sum(where.values())} | {json.dumps(dict(where))}")
    return result, sum(where.values())


def phase_multiway(hf, normalize, scans, T_gt):
    """Path 9 (a) on the card: ``register_multiway`` (window 2, one
    scan-to-map round, the CLI's defaults) timed with its launches; the
    edges' ``register_pairs`` (their transforms: the synchronization's
    input); ``synchronize_poses`` twice on the card (bit for bit) with its
    host waits; the scan-to-map polish of perturbed poses; the bounded NN at
    the map's shape against its plain version; the CLI in a subprocess.
    Returns (records, launches, results, what the CPU comparison needs)."""
    import numpy as np
    import torch

    from scream_tpu_torch.data import pad_cloud
    from scream_tpu_torch.data.transforms import rodrigues
    from scream_tpu_torch.ops import launch_counts, nn_cuda, reset_launch_counts
    from scream_tpu_torch.pipeline import (default_edges, refine_to_map, register_multiway,
                                           register_pairs, synchronize_poses)
    from scream_tpu_torch.pipeline.register import _default_capacity

    edges = default_edges(MW_SCANS, MW_WINDOW)
    kw = dict(normalize=normalize, batch_size=SERVE_BATCH, passes=2, device=DEV)
    register_multiway(hf, scans[:3], edges=default_edges(3, MW_WINDOW), **kw)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = register_multiway(hf, scans, edges=edges, refine_rounds=1, **kw)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check(all(counts[k] > 0 for k in PATH2_KERNELS) and np.isfinite(res.poses).all()
          and np.array_equal(res.poses[0], np.eye(4, dtype=np.float32))
          and len(res.edges) == len(edges),
          f"register_multiway: launches {counts}, finite {np.isfinite(res.poses).all()}, "
          f"gauge {res.poses[0].tolist()}")
    rot, tr = pose_errors(res.poses, T_gt)
    log(f"path 9 register_multiway ({MW_SCANS} scans x {MW_POINTS}, window {MW_WINDOW}: "
        f"{len(edges)} edges, passes 2, refine_rounds 1, hint-free d128, {hf.cfg.dtype}): "
        f"{wall:.2f} s | poses against the truth: max {rot:.4f} deg, {tr:.5f} | edge fitness "
        f"min {res.edge_fitness.min():.4f} median {float(np.median(res.edge_fitness)):.4f} | "
        f"launches {json.dumps(counts)}")

    pairs = [(scans[i], scans[j]) for i, j in edges]
    rel = register_pairs(hf, pairs, normalize=normalize, batch_size=SERVE_BATCH, passes=2,
                         device=DEV)
    rel_T = np.stack([r.transform for r in rel])
    w = np.asarray([r.fitness for r in rel], np.float32)
    same_fit = bool(np.array_equal(w, res.edge_fitness))
    first = register_pairs(hf, pairs[:EDGE_CPU_DISPATCH], normalize=normalize,
                           batch_size=EDGE_CPU_DISPATCH, passes=1, device=DEV)
    sync = lambda: synchronize_poses(MW_SCANS, edges, rel_T, weights=w, device=DEV)
    P1, waits = log_sync_waits(sync, f"path 9 synchronize_poses on the card ({MW_SCANS} "
                               f"scans, {len(edges)} edges, 100 sweeps)")
    t0 = time.perf_counter()
    P2 = sync()
    sync_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(P1, P2), "synchronize_poses: two runs on the card differ")
    rot_s, tr_s = pose_errors(P1, T_gt)
    log(f"path 9 synchronize_poses: two card runs bit identical, {sync_ms:.1f} ms, "
        f"{waits} host waits; poses against the truth max {rot_s:.4f} deg, {tr_s:.5f}; "
        f"register_multiway's edge fitness equal to these edges' {same_fit}")

    # The scan-to-map polish, fed the synchronized poses perturbed by
    # MW_PERTURB rad and MW_PERTURB (tests/test_multiway.py's test of it).
    rng = np.random.default_rng(MW_SEED + 1)
    noisy = P1.copy()
    for k in range(1, MW_SCANS):
        noisy[k, :3, :3] = (rodrigues(rng.normal(size=3) * MW_PERTURB)
                            @ noisy[k, :3, :3]).astype(np.float32)
        noisy[k, :3, 3] += (rng.normal(size=3) * MW_PERTURB).astype(np.float32)
    reset_launch_counts()
    t0 = time.perf_counter()
    refined = refine_to_map(scans, noisy, 0.1, rounds=MW_REFINE_ROUNDS, device=DEV)
    refine_s = time.perf_counter() - t0
    refine_counts = launch_counts()
    (b_rot, b_tr), (a_rot, a_tr) = pose_errors(noisy, T_gt), pose_errors(refined, T_gt)
    check(a_rot < b_rot and a_tr < b_tr and np.array_equal(refined[0], noisy[0]),
          f"refine_to_map: max errors {b_rot:.4f} deg / {b_tr:.5f} -> {a_rot:.4f} / {a_tr:.5f}")
    log(f"path 9 refine_to_map ({MW_REFINE_ROUNDS} rounds) of the synchronized poses "
        f"perturbed by {MW_PERTURB} rad / {MW_PERTURB}: max errors against the truth "
        f"{b_rot:.4f} deg / {b_tr:.5f} -> {a_rot:.4f} deg / {a_tr:.5f} (ratios "
        f"{a_rot / b_rot:.3f} / {a_tr / b_tr:.3f}); {refine_s:.2f} s; nn_bounded_single "
        f"launches {refine_counts['nn_bounded_single']}")

    # The bounded NN at the map's shape: scan 1 against the other scans in
    # the world frame, as refine_to_map pads them (ICP's view at its pose).
    world = [s @ P1[k, :3, :3].T + P1[k, :3, 3] for k, s in enumerate(scans)]
    cap = _default_capacity(sum(len(s) for s in scans))
    on = lambda a: torch.as_tensor(a, device=DEV)[None]
    (sp, sm) = pad_cloud(world[1].astype(np.float32), _default_capacity(MW_POINTS))
    (mp, mm) = pad_cloud(np.concatenate(world[:1] + world[2:]).astype(np.float32), cap)
    s_t, dst = icp_view(on(sp), on(mp), on(sm), on(mm),
                        torch.eye(4, device=DEV)[None])
    thresh_sq = float(torch.tensor(0.1, dtype=torch.float32) ** 2)
    no = torch.zeros(1, dtype=torch.bool, device=DEV)
    boxes = nn_cuda.nn_tile_boxes(dst)
    d2, xyz = nn_cuda.nn_bounded_single(s_t, dst, thresh_sq, boxes=boxes)
    rows = slice(0, MAP_CHECK_ROWS)
    d2p, xyzp = nn_cuda.nn_bounded_plain(s_t[:, rows].contiguous(), dst, thresh_sq, None)
    torch.cuda.synchronize()
    within = d2p < thresh_sq
    abs_err = float((d2[:, rows] - d2p)[within].abs().max())
    exact = bool(torch.equal(xyz[:, rows][within], xyzp[within]))
    outside = bool((d2[:, rows][~within] >= thresh_sq).all())
    check(abs_err <= 1e-6 and exact and outside and int(within.sum()) > 0,
          f"nn_bounded_single at the map shape: distance error {abs_err:.3g}, winners equal "
          f"{exact}, outside ok {outside}")
    ms, ms_all = timed(lambda: nn_cuda.nn_bounded_single(s_t, dst, thresh_sq, boxes=boxes))
    pms = cuda_ms(lambda: nn_cuda.nn_bounded_plain(s_t[:, rows].contiguous(), dst, thresh_sq,
                                                   None), reps=3)
    live, total = live_pairs(s_t, dst, thresh_sq)
    n_src = s_t.shape[1]
    b_ms, b_by = bound(n_src * 12 + cap * 12 + n_src * 16,
                       [(NN_INSTR_PER_PAIR * live * 128 * 256 + NN_INSTR_PER_ROW * live * 256,
                         INSTR_FP32)])
    log(f"kernel nn_bounded_single {n_src} x {cap} (the map of {MW_SCANS - 1} scans, "
        f"{nn_cuda.bounded_splits(1, n_src, cap)} splits): exact within the threshold on "
        f"{MAP_CHECK_ROWS} src rows ({int(within.sum())} inliers), timing rounds "
        f"{', '.join(f'{t:.4f}' for t in ms_all)} ms, plain on {MAP_CHECK_ROWS} rows "
        f"{pms:.4f} ms, live tile pairs {live} of {total}")
    record = dict(name="nn_bounded_single_map", err=0.0, max_abs_err=abs_err, ms=ms,
                  plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                  bar="exact within threshold", route="cuda",
                  source="scream_tpu_torch/csrc/nn.cu",
                  replaces="scream_tpu/ops/nn_pallas.py:162", live_share=live / total)

    # The CLI in a subprocess, on the same scans: its poses against the
    # in-process register_multiway's.
    root, env = repo_env()
    paths = []
    for k, s in enumerate(scans):
        paths.append(os.path.join(os.path.abspath(WORK9), f"scan{k}.npy"))
        np.save(paths[-1], s)
    out = os.path.join(os.path.abspath(WORK9), "poses.npy")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "scream_tpu_torch", "register", "--scans",
                           *paths, "--params", HINTFREE, "--refine-rounds", "1", "--out", out,
                           "--device", DEV], capture_output=True, text=True, timeout=300,
                          cwd=root, env=env)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"register --scans: exit {proc.returncode}:\n"
          f"{proc.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
    P = np.load(out)
    err = float(np.abs(P - res.poses).max())
    check([ln["scan"] for ln in lines] == list(range(MW_SCANS)) and err <= 1e-5
          and np.array_equal(P[0], np.eye(4, dtype=np.float32))
          and np.array_equal(np.stack([ln["pose"] for ln in lines]).astype(np.float32), P),
          f"register --scans: {len(lines)} lines, poses vs in-process {err:.3g}")
    log(f"path 9 cli: python -m scream_tpu_torch register --scans ({MW_SCANS} files) --params "
        f"{HINTFREE} --refine-rounds 1 --out ({cli_s:.1f} s wall, subprocess): {len(lines)} "
        f"pose lines, P[0] the identity, poses vs in-process max err {err:.2e} (bar 1e-5) | "
        f"{proc.stderr.strip().splitlines()[-1]}")
    results = {"multiway_s": wall, "multiway_max_err_deg_t": [rot, tr],
               "synchronize_ms": sync_ms, "synchronize_host_waits": waits,
               "refine_max_err_before_after": [b_rot, b_tr, a_rot, a_tr],
               "refine_s": refine_s}
    compare = dict(first=np.stack([r.transform for r in first]), rel_T=rel_T, w=w,
                   P_card=P1)
    return [record], {"nn_bounded_single_map": counts["nn_bounded_single"]}, results, compare


def compare_multiway(cmp, refs):
    """Path 9 (a) against the CPU path: the first dispatch's edge
    transforms, and ``synchronize_poses`` fed the card's edges on the CPU."""
    import numpy as np

    from scream_tpu_torch.pipeline import default_edges, synchronize_poses

    diff = np.abs(cmp["first"] - refs["edges_T"]).reshape(EDGE_CPU_DISPATCH, -1).max(-1)
    n_far = int((diff > TRANSFORM_TOL).sum())
    check(n_far <= 1, f"multiway edges card vs CPU path: {n_far} of {EDGE_CPU_DISPATCH} beyond "
          f"{TRANSFORM_TOL} ({diff.tolist()})")
    P_cpu = synchronize_poses(MW_SCANS, default_edges(MW_SCANS, MW_WINDOW), cmp["rel_T"],
                              weights=cmp["w"], device="cpu")
    sync_err = float(np.abs(P_cpu - cmp["P_card"]).max())
    check(sync_err <= SYNC_TOL, f"synchronize_poses card vs CPU: {sync_err:.3g} > {SYNC_TOL}")
    log(f"path 9 multiway card vs CPU path: first dispatch of {EDGE_CPU_DISPATCH} edges "
        f"(passes 1), {n_far} beyond {TRANSFORM_TOL} (bar <= 1), max {diff.max():.3e}, median "
        f"{float(np.median(diff)):.3e}; synchronize_poses on the card's edges max "
        f"{sync_err:.2e} (bar {SYNC_TOL})")


def phase_measure(hf32):
    """Path 9 (b): ``scripts/torch_port_measure_gt_free.py`` in-process on the
    card (oct24 over +-90 deg, ico60 over all of SO(3)); every value finite;
    stats and apply at the ico60 robust passes' first-block input (60 lanes x
    512) against their plain versions. Returns (records, launches, rows,
    the ico60 transforms)."""
    import numpy as np
    import torch

    from scream_tpu_torch.ops import launch_counts, reset_launch_counts
    from scream_tpu_torch.pipeline import register as reg

    script = load_measure_script()
    rows, launches, ico = {}, {}, None
    for starts, deg in MEASURE_RUNS:
        reset_launch_counts()
        got, transforms = script.run(measure_argv(starts, deg))
        counts = launch_counts()
        row = got[0]
        flat = [v for v in row.values() if isinstance(v, (int, float))] + \
            [v for v in (row["margin_succ_q"] or []) + row["margins_failed"]]
        check(all(math.isfinite(v) for v in flat) and np.isfinite(transforms[0]).all()
              and all(counts[k] > 0 for k in PATH2_KERNELS[:-1]),
              f"measure_gt_free --starts {starts}: row {row}, launches {counts}")
        log(f"path 9 measure_gt_free --starts {starts} --max-angle-deg {deg:g} "
            f"({MEASURE_PAIRS} x {MEASURE_POINTS}, fp32, robust): {json.dumps(row)} | "
            f"launches {json.dumps(counts)}")
        rows[starts] = row
        launches[starts] = counts
        if starts == "ico60":
            ico = transforms[0]

    # Stats and apply at the ico60 robust pass's shape: the first pair's 60
    # seed lanes through the model, as register_pairs batches them.
    pair = make_gt_free_pairs(1, MEASURE_POINTS, GT_FREE_SEED, max_angle_deg=180.0)[0]
    c0 = pair["src"].mean(axis=0)
    items = [((pair["src"] @ R0.T + (c0 - R0 @ c0)).astype(np.float32), pair["tgt"])
             for R0 in reg._rotation_starts("ico60")]
    b = reg._normalized_batch(items, "unit_sphere", 512, DEV)
    x, m_bool = block_input(hf32, hf32.trunk.stem_0,
                            (b["src"], b["tgt"], b["src_mask"], b["tgt_mask"], None))
    records = check_attention(hf32.trunk.stem_0, m_bool, suffix="_f32_robust60", x=x,
                              dtype=torch.float32)
    log_records(records)
    return records, {"attn_stats_f32_robust60": launches["ico60"]["attn_stats"],
                     "attn_apply_f32_robust60": launches["ico60"]["attn_apply"]}, rows, ico


def phase_multiscale(smi):
    """Path 9 (c): the multi-scale loader's batches on the card: stats and
    apply at the 8 x 256 bucket's first-block input against their plain
    versions, the bucketed steps' outputs for the CPU comparison, timed
    steps per bucket (pairs/s), and ``train 3dmatch --multi-scale`` in a
    subprocess. Returns (records, launches, results, the card's steps)."""
    import torch

    from scream_tpu_torch.config import ModelConfig, RenderConfig, TrainConfig
    from scream_tpu_torch.models import PointTransformer
    from scream_tpu_torch.ops import launch_counts, reset_launch_counts
    from scream_tpu_torch.pipeline.register import gt_center_hint, to_device
    from scream_tpu_torch.train import (generator_optimizer, init_train_state,
                                        make_registration_train_step)

    batches, init = multiscale_batches(), ms_init_state()
    steps = {b: ms_step(DEV, init, ms_cpu_batch(batches[b], b)) for b in MS_BUCKETS}
    model = PointTransformer(ModelConfig(), device=DEV)
    model.load_state_dict(init)
    tb = to_device(batches[min(MS_BUCKETS)], DEV)
    x, m_bool = block_input(model, model.trunk.stem_0,
                            (tb["src"], tb["tgt"], tb["src_mask"], tb["tgt_mask"],
                             gt_center_hint(tb["rot"], tb["trans"])))
    records = check_attention(model.trunk.stem_0, m_bool, suffix="_ms256", x=x)
    log_records(records)

    # Training rate per bucket: MS_ITERS timed steps after one warm-up.
    opt, sched = generator_optimizer(model.parameters(), TrainConfig(), steps_per_epoch=1000)
    step = make_registration_train_step(model, use_gan=False, render_cfg=RenderConfig())
    state = init_train_state(opt, sched)
    rates = {}
    reset_launch_counts()
    for b in sorted(batches):
        tb = to_device(batches[b], DEV)
        state, metrics, _ = step(state, tb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MS_ITERS):
            state, metrics, _ = step(state, tb)
        float(metrics["point_loss"])
        rates[b] = MS_ITERS * tb["src"].shape[0] / (time.perf_counter() - t0)
    counts = launch_counts()
    check(counts["attn_stats"] > 0 and counts["attn_apply"] > 0,
          f"bucketed training: launches {counts}")
    log(f"path 9 multi-scale training (3DMatch preset, d 256, 6 + 6, bf16, GAN off) on {smi}: "
        f"pairs/s by bucket {json.dumps({b: round(r, 2) for b, r in rates.items()})} | "
        f"launches {json.dumps(counts)}")

    ck = os.path.join(os.path.abspath(WORK9), "cli_multiscale")
    final, (out, cli_counts), wall = run_cli(
        ["train", "3dmatch", "--multi-scale", "--epochs", "2", "--synthetic-pairs",
         str(MS_CLI_PAIRS), "--checkpoint-dir", ck, "--device", DEV],
        "train 3dmatch --multi-scale", counted=True)
    check(cli_counts["attn_stats"] > 0 and cli_counts["attn_apply"] > 0,
          f"train --multi-scale: launches {cli_counts}")
    log(f"path 9 cli: train 3dmatch --multi-scale --epochs 2 --synthetic-pairs {MS_CLI_PAIRS} "
        f"({wall:.1f} s, subprocess): final_val {json.dumps(final)} | launches "
        f"{json.dumps(cli_counts)}")
    return records, {"attn_stats_ms256": counts["attn_stats"],
                     "attn_apply_ms256": counts["attn_apply"]}, \
        {"multiscale_pairs_per_s_by_bucket": rates, "multiscale_cli_s": wall}, steps


def compare_multiscale(steps, refs):
    """Path 9 (c) against the CPU path: point_loss 2e-2 and the gradient
    norm 5e-2 relative, at each bucket (ROADMAP's training bars)."""
    parts = []
    for b in MS_BUCKETS:
        (pl, gn), (pl_c, gn_c) = steps[b], refs[f"ms_{b}"].tolist()
        e_pl, e_gn = abs(pl - pl_c) / abs(pl_c), abs(gn - gn_c) / abs(gn_c)
        check(all(math.isfinite(v) for v in (pl, gn, pl_c, gn_c)) and e_pl <= 2e-2
              and e_gn <= 5e-2, f"bucketed step at {b}: point_loss {pl} / {pl_c}, grad norm "
              f"{gn} / {gn_c}")
        parts.append(f"{b} points ({8 if b != max(MS_BUCKETS) else MS_CPU_PAIRS} pairs): "
                     f"point_loss {pl:.6f} / {pl_c:.6f} (rel {e_pl:.2e}, bar 2e-2), grad norm "
                     f"{gn:.6f} / {gn_c:.6f} (rel {e_gn:.2e}, bar 5e-2)")
    log("path 9 bucketed step card vs CPU path: " + "; ".join(parts))


def phase_geometry(scan):
    """Path 9 (d): the geometry library on the card against the CPU path:
    normals of a 4,096-point terrain scan (|dot| >= 1 - 1e-4), the voxel
    downsample of a multiway scan against the native host version (the same
    voxels in key order, centroids within 1e-5), so3 / se3 exp, log and
    their round trips (1e-5), on rotations up to 3 rad."""
    import numpy as np
    import torch

    from scream_tpu_torch.data import make_dem_patch
    from scream_tpu_torch.geometry import estimate_normals, se3, so3
    from scream_tpu_torch.native import voxel_downsample as native_voxel
    from scream_tpu_torch.ops.voxel import voxel_downsample

    ground = make_dem_patch(np.random.default_rng(MW_SEED), n_dsm=MW_POINTS,
                            n_dem=MW_POINTS)["dem"]
    t0 = time.perf_counter()
    n_card = estimate_normals(torch.as_tensor(ground, device=DEV)).cpu()
    normals_ms = (time.perf_counter() - t0) * 1e3
    n_cpu = estimate_normals(torch.as_tensor(ground))
    dot = float((n_card * n_cpu).sum(-1).abs().min())
    check(dot >= 1 - 1e-4, f"estimate_normals card vs CPU: min |dot| {dot}")

    cent, valid = voxel_downsample(torch.as_tensor(scan, device=DEV), VOXEL, MW_POINTS)
    cent, valid = cent.cpu().numpy(), valid.cpu().numpy()
    host = native_voxel(scan, VOXEL)
    n_vox = int(valid.sum())
    vox_err = float(np.abs(cent[:n_vox] - host).max()) if n_vox == len(host) else math.inf
    check(n_vox == len(host) and valid[:n_vox].all() and vox_err <= 1e-5,
          f"voxel_downsample card vs native: {n_vox} / {len(host)} voxels, err {vox_err}")

    g = torch.Generator().manual_seed(MW_SEED)
    w = (so3.uniform_2_sphere(g, (512,), device="cpu")
         * torch.rand((512, 1), generator=g) * 3.0)
    v = torch.cat([torch.randn((512, 3), generator=g), w], -1)
    errs, trips = {}, {}
    for name, fn in (("so3.exp", lambda d: so3.exp(w.to(d))),
                     ("so3.log", lambda d: so3.log(so3.exp(w.to(d)))),
                     ("so3 round trip", lambda d: so3.exp(so3.log(so3.exp(w.to(d))))),
                     ("se3.exp", lambda d: se3.exp(v.to(d))),
                     ("se3.log", lambda d: se3.log(se3.exp(v.to(d)))),
                     ("se3 round trip", lambda d: se3.exp(se3.log(se3.exp(v.to(d)))))):
        card, cpu = fn(DEV).cpu(), fn("cpu")
        errs[name] = float((card - cpu).abs().max())
    # The round trips' own error, the same on both devices: fp32 exp / log
    # with the JAX package's formulas (logged, not gated: between the Taylor
    # branch's theta 1e-6 and ~1e-2, (1 - cos t) / t^2 cancels in fp32).
    for name, fwd, inv, x in (("so3", so3.exp, so3.log, w), ("se3", se3.exp, se3.log, v)):
        X = fwd(x.to(DEV))
        trips[name] = float((fwd(inv(X)) - X).abs().max())
    check(all(e <= 1e-5 for e in errs.values()), f"so3 / se3 card vs CPU: {errs}")
    log(f"path 9 geometry on the card vs the CPU path: estimate_normals ({MW_POINTS}-point "
        f"terrain scan, k 30, {normals_ms:.1f} ms) min |dot| {dot:.7f} (bar 1 - 1e-4); "
        f"voxel_downsample (voxel {VOXEL}) {n_vox} voxels as the native library, centroids "
        f"max err {vox_err:.2e} (bar 1e-5); " + ", ".join(f"{k} {e:.2e}" for k, e in
                                                          errs.items()) + " (bar 1e-5) | "
        "round trips' own error on the card: " + ", ".join(f"{k} {e:.2e}" for k, e in
                                                         trips.items()))


def path9(smi, child):
    """Path 9: multiway registration, the robust GT-free measurement,
    multi-scale training and the geometry library on the card; then the
    CPU path's references from ``child`` (:func:`start_path9_cpu`). Returns
    (records, launches by record name, results)."""
    import shutil

    import numpy as np
    import torch

    t0 = time.perf_counter()
    log(f"path 9 (multiway, robust measurement, multi-scale training, geometry) on {smi}")
    hf, normalize = load_hintfree(DEV)
    scans, T_gt = make_scans()
    records, launches, results, cmp = phase_multiway(hf, normalize, scans, T_gt)
    hf32, _ = load_hintfree(DEV, dtype="float32")
    rec, lau, rows, ico = phase_measure(hf32)
    records += rec
    launches.update(lau)
    del hf, hf32
    torch.cuda.empty_cache()
    rec, lau, ms_results, steps = phase_multiscale(smi)
    records += rec
    launches.update(lau)
    phase_geometry(scans[0])
    card_s = time.perf_counter() - t0

    refs = wait_path9_cpu(child)
    compare_multiway(cmp, refs)
    diff = np.abs(ico[:ROBUST_CPU_PAIRS] - refs["robust_T"]).reshape(ROBUST_CPU_PAIRS, -1).max(-1)
    n_far = int((diff > TRANSFORM_TOL).sum())
    check(n_far <= 1, f"robust ico60 card vs CPU path: {n_far} of {ROBUST_CPU_PAIRS} beyond "
          f"{TRANSFORM_TOL} ({diff.tolist()})")
    log(f"path 9 robust ico60 card vs CPU path (first {ROBUST_CPU_PAIRS} pairs, fp32): {n_far} "
        f"beyond {TRANSFORM_TOL} (bar <= 1), per-pair max {', '.join(f'{d:.2e}' for d in diff)}")
    compare_multiscale(steps, refs)
    shutil.rmtree(WORK9, ignore_errors=True)
    log(f"path 9 took {time.perf_counter() - t0:.1f} s ({card_s:.1f} s of card work)")
    return records, launches, {**results, **ms_results, "measure_gt_free_rows": rows,
                               "path9_s": time.perf_counter() - t0}


def run_only(names, smi):
    """``--only``: the named kernels' checks alone, after the device and
    build phases, at the shapes and on the inputs of the full run: the
    exact NN at path 1's shape and on exact ties at B = 1 and 16; the splat
    at path 3's and the KITTI shape and on the adversarial scenes; the tail
    at every width (``tail``); stats and apply at path 1's shape, gates
    included, and at every (d, heads, dtype) cell (``apply``); or path 6
    (``ingest``), path 7 (``fp32``), path 8 (``d384``) or path 9
    (``multiway``, with its CPU references' child process) whole. No result
    line is printed."""
    if "nn_exact" in names:
        rec = check_exact_path1(make_batches(2 * (TIMED_BATCHES + 1) + 1, seed=0)[-1])
        log("kernels on exact ties: "
            + ", ".join(check_exact_ties(n, 2048) for n in (1, B)))
        log_records([rec])
    if "ingest" in names:
        path6()
    if "fp32" in names:
        path7(smi)
    if "tail" in names:
        phase_tail_widths()
    if "apply" in names:
        phase_apply_cells()
    if "d384" in names:
        path8(smi)
    if "multiway" in names:
        child = start_path9_cpu()
        try:
            path9(smi, child)
        finally:
            stop_child(child)
    if "splat" in names:
        train = make_batches(2 * (TRAIN_ITERS + 1) + 1, seed=500, batch=TRAIN_B,
                             cap=TRAIN_CAP)[-1]
        kitti = make_batches(1, seed=600, batch=TRAIN_B, n_src=8000, n_tgt=8000,
                             cap=KITTI_CAP)[0]
        phase_splat(train, kitti)
    log(f"only {', '.join(names)}: every check passed")


def main():
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port's paths on one NVIDIA GPU "
                                 "and check every kernel against its plain version.")
    ap.add_argument("--only", default="", metavar="NAME[,NAME]",
                    help=f"check only these kernels ({', '.join(ONLY_KERNELS)}): a short "
                    "build-and-compare after a kernel change; or run only these paths "
                    f"({', '.join(ONLY_PATHS)})")
    ap.add_argument("--path9-cpu", default=None, metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.path9_cpu:  # the child process of path 9's CPU references
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        path9_cpu(args.path9_cpu)
        return
    only = [k for k in args.only.split(",") if k]
    if any(k not in ONLY_KERNELS + ONLY_PATHS for k in only):
        ap.error(f"--only takes {', '.join(ONLY_KERNELS + ONLY_PATHS)}, not {only}")
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(OUT_DIR, exist_ok=True)
    open(os.path.join(OUT_DIR, "chip_smoke.log"), "w").close()
    smi = phase_device()

    import torch

    from scream_tpu_torch.config import ModelConfig
    from scream_tpu_torch.models import PointTransformer

    phase_build()
    if only:
        run_only(only, smi)
        faulthandler.cancel_dump_traceback_later()
        return
    batches = make_batches(2 * (TIMED_BATCHES + 1) + 1, seed=0)
    # Path 1: the shipped trained point-generator (full-width ModelConfig).
    model, _ = load_weights(POINT_GEN, DEV)
    records = phase_kernels(model, batches[-1])
    phase_forward(model, batches[-1])
    pps, counts, path1_re = run_path(model, batches[:TIMED_BATCHES + 1], None)
    pps_sub, counts_sub, _ = run_path(model, batches[TIMED_BATCHES + 1:-1], ICP_SUB)
    phase_oracle(batches[-1])

    # Path 2: GT-free serving with the shipped hint-free checkpoint.
    hf, normalize = load_hintfree(DEV)
    hf_cpu, _ = load_hintfree("cpu")
    pairs = make_gt_free_pairs(GT_FREE_PAIRS, GT_FREE_POINTS, GT_FREE_SEED)
    pairs_512 = make_gt_free_pairs(SERVE_PAIRS + SERVE_BATCH, GT_FREE_POINTS, 200)
    pairs_4096 = make_gt_free_pairs(SERVE_PAIRS + SERVE_BATCH, 4000, 300)
    records += phase_kernels_gt_free(hf, normalize, pairs, pairs_4096[0])
    serve_counts = phase_gt_free(hf, hf_cpu, normalize, pairs)
    phase_cli(hf, normalize, pairs[1])
    serving = phase_serving_times(hf, normalize, pairs_512, pairs_4096)

    # Path 3: the GAN training step at full width with the shipped
    # discriminator, from path 1's seeded random init.
    from scream_tpu_torch.utils.checkpoint import load_discriminator

    gen = PointTransformer(ModelConfig(), device="cuda",
                           generator=torch.Generator().manual_seed(0))
    init_state = {k: v.detach().cpu().clone() for k, v in gen.state_dict().items()}
    train_batches = make_batches(2 * (TRAIN_ITERS + 1) + 1, seed=500, batch=TRAIN_B,
                                 cap=TRAIN_CAP)
    kitti = make_batches(1, seed=600, batch=TRAIN_B, n_src=8000, n_tgt=8000, cap=KITTI_CAP)
    records += phase_kernels_train(gen, train_batches[-1])
    records += phase_splat(train_batches[-1], kitti[0])
    small = {k: v[:2, :1024] if v.ndim > 1 and v.shape[1] == TRAIN_CAP else v[:2]
             for k, v in train_batches[-1].items()}
    phase_train_card_vs_cpu(init_state, small)
    phase_disc_separation(gen, make_batches(1, seed=700, batch=TRAIN_B, n_src=512,
                                            n_tgt=512, cap=512)[0])
    train_counts, training = phase_training(gen, load_discriminator(DISC, DEV),
                                            train_batches[:-1])
    del gen
    torch.cuda.empty_cache()

    # Path 9's CPU references start here, after the last time-gated path, in
    # a child process at the lowest priority, so that they overlap paths 4-9.
    child = start_path9_cpu()
    try:
        # Path 4: OpenGF training at d_model 512, every block on the tail
        # kernel; its d 256 tail check on path 1's batch keeps the seeded
        # random init.
        del model
        init_model = PointTransformer(ModelConfig(), device="cuda",
                                      generator=torch.Generator().manual_seed(0))
        dem_records, dem_counts, dem_training = path4(init_model, batches[-1])
        records += dem_records
        del init_model
        torch.cuda.empty_cache()

        # Path 5: the evaluate protocols and the bench with the shipped weights.
        eval_counts, evaluation = path5()

        # Path 6: ingestion on the card (preprocess, the raw-frame KITTI GT).
        raw_counts, ingest_eval_counts, raw_rec, ingestion = path6()
        records.append(raw_rec)

        # Path 7: the float32 configuration.
        f32_records, f32_counts, f32_results = path7(smi, path1_re)
        records += f32_records

        # Path 8: bf16 at d 384 and the other head counts.
        d384_records, d384_launches, d384_results = path8(smi)
        records += d384_records

        # Path 9: multiway, the robust measurement, multi-scale training,
        # the geometry library; then the comparisons with the CPU references.
        mw_records, mw_launches, mw_results = path9(smi, child)
        records += mw_records
    finally:
        stop_child(child)

    # Launches: each row from the run of the path that gives it its shape.
    launches_of = {
        "attn_stats": counts["attn_stats"], "attn_apply": counts["attn_apply"],
        "nn_exact": counts["nn_exact"], "nn_bounded": counts["nn_bounded"],
        "attn_stats_d128": serve_counts["attn_stats"],
        "attn_apply_d128": serve_counts["attn_apply"],
        "nn_bounded_single": serve_counts["nn_bounded_single"],
        "attn_stats_train": train_counts["attn_stats"],
        "attn_apply_train": train_counts["attn_apply"],
        "max_splat": train_counts["max_splat"],
        "block_tail": dem_counts["block_tail"],
        "nn_bounded_single_kitti_raw": raw_counts["nn_bounded_single"],
        "attn_stats_f32": f32_counts["main"]["attn_stats"],
        "attn_apply_f32": f32_counts["main"]["attn_apply"],
        "attn_stats_f32_d128": f32_counts["serving"]["attn_stats"],
        "attn_apply_f32_d128": f32_counts["serving"]["attn_apply"],
        "block_tail_f32": f32_counts["train_cli"]["block_tail"], **d384_launches,
        **mw_launches}
    kernels = []
    for r in records:
        if r["name"] not in launches_of:
            continue  # extra shapes (the ICP subsample, B=1 at 4,096, KITTI GAN,
            # the coarse DEM stem, the tail at d 256, ragged rows), logged above
        launches = launches_of[r["name"]]
        kernels.append({
            "name": r["name"], "status": "ported, within its bar",
            "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        })
    log(json.dumps({"pairs_per_s": pps, "pairs_per_s_icp_subsampled": pps_sub,
                    "launches_icp_subsampled": counts_sub,
                    "launches_gt_free_serving": serve_counts, **serving,
                    "launches_training_gan": train_counts, **training,
                    "launches_dem_training": dem_counts, **dem_training,
                    "launches_evaluate": eval_counts, **evaluation,
                    "launches_ingest_evaluate": ingest_eval_counts,
                    "launches_raw_kitti_refinement": raw_counts, **ingestion,
                    **f32_results, **d384_results, **mw_results}, default=float))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
