#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, the CUDA toolkit (``nvcc``) and ``nvidia-smi``; it
imports nothing of JAX or of the JAX package. Phases, one line each:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: the four kernels from ``scream_tpu_torch/csrc`` in one ``nvcc``
   call (compiler report in ``chiprun_out/chip_smoke_build.log``);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes, with its time, the plain version's time and the
   least time the card could take for the same work;
4. main path: ``register_batch`` at 16 pairs x 4,096 points, full-width
   ``ModelConfig`` from a seeded random init, 30 ICP iterations, distinct
   inputs per call, with and without ``icp_subsample=1024``; pairs/s, each
   kernel's launches (all must be > 0) and finiteness;
5. oracle pose: the pose solve and ICP fed the GT-posed source plus noise
   must recover the pose; the same solve on the CPU path must agree;
6. the kernel list (JSON), the ``nvidia-smi`` line, and last the result line
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the result line. A watchdog turns a hang
into a stack dump and exit code 1.
"""

import faulthandler
import json
import math
import os
import subprocess
import sys
import time

WATCHDOG_S = 900
B, CAP, N_SRC, N_TGT = 16, 4096, 3840, 4032  # bench.py's headline shape
ICP_ITERS, ICP_SUB = 30, 1024
TIMED_BATCHES = 3
# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, fp32 CUDA cores, HBM3.
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12
OUT_DIR = "chiprun_out"


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def bound(bytes_moved, ops_by_rate):
    """Least time (ms) for the work: the larger of bytes over HBM rate and
    the operations over their type's peak; returns (ms, "bytes"|"operations")."""
    t_bytes = bytes_moved / PEAK_BYTES
    t_ops = sum(ops / rate for ops, rate in ops_by_rate)
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


def rel_err(got, want, rows=None):
    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


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
    report = [ln.strip() for ln in _build.build_log.splitlines()
              if "registers" in ln or "spill" in ln]
    log(f"build: {secs:.1f} s, one nvcc call -> {path.name}")
    for ln in report:
        log(f"  ptxas: {ln}")


def make_batches(n_batches, seed):
    from scream_tpu_torch.data import PairLoader, SyntheticPairDataset

    ds = SyntheticPairDataset(length=B * n_batches, n_src=N_SRC, n_tgt=N_TGT, seed=seed)
    return list(PairLoader(ds, batch_size=B, src_capacity=CAP, tgt_capacity=CAP,
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


def phase_kernels(model, batch):
    """Each kernel against its plain version on the card; returns records."""
    import torch

    from scream_tpu_torch.geometry.icp import _spatial_sort
    from scream_tpu_torch.ops import attn_cuda, nn_cuda
    from scream_tpu_torch.pipeline.register import (solve_pose,
                                                    spread_subsample_indices,
                                                    to_device)

    dev = torch.device("cuda")
    bf, f32 = torch.bfloat16, torch.float32
    records = []
    blk = model.trunk.stem_0
    H, d = blk.num_heads, blk.d_model
    hid = d * blk.ffn_mult
    g = torch.Generator(device=dev).manual_seed(0)
    L = CAP
    x = torch.randn((B, L, d), generator=g, device=dev).to(bf)
    tb = to_device(batch, dev)
    m_bool = tb["tgt_mask"]
    m = m_bool.float().contiguous()
    c = lambda w: w.detach().to(bf).contiguous()
    p = lambda w: w.detach().float().contiguous()
    Wq, Wk, Wv, Wm = (c(blk.q_proj.kernel), c(blk.k_proj.kernel),
                      c(blk.v_proj.kernel), c(blk.merge.kernel))
    W1, W2 = c(blk.ffn_in.kernel), c(blk.ffn_out.kernel)
    g1, b1, g2, b2 = (p(blk.norm1.scale), p(blk.norm1.bias), p(blk.norm2.scale),
                      p(blk.norm2.bias))

    # Kernel 1: attention statistics.
    KV, ks = attn_cuda.attn_stats(x, m, Wk, Wv, num_heads=H)
    KVp, ksp = attn_cuda.attn_stats_plain(x, m, Wk, Wv, num_heads=H)
    torch.cuda.synchronize()
    err = max(rel_err(KV, KVp), rel_err(ks, ksp))
    abs_err = max(float((KV - KVp).abs().max()), float((ks - ksp).abs().max()))
    check(err <= 5e-3, f"attn_stats: relative error {err:.3g} > 5e-3")
    ms = cuda_ms(lambda: attn_cuda.attn_stats(x, m, Wk, Wv, num_heads=H))
    pms = cuda_ms(lambda: attn_cuda.attn_stats_plain(x, m, Wk, Wv, num_heads=H))
    hd = d // H
    b_ms, b_by = bound(B * L * d * 2 + B * L * 4 + 2 * d * d * 2 + B * (H * hd * hd + d) * 4,
                       [(2 * B * L * d * 2 * d + 2 * B * L * H * hd * hd, PEAK_BF16)])
    records.append(dict(name="attn_stats", err=err, max_abs_err=abs_err, ms=ms,
                        plain_ms=pms, bound_ms=b_ms, bound_by=b_by, bar="5e-3 rel",
                        route="cuda", source="scream_tpu_torch/csrc/attn.cu",
                        replaces="scream_tpu/ops/attn_pallas.py:117"))

    # Kernel 2: attention apply + block tail (fed the plain stats).
    args = (x, m, KVp, ksp, Wq, Wm, g1, b1, W1, W2, g2, b2)
    kw = dict(attn_eps=1e-6, ln_eps=1e-5, norm_dtype=f32)
    out = attn_cuda.attn_apply(*args, **kw)
    outp = attn_cuda.attn_apply_plain(*args, **kw)
    torch.cuda.synchronize()
    err = rel_err(out, outp, rows=m_bool)
    abs_err = float((out.float() - outp.float())[m_bool].abs().max())
    # One bf16 ulp at the output's largest values is 2^-8..2^-7 of them, so a
    # single final-rounding flip reaches 4e-3..8e-3.
    check(err <= 1e-2, f"attn_apply: relative error {err:.3g} > 1e-2")
    ms = cuda_ms(lambda: attn_cuda.attn_apply(*args, **kw))
    pms = cuda_ms(lambda: attn_cuda.attn_apply_plain(*args, **kw))
    b_ms, b_by = bound(2 * B * L * d * 2 + B * L * 4 + (2 * d * d + 2 * d * hid) * 2
                       + B * (H * hd * hd + d) * 4 + 4 * d * 4,
                       [(2 * B * L * d * (2 * d + 2 * hid), PEAK_BF16),
                        (2 * B * L * H * hd * hd, PEAK_FP32)])
    records.append(dict(name="attn_apply", err=err, max_abs_err=abs_err, ms=ms,
                        plain_ms=pms, bound_ms=b_ms, bound_by=b_by, bar="1e-2 rel",
                        route="cuda", source="scream_tpu_torch/csrc/attn.cu",
                        replaces="scream_tpu/ops/attn_pallas.py:147"))

    # The whole fused block against the literal plain block in bf16, the
    # comparison the TPU selftest gates the Pallas kernels at (5e-2).
    fused = attn_cuda.attention_block_fused(
        x, x, m_bool, m_bool, blk.q_proj.kernel, blk.k_proj.kernel,
        blk.v_proj.kernel, blk.merge.kernel, blk.norm1.scale, blk.norm1.bias,
        blk.ffn_in.kernel, blk.ffn_out.kernel, blk.norm2.scale, blk.norm2.bias,
        num_heads=H, dtype=bf, norm_dtype=f32)
    plain = attn_cuda.block_plain(
        x, x, m_bool, m_bool, blk.q_proj.kernel, blk.k_proj.kernel,
        blk.v_proj.kernel, blk.merge.kernel, blk.norm1.scale, blk.norm1.bias,
        blk.ffn_in.kernel, blk.ffn_out.kernel, blk.norm2.scale, blk.norm2.bias,
        num_heads=H, cd=bf, nd=f32, attn_eps=1e-6, ln_eps=1e-5)
    torch.cuda.synchronize()
    blk_err = rel_err(fused.detach(), plain.detach(), rows=m_bool)
    check(blk_err <= 5e-2, f"fused block vs plain block: {blk_err:.3g} > 5e-2")
    log(f"kernel fused_block_vs_plain_block: rel_err {blk_err:.3e} (bar 5e-2)")

    # Kernel 3: exact NN of the pose solve (src_pred/s against tgt/s).
    inv_s = (1.0 / tb["scale"])[:, None, None]
    pred = oracle_pred(batch, 0.01, 0, dev)
    src = (pred * inv_s).contiguous()
    dst = nn_cuda.mask_far(tb["tgt"] * inv_s, m_bool)
    d2, idx = nn_cuda.nn_exact(src, dst)
    d2p, idxp = nn_cuda.nn_exact_plain(src, dst)
    torch.cuda.synchronize()
    mism = int((idx != idxp).sum())
    abs_err = float((d2 - d2p).abs().max())
    check(mism == 0 and abs_err <= 1e-6,
          f"nn_exact: {mism} index mismatches, distance error {abs_err:.3g}")
    ms = cuda_ms(lambda: nn_cuda.nn_exact(src, dst))
    pms = cuda_ms(lambda: nn_cuda.nn_exact_plain(src, dst), reps=3)
    b_ms, b_by = bound(B * CAP * 12 * 2 + B * CAP * 12,
                       [(9 * B * CAP * CAP + 5 * B * CAP, PEAK_FP32)])
    records.append(dict(name="nn_exact", err=float(mism), max_abs_err=abs_err, ms=ms,
                        plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                        bar="0 index mismatches, 1e-6 abs", route="cuda",
                        source="scream_tpu_torch/csrc/nn.cu",
                        replaces="scream_tpu/ops/nn_pallas.py:59"))

    # Kernel 4: bounded NN as ICP calls it: de-normalized clouds, src sorted
    # on the init-rotated axis and moved by the solved pose, tgt sorted on x.
    sol = solve_pose(tb["src"], pred, tb["tgt"], tb["src_mask"], m_bool,
                     tb["scale"], tb["center"])
    src_dn = tb["src"] * inv_s + tb["center"][:, None, :]
    tgt_dn = tb["tgt"] * inv_s + tb["center"][:, None, :]
    T = sol.transform
    for n in (CAP, ICP_SUB):
        idx = torch.as_tensor(spread_subsample_indices(CAP, n), dtype=torch.long, device=dev)
        s_sorted, _ = _spatial_sort(src_dn[:, idx], tb["src_mask"][:, idx], T[:, 0, :3])
        t_sorted, t_mask = _spatial_sort(tgt_dn, m_bool)
        s_t = (s_sorted @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]).contiguous()
        dst = nn_cuda.mask_far(t_sorted, t_mask)
        thresh_sq = float(torch.tensor(0.1, dtype=f32) ** 2)
        dead = torch.zeros(B, dtype=torch.bool, device=dev)
        dead[-2:] = True
        d2, xyz = nn_cuda.nn_bounded(s_t, dst, thresh_sq, dead)
        d2p, xyzp = nn_cuda.nn_bounded_plain(s_t, dst, thresh_sq, dead)
        torch.cuda.synchronize()
        within = (d2p < thresh_sq) & ~dead[:, None]
        abs_err = float((d2 - d2p)[within].abs().max())
        coords_equal = bool(torch.equal(xyz[within], xyzp[within]))
        dead_ok = bool((d2[-2:] == nn_cuda.NO_HIT).all())
        check(abs_err <= 1e-6 and coords_equal and dead_ok and int(within.sum()) > 0,
              f"nn_bounded n={n}: distance error {abs_err:.3g}, coords equal "
              f"{coords_equal}, dead lanes ok {dead_ok}")
        alive = torch.zeros(B, dtype=torch.bool, device=dev)
        ms = cuda_ms(lambda: nn_cuda.nn_bounded(s_t, dst, thresh_sq, alive))
        pms = cuda_ms(lambda: nn_cuda.nn_bounded_plain(s_t, dst, thresh_sq, alive), reps=3)
        # Work this run's data needs: the (128-point sub-slab, 256-row tile)
        # pairs whose boxes pass the threshold test.
        slabs = s_t.reshape(B, n // 128, 128, 3)
        boxes = nn_cuda.tile_boxes(dst)
        gap = torch.clamp_min(torch.maximum(
            slabs.amin(2)[:, :, None] - boxes[:, None, :, 3:],
            boxes[:, None, :, :3] - slabs.amax(2)[:, :, None]), 0.0)
        live = int(((gap * gap).sum(-1) <= thresh_sq).sum())
        total = B * (n // 128) * boxes.shape[1]
        b_ms, b_by = bound(B * n * 12 + B * CAP * 12 + B * n * 16,
                           [(9 * live * 128 * 256 + 5 * live * 256, PEAK_FP32)])
        rec = dict(name="nn_bounded" if n == CAP else "nn_bounded_sub1024", err=0.0,
                   max_abs_err=abs_err, ms=ms, plain_ms=pms, bound_ms=b_ms,
                   bound_by=b_by, bar="exact within threshold", route="cuda",
                   source="scream_tpu_torch/csrc/nn.cu",
                   replaces="scream_tpu/ops/nn_pallas.py:376",
                   live_share=live / total)
        records.append(rec)

    for r in records:
        log(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
            f"(err {r['err']:.3e}, bar {r['bar']}) | {r['ms']:.4f} ms | plain "
            f"{r['plain_ms']:.4f} ms | bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            + (f" | live tile share {r['live_share']:.3f}" if "live_share" in r else ""))
    return records


def phase_forward(model, batch):
    """The fused-kernel forward against the plain-body forward, same weights,
    both bf16 on the card (24 blocks compound each block's rounding)."""
    import torch

    from scream_tpu_torch.config import ModelConfig
    from scream_tpu_torch.models import PointTransformer
    from scream_tpu_torch.pipeline.register import gt_center_hint, to_device

    plain = PointTransformer(ModelConfig(fused_attention=False), device="cuda")
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


def run_path(model, batches, icp_subsample):
    """register_batch over distinct batches; returns (pairs/s, outputs)."""
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
    pps = B * len(outs) / elapsed
    finite = all(bool(torch.isfinite(x).all()) for m in outs
                 for x in (m.transform, m.re_deg, m.te))
    check(finite, "register_batch: non-finite output")
    check(all(v > 0 for v in counts.values()), f"a kernel was not launched: {counts}")
    check(all(m.transform.shape == (B, 4, 4) for m in outs), "bad output shape")
    re = torch.cat([m.re_deg for m in outs])
    log(f"main path register_batch B={B} cap={CAP} icp_iters={ICP_ITERS} "
        f"icp_subsample={icp_subsample}: {pps:.2f} pairs/s over {len(outs)} batches "
        f"({elapsed / len(outs) * 1e3:.1f} ms/batch) | launches {json.dumps(counts)} | "
        f"all finite | median RE {float(re.median()):.2f} deg (random weights)")
    return pps, counts


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


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    smi = phase_device()

    import torch

    from scream_tpu_torch.config import ModelConfig
    from scream_tpu_torch.models import PointTransformer

    phase_build()
    batches = make_batches(2 * (TIMED_BATCHES + 1) + 1, seed=0)
    model = PointTransformer(ModelConfig(), device="cuda",
                             generator=torch.Generator().manual_seed(0))
    records = phase_kernels(model, batches[-1])
    phase_forward(model, batches[-1])
    pps, counts = run_path(model, batches[:TIMED_BATCHES + 1], None)
    pps_sub, counts_sub = run_path(model, batches[TIMED_BATCHES + 1:-1], ICP_SUB)
    phase_oracle(batches[-1])

    kernels = []
    for r in records:
        if r["name"] == "nn_bounded_sub1024":
            continue
        kernels.append({
            "name": r["name"], "status": "ported, within its bar",
            "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": counts[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        })
    log(json.dumps({"pairs_per_s": pps, "pairs_per_s_icp_subsampled": pps_sub,
                    "launches_icp_subsampled": counts_sub}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
