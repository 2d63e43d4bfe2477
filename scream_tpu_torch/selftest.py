"""On-card kernel selftest: the Hopper kernels against their plain PyTorch
versions (port of ``scream_tpu/selftest.py``, which holds the compiled
Pallas kernels to the XLA paths on the TPU).

    python -m scream_tpu_torch selftest

builds the kernels (``scream_tpu_torch/csrc``) if this tree has no library
yet, runs every check on the first CUDA device, prints one JSON line with
each check's error beside the bar of ``SELFTEST_TPU.json``'s run, and exits
nonzero on any miss. Without a CUDA device it prints ``{"ok": false,
"error": ...}`` and exits nonzero: it has no CPU mode (the CPU tests hold
the plain versions to the JAX package).

The checks: the exact NN (masked and unmasked), the bounded NN (exact within
the threshold), ICP on the bounded kernel against the same ICP on the CPU
path (the plain version), chunked against continuous batched ICP and each
batched lane against the single-pair loop, the splat forward and its VJP,
the bf16 tail and fused block with their gradients, the fp32 stats, apply
and tail, and the head-generic pair (``csrc/attn_heads*.cu``): the bf16
block at 2 heads of 128, the fp32 stats and apply at 32 heads of 8.
"""

from __future__ import annotations

import json
import sys
from typing import Dict

import numpy as np


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _rel(a, b, rows=None) -> float:
    a, b = a.float(), b.float()
    if rows is not None:
        a, b = a[rows], b[rows]
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _nn_checks(out: Dict, rng, dev):
    """The exact and bounded NN; returns the bounded check's clouds, which
    the ICP checks reuse."""
    import torch

    from scream_tpu_torch.ops import nn_cuda

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    src, dst = t(rng.standard_normal((2000, 3)))[None], t(rng.standard_normal((3000, 3)))[None]
    mask = torch.as_tensor(rng.random(3000) > 0.1, device=dev)[None]
    for name, m in (("nn", mask), ("nn_unmasked", None)):
        far = nn_cuda.mask_far(dst, m)
        d, i = nn_cuda.nn_exact(src, far)
        dp, ip = nn_cuda.nn_exact_plain(src, far)
        out[f"{name}_{'dist_' if m is not None else ''}max_err"] = _max_err(d, dp)
        out[f"{name}_idx_mismatches"] = int((i != ip).sum())

    # The bounded NN on voxel-sorted clouds (pruning fires as on real ones).
    def sorted_cloud():
        p = rng.random((2048, 3)) * 3.0
        key = np.floor(p / 0.2)
        return p[np.lexsort((key[:, 2], key[:, 1], key[:, 0]))]

    sb, db = t(sorted_cloud()), t(sorted_cloud())
    bd, _ = nn_cuda.nn_bounded_single(sb[None], db[None].contiguous(), 0.01)
    bmin, _ = nn_cuda.nn_exact_plain(sb[None], db[None].contiguous())
    inl = bmin[0] <= 0.01
    out["bounded_nn_inliers"] = int(inl.sum())
    out["bounded_nn_max_err"] = float(((bd[0] - bmin[0]).abs() * inl).max())
    out["bounded_nn_bound_ok"] = bool((bd[0][~inl] > 0.01).all())
    return sb, db


def _icp_checks(out: Dict, rng, dev, sb, db) -> None:
    import torch

    from scream_tpu_torch.geometry.icp import registration_icp, registration_icp_batched

    T0 = torch.eye(4, device=dev)
    T0[:3, 3] = torch.tensor([0.05, -0.03, 0.02], device=dev)
    res = registration_icp(sb, db, 0.1, init=T0, max_iteration=10)
    out["bounded_icp_finite"] = bool(torch.isfinite(res.transformation).all())
    out["bounded_icp_iterations"] = int(res.iterations)
    # The same ICP on the CPU path: the bounded kernel's plain version.
    res_cpu = registration_icp(sb.cpu(), db.cpu(), 0.1, init=T0.cpu(), max_iteration=10)
    out["bounded_icp_transform_max_err"] = _max_err(res.transformation.cpu(),
                                                    res_cpu.transformation)

    # Chunked (retire + power-of-two regroup) against the continuous loop,
    # two lanes with different noise so that they converge apart.
    noise = torch.as_tensor(rng.standard_normal((1024, 3)) * 0.01, dtype=torch.float32,
                            device=dev)
    sb2 = torch.stack([sb[:1024], sb[:1024]])
    db2 = torch.stack([db[:1024], db[:1024] + noise])
    T02 = torch.stack([T0, T0])
    cont = registration_icp_batched(sb2, db2, 0.1, init=T02, max_iteration=12)
    cont1 = registration_icp_batched(sb2, db2, 0.1, init=T02, max_iteration=1)
    chnk = registration_icp_batched(sb2, db2, 0.1, init=T02, max_iteration=12, chunk=4)
    out["chunked_icp_transform_max_err"] = _max_err(cont.transformation, chnk.transformation)
    out["chunked_icp_iter_max_diff"] = int((cont.iterations - chnk.iterations).abs().max())
    # Each batched lane against the single-pair loop: one step within 1e-5
    # (a packing or dead-lane fault is orders larger), whole trajectories
    # within 2e-2 (one threshold-boundary Kabsch weight can flip).
    step_err, traj_err, iter_diff = 0.0, 0.0, 0
    for lane in range(2):
        one = registration_icp(sb2[lane], db2[lane], 0.1, init=T02[lane], max_iteration=1)
        step_err = max(step_err, _max_err(cont1.transformation[lane], one.transformation))
        per = registration_icp(sb2[lane], db2[lane], 0.1, init=T02[lane], max_iteration=12)
        traj_err = max(traj_err, _max_err(cont.transformation[lane], per.transformation))
        iter_diff = max(iter_diff, abs(int(cont.iterations[lane]) - int(per.iterations)))
    out["batched_icp_step_max_err"] = step_err
    out["batched_icp_transform_max_err"] = traj_err
    out["batched_icp_iter_max_diff"] = iter_diff


def _splat_checks(out: Dict, rng, dev) -> None:
    import torch

    from scream_tpu_torch.ops.render import render_depth_images

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    sp, tp = t(rng.uniform(-0.9, 0.9, (2, 500, 3))), t(rng.uniform(-0.9, 0.9, (2, 600, 3)))
    render = lambda pts, kernel: render_depth_images(pts, tp, rho=24.0, width=64,
                                                     use_pallas=kernel)
    out["splat_max_err"] = _max_err(render(sp, True), render(sp, False))

    # The VJP: the kernel's argmax-routed backward against autograd through
    # the plain renderer, relative to the gradient's scale (rho^2 = 576).
    def grad(kernel):
        pts = sp.clone().requires_grad_(True)
        img = render(pts, kernel)
        w = torch.cos(torch.arange(img.numel(), device=dev, dtype=torch.float32)
                      .reshape(img.shape) * 0.01)
        return torch.autograd.grad((img * w).sum(), pts)[0]

    ga, gb = grad(True), grad(False)
    out["splat_grad_max_err"] = _max_err(ga, gb)
    out["splat_grad_scale"] = float(gb.abs().max())
    out["splat_grad_rel_err"] = out["splat_grad_max_err"] / max(out["splat_grad_scale"], 1e-30)


def _block_checks(out: Dict, rng, dev) -> None:
    """The bf16 tail and fused block against their plain versions, forward
    and gradients; then the fp32 stats, apply and tail; then the
    head-generic pair at head counts no head-specific kernel takes."""
    import torch

    from scream_tpu_torch.ops import attn_cuda, tail_cuda
    from scream_tpu_torch.ops.ffn import tail_plain

    bf, f32 = torch.bfloat16, torch.float32
    t = lambda a, dt=f32: torch.as_tensor(np.asarray(a, np.float32), device=dev).to(dt)
    d, hid = 256, 1024
    xt, qt = t(rng.standard_normal((2, 512, d)), bf), t(rng.standard_normal((2, 512, d)), bf)
    wargs = (t(rng.standard_normal((d, d)) / 16), t(rng.uniform(0.5, 1.5, (d,))),
             t(rng.standard_normal((d,)) * 0.1), t(rng.standard_normal((d, hid)) / 16),
             t(rng.standard_normal((hid, d)) / 32), t(rng.uniform(0.5, 1.5, (d,))),
             t(rng.standard_normal((d,)) * 0.1))

    def tails(cd):
        kern = lambda a, q: tail_cuda.block_tail(a, q, *wargs, dtype=cd, norm_dtype=f32)
        plain = lambda a, q: tail_plain(a, q, *wargs, cd=cd, nd=f32, eps=1e-5)
        return kern, plain

    kern, plain = tails(bf)
    with torch.no_grad():
        tf, tx = kern(xt, qt), plain(xt, qt)
    out["fused_tail_max_err"] = _max_err(tf, tx)
    out["fused_tail_rel_err"] = _rel(tf, tx)

    def tail_grad(fn):
        x = xt.clone().requires_grad_(True)
        return torch.autograd.grad(fn(x, qt).float().square().sum(), x)[0]

    gt_f, gt_x = tail_grad(kern), tail_grad(plain)
    out["fused_tail_grad_rel_err"] = _rel(gt_f, gt_x)

    # The fused attention block (stats over xb, apply over xa: cross
    # attention, masked rows in both) against the literal plain block.
    xa = t(rng.standard_normal((2, 500, d)) * 0.1)
    xb = t(rng.standard_normal((2, 300, d)) * 0.1)
    qm = torch.as_tensor(rng.random((2, 500)) > 0.15, device=dev)
    km = torch.as_tensor(rng.random((2, 300)) > 0.15, device=dev)
    aw = (t(rng.standard_normal((d, d)) / 16), t(rng.standard_normal((d, d)) / 16),
          t(rng.standard_normal((d, d)) / 16)) + wargs

    def block(x, fused, cd=bf, heads=8):
        if fused:
            return attn_cuda.attention_block_fused(x, xb, qm, km, *aw, num_heads=heads,
                                                   dtype=cd, norm_dtype=f32)
        return attn_cuda.block_plain(x, xb, qm, km, *aw, num_heads=heads, cd=cd, nd=f32,
                                     attn_eps=1e-6, ln_eps=1e-5)

    with torch.no_grad():
        af, ax = block(xa, True), block(xa, False)
    out["fused_attn_max_err"] = _max_err(af[qm], ax[qm])
    out["fused_attn_rel_err"] = _rel(af, ax, rows=qm)
    proj = t(rng.standard_normal(tuple(xa.shape)))

    def attn_grad(fused):
        x = xa.clone().requires_grad_(True)
        y = block(x, fused).float() * proj
        return torch.autograd.grad(torch.where(qm[..., None], y, 0.0).sum(), x)[0]

    out["fused_attn_grad_rel_err"] = _rel(attn_grad(True), attn_grad(False))

    # fp32: stats and apply (fed the plain stats) of the fused block, and
    # the tail, each against its plain version.
    c32 = [w.float().contiguous() for w in aw]
    Wq, Wk, Wv, Wm, g1, b1, W1, W2, g2, b2 = c32
    mkv, mq = km.float(), qm.float()
    KV, ks = attn_cuda.attn_stats(xb, mkv, Wk, Wv, num_heads=8)
    KVp, ksp = attn_cuda.attn_stats_plain(xb, mkv, Wk, Wv, num_heads=8)
    out["f32_stats_rel_err"] = max(_rel(KV, KVp), _rel(ks, ksp))
    args = (xa, mq, KVp, ksp, Wq, Wm, g1, b1, W1, W2, g2, b2)
    kw = dict(attn_eps=1e-6, ln_eps=1e-5, norm_dtype=f32)
    out["f32_apply_rel_err"] = _rel(attn_cuda.attn_apply(*args, **kw),
                                    attn_cuda.attn_apply_plain(*args, **kw), rows=qm)
    kern, plain = tails(f32)
    with torch.no_grad():
        out["f32_tail_rel_err"] = _rel(kern(xt.float(), qt.float()),
                                       plain(xt.float(), qt.float()))

    # The head-generic pair: the bf16 block at 2 heads of 128; the fp32
    # stats and apply at 32 heads of 8.
    with torch.no_grad():
        out["heads_attn_rel_err"] = _rel(block(xa, True, heads=2), block(xa, False, heads=2),
                                         rows=qm)
    KV, ks = attn_cuda.attn_stats(xb, mkv, Wk, Wv, num_heads=32)
    KVp, ksp = attn_cuda.attn_stats_plain(xb, mkv, Wk, Wv, num_heads=32)
    out["heads_f32_stats_rel_err"] = max(_rel(KV, KVp), _rel(ks, ksp))
    args = (xa, mq, KVp, ksp, Wq, Wm, g1, b1, W1, W2, g2, b2)
    out["heads_f32_apply_rel_err"] = _rel(attn_cuda.attn_apply(*args, **kw),
                                          attn_cuda.attn_apply_plain(*args, **kw), rows=qm)


# Each check's bar: SELFTEST_TPU.json's (the JAX selftest's), and the fp32
# kernels' bars of the port's card checks (chip_smoke.py FP32_BARS).
BARS = {
    "nn_dist_max_err": 1e-4, "nn_idx_mismatches": 0,
    "nn_unmasked_max_err": 1e-4, "nn_unmasked_idx_mismatches": 0,
    "bounded_nn_max_err": 1e-4, "bounded_icp_transform_max_err": 1e-3,
    "chunked_icp_transform_max_err": 1e-4, "chunked_icp_iter_max_diff": 1,
    "batched_icp_step_max_err": 1e-5, "batched_icp_transform_max_err": 2e-2,
    "batched_icp_iter_max_diff": 1, "splat_max_err": 1e-4, "splat_grad_rel_err": 1e-3,
    "fused_tail_rel_err": 3e-2, "fused_tail_grad_rel_err": 3e-2,
    "fused_attn_rel_err": 5e-2, "fused_attn_grad_rel_err": 5e-2,
    "f32_stats_rel_err": 1e-5, "f32_apply_rel_err": 2e-5, "f32_tail_rel_err": 2e-5,
    "heads_attn_rel_err": 5e-2, "heads_f32_stats_rel_err": 1e-5,
    "heads_f32_apply_rel_err": 2e-5,
}
# Counts that meet their bar at equality; errors must stay below theirs.
_AT_MOST = ("nn_idx_mismatches", "nn_unmasked_idx_mismatches", "chunked_icp_iter_max_diff",
            "batched_icp_iter_max_diff")


def run_checks(device) -> Dict:
    """Every check's result on ``device``: on the card kernel against plain
    version; on the CPU both sides are the plain version (the wrappers'
    route for CPU tensors), which exercises the checks themselves."""
    import torch

    out: Dict = {}
    rng = np.random.default_rng(0)
    dev = torch.device(device)
    _icp_checks(out, rng, dev, *_nn_checks(out, rng, dev))
    _splat_checks(out, rng, dev)
    _block_checks(out, rng, dev)
    return out


def run_selftest() -> Dict:
    import torch

    out: Dict = {"ok": False}
    if not torch.cuda.is_available():
        out["error"] = "selftest needs a CUDA device; torch.cuda.is_available() is False"
        return out
    out["device"] = torch.cuda.get_device_name(0)
    out.update(run_checks("cuda"))
    misses = [k for k, bar in BARS.items()
              if not (out[k] <= bar if k in _AT_MOST else out[k] < bar)]
    flags = [k for k in ("bounded_nn_bound_ok", "bounded_icp_finite") if not out[k]]
    out["misses"] = misses + flags
    out["ok"] = not out["misses"]
    return out


def _json_safe(obj):
    """NaN/Inf floats would break the one-JSON-line output (json.dumps
    emits the non-standard tokens NaN/Infinity): stringify them."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, float) and not np.isfinite(obj):
        return repr(obj)
    return obj


def main() -> int:
    # Whatever happens, one parseable JSON line: a kernel that does not
    # build or launch is a failed selftest, reported as such.
    try:
        out = run_selftest()
    except Exception as e:  # nvcc failure, launch error, ...
        out = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    print(json.dumps(_json_safe(out)))
    return 0 if out.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
