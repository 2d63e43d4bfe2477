"""Does a pair's result depend on the batch it runs in? The data-parallel
path (``parallel/``) runs each rank's rows of a batch, so a pair that a
single process registers in a batch of 16 runs in a batch of 8 on a rank of
two. This script runs ``register_batch``'s stages on a batch of 16 pairs at
4,096 points (``chip_smoke.py`` path 1's shape and weights) once whole and
once as its two halves, feeding every stage the same inputs in both runs,
and prints, stage by stage, the largest difference between the whole and
the halves (0 = bit for bit):

    python3 scripts/torch_port_mesh_bits.py [--device cuda] [--batch 16]

The stages: the embed, each attention block, the head (``src_pred``), the
exact NN, Kabsch (its H products, the SVD, the transform), the pose solve,
ICP, the metrics, ``register_batch`` whole, and ``register_pairs`` (the
hint-free checkpoint) in dispatches of the batch and of half; then other
formulations of the sums over points and
of the dense layers, as batched products (``*_bmm``) beside the present
ones. One JSON line.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scream_tpu_torch.data import PairLoader, SyntheticPairDataset  # noqa: E402
from scream_tpu_torch.geometry.icp import registration_icp_batched  # noqa: E402
from scream_tpu_torch.geometry.kabsch import kabsch  # noqa: E402
from scream_tpu_torch.geometry.metrics import transformation_error  # noqa: E402
from scream_tpu_torch.ops.nn_cuda import nearest_neighbor_full  # noqa: E402
from scream_tpu_torch.pipeline.register import (denormalized_gt,  # noqa: E402
                                                gt_center_hint, register_batch,
                                                register_pairs, solve_pose, to_device)
from scream_tpu_torch.utils.checkpoint import load_params  # noqa: E402
from scream_tpu_torch.models import PointTransformer  # noqa: E402

WEIGHTS = os.path.join("scream_tpu_torch", "weights", "point-generator")
HINTFREE = os.path.join("scream_tpu_torch", "weights", "point-generator-hintfree")


def diff(whole, halves):
    """Largest |whole - cat(halves)| over the batch axis (0 = same bits)."""
    if isinstance(whole, (tuple, list)):
        return max(diff(w, [h[i] for h in halves]) for i, w in enumerate(whole))
    cat = torch.cat(halves)
    return float((whole.float() - cat.float()).abs().max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--points", type=int, default=4096)
    a = ap.parse_args()
    dev = torch.device(a.device)
    cfg, _, state = load_params(WEIGHTS)
    model = PointTransformer(cfg, device=dev)
    model.load_state_dict(state)
    model.eval()
    n = a.points
    ds = SyntheticPairDataset(length=a.batch, n_src=n * 15 // 16, n_tgt=n * 63 // 64, seed=0)
    batch = to_device(next(iter(PairLoader(ds, a.batch, n, n, num_workers=0))), dev)
    h = a.batch // 2
    parts = [{k: v[:h] for k, v in batch.items()}, {k: v[h:] for k, v in batch.items()}]
    out = {}

    @torch.no_grad()
    def stages(b):
        trunk = model.trunk
        center = gt_center_hint(b["rot"], b["trans"], "trans")
        feats = trunk.embed(b["src"], b["tgt"], center)
        res = {"embed": feats}
        src_f, tgt_f = feats
        sm, tm = b["src_mask"], b["tgt_mask"]
        for i in range(cfg.self_layers):
            blk = getattr(trunk, f"stem_{i}")
            tgt_f = blk(tgt_f, tgt_f, tgt_f, tm, tm)
            src_f = blk(src_f, src_f, src_f, sm, sm)
            res[f"stem_{i}"] = (src_f, tgt_f)
        for i in range(cfg.cross_layers):
            src_f = getattr(trunk, f"cross_self_{i}")(src_f, src_f, src_f, sm, sm)
            src_f = getattr(trunk, f"cross_attn_{i}")(src_f, tgt_f, tgt_f, sm, tm)
            res[f"cross_{i}"] = src_f
        res["head"] = trunk.head(src_f)
        return res

    whole, halves = stages(batch), [stages(p) for p in parts]
    for k in whole:
        out[k] = diff(whole[k], [hv[k] for hv in halves])

    # Every later stage gets the whole run's inputs, cut in two.
    src_pred = whole["head"].float()
    cut = lambda t: [t[:h], t[h:]]
    inv_s = (1.0 / batch["scale"])[:, None, None]
    with torch.no_grad():
        nn_w = nearest_neighbor_full(src_pred * inv_s, batch["tgt"] * inv_s, batch["tgt_mask"])
        nn_h = [nearest_neighbor_full(p * s, t * s, m) for p, s, t, m in zip(
            cut(src_pred), cut(inv_s), cut(batch["tgt"]), cut(batch["tgt_mask"]))]
        out["nn_exact"] = diff(nn_w, nn_h)
        A = torch.randn(a.batch, n, 3, generator=torch.Generator().manual_seed(1)).to(dev)
        Bm = A @ torch.linalg.qr(torch.randn(3, 3))[0].to(dev) + 0.01
        w = (torch.rand(a.batch, n, generator=torch.Generator().manual_seed(2)) > 0.3
             ).float().to(dev)
        H_w = (A * w[..., None]).transpose(-1, -2) @ Bm
        out["kabsch_H_bmm"] = diff(H_w, [(x * y[..., None]).transpose(-1, -2) @ z
                                         for x, y, z in zip(cut(A), cut(w), cut(Bm))])
        out["kabsch_sum"] = diff((A * w[..., None]).sum(-2), [(x * y[..., None]).sum(-2)
                                                             for x, y in zip(cut(A), cut(w))])
        out["svd"] = diff(torch.linalg.svd(H_w)[0], [torch.linalg.svd(x)[0] for x in cut(H_w)])
        out["kabsch"] = diff(kabsch(A, Bm, w), [kabsch(x, y, z) for x, y, z in
                                                 zip(cut(A), cut(Bm), cut(w))])
        sol_w = solve_pose(batch["src"], src_pred, batch["tgt"], batch["src_mask"],
                           batch["tgt_mask"], batch["scale"], batch["center"])
        sol_h = [solve_pose(*args) for args in zip(*(cut(batch[k]) if k != "pred" else
                                                     cut(src_pred) for k in (
            "src", "pred", "tgt", "src_mask", "tgt_mask", "scale", "center")))]
        out["solve_pose"] = diff(sol_w.transform, [s.transform for s in sol_h])
        src_dn = batch["src"] * inv_s + batch["center"][:, None, :]
        tgt_dn = batch["tgt"] * inv_s + batch["center"][:, None, :]
        icp = lambda s, t, T, sm, tm: registration_icp_batched(
            s, t, 0.1, init=T, max_iteration=30, src_mask=sm, tgt_mask=tm).transformation
        T0 = sol_w.transform
        out["icp"] = diff(icp(src_dn, tgt_dn, T0, batch["src_mask"], batch["tgt_mask"]),
                          [icp(*x) for x in zip(cut(src_dn), cut(tgt_dn), cut(T0),
                                                cut(batch["src_mask"]),
                                                cut(batch["tgt_mask"]))])
        gt = denormalized_gt(batch["rot"], batch["trans"], batch["scale"], batch["center"])
        out["metrics"] = diff(transformation_error(T0, gt),
                              [transformation_error(x, y) for x, y in zip(cut(T0), cut(gt))])

        # Formulations whose bits could not depend on the batch: the point
        # sums as batched products, the dense layers as batched products.
        out["centroid_bmm"] = diff(w[:, None, :] @ A, [y[:, None, :] @ x
                                                      for x, y in zip(cut(A), cut(w))])
        d2 = torch.rand(a.batch, n, generator=torch.Generator().manual_seed(3)).to(dev)
        out["rmse_sum"] = diff((d2 * w).sum(-1), [(x * y).sum(-1)
                                                  for x, y in zip(cut(d2), cut(w))])
        out["rmse_bmm"] = diff(d2[:, None, :] @ w[:, :, None],
                               [x[:, None, :] @ y[:, :, None] for x, y in zip(cut(d2), cut(w))])
        feats = whole["cross_5"] if "cross_5" in whole else src_pred
        for name, lay in (("head_0", model.trunk.head_0), ("head_out", model.trunk.head_out)):
            dt = torch.float32 if name == "head_out" else cfg.compute_dtype
            W, bias = lay.kernel.to(dt), lay.bias.to(dt)
            x = feats.to(dt)
            out[f"{name}_mm"] = diff(x @ W + bias, [y @ W + bias for y in cut(x)])
            bmm = lambda y: y @ W.expand(y.shape[0], *W.shape) + bias
            out[f"{name}_bmm"] = diff(bmm(x), [bmm(y) for y in cut(x)])
    with torch.no_grad():
        rb = lambda b: register_batch(model, b, device=dev)
        m_w = rb(batch)
        m_h = [rb(p) for p in parts]
        out["register_batch"] = diff((m_w.transform, m_w.re_deg, m_w.te),
                                     [(m.transform, m.re_deg, m.te) for m in m_h])
        # GT-free serving: the same pairs in dispatches of the batch and of half.
        hf_cfg, normalize, hf_state = load_params(HINTFREE)
        hf = PointTransformer(hf_cfg, device=dev)
        hf.load_state_dict(hf_state)
        hf.eval()
        pairs = [(s_[:m_].numpy(), t_[:k_].numpy()) for s_, t_, m_, k_ in zip(
            batch["src"].cpu(), batch["tgt"].cpu(), batch["src_mask"].sum(-1).cpu(),
            batch["tgt_mask"].sum(-1).cpu())]
        T = lambda bs: torch.as_tensor(np.stack([r.transform for r in register_pairs(
            hf, pairs, normalize=normalize, batch_size=bs, device=dev)]))
        out["register_pairs"] = diff(T(a.batch), [T(h)])
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    print(json.dumps({"device": name, "batch": a.batch, "points": n, "whole_vs_halves": out}))


if __name__ == "__main__":
    main()
