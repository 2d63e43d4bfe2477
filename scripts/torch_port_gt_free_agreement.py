#!/usr/bin/env python3
"""Per-pair agreement of GT-free ``register_pair(passes=2)`` between the
card and the CPU path, on the 16 pairs ``chip_smoke.py`` path 2 gates.

Usage, on a machine with an NVIDIA GPU:

    python3 scripts/torch_port_gt_free_agreement.py [TREE]

or, on any host, the CPU path's own sensitivity:

    python3 scripts/torch_port_gt_free_agreement.py --cpu-noise EPS [--draws N]

``TREE`` (default: this checkout) is the root of the tree to evaluate, for
example an unpacked ``git archive`` of another commit, so that two commits
can be compared on one card in one call. For each pair it prints the
forward's relative error (the card's fused kernels against the CPU path's
plain route, max |err| over max |ref| on the valid source rows), the
largest transform difference (the quantity ``chip_smoke.py`` holds to 0.05
on all but 2 of 16 pairs), RE against the ground truth and ICP fitness on
both; then how many pairs differ by more than 0.05.

``--cpu-noise EPS``: no card. The CPU path's transforms and RE, then ``N``
draws (seeds 1..N) in which the model's output is multiplied by
``1 + EPS * n``, ``n`` standard normal per element: how many pairs each
draw moves beyond 0.05, and which. It shows how far a perturbation of the
forward's size moves the gate's count. It gates nothing.
"""

import os
import sys


def cpu_noise(eps, draws):
    import numpy as np
    import torch

    import chip_smoke as cs
    from scream_tpu_torch.geometry.metrics import transformation_error
    from scream_tpu_torch.pipeline import register_pair

    model, normalize = cs.load_hintfree("cpu")
    pairs = cs.make_gt_free_pairs(cs.GT_FREE_PAIRS, cs.GT_FREE_POINTS, cs.GT_FREE_SEED)
    gt = torch.as_tensor(np.stack([cs.gt_transform(p) for p in pairs]))
    run = lambda: np.stack([register_pair(model, p["src"], p["tgt"], normalize=normalize,
                                          passes=2, device="cpu").transform for p in pairs])
    base = run()
    re = transformation_error(torch.as_tensor(base), gt)[0]
    print("CPU path RE (deg): " + ", ".join(f"{float(x):.2f}" for x in re), flush=True)
    forward = model.forward
    for seed in range(1, draws + 1):
        g = torch.Generator().manual_seed(seed)

        def noisy(*a, **k):
            out = forward(*a, **k)
            return out * (1 + eps * torch.randn(out.shape, generator=g)).to(out.dtype)

        model.forward = noisy
        got = run()
        model.forward = forward
        diff = np.abs(got - base).reshape(len(pairs), -1).max(1)
        far = [i for i, d in enumerate(diff) if d > cs.TRANSFORM_TOL]
        print(f"noise {eps:g}, draw {seed}: {len(far)} of {len(pairs)} transforms beyond "
              f"{cs.TRANSFORM_TOL} (pairs {far}), max {diff.max():.4f}", flush=True)


def main():
    args = sys.argv[1:]
    if args[:1] == ["--cpu-noise"]:
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        draws = int(args[args.index("--draws") + 1]) if "--draws" in args else 4
        return cpu_noise(float(args[1]), draws)
    root = os.path.abspath(args[0] if args else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from scream_tpu_torch.geometry.metrics import transformation_error
    from scream_tpu_torch.pipeline import register as reg
    from scream_tpu_torch.pipeline import register_pair

    if not torch.cuda.is_available():
        raise SystemExit("torch_port_gt_free_agreement: needs a CUDA GPU")
    card, normalize = cs.load_hintfree("cuda")
    cpu, _ = cs.load_hintfree("cpu")
    pairs = cs.make_gt_free_pairs(cs.GT_FREE_PAIRS, cs.GT_FREE_POINTS, cs.GT_FREE_SEED)
    rows = []
    for p in pairs:
        preds = []
        for model, dev in ((card, "cuda"), (cpu, "cpu")):
            b = reg._normalized_batch([(p["src"], p["tgt"])], normalize, 512, dev)
            with torch.no_grad():
                preds.append(model(b["src"], b["tgt"], b["src_mask"], b["tgt_mask"],
                                   None).float().cpu()[0][b["src_mask"][0].cpu()])
        fwd = float((preds[0] - preds[1]).abs().max() / preds[1].abs().max())
        res = [register_pair(m, p["src"], p["tgt"], normalize=normalize, passes=2, device=d)
               for m, d in ((card, "cuda"), (cpu, "cpu"))]
        rows.append((fwd, res))
    gt = torch.as_tensor(np.stack([cs.gt_transform(p) for p in pairs]))
    re = [transformation_error(torch.as_tensor(np.stack([r[1][k].transform for r in rows])),
                               gt)[0] for k in (0, 1)]
    far = 0
    for i, (fwd, (rc, rp)) in enumerate(rows):
        diff = float(np.abs(rc.transform - rp.transform).max())
        far += diff > cs.TRANSFORM_TOL
        print(f"pair {i:2d}: forward rel err {fwd:.3e} | transform diff {diff:.4f} | RE card "
              f"{float(re[0][i]):.2f} CPU {float(re[1][i]):.2f} deg | fitness card "
              f"{rc.fitness:.4f} CPU {rp.fitness:.4f}")
    fwds = [r[0] for r in rows]
    print(f"{root}: {far} of {len(rows)} transforms beyond {cs.TRANSFORM_TOL}; forward rel "
          f"err median {np.median(fwds):.3e}, max {max(fwds):.3e} | "
          f"{torch.cuda.get_device_name(0)}", flush=True)


if __name__ == "__main__":
    main()
