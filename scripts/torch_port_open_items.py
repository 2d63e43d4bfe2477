"""Two checks of the port against the JAX package on the CPU, on the inputs
of ``chip_smoke.py``'s paths 5 and 9 (a host with JAX; not for the card).

``kitti``: the KITTI protocol with the hint-free KITTI checkpoint and
``center_mode="none"`` on path 5's split tree (``write_split_tree``: 8
pairs of 6,000-8,192 points, extent 40), through the JAX package's
``evaluate kitti`` (``params/kitti-generator-hintfree``) and the port's on
the CPU (``scream_tpu_torch/weights/kitti-generator-hintfree``), each in a
subprocess with the same flags; prints both JSON lines and the success
counts.

``refine``: ``refine_to_map`` of path 9's 16-scan scene (``make_scans``)
with path 9's perturbation (0.03 rad and 0.03 from the true poses, seed
``MW_SEED + 1``) and rounds (2), threshold 0.1, in the JAX package and in
the port on the CPU; prints the largest rotation and translation errors
before and after and their ratios (``tests/test_multiway.py`` asks 0.75 of
both on its own 4-scan scene).

``--package`` runs one side alone, and ``--device cuda`` the port's side
on the card (the kernels, held bit for bit or within their bars to the
CPU path's plain versions): the CPU path's 1,000-step KITTI ICP at 8 x
8,192 and the 30 single-pair ICPs against a 65,536-row map take hours on
a CPU. The JAX side imports the JAX package, so it runs on a host with JAX.

Usage (from the repository root):
    python scripts/torch_port_open_items.py kitti [--package jax|port] [--device cuda]
    python scripts/torch_port_open_items.py refine [--package jax|port] [--device cuda]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kitti(packages, device):
    cs = _chip_smoke()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="open_items_", dir=os.path.join(REPO, "build"))
    cs.write_split_tree(root)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    # The JAX command builds the default model unless told the checkpoint's
    # architecture (its sidecar's); the port's reads it from its sidecar.
    flags = ["evaluate", "kitti", "--root", root, "--center-mode", "none",
             "--max-points", str(cs.KITTI_CAP), "--batch-size", str(cs.EVAL_BATCH),
             "--d-model", "128", "--self-layers", "3", "--cross-layers", "3",
             "--dtype", "float32"]  # the JAX CPU backend runs no bf16 dot
    runs = {"jax": [sys.executable, "-m", "scream_tpu", *flags, "--params",
                    os.path.join("params", "kitti-generator-hintfree")],
            "port": [sys.executable, "-m", "scream_tpu_torch", *flags, "--device", device,
                     "--params", cs.KITTI_HINTFREE]}
    for name in packages:
        cmd = runs[name]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"{name}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"package": name, "device": "cpu" if name == "jax" else device,
                          "seconds": time.perf_counter() - t0,
                          "successes": round(out["success_rate"] * out["n_pairs"]),
                          "result": out}), flush=True)


def refine(packages, device):
    import numpy as np

    cs = _chip_smoke()
    from scream_tpu_torch.data.transforms import rodrigues

    scans, T = cs.make_scans()
    rng = np.random.default_rng(cs.MW_SEED + 1)
    noisy = T.copy()
    for k in range(1, cs.MW_SCANS):
        noisy[k, :3, :3] = (rodrigues(rng.normal(size=3) * cs.MW_PERTURB)
                            @ noisy[k, :3, :3]).astype(np.float32)
        noisy[k, :3, 3] += (rng.normal(size=3) * cs.MW_PERTURB).astype(np.float32)
    before = cs.pose_errors(noisy, T)

    def run(name):
        if name == "port":
            from scream_tpu_torch.pipeline import refine_to_map

            return refine_to_map(scans, noisy, 0.1, rounds=cs.MW_REFINE_ROUNDS, device=device)
        import jax

        jax.config.update("jax_platforms", "cpu")
        from scream_tpu.pipeline import refine_to_map

        return refine_to_map(scans, noisy, 0.1, rounds=cs.MW_REFINE_ROUNDS)

    for name in packages:
        t0 = time.perf_counter()
        after = cs.pose_errors(np.asarray(run(name), np.float32), T)
        print(json.dumps({"package": name, "device": "cpu" if name == "jax" else device,
                          "seconds": time.perf_counter() - t0,
                          "before_deg_t": before, "after_deg_t": after,
                          "ratios": [after[0] / before[0], after[1] / before[1]]}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("check", choices=("kitti", "refine"))
    ap.add_argument("--package", choices=("jax", "port"), default=None,
                    help="run one side only (default both)")
    ap.add_argument("--device", default="cpu", help="the port's device")
    args = ap.parse_args(argv)
    packages = [args.package] if args.package else ["jax", "port"]
    {"kitti": kitti, "refine": refine}[args.check](packages, args.device)


if __name__ == "__main__":
    main()
