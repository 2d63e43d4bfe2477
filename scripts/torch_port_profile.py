#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's paths, on one GPU.

Usage, from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_port_profile.py [--icp-subsample 1024]
    python3 scripts/torch_port_profile.py --gt-free
    python3 scripts/torch_port_profile.py --train
    python3 scripts/torch_port_profile.py --dem

Default: ``register_batch`` at the bench shape (16 pairs x 4,096 points,
full-width model from a seeded random init, 30 ICP iterations). It prints,
for one batch after a warm-up:

* the stage times by CUDA events: forward, pose solve, ICP + metrics;
* the device time of every kernel name under ``torch.profiler`` (summed over
  the batch, largest first) and the device's busy share of the wall time.

``--gt-free``: GT-free serving with the shipped hint-free checkpoint, one
``register_pair(passes=2)`` of a 448-point pair and one ``register_pairs``
batch of 8 such pairs (capacity 512), each profiled the same way after a
warm-up.

``--train``: one GAN training iteration at full width (the 3DMatch preset
with ``use_gan``: 8 pairs x 4,096 points, seeded random generator, the
shipped discriminator): the generator step then the discriminator step,
stage times by CUDA events and the host wall time of one iteration, the
kernel breakdown of the next under the profiler, after a warm-up iteration,
each on its own batch; and the device's busy share of an unprofiled
iteration: the profiled iteration's device time over the unprofiled one's
wall time (the profiler's own per-launch cost inflates its wall).

``--dem``: the same for one OpenGF training iteration at ``chip_smoke.py``
path 4's shape (``opengf_presets()`` at d_model 512: 8 patches of 8,192
DSM/DEM points, coarse capacity 1,024, seeded random init, GAN off): the
``make_dem_train_step`` stages (forward, backward, optimizer), where every
attention block runs the tail kernel.

It writes the profiler tables to ``chiprun_out/torch_port_profile.txt``.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, CAP, N_SRC, N_TGT = 16, 4096, 3840, 4032


def kernel_table(prof, wall_ms, label):
    """Print the device time by kernel name, the busy share of ``wall_ms``
    and the launch count; append the profiler table to the output file.
    Returns the busy time in ms."""
    import torch

    # Kernels only: an operator row's "self" device time repeats the time of
    # kernels launched under it (the ctypes launches sit under _FusedBlock).
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"{label} wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall_ms:.1f} %), {sum(r[1] for r in rows)} kernel launches")
    for ms, count, name in rows[:15]:
        print(f"  {ms:9.3f} ms  {count:5d} x  {name[:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "torch_port_profile.txt"), "a") as f:
        f.write(f"{label}\n")
        f.write(prof.key_averages().table(row_limit=40))
        f.write("\n")
    return busy


def profile_gt_free():
    """register_pair and one register_pairs batch with the hint-free model."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from scream_tpu_torch.data.synthetic import make_pair
    from scream_tpu_torch.models import PointTransformer
    from scream_tpu_torch.pipeline import register_pair, register_pairs
    from scream_tpu_torch.utils.checkpoint import load_params

    cfg, normalize, state = load_params(
        os.path.join("scream_tpu_torch", "weights", "point-generator-hintfree"))
    model = PointTransformer(cfg, device="cuda")
    model.load_state_dict(state)
    model.eval()
    rng = np.random.default_rng(7)
    pairs = [make_pair(rng, n_src=448, n_tgt=448, overlap=0.7, noise=0.0,
                       max_angle=np.deg2rad(30.0)) for _ in range(18)]
    as_pairs = [(p["src"], p["tgt"]) for p in pairs]
    register_pair(model, *as_pairs[0], normalize=normalize)  # warm-up
    register_pairs(model, as_pairs[2:10], normalize=normalize)
    torch.cuda.synchronize()
    print(f"device: {torch.cuda.get_device_name(0)} | GT-free, hint-free d128 checkpoint")
    for label, run in (
            ("register_pair(passes=2) 448 pts",
             lambda: register_pair(model, *as_pairs[1], normalize=normalize)),
            ("register_pairs 8 x 448 pts",
             lambda: register_pairs(model, as_pairs[10:18], normalize=normalize))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            run()  # results come back to the host as numpy
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernel_table(prof, wall_ms, label)


def profile_train():
    """One GAN training iteration (G step + D step) at full width."""
    import torch

    from scream_tpu_torch.config import ModelConfig, RenderConfig, TrainConfig
    from scream_tpu_torch.data import PairLoader, SyntheticPairDataset
    from scream_tpu_torch.models import PointTransformer
    from scream_tpu_torch.pipeline.register import to_device
    from scream_tpu_torch.train import (DiscState, discriminator_optimizer,
                                        generator_optimizer, init_train_state,
                                        make_disc_logit_fn, make_discriminator_step,
                                        make_registration_train_step)
    from scream_tpu_torch.utils.checkpoint import load_discriminator

    b_train = 8
    ds = SyntheticPairDataset(length=3 * b_train, n_src=N_SRC, n_tgt=N_TGT, seed=1)
    batches = [to_device(b, "cuda") for b in
               PairLoader(ds, batch_size=b_train, src_capacity=CAP, num_workers=8)]
    model = PointTransformer(ModelConfig(), device="cuda",
                             generator=torch.Generator().manual_seed(0))
    disc = load_discriminator(os.path.join("scream_tpu_torch", "weights", "discriminator"),
                              "cuda")
    tcfg, rcfg = TrainConfig(use_gan=True), RenderConfig()
    opt, sched = generator_optimizer(model.parameters(), tcfg, steps_per_epoch=1000)
    state = init_train_state(opt, sched)
    gstep = make_registration_train_step(model, use_gan=True,
                                         disc_apply=make_disc_logit_fn(), render_cfg=rcfg)
    dstate = DiscState(disc, discriminator_optimizer(disc.parameters(), tcfg))
    dstep = make_discriminator_step(rcfg)

    def iteration(tb, hook=None):
        nonlocal state, dstate
        state, metrics, fake = gstep(state, tb, disc, hook)
        dstate, d_loss = dstep(dstate, fake, tb["src"], tb["tgt"], tb["src_mask"],
                               tb["tgt_mask"], tb["rot"], tb["trans"])
        if hook is not None:
            hook("d_step")
        return float(metrics["loss"]), float(d_loss)  # losses to the host

    profile_iteration(iteration, batches,
                      f"GAN training iteration, {b_train} x {CAP}, full width",
                      "GAN training iteration (G step + D step)")


def profile_iteration(iteration, batches, title, label):
    """``iteration(batch, hook)`` once per batch: a warm-up on the first,
    stage times by CUDA events and the host wall time on the second, the
    kernel breakdown under the profiler on the third; then the device's busy
    share of the unprofiled iteration."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    iteration(batches[0])  # warm-up
    events = [("start", torch.cuda.Event(enable_timing=True))]
    events[0][1].record()

    def hook(name):
        events.append((name, torch.cuda.Event(enable_timing=True)))
        events[-1][1].record()

    t0 = time.perf_counter()
    iteration(batches[1], hook)  # ends with the losses on the host
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    print(f"device: {torch.cuda.get_device_name(0)} | {title}")
    print("stages (ms, CUDA events): " + ", ".join(
        f"{n} {a.elapsed_time(b):.2f}" for (_, a), (n, b) in zip(events, events[1:])))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        iteration(batches[2])
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = kernel_table(prof, wall_ms, label)
    print(f"unprofiled iteration wall {plain_wall_ms:.2f} ms: device busy share "
          f"{100 * busy / plain_wall_ms:.1f} % (profiled device time over it)")


def profile_dem():
    """One OpenGF training iteration at d_model 512 (chip_smoke.py path 4)."""
    import dataclasses

    import numpy as np
    import torch

    from scream_tpu_torch.config import opengf_presets
    from scream_tpu_torch.data import collate_dem, make_dem_patch
    from scream_tpu_torch.models import DEMTransformer
    from scream_tpu_torch.pipeline.register import to_device
    from scream_tpu_torch.train import (generator_optimizer, init_train_state,
                                        make_dem_train_step)

    b_train, cap, coarse = 8, 8192, 1024
    model_cfg, tcfg, _, _ = opengf_presets()
    model_cfg = dataclasses.replace(model_cfg, d_model=512)
    rng = np.random.default_rng(11)
    batches = [to_device(collate_dem([make_dem_patch(rng, n_dsm=cap, n_dem=cap)
                                      for _ in range(b_train)], cap, cap, coarse), "cuda")
               for _ in range(3)]
    model = DEMTransformer(model_cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    opt, sched = generator_optimizer(model.parameters(), tcfg, steps_per_epoch=1000)
    state = init_train_state(opt, sched)
    step = make_dem_train_step(model)

    def iteration(tb, hook=None):
        nonlocal state
        state, metrics, _ = step(state, tb, None, hook)
        return float(metrics["loss"])  # the loss to the host

    profile_iteration(iteration, batches,
                      f"OpenGF training iteration, {b_train} x {cap} (coarse {coarse}), "
                      "d_model 512", "OpenGF training iteration (G step, d 512)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--icp-subsample", type=int, default=None)
    ap.add_argument("--gt-free", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--dem", action="store_true")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from scream_tpu_torch.config import ModelConfig
    from scream_tpu_torch.data import PairLoader, SyntheticPairDataset
    from scream_tpu_torch.geometry.icp import icp_refine_if_better
    from scream_tpu_torch.models import PointTransformer
    from scream_tpu_torch.pipeline import register as reg

    if not torch.cuda.is_available():
        raise SystemExit("torch_port_profile: needs a CUDA GPU")
    if args.gt_free:
        profile_gt_free()
        return
    if args.train:
        profile_train()
        return
    if args.dem:
        profile_dem()
        return
    ds = SyntheticPairDataset(length=3 * B, n_src=N_SRC, n_tgt=N_TGT, seed=1)
    batches = list(PairLoader(ds, batch_size=B, src_capacity=CAP, num_workers=8))
    model = PointTransformer(ModelConfig(), device="cuda",
                             generator=torch.Generator().manual_seed(0))
    kw = dict(icp_subsample=args.icp_subsample, device="cuda")
    reg.register_batch(model, batches[0], **kw).transform.cpu()  # warm-up

    # Stage times by CUDA events on the second batch.
    b = reg.to_device(batches[1], "cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.no_grad():
        ev[0].record()
        center = reg.gt_center_hint(b["rot"], b["trans"])
        pred = model(b["src"], b["tgt"], b["src_mask"], b["tgt_mask"], center)
        ev[1].record()
        sol = reg.solve_pose(b["src"], pred.float(), b["tgt"], b["src_mask"],
                             b["tgt_mask"], b["scale"], b["center"])
        ev[2].record()
        gt_T = reg.denormalized_gt(b["rot"], b["trans"], b["scale"], b["center"])
        inv_s = (1.0 / b["scale"])[:, None, None]
        src_dn = b["src"] * inv_s + b["center"][:, None, :]
        tgt_dn = b["tgt"] * inv_s + b["center"][:, None, :]
        sm = b["src_mask"]
        if args.icp_subsample:
            idx = torch.as_tensor(reg.spread_subsample_indices(CAP, args.icp_subsample),
                                  device="cuda").long()
            src_dn, sm = src_dn[:, idx], sm[:, idx]
        icp_refine_if_better(src_dn, tgt_dn, sol.transform, gt_T, 0.1,
                             src_mask=sm, tgt_mask=b["tgt_mask"])
        ev[3].record()
    torch.cuda.synchronize()
    stages = dict(forward=ev[0].elapsed_time(ev[1]), solve=ev[1].elapsed_time(ev[2]),
                  icp=ev[2].elapsed_time(ev[3]))
    print(f"device: {torch.cuda.get_device_name(0)} | icp_subsample={args.icp_subsample}")
    print("stages (ms, CUDA events): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))

    # Kernel breakdown of one whole register_batch on the third batch.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        reg.register_batch(model, batches[2], **kw).transform.cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernel_table(prof, wall_ms, f"register_batch icp_subsample={args.icp_subsample}")


if __name__ == "__main__":
    main()
