#!/usr/bin/env python3
"""How much of the 5e-2 bar of ``chip_smoke.py`` path 12 (a) the head count
takes. Path 12 (a) holds a seeded random-init ``ModelConfig(num_heads=2)``
(d 256, 6 + 6 layers, bf16) forward through the head-generic kernels
against the same weights' plain-body forward. This script makes that model
and batch as path 12 does and prints, for 2 heads (the head-generic
kernels) and 8 heads (the head-specific kernels) on the same weights and
input, the relative error of the fused forward against the plain one. It
gates nothing. Usage, on a machine with an NVIDIA GPU:

    python3 scripts/torch_port_heads_bar_probe.py

One JSON line: ``{"heads2_forward_vs_plain": x, "heads8_forward_vs_plain": x,
"launches": {...}}``, the launches counted by heads.
"""

import dataclasses
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (make_batches, rel_err: path 12's data and measure)
from scream_tpu_torch.config import ModelConfig  # noqa: E402
from scream_tpu_torch.models import PointTransformer  # noqa: E402
from scream_tpu_torch.ops import launch_counts, reset_launch_counts  # noqa: E402
from scream_tpu_torch.pipeline.register import gt_center_hint, to_device  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_port_heads_bar_probe: no CUDA device")
    cfg = ModelConfig(num_heads=chip_smoke.HEADS_MAIN)
    weights = PointTransformer(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(1200)).state_dict()
    batch = chip_smoke.make_batches(chip_smoke.TIMED_BATCHES + 2, seed=1200)[-1]
    tb = to_device(batch, "cuda")
    args = (tb["src"], tb["tgt"], tb["src_mask"], tb["tgt_mask"],
            gt_center_hint(tb["rot"], tb["trans"]))
    out, launches = {}, {}
    for heads in (chip_smoke.HEADS_MAIN, 8):
        fwd = {}
        for fused in (None, False):
            m = PointTransformer(dataclasses.replace(cfg, num_heads=heads, fused_attention=fused,
                                                     fused_block_tail=fused),
                                 device="cuda").eval()
            m.load_state_dict(weights)
            reset_launch_counts()
            with torch.no_grad():
                fwd[fused] = m(*args)
            if fused is None:
                launches[heads] = {k: v for k, v in launch_counts().items() if v}
            del m
        out[f"heads{heads}_forward_vs_plain"] = chip_smoke.rel_err(fwd[None], fwd[False],
                                                                   rows=tb["src_mask"])
    out["launches"] = launches
    print(json.dumps(out))


if __name__ == "__main__":
    main()
