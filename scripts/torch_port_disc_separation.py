#!/usr/bin/env python3
"""The shipped discriminator's mean logits on real and fake renders, in the
JAX package and in the port's CPU path, on the pairs ``chip_smoke.py``'s
path 3 scores on the card.

8 synthetic pairs x 512 points (``SyntheticPairDataset(seed=700)``, one
``PairLoader`` batch at capacity 512; the data modules of the two packages
are bit-identical). "Real" is the render of the GT-aligned source beside the
target, "fake" the render of the port's full-width generator from its
seeded random init (``PointTransformer(ModelConfig(), generator=seed 0)``,
bf16 plain body on the CPU), both with the 3DMatch render config (six
views, 64 x 64, rho 24). Each package renders with its own renderer and
scores with its own copy of the shipped discriminator (the JAX package from
``params/discriminator`` through orbax, the port from
``scream_tpu_torch/weights/discriminator``), in batch-stats mode as the
generator step queries it, and in eval mode.

Runs on a host with JAX, flax and orbax, on the CPU; prints one JSON line.

Usage (from the repository root):
    python scripts/torch_port_disc_separation.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from scream_tpu.models.gan import PatchDiscriminator as JDisc
    from scream_tpu.models.gan import images_to_nhwc as j_nhwc
    from scream_tpu.ops.render import render_depth_images as j_render
    from scream_tpu.utils.checkpoint import load_params
    from scream_tpu_torch.config import ModelConfig, RenderConfig
    from scream_tpu_torch.data import PairLoader, SyntheticPairDataset
    from scream_tpu_torch.models import PointTransformer, images_to_nhwc
    from scream_tpu_torch.ops.render import render_from_config
    from scream_tpu_torch.pipeline.register import gt_center_hint, to_device
    from scream_tpu_torch.utils.checkpoint import load_discriminator

    ds = SyntheticPairDataset(length=8, n_src=512, n_tgt=512, seed=700)
    batch = next(iter(PairLoader(ds, batch_size=8, src_capacity=512, num_workers=1)))
    tb = to_device(batch, "cpu")
    gen = PointTransformer(ModelConfig(), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        fake_pts = gen(tb["src"], tb["tgt"], tb["src_mask"], tb["tgt_mask"],
                       gt_center_hint(tb["rot"], tb["trans"])).float()
    real_pts = (np.einsum("bij,bnj->bni", batch["rot"], batch["src"])
                + batch["trans"].transpose(0, 2, 1)).astype(np.float32)
    points = {"real": real_pts, "fake": fake_pts.numpy()}

    jdisc = JDisc(input_nc=2)
    tmpl = jdisc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 2)), train=False)
    variables = load_params("params/discriminator", {"params": tmpl["params"],
                                                     "batch_stats": tmpl["batch_stats"]})
    disc = load_discriminator(os.path.join("scream_tpu_torch", "weights", "discriminator"),
                              device="cpu")
    out = {}
    for kind, pts in points.items():
        imgs = j_nhwc(j_render(jnp.asarray(pts), jnp.asarray(batch["tgt"]),
                               jnp.asarray(batch["src_mask"]), jnp.asarray(batch["tgt_mask"]),
                               use_pallas=False))
        out[f"jax_{kind}_batch_stats"] = float(jnp.mean(
            jdisc.apply(variables, imgs, train=True, mutable=["batch_stats"])[0]))
        out[f"jax_{kind}_eval"] = float(jnp.mean(jdisc.apply(variables, imgs, train=False)))
        with torch.no_grad():
            timgs = images_to_nhwc(render_from_config(torch.from_numpy(pts), tb["tgt"],
                                                      RenderConfig(), tb["src_mask"],
                                                      tb["tgt_mask"]))
            out[f"port_cpu_{kind}_batch_stats"] = float(
                disc(timgs, train=True, update_stats=False).mean())
            out[f"port_cpu_{kind}_eval"] = float(disc(timgs, train=False).mean())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
