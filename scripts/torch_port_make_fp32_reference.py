"""Write the JAX package's float32 forwards of the shipped point generators
on seeded inputs, so that the port on the card can be held to the JAX
package without JAX on the card's machine.

``tests/data/torch_port_fp32_reference.npz`` holds the seed and, per model,
the ``src_pred`` of the JAX ``PointTransformer`` in float32 on the CPU
(``JModelConfig(dtype="float32")`` from the checkpoint's sidecar, the orbax
weights read by the JAX package's loader):

* ``point_generator``: ``params/point-generator`` (d 256, 6 + 6 layers),
  2 pairs x 1,024 points;
* ``point_generator_hintfree``: ``params/point-generator-hintfree`` (d 128,
  3 + 3 layers), 2 pairs x 448 points.

:func:`reference_inputs` makes each model's inputs from the seed with numpy
alone; this script, ``tests/test_torch_port_fp32.py`` (which recomputes the
JAX forwards and holds the file to them, and holds the port's CPU forwards
to it) and ``chip_smoke.py`` path 7 (the card's forwards) all call it. The
module imports JAX only inside :func:`main`, so the card's machine can
import it.

Usage (from the repository root, on a host with JAX, flax and orbax):
    python scripts/torch_port_make_fp32_reference.py [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_port_fp32_reference.npz")
SEED = 1300
# key in the file -> (checkpoint name under params/ and scream_tpu_torch/weights/,
# pairs, points a cloud)
MODELS = {
    "point_generator": ("point-generator", 2, 1024),
    "point_generator_hintfree": ("point-generator-hintfree", 2, 448),
}


def reference_inputs(key: str, seed: int = SEED):
    """(src, tgt, src_mask, tgt_mask, src_center) of ``MODELS[key]`` as
    numpy: clouds uniform in [-0.8, 0.8]^3, the second pair's source masked
    past three quarters of its points, the centre the mean of each source."""
    _, pairs, points = MODELS[key]
    rng = np.random.default_rng([seed, list(MODELS).index(key)])
    src, tgt = rng.uniform(-0.8, 0.8, (2, pairs, points, 3)).astype(np.float32)
    src_mask = np.ones((pairs, points), bool)
    src_mask[1, 3 * points // 4:] = False
    tgt_mask = np.ones((pairs, points), bool)
    center = src.mean(1, keepdims=True).astype(np.float32)
    return src, tgt, src_mask, tgt_mask, center


def sidecar_fields(name: str) -> dict:
    """The architecture fields of a checkpoint's ``model_config.json`` (the
    port's copy, which names the default architecture where the orbax
    checkpoint has no sidecar)."""
    path = os.path.join(REPO, "scream_tpu_torch", "weights", name, "model_config.json")
    with open(path) as f:
        return {k: v for k, v in json.load(f).items() if k != "normalize"}


def jax_forward(key: str, seed: int = SEED) -> np.ndarray:
    """The JAX package's float32 forward of ``MODELS[key]`` on the CPU."""
    import jax
    import jax.numpy as jnp

    from scream_tpu.config import ModelConfig
    from scream_tpu.models.point_transformer import PointTransformer
    from scream_tpu.utils.checkpoint import load_params

    name = MODELS[key][0]
    model = PointTransformer(ModelConfig(dtype="float32", **sidecar_fields(name)))
    inputs = [jnp.asarray(a) for a in reference_inputs(key, seed)]
    init = model.init(jax.random.PRNGKey(0), *inputs)["params"]
    params = load_params(os.path.join(REPO, "params", name), init)
    return np.asarray(model.apply({"params": params}, *inputs), np.float32)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    preds = {key: jax_forward(key) for key in MODELS}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, seed=np.int64(SEED), **preds)
    for key, p in preds.items():
        print(f"{key}: src_pred {p.shape}, max |value| {np.abs(p).max():.6f}")
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
