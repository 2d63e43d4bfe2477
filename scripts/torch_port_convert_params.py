"""Convert an orbax checkpoint of the JAX package into a torch checkpoint of
the port (``model.pt`` + ``model_config.json``).

Runs on a host with JAX, flax and orbax (the card's machine has none): the
checkpoint is read with the JAX package's own loader
(``scream_tpu.utils.checkpoint.load_params``) into the tree of a
``PointTransformer`` built from its ``model_config.json`` sidecar, each leaf
goes to numpy, ``scream_tpu_torch.utils.convert.params_from_jax`` flattens
the tree, and the port's ``save_params`` writes it in fp32 with the sidecar
copied unchanged.

``--discriminator`` converts the shipped PatchGAN instead: its orbax
checkpoint (``params`` + ``batch_stats``) is read into the tree of a
``PatchDiscriminator(input_nc=2)``, and
``scream_tpu_torch.utils.convert.discriminator_from_jax`` maps it to the
port's names and torch's conv layout; the sidecar holds the constructor
arguments.

Usage (from the repository root):
    python scripts/torch_port_convert_params.py \
        [--src params/point-generator-hintfree] \
        [--dst scream_tpu_torch/weights/point-generator-hintfree]
    python scripts/torch_port_convert_params.py --discriminator \
        [--src params/discriminator] [--dst scream_tpu_torch/weights/discriminator]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(src: str):
    """``(state_dict, sidecar)`` of the orbax checkpoint at ``src``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from scream_tpu.config import ModelConfig
    from scream_tpu.models.point_transformer import PointTransformer
    from scream_tpu.utils.checkpoint import load_params
    from scream_tpu_torch.utils.convert import params_from_jax

    with open(os.path.join(src, "model_config.json")) as f:
        sidecar = json.load(f)
    fields = {k: v for k, v in sidecar.items() if k != "normalize"}
    model = PointTransformer(dataclasses.replace(ModelConfig(), **fields))
    z = jnp.zeros((1, 8, 3), jnp.float32)
    init = model.init(jax.random.PRNGKey(0), z, z, jnp.ones((1, 8), bool),
                      jnp.ones((1, 8), bool), jnp.zeros((1, 1, 3)))["params"]
    params = load_params(src, init)
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)
    return params_from_jax(tree), sidecar


DISC_ARGS = {"input_nc": 2, "ndf": 64, "n_layers": 3}


def convert_discriminator(src: str):
    """``(state_dict, sidecar)`` of the orbax discriminator at ``src``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from scream_tpu.models.gan import PatchDiscriminator
    from scream_tpu.utils.checkpoint import load_params
    from scream_tpu_torch.utils.convert import discriminator_from_jax

    disc = PatchDiscriminator(**DISC_ARGS)
    init = disc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, DISC_ARGS["input_nc"])),
                     train=False)
    variables = load_params(src, {"params": init["params"],
                                  "batch_stats": init["batch_stats"]})
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), variables)
    return discriminator_from_jax(tree), dict(DISC_ARGS)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--discriminator", action="store_true",
                    help="convert the PatchGAN discriminator")
    ap.add_argument("--src", default=None,
                    help="orbax checkpoint directory (default params/point-generator-"
                         "hintfree, or params/discriminator)")
    ap.add_argument("--dst", default=None,
                    help="output directory of the torch checkpoint (default under "
                         "scream_tpu_torch/weights/)")
    args = ap.parse_args(argv)
    name = "discriminator" if args.discriminator else "point-generator-hintfree"
    args.src = args.src or os.path.join("params", name)
    args.dst = args.dst or os.path.join("scream_tpu_torch", "weights", name)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from scream_tpu_torch.utils.checkpoint import save_params

    state, sidecar = (convert_discriminator if args.discriminator else convert)(args.src)
    save_params(args.dst, state, sidecar)
    n = sum(v.numel() for v in state.values())
    print(json.dumps({"src": args.src, "dst": args.dst, "tensors": len(state),
                      "parameters": n}))


if __name__ == "__main__":
    main()
