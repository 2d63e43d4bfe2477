"""Convert an orbax checkpoint of the JAX package into a torch checkpoint of
the port (``model.pt`` + ``model_config.json``).

Runs on a host with JAX, flax and orbax (the card's machine has none): the
checkpoint is read with the JAX package's own loader
(``scream_tpu.utils.checkpoint.load_params``) into the tree of a
``PointTransformer`` built from its ``model_config.json`` sidecar, each leaf
goes to numpy, ``scream_tpu_torch.utils.convert.params_from_jax`` flattens
the tree, and the port's ``save_params`` writes it in fp32 with the sidecar
copied unchanged. A checkpoint without a sidecar loads into the default
``ModelConfig()``, as the JAX CLI loads it (``scream_tpu/cli.py:644-657``,
``bench.py:139-146``); the port's sidecar then names that architecture and
the ``normalize`` of the ``--task`` preset (3dmatch ``unit_sphere``, kitti
``unit_cube``, opengf ``none``).

``--dem`` converts a ground-generation checkpoint: the tree of a
``DEMTransformer(ModelConfig(separate_stems=True))`` (``opengf_presets``),
mapped by the same ``params_from_jax``; its sidecar adds
``separate_stems``.

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
    python scripts/torch_port_convert_params.py --src params/point-generator \
        --dst scream_tpu_torch/weights/point-generator
    python scripts/torch_port_convert_params.py --dem --src params/dem-generator \
        --dst scream_tpu_torch/weights/dem-generator
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


# The architecture fields a sidecar of the port names (``load_params``
# applies them over the default ``ModelConfig``).
ARCH_FIELDS = ("d_model", "num_heads", "self_layers", "cross_layers")


def _sidecar(src: str, task: str, dem: bool) -> dict:
    """The checkpoint's own ``model_config.json``, or, where it has none,
    the default ``ModelConfig()``'s architecture and the task preset's
    ``normalize``."""
    path = os.path.join(src, "model_config.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    from scream_tpu.cli import TASKS
    from scream_tpu.config import ModelConfig

    cfg = ModelConfig(separate_stems=dem)
    side = {k: getattr(cfg, k) for k in ARCH_FIELDS}
    if dem:
        side["separate_stems"] = True
    side["normalize"] = TASKS[task]()[2].normalize
    return side


def convert(src: str, task: str = "3dmatch", dem: bool = False):
    """``(state_dict, sidecar)`` of the orbax checkpoint at ``src``: a
    ``PointTransformer``, or with ``dem`` a ``DEMTransformer``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from scream_tpu.config import ModelConfig
    from scream_tpu.models.point_transformer import DEMTransformer, PointTransformer
    from scream_tpu.utils.checkpoint import load_params
    from scream_tpu_torch.utils.convert import params_from_jax

    sidecar = _sidecar(src, task, dem)
    fields = {k: v for k, v in sidecar.items() if k != "normalize"}
    cfg = dataclasses.replace(ModelConfig(), **fields)
    z = jnp.zeros((1, 8, 3), jnp.float32)
    ones = jnp.ones((1, 8), bool)
    if dem:
        init = DEMTransformer(cfg).init(jax.random.PRNGKey(0), z, z, ones, ones)["params"]
    else:
        init = PointTransformer(cfg).init(jax.random.PRNGKey(0), z, z, ones, ones,
                                          jnp.zeros((1, 1, 3)))["params"]
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
    ap.add_argument("--dem", action="store_true",
                    help="convert a DEMTransformer (ground generation) checkpoint")
    ap.add_argument("--task", choices=("3dmatch", "kitti", "opengf"), default=None,
                    help="preset whose normalize a new sidecar names (default "
                         "opengf with --dem, else 3dmatch)")
    ap.add_argument("--src", default=None,
                    help="orbax checkpoint directory (default params/point-generator-"
                         "hintfree, params/dem-generator with --dem, or "
                         "params/discriminator)")
    ap.add_argument("--dst", default=None,
                    help="output directory of the torch checkpoint (default under "
                         "scream_tpu_torch/weights/)")
    args = ap.parse_args(argv)
    name = ("discriminator" if args.discriminator else
            "dem-generator" if args.dem else "point-generator-hintfree")
    task = args.task or ("opengf" if args.dem else "3dmatch")
    args.src = args.src or os.path.join("params", name)
    args.dst = args.dst or os.path.join("scream_tpu_torch", "weights", name)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from scream_tpu_torch.utils.checkpoint import save_params

    if args.discriminator:
        state, sidecar = convert_discriminator(args.src)
    else:
        state, sidecar = convert(args.src, task, args.dem)
    save_params(args.dst, state, sidecar)
    n = sum(v.numel() for v in state.values())
    print(json.dumps({"src": args.src, "dst": args.dst, "tensors": len(state),
                      "parameters": n}))


if __name__ == "__main__":
    main()
