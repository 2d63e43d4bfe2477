"""Flax parameter trees -> the port's ``state_dict``s.

:func:`params_from_jax` (the point transformer): the port names its parameters as the flax tree does (``trunk.stem_0.q_proj``
...) and keeps flax's ``(in, out)`` kernel layout (``y = x @ W``), so the
conversion only flattens the tree, joining keys with ``"."``; nothing is
transposed. :func:`discriminator_from_jax` (the PatchGAN) maps flax's
``{"params", "batch_stats"}`` to torch's names and layouts. Both take the tree as nested dicts of numpy arrays (read with the
JAX package's own loader, outside this package) and imports nothing of JAX.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flatten a flax ``params`` tree (e.g. ``model.init(...)["params"]``)
    into a ``state_dict`` for :class:`~scream_tpu_torch.models.PointTransformer`
    (``load_state_dict(..., strict=True)`` then checks that every leaf is
    used exactly once)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                if key in out:
                    raise ValueError(f"duplicate parameter {key!r}")
                out[key] = torch.from_numpy(np.array(v, copy=True))

    walk(tree, "")
    return out


def discriminator_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``PatchDiscriminator``'s ``{"params": ..., "batch_stats": ...}``
    as a ``state_dict`` of :class:`~scream_tpu_torch.models.PatchDiscriminator`:
    conv kernels ``(kh, kw, in, out)`` -> ``conv_k.weight`` ``(out, in, kh, kw)``
    (both cross-correlate, so nothing is flipped), conv biases as they are,
    BatchNorm ``scale``/``bias`` -> ``bn_k.weight``/``bias`` and the batch
    stats ``mean``/``var`` -> ``bn_k.running_mean``/``running_var``."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in params.items():
        if name.startswith("conv"):
            out[f"{name}.weight"] = t(np.transpose(np.asarray(leaf["kernel"]), (3, 2, 0, 1)))
            if "bias" in leaf:
                out[f"{name}.bias"] = t(leaf["bias"])
        elif name.startswith("bn"):
            out[f"{name}.weight"] = t(leaf["scale"])
            out[f"{name}.bias"] = t(leaf["bias"])
            out[f"{name}.running_mean"] = t(stats[name]["mean"])
            out[f"{name}.running_var"] = t(stats[name]["var"])
        else:
            raise ValueError(f"unexpected discriminator parameter {name!r}")
    return out
