"""Flax parameter trees -> the port's ``state_dict``.

The port names its parameters as the flax tree does (``trunk.stem_0.q_proj``
...) and keeps flax's ``(in, out)`` kernel layout (``y = x @ W``), so the
conversion only flattens the tree, joining keys with ``"."``; nothing is
transposed. It takes the tree as nested dicts of numpy arrays (read with the
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
