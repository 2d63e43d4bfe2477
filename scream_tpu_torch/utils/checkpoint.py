"""Torch checkpoints of the port: ``model.pt`` + ``model_config.json``.

A checkpoint directory of the point transformer holds the model's ``state_dict`` (``model.pt``,
``torch.save`` of fp32 tensors, flax names and ``(in, out)`` layout) and the
same ``model_config.json`` sidecar the JAX package's checkpoints carry
(``ModelConfig`` fields plus the ``normalize`` convention the model was
trained with). ``scripts/torch_port_convert_params.py`` writes one from an
orbax checkpoint on a host with JAX; the converted hint-free checkpoint
ships in ``scream_tpu_torch/weights/point-generator-hintfree``.

The discriminator's directory (``weights/discriminator``) holds its
``state_dict`` the same way, with the ``PatchDiscriminator`` constructor
arguments as the sidecar (:func:`load_discriminator`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import torch

from scream_tpu_torch.config import ModelConfig
from scream_tpu_torch.utils.device import resolve_device

MODEL_FILE = "model.pt"
SIDECAR = "model_config.json"


def load_params(directory: str
                ) -> Tuple[ModelConfig, Optional[str], Dict[str, torch.Tensor]]:
    """``(ModelConfig, normalize, state_dict)`` of a checkpoint directory.

    The config is the default ``ModelConfig`` updated with the sidecar's
    fields, ``normalize`` the convention it names (popped from the fields;
    None if absent); callers apply explicit flags on top (they win, as in the
    JAX CLI). The state_dict is loaded on the CPU (``weights_only``)."""
    path = os.path.join(directory, MODEL_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: not a torch checkpoint of the port (convert an orbax "
            "checkpoint with scripts/torch_port_convert_params.py)")
    with open(os.path.join(directory, SIDECAR)) as f:
        side = json.load(f)
    normalize = side.pop("normalize", None)
    state = torch.load(path, map_location="cpu", weights_only=True)
    return dataclasses.replace(ModelConfig(), **side), normalize, state


def save_params(directory: str, state: Dict[str, torch.Tensor],
                sidecar: Dict) -> None:
    """Write ``model.pt`` (the state_dict, fp32, contiguous) and
    ``model_config.json`` (``sidecar`` as given) into ``directory``."""
    os.makedirs(directory, exist_ok=True)
    state = {k: v.detach().float().contiguous() for k, v in state.items()}
    torch.save(state, os.path.join(directory, MODEL_FILE))
    with open(os.path.join(directory, SIDECAR), "w") as f:
        json.dump(sidecar, f, indent=1)
        f.write("\n")


def load_discriminator(directory: str, device="cuda"):
    """The :class:`~scream_tpu_torch.models.PatchDiscriminator` of a
    checkpoint directory (sidecar: ``input_nc``, ``ndf``, ``n_layers``),
    weights and running averages loaded strictly, on ``device``."""
    from scream_tpu_torch.models.gan import PatchDiscriminator

    path = os.path.join(directory, MODEL_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: not a torch checkpoint of the port (convert an orbax "
            "checkpoint with scripts/torch_port_convert_params.py --discriminator)")
    with open(os.path.join(directory, SIDECAR)) as f:
        side = json.load(f)
    disc = PatchDiscriminator(**side, device="cpu")
    disc.load_state_dict(torch.load(path, map_location="cpu", weights_only=True),
                         strict=True)
    return disc.to(resolve_device(device))
