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

Training (port of ``scream_tpu/utils/checkpoint.py``):
:class:`BestCheckpointer` writes such a weights directory under
``<dir>/best`` whenever the watched validation metric improves, and
:func:`save_train_state` / :func:`load_train_state` keep the full train
state (weights, Adam state, LR schedule, step count, the discriminator under
GAN) as one ``torch.save`` file for resuming; the JAX package keeps both as
orbax trees.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch

from scream_tpu_torch.config import ModelConfig
from scream_tpu_torch.utils.device import resolve_device

MODEL_FILE = "model.pt"
SIDECAR = "model_config.json"
STATE_FILE = "state.pt"
BEST_METRIC = "best_metric.json"


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


class BestCheckpointer:
    """Save the weights when the watched metric improves: lower is better
    in mode "min" (point loss, chamfer), higher in "max" (success rate).

    The best metric persists in ``best_metric.json``, so a resumed run keeps
    gating against the earlier best. A non-finite metric never saves: a
    NaN best would wedge the gate (every later comparison is False).
    """

    def __init__(self, directory: str, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = os.path.abspath(directory)
        self.mode = mode
        self.best: Optional[float] = None
        os.makedirs(self.directory, exist_ok=True)
        meta = os.path.join(self.directory, BEST_METRIC)
        if os.path.exists(meta):
            with open(meta) as f:
                rec = json.load(f)
            if rec.get("mode") == mode and math.isfinite(rec.get("best", float("nan"))):
                self.best = float(rec["best"])

    def improved(self, metric: float) -> bool:
        if not math.isfinite(metric):
            return False
        if self.best is None:
            return True
        return metric < self.best if self.mode == "min" else metric > self.best

    def maybe_save(self, metric: float, state: Dict[str, torch.Tensor],
                   sidecar: Dict) -> bool:
        """Save ``state`` (a state_dict) with ``sidecar`` as
        ``<dir>/best`` if ``metric`` beats the best so far; returns whether
        it saved."""
        if not self.improved(metric):
            return False
        self.best = float(metric)
        save_params(os.path.join(self.directory, "best"), state, sidecar)
        with open(os.path.join(self.directory, BEST_METRIC), "w") as f:
            json.dump({"best": self.best, "mode": self.mode}, f)
        return True

    def restore(self) -> Tuple[ModelConfig, Optional[str], Dict[str, torch.Tensor]]:
        """The best checkpoint, as :func:`load_params` reads it."""
        return load_params(os.path.join(self.directory, "best"))


def save_train_state(directory: str, tree: Dict[str, Any]) -> None:
    """Write a train-state tree (state_dicts, step counts) to
    ``directory/state.pt``, replacing any earlier one atomically."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, STATE_FILE)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def load_train_state(directory: str) -> Dict[str, Any]:
    """The tree :func:`save_train_state` wrote, on the CPU."""
    return torch.load(os.path.join(directory, STATE_FILE), map_location="cpu",
                      weights_only=True)
