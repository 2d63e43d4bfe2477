"""Entry-point device resolution: no silent fallback to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising if CUDA is asked for and absent.

    Every entry point of the port takes ``device="cuda"`` by default; the
    tests pass ``"cpu"``. A CUDA request on a host without a GPU is an
    error, never a quiet switch to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev


def on_cuda(x: torch.Tensor) -> bool:
    """The auto routes' predicate, shared by the attention blocks and the
    renderer: whether ``x`` lies on a CUDA device (the CPU tests patch it
    to build CUDA routing)."""
    return x.is_cuda
