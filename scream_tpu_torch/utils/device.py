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


def fetch_async(tensors: dict):
    """Start copying ``tensors`` (a dict of tensors) to the host now, in
    stream order; returns a function that waits for those copies alone and
    gives the dict as numpy arrays.

    On a CUDA device the copies go into pinned memory with ``non_blocking``
    and an event marks their end, so work queued after this call (the next
    batch) does not delay the fetch, as a later ``.cpu()`` would (it waits
    for the whole stream). On the CPU the arrays are the tensors' own."""
    first = next(iter(tensors.values()))
    if not first.is_cuda:
        return lambda: {k: v.numpy() for k, v in tensors.items()}
    host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v, non_blocking=True)
            for k, v in tensors.items()}
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return {k: v.numpy() for k, v in host.items()}

    return wait
