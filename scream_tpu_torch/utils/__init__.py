"""Device resolution, the flax-to-torch weight converter (``convert``), the
reference ``.pth`` converter (``torch_convert``), the port's torch
checkpoints (``checkpoint``) and visualization (``viz``, ``viz_html``)."""

from scream_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
