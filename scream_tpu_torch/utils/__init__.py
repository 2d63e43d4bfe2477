"""Device resolution, the flax-to-torch weight converter (``convert``) and
the port's torch checkpoints (``checkpoint``)."""

from scream_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
