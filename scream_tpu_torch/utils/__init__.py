"""Device resolution and the flax-to-torch weight converter."""

from scream_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
