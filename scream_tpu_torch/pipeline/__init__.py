"""The registration pipeline: forward -> pose solve -> ICP -> metrics."""

from scream_tpu_torch.pipeline.register import register_batch

__all__ = ["register_batch"]
