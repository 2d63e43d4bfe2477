"""The registration transformer: attention blocks and the point transformer."""

from scream_tpu_torch.models.attention import (AttentionBlock, linear_attention,
                                               sinusoidal_pe)
from scream_tpu_torch.models.point_transformer import PointTransformer

__all__ = ["AttentionBlock", "linear_attention", "sinusoidal_pe", "PointTransformer"]
