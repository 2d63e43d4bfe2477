"""The registration transformer (attention blocks, the point transformer)
and the PatchGAN discriminator."""

from scream_tpu_torch.models.attention import (AttentionBlock, linear_attention,
                                               sinusoidal_pe)
from scream_tpu_torch.models.gan import PatchDiscriminator, images_to_nhwc
from scream_tpu_torch.models.point_transformer import PointTransformer

__all__ = ["AttentionBlock", "linear_attention", "sinusoidal_pe", "PatchDiscriminator",
           "images_to_nhwc", "PointTransformer"]
