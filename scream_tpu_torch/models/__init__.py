"""The transformer family (attention blocks, the point transformer, the DEM
transformer) and the PatchGAN discriminator."""

from scream_tpu_torch.models.attention import (AttentionBlock, linear_attention,
                                               sinusoidal_pe)
from scream_tpu_torch.models.gan import PatchDiscriminator, images_to_nhwc
from scream_tpu_torch.models.point_transformer import DEMTransformer, PointTransformer

__all__ = ["AttentionBlock", "linear_attention", "sinusoidal_pe", "PatchDiscriminator",
           "images_to_nhwc", "DEMTransformer", "PointTransformer"]
