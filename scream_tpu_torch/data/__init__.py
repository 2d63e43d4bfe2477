"""Host-side data: synthetic pairs and DEM patches, the preprocessed split
readers, padded batching, the pair and DEM loaders, and the point-cloud
readers of the ``register`` CLI (``ply.load_cloud_any``)."""

from scream_tpu_torch.data.batching import collate_dem, collate_pairs, pad_cloud
from scream_tpu_torch.data.datasets import (OpenGFDataset, PairDataset,
                                            SyntheticPairDataset)
from scream_tpu_torch.data.loader import DEMLoader, PairLoader
from scream_tpu_torch.data.synthetic import make_dem_patch, make_pair, make_scene

__all__ = ["collate_dem", "collate_pairs", "pad_cloud", "OpenGFDataset", "PairDataset",
           "SyntheticPairDataset", "DEMLoader", "PairLoader", "make_dem_patch",
           "make_pair", "make_scene"]
