"""Host-side data: synthetic pairs and DEM patches, the preprocessed split
readers, padded and bucketed batching, the pair and DEM loaders, the
collated bucket-shard cache of the evaluation, device prefetch, and the
point-cloud readers of the ``register`` CLI (``ply.load_cloud_any``)."""

from scream_tpu_torch.data.batching import (bucket_for, collate_dem, collate_pairs,
                                            pad_cloud)
from scream_tpu_torch.data.collated import (CollatedPairLoader, build_collated_cache,
                                            collated_or_build, has_collated_cache)
from scream_tpu_torch.data.datasets import (ConcatDataset, OpenGFDataset, PairDataset,
                                            SyntheticPairDataset)
from scream_tpu_torch.data.loader import (BucketedPairLoader, DEMLoader,
                                          HostShardDataset, PairLoader,
                                          prefetch_to_device)
from scream_tpu_torch.data.synthetic import make_dem_patch, make_pair, make_scene

__all__ = ["bucket_for", "collate_dem", "collate_pairs", "pad_cloud",
           "CollatedPairLoader", "build_collated_cache", "collated_or_build",
           "has_collated_cache", "ConcatDataset", "OpenGFDataset", "PairDataset",
           "SyntheticPairDataset", "BucketedPairLoader", "DEMLoader",
           "HostShardDataset", "PairLoader", "prefetch_to_device", "make_dem_patch",
           "make_pair", "make_scene"]
