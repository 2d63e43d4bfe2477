"""Host-side data: synthetic pairs, padded batching, the pair loader, and
the point-cloud readers of the ``register`` CLI (``ply.load_cloud_any``)."""

from scream_tpu_torch.data.batching import collate_pairs, pad_cloud
from scream_tpu_torch.data.datasets import SyntheticPairDataset
from scream_tpu_torch.data.loader import PairLoader
from scream_tpu_torch.data.synthetic import make_pair, make_scene

__all__ = ["collate_pairs", "pad_cloud", "SyntheticPairDataset", "PairLoader",
           "make_pair", "make_scene"]
