"""The registration pipelines: the protocol path (``register_batch``, and
``register_batch_requeue`` with chunked ICP), GT-free serving
(``register_pair(s)``, ``register_pair(s)_robust``) and multiway
registration (``register_multiway``: pairwise serving, pose-graph
synchronization, scan-to-map polish)."""

from scream_tpu_torch.pipeline.multiway import (MultiwayResult, default_edges,
                                                refine_to_map, register_multiway,
                                                synchronize_poses)
from scream_tpu_torch.pipeline.register import (PairRegistration,
                                                register_batch,
                                                register_batch_requeue, register_pair,
                                                register_pair_robust,
                                                register_pairs,
                                                register_pairs_robust)

__all__ = ["MultiwayResult", "PairRegistration", "default_edges", "refine_to_map",
           "register_batch", "register_batch_requeue", "register_multiway",
           "register_pair", "register_pair_robust", "register_pairs",
           "register_pairs_robust", "synchronize_poses"]
