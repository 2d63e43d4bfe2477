"""The registration pipelines: the protocol path (``register_batch``, and
``register_batch_requeue`` with chunked ICP) and GT-free serving (``register_pair(s)``, ``register_pair(s)_robust``)."""

from scream_tpu_torch.pipeline.register import (PairRegistration,
                                                register_batch,
                                                register_batch_requeue, register_pair,
                                                register_pair_robust,
                                                register_pairs,
                                                register_pairs_robust)

__all__ = ["PairRegistration", "register_batch", "register_batch_requeue", "register_pair",
           "register_pair_robust", "register_pairs", "register_pairs_robust"]
