"""Geometry: SO(3) / SE(3) functions and their class API ``SO3`` / ``SE3``,
pairwise distances, normals, weighted Kabsch, metrics and ICP (the JAX
package's geometry API)."""

from scream_tpu_torch.geometry import se3, so3
from scream_tpu_torch.geometry.icp import (ICPResult, icp_refine_if_better,
                                           registration_icp, registration_icp_batched)
from scream_tpu_torch.geometry.lie import SE3, SO3
from scream_tpu_torch.geometry.kabsch import (integrate_trans, kabsch,
                                              kabsch_from_correspondence)
from scream_tpu_torch.geometry.metrics import (chamfer_distance, redwood_rmse,
                                               transformation_error)
from scream_tpu_torch.geometry.normals import estimate_normals, orient_normals_towards
from scream_tpu_torch.geometry.pairwise import (masked_square_distance, nearest_neighbor,
                                                radius_correspondence_mask, radius_count,
                                                square_distance)

__all__ = ["so3", "se3", "SO3", "SE3", "square_distance", "masked_square_distance", "nearest_neighbor",
           "radius_count", "radius_correspondence_mask", "ICPResult",
           "icp_refine_if_better", "registration_icp", "registration_icp_batched",
           "estimate_normals", "orient_normals_towards", "kabsch", "integrate_trans",
           "kabsch_from_correspondence", "transformation_error", "redwood_rmse",
           "chamfer_distance"]
