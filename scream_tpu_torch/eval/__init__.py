"""Benchmark evaluation protocols (port of ``scream_tpu/eval``)."""

from scream_tpu_torch.eval.protocols import (SCENE_NAMES, SkipDataset,
                                             evaluate_3d_lo_match, evaluate_3d_match,
                                             evaluate_3d_zero_match, evaluate_kitti,
                                             evaluate_open_gf, evaluate_registration,
                                             evaluate_registration_per_scene)

__all__ = ["SCENE_NAMES", "SkipDataset", "evaluate_3d_lo_match", "evaluate_3d_match",
           "evaluate_3d_zero_match", "evaluate_kitti", "evaluate_open_gf",
           "evaluate_registration", "evaluate_registration_per_scene"]
