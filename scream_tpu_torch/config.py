"""Model, evaluation, render and training configuration (port of
``scream_tpu/config.py``).

Same fields and defaults as the JAX dataclasses: d_model 256, 8 heads,
6 shared self-attention stem layers + 6 cross blocks, ffn_mult 4, bf16
compute with fp32 params, fp32 LayerNorm
(reference ``models/pointnet.py:8-36``). ``EvalConfig`` carries the
fields :func:`scream_tpu_torch.pipeline.register.register_batch` reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the JAX config names dtypes
    by string; the port keeps the strings so configs compare equal)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """PointTransformer architecture; defaults mirror the reference model."""

    d_model: int = 256
    num_heads: int = 8
    self_layers: int = 6
    cross_layers: int = 6
    ffn_mult: int = 4
    # bf16 compute / fp32 params replaces the reference's AMP (train_kitti.py:52).
    dtype: str = "bfloat16"
    # LayerNorm computation dtype.
    norm_dtype: str = "float32"
    separate_stems: bool = False  # True for the DEM (OpenGF) variant
    remat: bool = False  # rematerialize attention blocks during training
    # Fused block-tail kernel (TPU: ffn_pallas._tail_kernel), not ported
    # yet. Where the fused attention block does not apply but the JAX rule
    # (ops.ffn.jax_fusable_tail) admits the tail kernel, a block on CUDA
    # tensors raises NotImplementedError; False asks for the plain tail
    # (so does fused_attention=False).
    fused_block_tail: Optional[bool] = None
    # Fused attention-block kernels (ops/attn_cuda.py). None = auto: on
    # CUDA tensors the kernels run wherever the JAX rule
    # (``ops.attn_cuda.jax_fusable_block``) admits the fused block, and a
    # shape the kernels do not take (fp32, other head dims) raises
    # NotImplementedError; False forces the plain body, tail included.
    fused_attention: Optional[bool] = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def norm_compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.norm_dtype)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluation knobs read by ``register_batch``
    (reference ``evaluate_3d_match.py:174-195``)."""

    dis_thresh: float = 0.1  # NN threshold (0.2 for zero-match)
    corr: str = "tgt"  # "src_pred" for zero-match
    icp_thresh: float = 0.1  # 1.0 for KITTI
    icp_max_iter: int = 30  # 1000 for KITTI (evaluate_kitti.py:69)
    # The GT-derived src_center hint fed to the model: 3DMatch passes t
    # (evaluate_3d_match.py:84), KITTI passes -R^T t (evaluate_kitti.py:39).
    center_mode: str = "trans"  # "neg_rt" for KITTI


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Depth-image renderer (reference ``models/render.py:8-25``)."""

    rho: float = 24.0
    width: int = 64
    multi_view: bool = True  # 6 fixed views; False = single identity view
    # "multi" | "identity" | "back" (the KITTI GAN variant uses rho=48 with a
    # single Ry(pi) view, reference ``train_kitti.py:45-48``); None derives
    # from multi_view.
    view_mode: Optional[str] = None
    # Splat kernel (ops/splat_cuda.py). None = auto: the kernel for CUDA
    # tensors, the plain renderer for CPU tensors (the JAX package's auto
    # picks the Pallas kernel on the TPU backend). True = the kernel's
    # wrapper on any device (its plain version for CPU tensors); False = the
    # plain renderer, the only way to ask for plain code on CUDA tensors.
    use_pallas: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters; 3DMatch defaults from reference
    ``train_3d_match.py:34-43`` (the fields the ported training steps and
    optimizers read)."""

    lr_g: float = 2e-4
    lr_d: float = 1e-4
    min_lr: float = 1e-5
    lr_decay_gamma: float = 0.5
    # LR-decay epoch boundaries: "every15" -> 15, 30, 45... (3DMatch/OpenGF);
    # "kitti" -> 10, 30, 60, 90 (train.optim.decay_epochs).
    decay_mode: str = "every15"
    epochs: int = 45
    use_gan: bool = False  # the reference's use_GAN switch
    gan_weight: float = 0.1
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_b1_d: float = 0.5  # discriminator betas (train_3d_match.py:41)


def kitti_gan_render_config() -> RenderConfig:
    """The renderer override the reference applies for KITTI GAN training
    (``train_kitti.py:45-48``): rho 48, single back view."""
    return RenderConfig(rho=48.0, width=64, multi_view=False, view_mode="back")
