"""Model, data, evaluation, render and training configuration and the task
presets (port of ``scream_tpu/config.py``).

Same fields and defaults as the JAX dataclasses: d_model 256, 8 heads,
6 shared self-attention stem layers + 6 cross blocks, ffn_mult 4, bf16
compute with fp32 params, fp32 LayerNorm
(reference ``models/pointnet.py:8-36``); the per-task presets
(:func:`threedmatch_presets`, :func:`kitti_presets`, :func:`opengf_presets`)
and the per-protocol evaluation knobs (:func:`eval_preset`) are the JAX
package's, field for field.
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
    # Fused block-tail kernel (ops/tail_cuda.py). None = auto: on CUDA
    # tensors it runs wherever the fused attention block does not and the
    # JAX rule (ops.ffn.jax_fusable_tail) admits the tail kernel, and a shape
    # the kernel does not take (fp32) raises NotImplementedError; False asks
    # for the plain tail. The routing is models.attention.route_block.
    fused_block_tail: Optional[bool] = None
    # Fused attention-block kernels (ops/attn_cuda.py). None = auto: on
    # CUDA tensors the kernels run wherever the JAX rule
    # (``ops.attn_cuda.jax_fusable_block``) admits the fused block, and a
    # shape the kernels do not take (bf16 d 512 at ffn_mult 1-2, fp32 d 384
    # at ffn_mult 1-3; every head count dividing d is taken) raises
    # NotImplementedError; False asks for the plain attention and leaves
    # the tail to fused_block_tail, as in the JAX package. When it fires it
    # subsumes the tail kernel.
    fused_attention: Optional[bool] = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def norm_compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.norm_dtype)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Bucketed padding + normalization for static shapes."""

    max_points: int = 4096  # per-cloud padding bucket
    normalize: str = "unit_sphere"  # or "unit_cube" (KITTI, datasets/kitti.py:268-273)
    augment_perturb_std: float = 0.1
    augment_jitter_std: float = 0.003
    perturb_both_sides: bool = True  # 3DMatch perturbs either side; KITTI src only
    root: str = "data"


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluation protocol knobs (reference ``evaluate_3d_match.py:174-195``)."""

    dis_thresh: float = 0.1  # NN threshold (0.2 for zero-match)
    corr: str = "tgt"  # "src_pred" for zero-match
    icp_thresh: float = 0.1  # 1.0 for KITTI
    icp_max_iter: int = 30  # 1000 for KITTI (evaluate_kitti.py:69)
    rmse_thresh: float = 0.2  # registration recall criterion
    re_stat: str = "median"  # "mean" for zero-match
    success_re_deg: float = 5.0  # KITTI success criteria
    success_te: float = 2.0
    # The GT-derived src_center hint fed to the model: 3DMatch passes t
    # (evaluate_3d_match.py:84), KITTI passes -R^T t (evaluate_kitti.py:39).
    center_mode: str = "trans"  # "neg_rt" for KITTI


def eval_preset(protocol: str) -> EvalConfig:
    """Per-protocol evaluation knobs, each cited to the reference driver
    (``evaluate_3d_match.py:174-195``, ``evaluate_kitti.py:31-110``)."""
    presets = {
        "3dmatch": EvalConfig(),
        "3dlomatch": EvalConfig(),
        "3dzeromatch": EvalConfig(dis_thresh=0.2, corr="src_pred", re_stat="mean"),
        "kitti": EvalConfig(dis_thresh=1.5, icp_thresh=1.0, icp_max_iter=1000,
                            center_mode="neg_rt"),
        "opengf": EvalConfig(),
    }
    try:
        return presets[protocol]
    except KeyError:
        raise ValueError(f"unknown eval protocol {protocol!r}") from None


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
    ``train_3d_match.py:34-43``; KITTI and OpenGF override them through the
    task presets below."""

    lr_g: float = 2e-4
    lr_d: float = 1e-4
    min_lr: float = 1e-5
    lr_decay_gamma: float = 0.5
    # LR-decay epoch boundaries: "every15" -> 15, 30, 45... (3DMatch/OpenGF);
    # "kitti" -> 10, 30, 60, 90 (train.optim.decay_epochs).
    decay_mode: str = "every15"
    epochs: int = 45
    batch_size: int = 8
    use_gan: bool = False  # the reference's use_GAN switch
    gan_weight: float = 0.1
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_b1_d: float = 0.5  # discriminator betas (train_3d_match.py:41)
    seed: int = 0
    checkpoint_metric: str = "point_loss"  # or "success_rate", "chamfer"
    # Steps between GAN sample-image dumps (--sample-img-dir).
    save_img_iter: int = 1000
    log_every: int = 50  # trainer batch-counter interval for metric snapshots
    # GPipe microbatches for the pipeline-parallel trainer path
    # (``--mesh pipe=N``); None -> 2 x n_stages. Batch size must divide it.
    pp_microbatches: int | None = None


def kitti_gan_render_config() -> RenderConfig:
    """The renderer override the reference applies for KITTI GAN training
    (``train_kitti.py:45-48``): rho 48, single back view."""
    return RenderConfig(rho=48.0, width=64, multi_view=False, view_mode="back")


def threedmatch_presets():
    return (
        ModelConfig(),
        TrainConfig(),
        DataConfig(max_points=4096, normalize="unit_sphere"),
        eval_preset("3dmatch"),
    )


def kitti_presets():
    return (
        ModelConfig(),
        TrainConfig(lr_g=3.2e-4, epochs=120, decay_mode="kitti",
                    checkpoint_metric="success_rate"),
        DataConfig(max_points=8192, normalize="unit_cube", augment_jitter_std=0.0,
                   perturb_both_sides=False),
        eval_preset("kitti"),
    )


def opengf_presets():
    return (
        ModelConfig(separate_stems=True),
        TrainConfig(checkpoint_metric="chamfer"),
        DataConfig(max_points=8192, normalize="none"),
        eval_preset("opengf"),
    )
