"""The registration / ground-generation transformer family (port of
``scream_tpu/models/point_transformer.py``; reference ``models/pointnet.py``).

* :class:`PointTransformer` predicts where the source cloud sits in the
  target frame (``src_pred``): sinusoidal PE + a Dense embedding of centred
  coordinates, LayerNorm, 6 *shared* self-attention stem layers applied to
  both clouds, 6 cross blocks (self on src, then cross src<-tgt), and a
  3-layer coordinate head.
* :class:`DEMTransformer` (OpenGF ground generation, reference
  ``:103-167``) is the same skeleton with *separate* stems for the DSM and
  the coarse DEM and no source centring.

Compute runs in ``ModelConfig.dtype`` (bf16 by default) over fp32
parameters.

Parameter names follow the flax tree (``trunk.stem_0.q_proj.kernel``, or
``trunk.stem_src_0.q_proj.kernel`` with separate stems, ...) with flax's
``(in, out)`` kernel layout, so ``utils.convert.params_from_jax`` maps a JAX
checkpoint one to one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from scream_tpu_torch.config import ModelConfig
from scream_tpu_torch.geometry.kabsch import weighted_point_sum
from scream_tpu_torch.models.attention import AttentionBlock, sinusoidal_pe
from scream_tpu_torch.ops.ffn import _ln
from scream_tpu_torch.pipeline.register import gt_aligned_src
from scream_tpu_torch.utils.device import resolve_device


class _Dense(nn.Module):
    """``(in, out)`` kernel + bias, flax ``nn.Dense``'s layout and default
    init (lecun-normal kernel, zero bias)."""

    def __init__(self, d_in: int, d_out: int, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))
        std = math.sqrt(1.0 / d_in) / 0.87962566103423978  # truncated at 2 sigma
        nn.init.trunc_normal_(self.kernel, std=std, a=-2 * std, b=2 * std,
                              generator=generator)

    def forward(self, x, dtype):
        """Inputs, kernel and bias promoted to ``dtype``, as flax's Dense. On
        CUDA a batch ``(B, N, in)`` runs as a batched product of ``B``
        items: one folded ``(B N, in)`` product lets cuBLAS pick its kernel,
        and so a row's bits, by the batch size (``weighted_point_sum``)."""
        W = self.kernel.to(dtype)
        if x.is_cuda and x.dim() == 3:
            W = W.expand(x.shape[0], *W.shape)
        return x.to(dtype) @ W + self.bias.to(dtype)


class _Trunk(nn.Module):
    """Shared encoder trunk: embed -> stems -> cross blocks -> coord head."""

    def __init__(self, cfg: ModelConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.embedding = _Dense(3, d, generator)
        self.pre_norm = nn.Module()
        self.pre_norm.scale = nn.Parameter(torch.ones(d))
        self.pre_norm.bias = nn.Parameter(torch.zeros(d))
        block = lambda: AttentionBlock(
            d, cfg.num_heads, cfg.ffn_mult, dtype=cfg.compute_dtype,
            norm_dtype=cfg.norm_compute_dtype, fused_attn=cfg.fused_attention,
            fused_tail=cfg.fused_block_tail, generator=generator)
        stems = ("stem_src", "stem_tgt") if cfg.separate_stems else ("stem",)
        for i in range(cfg.self_layers):
            for name in stems:
                self.add_module(f"{name}_{i}", block())
        for i in range(cfg.cross_layers):
            self.add_module(f"cross_self_{i}", block())
            self.add_module(f"cross_attn_{i}", block())
        self.head_0 = _Dense(d, d, generator)
        self.head_1 = _Dense(d, d, generator)
        self.head_out = _Dense(d, 3, generator)

    def embed(self, src, tgt, src_center):
        """PE on raw coords + embedding on centred src coords, then the
        shared LayerNorm (reference models/pointnet.py:43-46)."""
        dt, d = self.cfg.compute_dtype, self.cfg.d_model
        src_feats = sinusoidal_pe(src, d, dtype=dt) + self.embedding(src - src_center, dt)
        tgt_feats = sinusoidal_pe(tgt, d, dtype=dt) + self.embedding(tgt, dt)
        norm = lambda x: _ln(x, self.pre_norm.scale, self.pre_norm.bias, 1e-5,
                             torch.float32).to(dt)
        return norm(src_feats), norm(tgt_feats)

    def head(self, src_feats):
        """Coordinate head (reference :27-33); fp32 output for the pose solve."""
        dt = self.cfg.compute_dtype
        h = torch.relu(self.head_0(src_feats, dt))
        h = torch.relu(self.head_1(h, dt))
        return self.head_out(h, torch.float32)

    def forward(self, src, tgt, src_mask, tgt_mask, src_center):
        cfg = self.cfg
        src_feats, tgt_feats = self.embed(src, tgt, src_center)

        # Self-attention stems: one stack shared by both clouds (reference
        # :18-20, :50-52), or one per cloud in the DEM variant (:113-118).
        for i in range(cfg.self_layers):
            if cfg.separate_stems:
                src_blk = getattr(self, f"stem_src_{i}")
                tgt_blk = getattr(self, f"stem_tgt_{i}")
                src_feats = src_blk(src_feats, src_feats, src_feats, src_mask, src_mask)
                tgt_feats = tgt_blk(tgt_feats, tgt_feats, tgt_feats, tgt_mask, tgt_mask)
            else:
                blk = getattr(self, f"stem_{i}")
                tgt_feats = blk(tgt_feats, tgt_feats, tgt_feats, tgt_mask, tgt_mask)
                src_feats = blk(src_feats, src_feats, src_feats, src_mask, src_mask)

        # Cross stage: alternate (self on src, cross src<-tgt) (reference :53-57).
        for i in range(cfg.cross_layers):
            src_feats = getattr(self, f"cross_self_{i}")(
                src_feats, src_feats, src_feats, src_mask, src_mask)
            src_feats = getattr(self, f"cross_attn_{i}")(
                src_feats, tgt_feats, tgt_feats, src_mask, tgt_mask)
        return self.head(src_feats)


def masked_centroid(src, src_mask, point_reduce=None):
    """The masked centroid ``(B, 1, 3)``: the default ``src_center``;
    ``point_reduce`` sums its sums over the ranks holding the other points."""
    m = src_mask.to(src.dtype)
    num, den = weighted_point_sum(m, src), m.sum(1)[:, None, None]
    if point_reduce is not None:
        num, den = point_reduce(num), point_reduce(den)
    return num / torch.clamp_min(den, 1.0)


class PointTransformer(nn.Module):
    """Registration model: ``(src, tgt) -> src_pred`` in the target frame.

    Call with ``(B, N, 3)`` / ``(B, M, 3)`` clouds and boolean masks.
    ``src_center`` defaults to the masked src centroid; the protocols pass
    the GT-derived hint as the reference does. Parameters are drawn from
    ``generator`` (seed 0 if None) on the CPU, then moved to ``device``.
    """

    def __init__(self, cfg: ModelConfig = ModelConfig(), *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.trunk = _Trunk(cfg, generator)
        self.point_reduce = None  # sum over the ranks holding the other points (SP)
        self.to(dev)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None, src_center=None):
        if src_mask is None:
            src_mask = torch.ones(src.shape[:2], dtype=torch.bool, device=src.device)
        if tgt_mask is None:
            tgt_mask = torch.ones(tgt.shape[:2], dtype=torch.bool, device=tgt.device)
        if src_center is None:
            src_center = masked_centroid(src, src_mask, self.point_reduce)
        return self.trunk(src, tgt, src_mask, tgt_mask, src_center)

    @staticmethod
    def loss(src_pred, src, rot_gt, trans_gt, src_mask=None, point_reduce=None):
        """Masked mean per-point L1 to the GT-transformed source: sum |.|
        over xyz, mean over valid points, mean over the batch (reference
        ``models/pointnet.py:93-99``). ``point_reduce`` sums the per-item
        sums over the ranks holding the other points (SP, with a mask)."""
        l1 = torch.abs(src_pred - gt_aligned_src(src, rot_gt, trans_gt)).sum(-1)  # (B, N)
        return _masked_item_mean(l1, src_mask, point_reduce)


class DEMTransformer(nn.Module):
    """OpenGF ground generator: ``(dsm, dem_coarse) -> dem_pred``.

    Separate stems, no input centring (reference ``models/pointnet.py:103-161``):
    the trunk sees a zero ``src_center``. A config without
    ``separate_stems`` is taken with it, as in the JAX package. Parameters
    are drawn from ``generator`` (seed 0 if None) on the CPU, then moved to
    ``device``.
    """

    def __init__(self, cfg: ModelConfig = ModelConfig(separate_stems=True), *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if not cfg.separate_stems:
            cfg = dataclasses.replace(cfg, separate_stems=True)
        self.cfg = cfg
        self.trunk = _Trunk(cfg, generator)
        self.point_reduce = None  # as PointTransformer's
        self.to(dev)

    def forward(self, dsm, dem_coarse, dsm_mask=None, dem_mask=None):
        if dsm_mask is None:
            dsm_mask = torch.ones(dsm.shape[:2], dtype=torch.bool, device=dsm.device)
        if dem_mask is None:
            dem_mask = torch.ones(dem_coarse.shape[:2], dtype=torch.bool,
                                  device=dem_coarse.device)
        zero_center = torch.zeros((dsm.shape[0], 1, 3), dtype=dsm.dtype, device=dsm.device)
        return self.trunk(dsm, dem_coarse, dsm_mask, dem_mask, zero_center)

    @staticmethod
    def loss(dem_pred, dem_gt, mask=None, point_reduce=None):
        """Masked mean per-point L1 (reference ``models/pointnet.py:163-167``);
        ``point_reduce`` as in :meth:`PointTransformer.loss`."""
        l1 = torch.abs(dem_pred - dem_gt).sum(-1)
        return _masked_item_mean(l1, mask, point_reduce)


def _masked_item_mean(l1, mask, point_reduce):
    """Mean over valid points of each item, then over the batch."""
    if mask is None:
        if point_reduce is not None:
            raise ValueError("a sequence-parallel loss needs the point mask")
        return l1.mean()
    m = mask.to(l1.dtype)
    num, den = (l1 * m).sum(1), m.sum(1)
    if point_reduce is not None:
        num, den = point_reduce(num), point_reduce(den)
    return (num / torch.clamp_min(den, 1.0)).mean()
