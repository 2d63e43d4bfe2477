"""Differentiable multi-view depth-image renderer (port of
``scream_tpu/ops/render.py``; reference ``models/render.py:8-73``).

The math of the reference ``render``/``forward``, batched over pairs:

* each of V fixed view rotations turns the concatenated ``[src_pred; tgt]``
  cloud; the six views are Rz(0)Ry(b)Rx(c) for (b, c) in {(0,0), (pi/2,0),
  (pi,0), (3pi/2,0), (0,pi/2), (0,3pi/2)} (reference ``:17-25,67``);
* a point's intensity is its inverse depth normalized over the union of both
  clouds (``:29-31``), with the depth bounds detached, as the reference
  reads them with ``.item()``;
* each pixel takes the max over src points and over tgt points separately of
  ``intensity * exp(-d^2 rho^2 / 2)`` against the normalized pixel grid
  (``:14-16,42-50``): :mod:`scream_tpu_torch.ops.splat_cuda`;
* the output ``(B, V, 2, w, w)`` is mapped to [-1, 1] (``:59,70``).

Masked points contribute intensity 0 and leave the depth range alone.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from scream_tpu_torch.config import RenderConfig
from scream_tpu_torch.ops.splat_cuda import max_splat, max_splat_plain, pixel_grid
from scream_tpu_torch.utils import device as device_util

__all__ = ["view_matrices", "pixel_grid", "splat_inputs", "render_depth_images",
           "render_from_config"]

_BIG = 3e38


def _ry(b):
    c, s = math.cos(b), math.sin(b)
    return [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]


def _rx(a):
    c, s = math.cos(a), math.sin(a)
    return [[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]]


def view_matrices(multi_view: bool = True, view_mode: Optional[str] = None,
                  device=None) -> torch.Tensor:
    """The fixed view rotations ``(V, 3, 3)``: "multi" (six views),
    "identity" (one), or "back" (the single Ry(pi) view of the KITTI GAN
    variant, reference ``train_kitti.py:47-48``); ``view_mode`` None takes
    multi or identity from ``multi_view``."""
    if view_mode is None:
        view_mode = "multi" if multi_view else "identity"
    if view_mode == "identity":
        mats = [[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]]
    elif view_mode == "back":
        mats = [_ry(math.pi)]
    elif view_mode == "multi":
        half = math.pi / 2.0
        mats = [_ry(0.0), _ry(half), _ry(2 * half), _ry(3 * half), _rx(half),
                _rx(3 * half)]
    else:
        raise ValueError(f"unknown view_mode {view_mode!r}")
    return torch.tensor(mats, dtype=torch.float32, device=device)


def splat_inputs(src_pred, tgt, src_mask, tgt_mask, views):
    """The splat's inputs for every (pair, view): ``xy`` and ``vals``
    ``(B*V, N+M, 2)``, the rotated points' xy and their (src, tgt)
    intensities, ``1 - (depth - dmin) / (dmax - dmin)`` over the pair's
    valid points with the bounds detached, 0 on masked rows and on the other
    channel's rows."""
    B, n = src_pred.shape[0], src_pred.shape[1]
    dev = src_pred.device
    pts = torch.cat([src_pred, tgt], dim=1).float()  # (B, N+M, 3)
    mask = torch.cat([src_mask, tgt_mask], dim=1)[:, None, :]
    src_rows = torch.arange(pts.shape[1], device=dev) < n
    m_src = mask & src_rows
    m_tgt = mask & ~src_rows

    rp = torch.einsum("bnc,vdc->bvnd", pts, views)  # (B, V, N+M, 3)
    depth = rp[..., 2]
    dmin = torch.where(mask, depth, _BIG).amin(-1, keepdim=True).detach()
    dmax = torch.where(mask, depth, -_BIG).amax(-1, keepdim=True).detach()
    pix_val = 1.0 - (depth - dmin) / torch.clamp_min(dmax - dmin, 1e-8)
    vals = torch.stack([torch.where(m_src, pix_val, 0.0),
                        torch.where(m_tgt, pix_val, 0.0)], dim=-1)  # (B, V, N+M, 2)
    n_total = pts.shape[1]
    return (rp[..., :2].reshape(B * views.shape[0], n_total, 2),
            vals.reshape(B * views.shape[0], n_total, 2))


def render_depth_images(
    src_pred: torch.Tensor,
    tgt: torch.Tensor,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
    rho: float = 24.0,
    width: int = 64,
    multi_view: bool = True,
    tile: int = 256,
    use_pallas: Optional[bool] = None,
    view_mode: Optional[str] = None,
) -> torch.Tensor:
    """Render ``(B, V, 2, width, width)`` depth images in [-1, 1] from
    ``src_pred`` ``(B, N, 3)`` and ``tgt`` ``(B, M, 3)`` with boolean masks.

    ``use_pallas`` (the JAX name of the switch): None = the splat kernel for
    CUDA tensors and the plain renderer for CPU tensors; True = the kernel's
    wrapper (:func:`~scream_tpu_torch.ops.splat_cuda.max_splat`, its plain
    version for CPU tensors, argmax backward); False = the plain renderer,
    ``tile`` pixels at a time, differentiated by autograd. All B x V images
    go to the splat in one call."""
    B, n = src_pred.shape[0], src_pred.shape[1]
    dev = src_pred.device
    if src_mask is None:
        src_mask = torch.ones((B, n), dtype=torch.bool, device=dev)
    if tgt_mask is None:
        tgt_mask = torch.ones((B, tgt.shape[1]), dtype=torch.bool, device=dev)
    if use_pallas is None:
        use_pallas = device_util.on_cuda(src_pred)

    views = view_matrices(multi_view, view_mode, dev)  # (V, 3, 3)
    xy, vals = splat_inputs(src_pred, tgt, src_mask, tgt_mask, views)
    if use_pallas:
        imgs = max_splat(xy, vals, rho, width)
    else:
        imgs = max_splat_plain(xy, vals, rho, width, tile)[0]
    imgs = (imgs - 0.5) / 0.5
    return imgs.reshape(B, views.shape[0], 2, width, width)


def render_from_config(src_pred, tgt, cfg: RenderConfig, src_mask=None,
                       tgt_mask=None) -> torch.Tensor:
    return render_depth_images(
        src_pred, tgt, src_mask, tgt_mask, rho=cfg.rho, width=cfg.width,
        multi_view=cfg.multi_view, view_mode=cfg.view_mode,
        use_pallas=cfg.use_pallas)
