"""Host-side visualization: registration overlays, depth images, DEM maps
(port of ``scream_tpu/utils/viz.py``; numpy in, files out).

Counterpart of the reference's Open3D window flows (reference
``visualize_3d_match.py``, ``visualize_kitti.py``, ``visualize_open_gf.py``,
``visualize_depth_image.py``) and its image dumps (``deep_to_img``,
reference ``utils.py:81-91``). Headless: the figures are matplotlib's, which
each drawing function imports when it runs, as the JAX package does; the
colour conventions match (src yellow, tgt blue, prediction green).
:func:`save_depth_image_grid`, the GAN sample dump, writes its PNG with a
stdlib encoder (``zlib``, ``struct``) instead of ``plt.imsave`` (the same
pixels), so the dump needs no matplotlib.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence

import numpy as np

SRC_COLOR = (1.0, 0.706, 0.0)  # yellow (reference to_o3d_pcd calls)
TGT_COLOR = (0.0, 0.651, 0.929)  # blue
PRED_COLOR = (0.1, 0.8, 0.3)  # green


def _fig3d():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.set_box_aspect((1, 1, 1))
    return fig, ax


def plot_registration(
    src: np.ndarray,
    tgt: np.ndarray,
    transform: Optional[np.ndarray] = None,
    src_pred: Optional[np.ndarray] = None,
    path: Optional[str] = None,
    point_size: float = 1.0,
):
    """Scatter src (optionally transformed) over tgt; optionally the prediction.

    Mirrors the reference's before/after windows
    (reference ``visualize_3d_match.py:118-124``).
    """
    fig, ax = _fig3d()
    s = np.asarray(src)
    if transform is not None:
        T = np.asarray(transform)
        s = s @ T[:3, :3].T + T[:3, 3]
    ax.scatter(*s.T, c=[SRC_COLOR], s=point_size, label="src")
    ax.scatter(*np.asarray(tgt).T, c=[TGT_COLOR], s=point_size, label="tgt")
    if src_pred is not None:
        ax.scatter(*np.asarray(src_pred).T, c=[PRED_COLOR], s=point_size,
                   label="src_pred")
    ax.legend()
    if path:
        fig.savefig(path, dpi=120)
        import matplotlib.pyplot as plt

        plt.close(fig)
    return fig


def plot_correspondences(
    src: np.ndarray,
    tgt: np.ndarray,
    src_idx: Sequence[int],
    tgt_idx: Sequence[int],
    path: Optional[str] = None,
    max_lines: int = 200,
):
    """Correspondence 'flow lines' between clouds
    (reference ``visualize_3d_match.py:98-110``)."""
    fig, ax = _fig3d()
    src = np.asarray(src)
    tgt = np.asarray(tgt)
    ax.scatter(*src.T, c=[SRC_COLOR], s=1.0)
    ax.scatter(*tgt.T, c=[TGT_COLOR], s=1.0)
    si = np.asarray(src_idx)[:max_lines]
    ti = np.asarray(tgt_idx)[:max_lines]
    for a, b in zip(src[si], tgt[ti]):
        ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], c="red", lw=0.4)
    if path:
        fig.savefig(path, dpi=120)
        import matplotlib.pyplot as plt

        plt.close(fig)
    return fig


FLOW_COLOR = (224 / 255, 238 / 255, 238 / 255)  # the reference's line color


def plot_prediction_flow(
    src: np.ndarray,
    src_pred: np.ndarray,
    selected: Optional[np.ndarray] = None,
    path: Optional[str] = None,
    max_lines: int = 400,
    point_size: float = 1.0,
):
    """Zero-match 'flow lines': one line from every source point to its
    predicted position in the target frame.

    The reference draws an Open3D LineSet pairing ``src_pc`` with
    ``src_pred_pc`` point-for-point in light gray (224/238/238)
    (reference ``visualize_3d_match.py:98-110``). ``selected`` marks the
    correspondence subset (NN distance under threshold) highlighted by the
    'selected' window (`:115-116`).
    """
    fig, ax = _fig3d()
    src = np.asarray(src)
    pred = np.asarray(src_pred)
    ax.scatter(*src.T, c=[SRC_COLOR], s=point_size, label="src")
    ax.scatter(*pred.T, c=[(3 / 255, 168 / 255, 158 / 255)], s=point_size,
               label="src_pred")
    step = max(1, len(src) // max_lines)
    for a, b in zip(src[::step], pred[::step]):
        ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                c=FLOW_COLOR, lw=0.4)
    if selected is not None:
        sel = np.asarray(selected, dtype=bool)
        if sel.any():
            ax.scatter(*src[sel].T, c="red", s=point_size * 3, label="selected")
            ax.scatter(*pred[sel].T, c="darkred", s=point_size * 3)
    ax.legend()
    if path:
        fig.savefig(path, dpi=120)
        import matplotlib.pyplot as plt

        plt.close(fig)
    return fig


def depth_images_to_rgb(imgs: np.ndarray) -> np.ndarray:
    """2-channel depth image(s) -> uint8 RGB, src yellow / tgt blue.

    Same coloring rule as reference ``utils.py:81-91`` (``deep_to_img``):
    per pixel, the brighter channel wins; intensity scales the cloud color.
    Accepts ``(..., 2, H, W)`` in [-1, 1]; returns ``(..., H, W, 3)`` uint8.
    """
    imgs = np.asarray(imgs) * 0.5 + 0.5  # back to [0, 1]
    src_ch = imgs[..., 0, :, :]
    tgt_ch = imgs[..., 1, :, :]
    src_rgb = src_ch[..., None] * np.array(SRC_COLOR)
    tgt_rgb = tgt_ch[..., None] * np.array(TGT_COLOR)
    rgb = np.where((src_ch >= tgt_ch)[..., None], src_rgb, tgt_rgb)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def write_png_rgb(path: str, rgb: np.ndarray) -> None:
    """Write an ``(H, W, 3)`` uint8 image as an 8-bit RGB PNG (stdlib only:
    one IDAT of zlib-compressed rows, filter type 0)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_png_rgb: expected (H, W, 3), got {rgb.shape}")
    raw = b"".join(b"\x00" + rgb[r].tobytes() for r in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_depth_image_grid(imgs: np.ndarray, path: str):
    """Save a ``(V, 2, H, W)`` multi-view render as one horizontal strip,
    the reference's GAN sample-dump format (reference
    ``train_3d_match.py:211-214``): the pixels of ``plt.imsave`` on
    :func:`depth_images_to_rgb`'s strip, written by :func:`write_png_rgb`."""
    rgb = depth_images_to_rgb(imgs)  # (V, H, W, 3)
    write_png_rgb(path, np.concatenate(list(rgb), axis=1))


def plot_prediction_error(
    src_pred: np.ndarray,
    src_gt: np.ndarray,
    tgt: Optional[np.ndarray] = None,
    threshold: float = 0.075,
    path: Optional[str] = None,
    point_size: float = 1.0,
):
    """Color predicted source points by correctness: within ``threshold`` of
    their GT-registered position = green, mispredicted = red.

    The reference's interactive ``look()`` QA view
    (reference ``train_3d_match.py:54-103``, mispredicted coloring
    `:94-97`).
    """
    fig, ax = _fig3d()
    src_pred = np.asarray(src_pred)
    err = np.linalg.norm(src_pred - np.asarray(src_gt), axis=-1)
    ok = err < threshold
    if tgt is not None:
        ax.scatter(*np.asarray(tgt).T, c=[TGT_COLOR], s=point_size, label="tgt")
    ax.scatter(*src_pred[ok].T, c=[PRED_COLOR], s=point_size, label="pred ok")
    if (~ok).any():
        ax.scatter(*src_pred[~ok].T, c="red", s=point_size * 2, label="mispredicted")
    ax.legend()
    if path:
        fig.savefig(path, dpi=120)
        import matplotlib.pyplot as plt

        plt.close(fig)
    return fig


def plot_dem_height(
    points: np.ndarray,
    path: Optional[str] = None,
    cmap: str = "jet",
    point_size: float = 2.0,
):
    """Top-down DEM scatter with JET height colormap
    (reference ``visualize_open_gf.py:24-35``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    points = np.asarray(points)
    fig, ax = plt.subplots(figsize=(8, 8))
    sc = ax.scatter(points[:, 0], points[:, 1], c=points[:, 2], cmap=cmap,
                    s=point_size)
    fig.colorbar(sc, ax=ax, label="height")
    ax.set_aspect("equal")
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def stitch_patches(
    patches: Sequence[np.ndarray],
    centers: Sequence[np.ndarray],
    scale_factor: float = 50.0,
) -> np.ndarray:
    """Recompose per-patch DEM predictions into the full scene cloud.

    The reference stitches all 650 test tiles by adding back each patch
    center (reference ``visualize_open_gf.py:96-137``).
    """
    out = []
    for pts, c in zip(patches, centers):
        pts = np.asarray(pts) * scale_factor
        c = np.asarray(c).reshape(-1)
        shifted = pts.copy()
        # Full 3-D center (incl. elevation), as the reference's
        # `dem_pred * 50 + c` (`visualize_open_gf.py:108`); 2-vector centers
        # from older artifacts shift x/y only.
        shifted[:, : len(c)] += c[: shifted.shape[1]]
        out.append(shifted)
    return np.concatenate(out, axis=0)
