"""Minimal LAS/LAZ LiDAR reader (+ writer for fixtures) — no laspy needed;
the port's copy of ``scream_tpu/data/las.py`` (pure numpy).

The reference ingests OpenGF ``.laz`` tiles with laspy
(reference `process_open_gf.py:13-56`: ``laz.xyz`` +
``laz.classification``, class-0 points dropped). This module closes that
preprocessing gap first-party:

  * :func:`read_las` — pure-numpy parser for uncompressed ``.las``
    (versions 1.1-1.4, point record formats 0-10): header, scaled int32
    coordinates, classification byte.
  * ``.laz`` (LASzip-compressed) is dispatched to laspy *if installed*
    (optional dependency — not bundled in this image); otherwise a clear
    error tells the user to either install laspy/lazrs or convert to .las.
  * :func:`write_las` — minimal LAS 1.2 / format-0 writer (test fixtures,
    interchange).
  * :func:`read_opengf_cloud`, the reference's scene lists and
    :func:`_existing` — the OpenGF ingestion of ``preprocess opengf``.

Header/record layouts follow the public ASPRS LAS 1.4 specification.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

_HEADER_FMT = "<4sHHLHH8sBB32s32sHHHLLBHL"  # through legacy point count

# Byte offset of the classification field within a point record, per format.
# Formats 0-5: X(4) Y(4) Z(4) intensity(2) flags(1) -> classification at 15.
# Formats 6-10: X Y Z intensity(2) returns(1) class-flags(1) -> class at 16.
_CLASS_OFFSET = {**{f: 15 for f in range(6)}, **{f: 16 for f in range(6, 11)}}


def read_las(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a ``.las``/``.laz`` file -> ``(xyz float64 (N, 3), classification
    uint8 (N,))``.

    Uncompressed ``.las`` is parsed directly; ``.laz`` needs laspy+lazrs
    installed (optional).
    """
    with open(path, "rb") as f:
        head = f.read(375)
    if head[:4] != b"LASF":
        raise ValueError(f"{path}: not a LAS file (missing LASF signature)")
    # LAS 1.0-1.3 headers are >= 227 bytes; anything shorter is a truncated
    # download and every unpack below would be garbage (or a struct.error).
    if len(head) < 227:
        raise ValueError(
            f"{path}: truncated LAS header ({len(head)} bytes, need >= 227)"
        )

    offset_to_points = struct.unpack_from("<L", head, 96)[0]
    fmt_byte = head[104]
    record_len = struct.unpack_from("<H", head, 105)[0]
    n_points = struct.unpack_from("<L", head, 107)[0]
    version_minor = head[25]
    if version_minor >= 4 and n_points == 0:
        # LAS 1.4 moved the (64-bit) point count past the legacy fields.
        if len(head) < 255:
            raise ValueError(
                f"{path}: truncated LAS 1.4 header ({len(head)} bytes)"
            )
        n_points = struct.unpack_from("<Q", head, 247)[0]

    if fmt_byte & 0xC0:
        # LASzip sets the compression bit(s) in the point-format byte.
        return _read_laz_via_laspy(path)
    fmt = fmt_byte & 0x3F
    if fmt not in _CLASS_OFFSET:
        raise ValueError(f"{path}: unsupported point record format {fmt}")
    # Record must hold the 12 xyz bytes and the classification byte this
    # format promises; a corrupt header otherwise turns the reshape/column
    # reads below into shape errors instead of a diagnosis.
    min_len = max(12, _CLASS_OFFSET[fmt] + 1)
    if record_len < min_len:
        raise ValueError(
            f"{path}: point record length {record_len} too small for "
            f"format {fmt} (needs >= {min_len})"
        )

    scale = np.frombuffer(head, "<f8", 3, 131)
    offset = np.frombuffer(head, "<f8", 3, 155)

    with open(path, "rb") as f:
        f.seek(offset_to_points)
        raw = np.fromfile(f, dtype=np.uint8, count=n_points * record_len)
    if raw.size < n_points * record_len:
        raise ValueError(
            f"{path}: truncated point data ({raw.size} bytes for "
            f"{n_points} x {record_len})"
        )
    rec = raw.reshape(n_points, record_len)

    ixyz = rec[:, :12].copy().view("<i4").reshape(n_points, 3)
    xyz = ixyz.astype(np.float64) * scale + offset
    cls = rec[:, _CLASS_OFFSET[fmt]].copy()
    if fmt < 6:
        # Formats 0-5 pack synthetic/key-point/withheld flags into the top
        # three classification bits (LAS <= 1.3).
        cls = cls & 0x1F
    return xyz, cls


def _read_laz_via_laspy(path: str) -> Tuple[np.ndarray, np.ndarray]:
    try:
        import laspy  # optional
    except ImportError as e:
        raise ImportError(
            f"{path} is LASzip-compressed; reading it needs the optional "
            "laspy[lazrs] dependency (pip install 'laspy[lazrs]'), or "
            "convert it to uncompressed .las first (e.g. `las2las`)"
        ) from e
    f = laspy.read(path)
    return np.asarray(f.xyz, dtype=np.float64), np.asarray(f.classification, np.uint8)


def write_las(path: str, xyz: np.ndarray, classification: np.ndarray,
              scale: float = 0.001) -> None:
    """Write a minimal uncompressed LAS 1.2 / point-format-0 file."""
    xyz = np.asarray(xyz, np.float64)
    cls = np.asarray(classification, np.uint8)
    n = len(xyz)
    assert cls.shape == (n,)
    offset = xyz.min(axis=0) if n else np.zeros(3)
    header_size, record_len = 227, 20

    header = bytearray(header_size)
    header[0:4] = b"LASF"
    header[24], header[25] = 1, 2  # version 1.2
    struct.pack_into("<H", header, 94, header_size)
    struct.pack_into("<L", header, 96, header_size)  # points follow header
    struct.pack_into("<L", header, 100, 0)  # no VLRs
    header[104] = 0  # point format 0
    struct.pack_into("<H", header, 105, record_len)
    struct.pack_into("<L", header, 107, n)
    struct.pack_into("<L", header, 111, n)  # points-by-return[0]
    for k in range(3):
        struct.pack_into("<d", header, 131 + 8 * k, scale)
        struct.pack_into("<d", header, 155 + 8 * k, offset[k])
    # max/min x, y, z pairs
    for k in range(3):
        mx = xyz[:, k].max() if n else 0.0
        mn = xyz[:, k].min() if n else 0.0
        struct.pack_into("<d", header, 179 + 16 * k, mx)
        struct.pack_into("<d", header, 187 + 16 * k, mn)

    rec = np.zeros((n, record_len), np.uint8)
    ixyz = np.round((xyz - offset) / scale).astype("<i4")
    rec[:, :12] = ixyz.view(np.uint8).reshape(n, 12)
    rec[:, 15] = cls & 0x1F
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(rec.tobytes())


def read_opengf_cloud(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """OpenGF ingestion semantics (reference ``process_open_gf.py:26-32``):
    read xyz + classification and drop never-classified (class 0) points.

    Returns RAW OpenGF classes (1 = non-ground, 2 = ground): the reference's
    stored ``class - 1`` column with its later ``== 1`` ground test is the
    same predicate as ``ground_classes=(2,)`` in
    ``data/preprocess.py:tile_opengf_scene``.
    """
    xyz, cls = read_las(path)
    keep = cls != 0
    return xyz[keep], cls[keep]


# The reference's scene lists (reference ``process_open_gf.py:16-20,42``).
OPENGF_TRAIN_FILES = (
    [f"train/S7_{i}.laz" for i in range(1, 10)]
    + [f"train/S8_{i}.laz" for i in range(1, 10)]
    + [f"train/S9_{i}.laz" for i in range(1, 20)]
)
OPENGF_VAL_FILES = [f"val/S{i}_v.laz" for i in range(7, 10)]
OPENGF_TEST_FILES = ["test/test.laz"]


def _existing(root: str, rel_paths) -> list:
    """Resolve the canonical .laz names, accepting .las twins."""
    out = []
    for rel in rel_paths:
        p = os.path.join(root, rel)
        if os.path.exists(p):
            out.append(p)
        elif os.path.exists(p[:-4] + ".las"):
            out.append(p[:-4] + ".las")
    return out
