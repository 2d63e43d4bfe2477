"""Host point ops of the port: ``pointops.cpp`` bound with ``ctypes``.

The offline preprocessors (``data/preprocess.py``, ``data/raw.py``) and the
OpenGF loader call four host ops: the voxel-grid downsample and three radius
queries (any neighbour, neighbour count, highest point in a 2-D radius).
They run in ``pointops.cpp``, the port's own copy of the JAX package's
native library, which builds with ``g++ -O3 -fPIC -shared`` at first use
into ``build/scream_tpu_torch/`` next to the package, named by a hash of the
source and flags (as ``ops/_build.py`` names the CUDA library). A failed
build or load raises: there is no silent numpy path.

The numpy plain versions (``*_plain``) compute the same functions by brute
force; the tests hold the library to them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "pointops.cpp"
BUILD_DIR = SRC.parents[2] / "build" / "scream_tpu_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-shared"]
_PLAIN_CHUNK = 1024  # query rows per step of the brute-force plain versions

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpointops_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``pointops.cpp`` unless this exact source has a library."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; it builds the port's host point ops "
                           f"({SRC})")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded point-ops library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            c_d = ctypes.POINTER(ctypes.c_double)
            c_i32 = ctypes.POINTER(ctypes.c_int32)
            c_u8 = ctypes.POINTER(ctypes.c_uint8)
            i64, f64 = ctypes.c_int64, ctypes.c_double
            lib.voxel_downsample.restype = i64
            lib.voxel_downsample.argtypes = [c_d, i64, f64, c_d]
            lib.radius_has_neighbor.restype = None
            lib.radius_has_neighbor.argtypes = [c_d, i64, c_d, i64, f64, c_u8]
            lib.radius_count.restype = None
            lib.radius_count.argtypes = [c_d, i64, c_d, i64, f64, c_i32]
            lib.highest_in_radius_2d.restype = None
            lib.highest_in_radius_2d.argtypes = [c_d, i64, c_d, i64, f64, c_i32]
            _lib = lib
        return _lib


def _as_c(arr) -> np.ndarray:
    """``(n, 3)`` C-contiguous float64 (the library's layout)."""
    a = np.ascontiguousarray(arr, dtype=np.float64)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"expected an (n, 3) cloud, got shape {a.shape}")
    return a


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def voxel_downsample(points, voxel_size: float) -> np.ndarray:
    """Centroid per occupied voxel, ordered by the linearized voxel key;
    float64 sums, fp32 out."""
    pts = _as_c(points)
    out = np.empty_like(pts)
    n = library().voxel_downsample(_ptr(pts, ctypes.c_double), len(pts), float(voxel_size),
                                   _ptr(out, ctypes.c_double))
    return out[:n].astype(np.float32)


def radius_has_neighbor(query, ref, radius: float) -> np.ndarray:
    """Per query point: whether any ref point lies within ``radius``
    (inclusive)."""
    q, r = _as_c(query), _as_c(ref)
    out = np.empty(len(q), dtype=np.uint8)
    library().radius_has_neighbor(_ptr(q, ctypes.c_double), len(q), _ptr(r, ctypes.c_double),
                                  len(r), float(radius), _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def radius_count(query, ref, radius: float) -> np.ndarray:
    """Per query point: the number of ref points within ``radius``
    (inclusive), int32."""
    q, r = _as_c(query), _as_c(ref)
    out = np.empty(len(q), dtype=np.int32)
    library().radius_count(_ptr(q, ctypes.c_double), len(q), _ptr(r, ctypes.c_double),
                           len(r), float(radius), _ptr(out, ctypes.c_int32))
    return out


def highest_in_radius_2d(query, ref, radius: float) -> np.ndarray:
    """Per query point: the index of the highest-z ref point within the 2-D
    ``radius`` (ties to the lowest index), -1 where there is none."""
    q, r = _as_c(query), _as_c(ref)
    out = np.empty(len(q), dtype=np.int32)
    library().highest_in_radius_2d(_ptr(q, ctypes.c_double), len(q),
                                   _ptr(r, ctypes.c_double), len(r), float(radius),
                                   _ptr(out, ctypes.c_int32))
    return out


def voxel_downsample_plain(points, voxel_size: float) -> np.ndarray:
    """Plain version of :func:`voxel_downsample`: a stable sort by voxel key,
    then per-voxel float64 sums in input order."""
    pts = np.asarray(points, dtype=np.float64)
    origin = pts.min(axis=0)
    coords = np.floor((pts - origin) / voxel_size).astype(np.int64)
    dims = coords.max(axis=0) + 1
    key = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    starts = np.flatnonzero(np.concatenate([[True], key_sorted[1:] != key_sorted[:-1]]))
    sums = np.add.reduceat(pts[order], starts, axis=0)
    counts = np.diff(np.concatenate([starts, [len(pts)]]))
    return (sums / counts[:, None]).astype(np.float32)


def _within(query, ref, radius: float, dims: int):
    """Yield ``(rows, (n, m) bool)``: which ref points lie within ``radius``
    of each query point in the first ``dims`` coordinates, by brute force
    in float64 (the library's ``dx*dx + dy*dy (+ dz*dz) <= r*r``)."""
    q, r = _as_c(query), _as_c(ref)
    r2 = float(radius) * float(radius)
    for n0 in range(0, len(q), _PLAIN_CHUNK):
        d = q[n0:n0 + _PLAIN_CHUNK, None, :dims] - r[None, :, :dims]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        if dims == 3:
            d2 = d2 + d[..., 2] * d[..., 2]
        yield slice(n0, n0 + _PLAIN_CHUNK), d2 <= r2


def radius_has_neighbor_plain(query, ref, radius: float) -> np.ndarray:
    """Plain version of :func:`radius_has_neighbor`."""
    out = np.zeros(len(query), dtype=bool)
    for rows, hit in _within(query, ref, radius, 3):
        out[rows] = hit.any(axis=1)
    return out


def radius_count_plain(query, ref, radius: float) -> np.ndarray:
    """Plain version of :func:`radius_count`."""
    out = np.zeros(len(query), dtype=np.int32)
    for rows, hit in _within(query, ref, radius, 3):
        out[rows] = hit.sum(axis=1)
    return out


def highest_in_radius_2d_plain(query, ref, radius: float) -> np.ndarray:
    """Plain version of :func:`highest_in_radius_2d` (``argmax`` takes the
    first, lowest index of equal heights)."""
    z = _as_c(ref)[:, 2]
    out = np.full(len(query), -1, dtype=np.int32)
    for rows, hit in _within(query, ref, radius, 2):
        if hit.shape[1] == 0:
            continue
        best = np.argmax(np.where(hit, z[None, :], -np.inf), axis=1)
        out[rows] = np.where(hit.any(axis=1), best, -1)
    return out
