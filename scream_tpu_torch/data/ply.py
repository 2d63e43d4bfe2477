"""First-party PLY point-cloud reader/writer (no open3d/plyfile dependency);
the port's copy of ``scream_tpu/data/ply.py`` (pure numpy).

The reference ingests point clouds via Open3D, which reads PLY natively;
this framework's CLI accepts raw scans directly (`register --src/--tgt/
--scans/--manifest`), so PLY — the lingua franca of scan datasets — needs a
first-party path just like LAS (`data/las.py`). Supports the formats scan
tooling actually emits:

  * ``format ascii 1.0``
  * ``format binary_little_endian 1.0`` / ``binary_big_endian 1.0``
  * any ``element vertex`` property layout (x/y/z picked out by name, other
    properties skipped with correct strides), ``list`` properties rejected
    for vertices (legal PLY, but no scan tool puts lists on vertices),
  * non-vertex elements (faces etc.) after the vertex block are ignored —
    points are what the registration stack consumes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_TYPES: Dict[str, str] = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> np.ndarray:
    """Read the vertex positions of a PLY file -> ``(N, 3)`` float32."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file (magic {magic!r})")
        fmt = None
        # Header elements IN DECLARATION ORDER — the data blocks follow the
        # same order, so elements declared BEFORE vertex must be skipped
        # over (a camera/obj_info element first is spec-legal).
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: header ended before end_header")
            parts = line.decode("ascii", "replace").strip().split()
            if not parts or parts[0] in ("comment", "obj_info"):
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if not elements:
                    raise ValueError(f"{path}: property before any element")
                if parts[1] == "list":
                    # List sizes are data-dependent: impossible to skip and
                    # unsupported on vertices (no scan tool emits them there).
                    elements[-1][2].append((parts[-1], "list"))
                else:
                    if parts[1] not in _TYPES:
                        raise ValueError(f"{path}: unknown type {parts[1]!r}")
                    elements[-1][2].append((parts[-1], _TYPES[parts[1]]))
            elif parts[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
            raise ValueError(f"{path}: unsupported format {fmt!r}")
        vertex_idx = [k for k, (nm, _, _) in enumerate(elements)
                      if nm == "vertex"]
        if not vertex_idx:
            raise ValueError(f"{path}: no vertex element")
        before = elements[: vertex_idx[0]]
        _, n_vertex, props = elements[vertex_idx[0]]
        for el_name, _, el_props in before + [("vertex", 0, props)]:
            for pn, pc in el_props:
                if pc == "list":
                    raise ValueError(
                        f"{path}: list property {pn!r} on element "
                        f"{el_name!r} (before/at vertex) is unsupported")
        names = [n for n, _ in props]
        for axis in ("x", "y", "z"):
            if axis not in names:
                raise ValueError(f"{path}: vertex element lacks {axis!r}")
        endian = ">" if fmt == "binary_big_endian" else "<"

        if fmt == "ascii":
            for _, count, _ in before:  # skip pre-vertex element rows
                for _ in range(count):
                    f.readline()
            rows = np.loadtxt(
                f, dtype=np.float64, max_rows=n_vertex, usecols=None,
                ndmin=2,
            )
            if rows.shape[0] != n_vertex or rows.shape[1] < len(props):
                raise ValueError(
                    f"{path}: expected {n_vertex} x {len(props)} vertex "
                    f"table, got {rows.shape}")
            cols = [names.index(a) for a in ("x", "y", "z")]
            return rows[:, cols].astype(np.float32)

        skip = sum(count * np.dtype(
            [(n, endian + c) for n, c in el_props]).itemsize
            for _, count, el_props in before)
        if skip:
            f.seek(skip, 1)
        dt = np.dtype([(n, endian + c) for n, c in props])
        buf = f.read(dt.itemsize * n_vertex)
        if len(buf) < dt.itemsize * n_vertex:
            raise ValueError(
                f"{path}: truncated vertex data ({len(buf)} bytes for "
                f"{n_vertex} x {dt.itemsize})")
        rec = np.frombuffer(buf, dtype=dt, count=n_vertex)
        return np.stack([rec[a].astype(np.float32)
                         for a in ("x", "y", "z")], axis=1)


def write_ply(path: str, xyz: np.ndarray, binary: bool = True) -> None:
    """Write ``(N, 3)`` positions as PLY (binary_little_endian or ascii)."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    header = (
        "ply\n"
        f"format {'binary_little_endian' if binary else 'ascii'} 1.0\n"
        f"element vertex {len(xyz)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(np.ascontiguousarray(xyz, "<f4").tobytes())
        else:
            np.savetxt(f, xyz, fmt="%.9g")


def load_cloud_any(path: str) -> np.ndarray:
    """Load a point cloud by extension: .npy, .ply, .las/.laz -> (N, 3)
    float32. The single loader behind the register CLI's file arguments."""
    lower = path.lower()
    if lower.endswith(".ply"):
        return read_ply(path)
    if lower.endswith((".las", ".laz")):
        from scream_tpu_torch.data.las import read_las

        return read_las(path)[0].astype(np.float32)
    return np.load(path).astype(np.float32)
