"""Build the port's CUDA kernels with ``nvcc``, load them with ``ctypes``,
and the checks every kernel wrapper makes around a launch.

Each source under ``scream_tpu_torch/csrc/*.cu`` compiles to an object in
its own ``nvcc`` process, all started together, and one more ``nvcc`` links
the objects into one shared library with a plain C interface (no PyTorch
headers), which takes seconds a file where PyTorch's extension builder takes
minutes. The library lands under ``build/`` next to the package
(git-ignored), named by a hash of the sources and flags, so an edit rebuilds
and an unchanged tree reuses it.

The build happens at first use (:func:`kernels`), never at import: the CPU
tests import every module on hosts without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "scream_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the last build in this process
build_log = ""  # nvcc's output for the loaded library (ptxas register/smem report)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else
    ``/usr/local/cuda/bin/nvcc``; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA toolkit is needed to build the scream_tpu_torch kernels")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libscream_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds, timeout=900):
    """Run the commands at once; (return code, output, wall seconds) of
    each, in order. Every process still running when this returns or raises
    is killed."""
    procs, done = [], {}

    def wait(i, p, t0):
        try:
            out = p.communicate(timeout=timeout)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0]
        done[i] = (p.returncode, out, time.perf_counter() - t0)

    threads = []
    try:
        for i, cmd in enumerate(cmds):
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
            threads.append(threading.Thread(target=wait, daemon=True,
                                            args=(i, procs[-1], time.perf_counter())))
            threads[-1].start()
        for th in threads:
            th.join()
        return [done[i] for i in range(len(cmds))]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def build() -> Path:
    """Compile the sources if this exact tree has no library yet: one nvcc
    process a source, all at once, then the link. nvcc's reports, in source
    order, each after a line ``nvcc <source>: <seconds> s``, are kept beside
    the library and read back with it."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        log = out.with_suffix(".log")
        build_log = log.read_text() if log.exists() else ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = BUILD_DIR / f"{tag}.tmp"
    t0 = time.perf_counter()
    try:
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                    for o, src in zip(objs, _sources())]
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
        logs = []
        for cmds in (compiles, [link]):
            for cmd, (rc, log, secs) in zip(cmds, _run_all(cmds)):
                logs.append(f"nvcc {Path(cmd[-1]).name}: {secs:.1f} s\n{log}")
                if rc != 0:
                    raise RuntimeError(f"nvcc failed (exit {rc}):\n{' '.join(cmd)}\n{log}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    out.with_suffix(".log").write_text(build_log)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


# Argument types of the C entry points (P pointer, I int, F float); each
# returns a cudaError_t as int.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "scream_attn_stats": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "scream_pack_stats": [_P, _P, _P, _I, _I, _P],
    "scream_attn_apply": [_P] * 10 + [_I, _I, _I, _I, _I, _F, _F, _P],
    "scream_nn_exact": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "scream_nn_tile_boxes": [_P, _P, _I, _I, _P],
    "scream_nn_bounded": [_P, _P, _P, _P, _F, _P, _P, _I, _I, _I, _I, _P],
    "scream_max_splat": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P, _P],
    "scream_splat_expf_check": [_P, _P],
    "scream_block_tail": [_P] * 8 + [_I, _I, _I, _F, _P],
    "scream_pack_weights": [_P, _P, _P, _P, _I, _P, _I, _I, _P],
    "scream_attn_stats_f32": [_P] * 8 + [_I, _I, _I, _I, _P],
    "scream_pack_stats_f32": [_P, _P, _P, _I, _I, _P],
    "scream_attn_apply_f32": [_P] * 14 + [_I, _I, _I, _I, _I, _F, _F, _I, _P],
    "scream_pack_block_f32": [_P] * 5 + [_I, _I, _P],
    "scream_block_tail_f32": [_P] * 11 + [_I, _I, _I, _F, _I, _P],
    "scream_attn_stats_heads": [_P] * 7 + [_I, _I, _I, _I, _P],
    "scream_attn_stats_heads_f32": [_P] * 9 + [_I, _I, _I, _I, _P],
    "scream_attn_apply_heads": [_P] * 10 + [_I, _I, _I, _I, _I, _F, _F, _P],
    "scream_attn_apply_heads_f32": [_P] * 14 + [_I, _I, _I, _I, _I, _F, _F, _I, _P],
}


def declare(lib, name) -> None:
    """Set the argument and return types of the C entry point ``name``."""
    fn = getattr(lib, name)
    fn.argtypes = SIGNATURES[name]
    fn.restype = ctypes.c_int


def kernels():
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name in SIGNATURES:
                declare(lib, name)
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch."""
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes (the
    raw handle, without building a ``torch.cuda.Stream``, which costs a small
    call's host several microseconds)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def route(x) -> bool:
    """True to launch the kernel (CUDA tensor), False for the plain version
    (CPU tensor); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def check_tensor(t, name, dtype, shape, align: int = 1) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` whose data starts on an ``align``-byte boundary."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data must be {align}-byte aligned")
