"""Process meshes over ``torch.distributed`` (port of
``scream_tpu/parallel/mesh.py``).

The JAX package runs one program over a named ``jax.sharding.Mesh`` and lets
XLA insert the collectives. The port runs one process per rank: a
:class:`Mesh` names the same axes over the ranks of a ``torch.distributed``
world, through a ``DeviceMesh`` (``init_device_mesh``) whose dim names are
the JAX axis names, and the parallel modules call the collectives
themselves.

Axes (as in the JAX package):
  * ``data``: registration pairs (the batch dimension);
  * ``seq``: points within a cloud (``parallel/sp.py``);
  * ``model``: attention heads and FFN hidden features (``parallel/tp.py``);
  * ``pipe``: layer stages (``parallel/pp.py``, ``parallel/pp_flagship.py``).

:func:`parse_mesh_spec` accepts and refuses the JAX command's specs with its
messages. :func:`launch` runs a function on every rank of a mesh: under
``torchrun`` (``WORLD_SIZE`` set) it joins the world it is in; otherwise it
spawns one process per rank (start method ``spawn``) after building the CUDA
kernels once, so the ranks load the built library instead of each running
``nvcc``. The backend is NCCL where every rank owns a card, gloo on the CPU
and where ranks share a card (NCCL refuses two ranks on one GPU). A world
that cannot be had raises: nothing runs single-process in its place. Rank 0
alone writes to stdout.

Gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` only; the
gathers and the point-to-point sends here stage CUDA tensors through the
host under gloo (:func:`all_gather_cat`, :func:`send`, :func:`recv`).
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import sys
import tempfile
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

class Mesh:
    """A named grid of ranks: ``shape`` (axis -> size, in the JAX package's
    axis order) and, once bound to a running world (:meth:`bind`), this
    rank's coordinate on each axis and each axis's process group.

    Rank ``r`` sits at the row-major coordinate of ``r`` in ``shape``, as
    ``init_device_mesh`` lays ranks out."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.device_mesh = None
        self.device = torch.device("cpu")

    def __repr__(self):
        return f"Mesh({self.shape}, bound={self.bound})"

    @property
    def bound(self) -> bool:
        return self.device_mesh is not None

    def bind(self, device=None) -> "Mesh":
        """Build the ``DeviceMesh`` over the running world (which must hold
        exactly ``size`` ranks); ``device`` is where this rank computes."""
        if not dist.is_initialized():
            raise RuntimeError("Mesh.bind needs a running torch.distributed world "
                               "(parallel.mesh.launch starts one)")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, the world "
                             f"has {world}")
        from torch.distributed.device_mesh import init_device_mesh

        self.device = torch.device(device) if device is not None else _rank_device()
        dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device_mesh = init_device_mesh(
            dev_type, tuple(self.shape.values()), mesh_dim_names=self.axis_names)
        return self

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an axis the mesh lacks)."""
        if axis not in self.shape:
            return 0
        self._need_bound()
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: Optional[str] = None):
        """The process group of ``axis`` (the ranks that differ only in
        their ``axis`` coordinate), or the whole world for None."""
        self._need_bound()
        if axis is None:
            return dist.group.WORLD
        return self.device_mesh.get_group(axis)

    def _need_bound(self):
        if self.device_mesh is None:
            raise RuntimeError(f"{self} is not bound to a running world "
                               "(parallel.mesh.launch runs a function on its ranks)")


_RANK_DEVICE = None  # where this rank computes, set when it joins a world


def _rank_device() -> torch.device:
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    return torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() and dist.get_backend() == "nccl" else torch.device("cpu")


def default_ranks(device="cpu") -> int:
    """The ranks ``auto`` spreads over: the world's size inside a running
    world or under ``torchrun``, else the CUDA cards for a CUDA device, else
    one (the CPU is one device, as it is to JAX)."""
    if dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def make_mesh(n_data: Optional[int] = None, n_seq: int = 1, n_ranks: Optional[int] = None,
              n_model: int = 1, n_pipe: int = 1, device="cpu") -> Mesh:
    """A ``(data, seq[, model])`` or ``(data, pipe)`` mesh.

    ``n_data`` defaults to the ranks left over by the other axes, out of
    ``n_ranks`` (default :func:`default_ranks` of ``device``). ``model`` and
    ``pipe`` axes are only added when > 1; ``pipe`` composes with ``data``
    only. Where ``n_ranks`` is known (given, or a running world's size) the
    axis product must fit it; otherwise :func:`launch` spawns the mesh's
    ranks (on one card they share it). Inside a running world of exactly
    the mesh's size the mesh comes back bound.
    """
    if n_data is None:
        n_data = (n_ranks or default_ranks(device)) // (n_seq * n_model * n_pipe)
    if n_data < 1 or n_seq < 1 or n_model < 1 or n_pipe < 1:
        raise ValueError(
            f"mesh axes must be >= 1, got data={n_data} seq={n_seq} "
            f"model={n_model} pipe={n_pipe}")
    if n_pipe > 1 and (n_seq > 1 or n_model > 1):
        raise ValueError("pipe composes with data only")
    need = n_data * n_seq * n_model * n_pipe
    have = n_ranks if n_ranks is not None else (
        dist.get_world_size() if dist.is_initialized() else None)
    if have is not None and need > have:
        raise ValueError(
            f"mesh {n_data}x{n_seq}x{n_model}x{n_pipe} needs {need} "
            f"devices, found {have}")
    if n_pipe > 1:
        shape = {"data": n_data, "pipe": n_pipe}
    elif n_model > 1:
        shape = {"data": n_data, "seq": n_seq, "model": n_model}
    else:
        shape = {"data": n_data, "seq": n_seq}
    mesh = Mesh(shape)
    if dist.is_initialized() and dist.get_world_size() == need:
        mesh.bind()
    return mesh


def parse_mesh_spec(spec: str, n_ranks: Optional[int] = None, device="cpu") -> Mesh:
    """Parse the CLI mesh flag: ``"data=4"``, ``"data=4,seq=2"``,
    ``"data=2,model=2"``, ``"data=2,pipe=4"``, ``"auto"``.

    ``auto`` (or ``all``) puts every rank on the data axis; ``data`` may be
    omitted when another axis is given (the rest of the ranks). ``seq`` with
    ``model`` is refused, ``pipe`` composes with ``data`` only, and other
    axis names are refused (expert parallelism is a library API)."""
    if spec in ("auto", "all"):
        return make_mesh(n_ranks=n_ranks, device=device)
    kv = {}
    for part in spec.split(","):
        if "=" not in part:
            raise ValueError(
                f"bad mesh spec {spec!r}: expected comma-separated axis=N "
                "entries, e.g. 'data=4' or 'data=4,seq=2'")
        k, v = part.split("=", 1)
        kv[k.strip()] = int(v)
    n_data = kv.pop("data", None)
    n_seq = kv.pop("seq", 1)
    n_model = kv.pop("model", 1)
    n_pipe = kv.pop("pipe", 1)
    if kv:
        raise ValueError(
            f"unknown mesh axes {sorted(kv)} in {spec!r}; the trainer path "
            "supports data, seq, model and pipe (expert parallelism is a "
            "library API, scream_tpu_torch.parallel)")
    if n_seq > 1 and n_model > 1:
        raise ValueError(
            f"mesh spec {spec!r}: the trainer path combines model= with "
            "data= only (seq x model 3-D training is a library-API "
            "composition, not a one-flag preset)")
    if n_pipe > 1 and (n_seq > 1 or n_model > 1):
        raise ValueError(f"mesh spec {spec!r}: pipe= composes with data= only")
    return make_mesh(n_data=n_data, n_seq=n_seq, n_ranks=n_ranks, n_model=n_model,
                     n_pipe=n_pipe, device=device)


def is_data_only(mesh: Mesh) -> bool:
    """True when every axis but ``data`` has size 1: the mesh shards only
    the pair batch. The fused kernels stay on for such meshes (each rank
    runs them on its shard, with no collective); any seq / model / pipe
    sharding takes the unfused graph, whose reductions the parallel modules
    place by hand."""
    return all(n == 1 for name, n in mesh.shape.items() if name != "data")


# ---------------------------------------------------------------------------
# Batches and parameters.


def batch_size(batch: Dict) -> int:
    return next(iter(batch.values())).shape[0]


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of a host or device batch: rows ``[i b/n, (i+1)
    b/n)`` on data coordinate ``i``. The batch size must divide the data
    axis (the loaders make fixed batch sizes)."""
    n, i = mesh.axis_size("data"), mesh.coord("data")
    out = {}
    for k, v in batch.items():
        assert v.shape[0] % n == 0, (
            f"batch dim {v.shape[0]} of '{k}' not divisible by data axis {n}")
        m = v.shape[0] // n
        out[k] = v[i * m:(i + 1) * m]
    return out


def to_device_maybe_sharded(batch: Dict, mesh: Optional[Mesh], skip=(), device="cpu"
                            ) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``: this rank's rows where a mesh
    is given and the batch divides its data axis, else the whole batch (a
    trailing partial batch then runs whole on every rank). Keys in ``skip``
    are left out."""
    arrays = {k: v for k, v in batch.items() if k not in skip}
    if mesh is not None and batch_size(arrays) % mesh.axis_size("data") == 0:
        arrays = shard_batch(arrays, mesh)
    return {k: torch.as_tensor(v).to(device) for k, v in arrays.items()}


@torch.no_grad()
def replicate(module_or_tensors, mesh: Mesh, axis: Optional[str] = None):
    """Make every rank hold rank 0's values: broadcast a module's parameters
    and buffers (or a list of tensors) in place over ``axis`` (default the
    whole world). Returns its argument."""
    tensors = (list(module_or_tensors.parameters()) + list(module_or_tensors.buffers())
               if isinstance(module_or_tensors, torch.nn.Module) else list(module_or_tensors))
    group = mesh.group(axis)
    src = dist.get_global_rank(group, 0) if axis is not None else 0
    for t in tensors:
        dist.broadcast(t.data, src, group=group)
    return module_or_tensors


# ---------------------------------------------------------------------------
# Collectives. Gloo takes CUDA tensors in all_reduce and broadcast; the
# rest stages them through the host.


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() != "nccl"


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` of the group, concatenated along ``dim`` in group
    rank order (shapes equal on every rank)."""
    src = t.detach().contiguous()
    host = src.cpu() if _staged(src) else src
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, host, group=group)
    return torch.cat(parts, dim).to(t.device)


def gather_objects(obj, group=None) -> list:
    """Every rank's picklable ``obj`` of the group, in group rank order."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def send(t: torch.Tensor, dst: int, tag: int = 0):
    """Send ``t`` to global rank ``dst``; returns a handle to ``wait()`` on
    (sends are asynchronous so that two stages never wait on each other)."""
    src = t.detach().contiguous()
    if _staged(src):
        src = src.cpu()
    return dist.isend(src, dst, tag=tag)


def recv(shape, dtype, src: int, device, tag: int = 0) -> torch.Tensor:
    """Receive a tensor of ``shape`` and ``dtype`` from global rank ``src``
    onto ``device``."""
    dev = torch.device(device)
    staged = dev.type == "cuda" and dist.get_backend() != "nccl"
    buf = torch.empty(shape, dtype=dtype, device="cpu" if staged else dev)
    dist.recv(buf, src, tag=tag)
    return buf.to(dev)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the gradients over it too
    (every rank's output feeds its own loss)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: sum over the group forward, identity backward (the
    ranks hold one replicated loss downstream)."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, sum of the gradients over the group
    backward (a replicated input feeding rank-local partial work)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Autograd-aware sum over ``group`` (backward: the gradients summed)."""
    return _AllReduceSum.apply(t, group)


def reduce_from_group(t: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(t, group)


def copy_to_group(t: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(t, group)


@contextlib.contextmanager
def grads_averaged(optimizer: torch.optim.Optimizer, group, n: int):
    """While open, ``optimizer.step()`` first replaces every gradient by its
    mean over ``group`` (one all-reduce of the flattened gradients); a
    ``group`` of None leaves them alone."""
    if group is None or n == 1:
        yield
        return

    def hook(opt, args, kwargs):
        average_grads([p for g in opt.param_groups for p in g["params"]], group, n)

    handle = optimizer.register_step_pre_hook(hook)
    try:
        yield
    finally:
        handle.remove()


@torch.no_grad()
def average_grads(params, group, n: int, op: str = "mean") -> None:
    """Replace each parameter's gradient by its mean (or ``op="sum"`` its
    sum) over ``group``, a missing gradient counting as zeros (all ranks
    then hold one). One all-reduce of the flattened gradients per dtype and
    device."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    buckets: Dict[tuple, list] = {}
    for p in params:
        buckets.setdefault((p.grad.dtype, p.grad.device), []).append(p)
    for ps in buckets.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        dist.all_reduce(flat, group=group)
        if op == "mean":
            flat /= n
        off = 0
        for p in ps:
            k = p.grad.numel()
            p.grad.copy_(flat[off:off + k].view_as(p.grad))
            off += k


def mean_metrics(metrics: Dict[str, torch.Tensor], group, n: int) -> Dict[str, torch.Tensor]:
    """Each scalar metric's mean over ``group`` (equal shards: the mean of
    the shard means is the batch mean)."""
    if not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= n
    return {k: flat[i] for i, k in enumerate(keys)}


# ---------------------------------------------------------------------------
# The launcher.


def _backend_for(device, world: int) -> str:
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def _init_rank(rank: int, world: int, init_method: str, device) -> torch.device:
    """Join the world as ``rank``: pick the card, start the backend."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    backend = _backend_for(dev, world)
    if dev.type == "cuda":
        idx = rank % torch.cuda.device_count() if backend == "nccl" else 0
        torch.cuda.set_device(idx)
        dev = torch.device("cuda", idx)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    global _RANK_DEVICE
    _RANK_DEVICE = dev
    return dev


def _exit_with_parent() -> None:
    """End this rank if the process that spawned it is gone (killed by a
    time limit, say), so that no rank outlives its launcher on the card."""
    import threading
    import time

    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _rank_main(rank: int, world: int, init_method: str, device, spec, fn, args):
    _exit_with_parent()
    dev = _init_rank(rank, world, init_method, device)
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    try:
        mesh = _as_mesh(spec, world).bind(dev)
        fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def _as_mesh(spec, n_ranks: Optional[int], device="cpu") -> Mesh:
    if isinstance(spec, Mesh):
        return Mesh(spec.shape)
    if isinstance(spec, dict):
        return Mesh(spec)
    return parse_mesh_spec(spec, n_ranks=n_ranks, device=device)


def launch(fn: Callable, spec, device="cpu", args: tuple = ()) -> None:
    """Run ``fn(mesh, *args)`` on every rank of ``spec`` (a mesh spec string,
    a :class:`Mesh` or an axis -> size dict), each rank's ``mesh`` bound and
    its ``mesh.device`` set.

    Under ``torchrun`` (``WORLD_SIZE`` set) this process is one rank: it
    joins the world from the environment, which must hold exactly the
    mesh's ranks. Otherwise the mesh's ranks are spawned here, with a
    ``file://`` rendezvous in a fresh temporary directory, and this call
    returns when they all have; a rank that fails makes it raise. For a
    CUDA device the kernels are built first, once, so that the ranks load
    the built library. ``fn`` and ``args`` must pickle (``fn`` a module-level
    function)."""
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ.get("RANK", "0"))
        mesh = _as_mesh(spec, world)
        if mesh.size != world:
            raise ValueError(f"mesh {mesh.shape} needs {mesh.size} ranks; torchrun "
                             f"started {world}")
        dev = _init_rank(rank, world, "env://", device)
        if rank != 0:
            sys.stdout = open(os.devnull, "w")
        try:
            fn(mesh.bind(dev), *args)
        finally:
            dist.destroy_process_group()
        return
    mesh = _as_mesh(spec, None, device)
    if torch.device(device).type == "cuda":
        from scream_tpu_torch.ops import _build
        from scream_tpu_torch.utils.device import resolve_device

        resolve_device(device)
        _build.kernels()
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="scream_mesh_")
    env_before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        init = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(_rank_main, args=(mesh.size, init, device, mesh.shape, fn, args),
                           nprocs=mesh.size, join=True, start_method="spawn")
    except mp.ProcessExitedException as e:
        raise RuntimeError(f"mesh rank {e.error_index} exited with code {e.exit_code}") from None
    finally:
        if env_before is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env_before
        shutil.rmtree(tmp, ignore_errors=True)
