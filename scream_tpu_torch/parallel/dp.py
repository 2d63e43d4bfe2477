"""Data parallelism over the pair batch (port of ``scream_tpu/parallel/dp.py``).

The JAX package shards the batch over the ``data`` mesh axis, replicates
the parameters and optimizer state, and lets XLA insert the gradient
all-reduce. Here every rank runs the step on its rows of the batch and the
collectives are explicit:

* the parameters (and the Adam state, if any) are broadcast from rank 0 at
  the first call and stay identical on every rank from then on;
* ``optimizer.step()`` first replaces each gradient by its mean over the
  data ranks (one all-reduce of the flattened gradients). The point losses
  are per-item means followed by a batch mean
  (``models/point_transformer.py``), so over equal shards the mean of the
  shard losses is the batch loss and the mean of the gradients its
  gradient;
* the returned metrics are their means over the data ranks, and the GAN
  step's render is gathered back to the whole batch, as the JAX step
  returns them;
* a discriminator's BatchNorm takes the global batch's statistics
  (``PatchDiscriminator.sync_batch_stats``), as under GSPMD.

A batch that does not divide the data axis (a ``drop_last=False`` loader's
trailing batch) runs whole on every rank, as in the JAX package: the
updates are identical and nothing is averaged, so nothing counts twice.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch

from scream_tpu_torch.parallel.mesh import (Mesh, all_gather_cat, batch_size,
                                            grads_averaged, mean_metrics, replicate,
                                            shard_batch)


def _divides(mesh: Mesh, b: int, axis: str = "data") -> bool:
    return mesh.axis_size(axis) > 1 and b % mesh.axis_size(axis) == 0


@torch.no_grad()
def replicate_optimizer(optimizer: torch.optim.Optimizer, mesh: Mesh, axis=None) -> None:
    """Broadcast an optimizer's parameters and state tensors from rank 0
    over ``axis`` (default the world)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = [t for p in params for t in optimizer.state.get(p, {}).values()
             if isinstance(t, torch.Tensor) and t.dim() > 0]
    replicate(params + state, mesh, axis)


@contextlib.contextmanager
def bn_synced(disc, group, n: int):
    """While open, ``disc``'s BatchNorm takes statistics over ``n`` equal
    shards of the batch, one on each rank of ``group`` (nothing without a
    discriminator or a group)."""
    if disc is None or group is None:
        yield
        return
    disc.sync_batch_stats(group, n)
    try:
        yield
    finally:
        disc.sync_batch_stats(None)


def _once(fn):
    done = []

    def call(*a):
        if not done:
            fn(*a)
            done.append(True)

    return call


def data_parallel_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """DP for a step ``step(state, batch, disc=None, ...) -> (state, metrics,
    fake)`` (``train.steps``): each rank steps on its rows of ``batch``, the
    gradients are averaged over the data ranks before the update, the
    metrics are averaged and ``fake`` (the GAN render) gathered. The state
    is broadcast from rank 0 at the first call."""
    group, n = mesh.group("data"), mesh.axis_size("data")
    sync = _once(lambda state: replicate_optimizer(state.optimizer, mesh))

    def wrapped(state, batch: Dict, *args, **kw):
        sync(state)
        if not _divides(mesh, batch_size(batch)):
            return step_fn(state, batch, *args, **kw)
        local = shard_batch(batch, mesh)
        disc = args[0] if args else kw.get("disc")
        with grads_averaged(state.optimizer, group, n), bn_synced(disc, group, n):
            state, metrics, fake = step_fn(state, local, *args, **kw)
        if fake is not None:
            fake = all_gather_cat(fake, group)
        return state, mean_metrics(metrics, group, n), fake

    return wrapped


def data_parallel_arrays_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """DP for a step ``step(state, *arrays) -> (state, loss)`` over
    positional batch arrays (the discriminator step, whose state holds the
    discriminator and its optimizer): every array is cut to this rank's
    rows, the discriminator's BatchNorm takes the global batch's
    statistics, its gradients are averaged and so is the loss."""
    group, n = mesh.group("data"), mesh.axis_size("data")
    sync = _once(lambda state: (replicate(state.disc, mesh),
                                replicate_optimizer(state.optimizer, mesh)))

    def wrapped(state, *arrays):
        sync(state)
        first = next(a for a in arrays if a is not None)
        if not _divides(mesh, first.shape[0]):
            return step_fn(state, *arrays)
        m, i = first.shape[0] // n, mesh.coord("data")
        local = tuple(None if a is None else a[i * m:(i + 1) * m] for a in arrays)
        with grads_averaged(state.optimizer, group, n), bn_synced(state.disc, group, n):
            state, loss = step_fn(state, *local)
        return state, mean_metrics({"loss": loss}, group, n)["loss"]

    return wrapped


def data_parallel_apply(apply_fn: Callable, mesh: Mesh) -> Callable:
    """DP for inference ``apply_fn(model, *batch_arrays) -> tensor``: the
    model broadcast from rank 0 at the first call, each rank runs its rows,
    and the outputs are gathered back to the whole batch (a batch that does
    not divide the data axis runs whole on every rank)."""
    group = mesh.group("data")
    sync = _once(lambda model: replicate(model, mesh))

    def wrapped(model, *batch_arrays):
        sync(model)
        if not _divides(mesh, batch_arrays[0].shape[0]):
            return apply_fn(model, *batch_arrays)
        n, i = mesh.axis_size("data"), mesh.coord("data")
        m = batch_arrays[0].shape[0] // n
        out = apply_fn(model, *(a[i * m:(i + 1) * m] for a in batch_arrays))
        return all_gather_cat(out, group)

    return wrapped


def data_seq_parallel_step(step_fn: Callable, mesh: Mesh,
                           seq_keys=("src", "tgt", "src_mask", "tgt_mask")) -> Callable:
    """2-D (data x seq) DP x SP for a ``train.steps`` generator step: pairs
    over ``data`` and the points of each cloud over ``seq``
    (``parallel/sp.py``).

    ``seq_keys`` name the batch entries whose axis 1 is the point axis
    (coordinates and masks); each rank takes its rows and, of those, its
    points. Inside the step the model's attention blocks sum ``(KV,
    K_sum)`` over the seq ranks and its point loss sums its per-item sums
    (``sp.points_parallel``); the loss then stands identical on the seq
    ranks of a row, so the gradients are averaged over the whole mesh. A
    batch that does not divide the data axis runs whole on every rank; one
    whose point axes do not divide the seq axis runs on rows only. The GAN
    term (a render of all the points) is not offered on a seq mesh."""
    from scream_tpu_torch.parallel.sp import points_parallel, shard_points

    world, n_seq = mesh.group(None), mesh.axis_size("seq")
    n = mesh.size
    model = step_fn.model
    sync = _once(lambda state: replicate_optimizer(state.optimizer, mesh))

    def wrapped(state, batch: Dict, *args, **kw):
        sync(state)
        if batch_size(batch) % mesh.axis_size("data"):
            return step_fn(state, batch, *args, **kw)
        local = shard_batch(batch, mesh)
        keys = [k for k in seq_keys if k in local]
        split = n_seq > 1 and all(local[k].shape[1] % n_seq == 0 for k in keys)
        if split and (args and args[0] is not None or kw.get("disc") is not None):
            raise NotImplementedError("the GAN term on a seq mesh is not ported "
                                      "(ROADMAP.md); use a data mesh")
        if split:
            local = {k: shard_points(v, mesh) if k in keys else v for k, v in local.items()}
        ctx = points_parallel(model, mesh) if split else contextlib.nullcontext()
        with ctx, grads_averaged(state.optimizer, world, n):
            state, metrics, fake = step_fn(state, local, *args, **kw)
        return state, mean_metrics(metrics, world, n), fake

    return wrapped
