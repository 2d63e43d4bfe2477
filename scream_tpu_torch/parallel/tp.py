"""Tensor parallelism: Megatron sharding of the attention blocks (port of
``scream_tpu/parallel/tp.py``).

The recipe is the JAX package's, over a ``model`` mesh axis of ``n`` ranks
(``models/attention.py:AttentionBlock``):

* column-parallel: the ``q_proj``, ``k_proj``, ``v_proj`` and ``ffn_in``
  kernels keep their output features ``[i d/n, (i+1) d/n)`` on rank ``i``
  (``num_heads / n`` heads each, whose linear attention runs whole on the
  rank; ``ffn_in`` a slice of the hidden width);
* row-parallel: ``merge`` and ``ffn_out`` keep the matching slice of their
  input features; each yields a partial sum that one all-reduce completes
  (two a block, the Megatron minimum);
* everything else (LayerNorms, embedding, head) is replicated.

The JAX package annotates the parameter tree and GSPMD inserts the
collectives; here each rank's parameters are replaced in place by its
shards (:func:`shard_params_tensor_parallel`: the same ``nn.Parameter``
objects, so an optimizer built over them keeps working and its Adam moments
are made, or cut, to the shards' shapes) and each block's forward
(:class:`TensorParallelBlock`) places Megatron's two operators: ``f``
(identity forward, gradients summed over the axis backward) where a
replicated activation enters the rank's columns, and ``g`` (sum forward,
identity backward) after each row-parallel product. Requires ``num_heads %
n == 0`` and ``d_model * ffn_mult % n == 0``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from scream_tpu_torch.models.attention import AttentionBlock, linear_attention
from scream_tpu_torch.ops.ffn import _ln
from scream_tpu_torch.parallel.mesh import (Mesh, all_gather_cat, batch_size,
                                            copy_to_group, grads_averaged, mean_metrics,
                                            reduce_from_group, replicate, shard_batch)

# Kernels whose OUTPUT features shard (column-parallel) / whose INPUT
# features shard (row-parallel). Matches AttentionBlock submodule names.
_COLUMN_PARALLEL = frozenset({"q_proj", "k_proj", "v_proj", "ffn_in"})
_ROW_PARALLEL = frozenset({"merge", "ffn_out"})


def _spec_for(name: str, axis: str) -> tuple:
    parts = name.split(".")
    if len(parts) >= 2 and parts[-1] == "kernel":
        if parts[-2] in _COLUMN_PARALLEL:
            return (None, axis)
        if parts[-2] in _ROW_PARALLEL:
            return (axis, None)
    return ()


def tensor_parallel_specs(model: torch.nn.Module, axis: str = "model") -> Dict[str, tuple]:
    """Each parameter's sharding, by name: ``(None, axis)`` column-parallel,
    ``(axis, None)`` row-parallel, ``()`` replicated (the JAX function's
    ``PartitionSpec`` tree, flattened to the port's names)."""
    return {name: _spec_for(name, axis) for name, _ in model.named_parameters()}


def _shard_dim(spec: tuple):
    return None if not spec else (1 if spec[0] is None else 0)


def _cut(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    m = t.shape[dim] // n
    return t.narrow(dim, i * m, m).clone()


class TensorParallelBlock:
    """The forward of an :class:`AttentionBlock` holding rank ``i``'s shards
    (set as the block's ``tp`` hook): local heads' attention, the two
    partial products completed by a sum over ``group``. Same op order as
    ``ops/ffn.tail_plain``; the partial sums are added in fp32."""

    def __init__(self, group, n: int):
        self.group, self.n = group, n

    def __call__(self, blk: AttentionBlock, q, k, v, q_mask=None, kv_mask=None):
        g, cd, nd = self.group, blk.dtype, blk.norm_dtype
        heads = blk.num_heads // self.n
        hd = blk.d_model // blk.num_heads
        B, L, S = q.shape[0], q.shape[1], k.shape[1]
        mm = lambda x, W: x.to(cd) @ W.to(cd)
        Wq, Wk, Wv = blk.q_proj.kernel, blk.k_proj.kernel, blk.v_proj.kernel
        qf = copy_to_group(q, g)
        if k is q and v is q:
            query, key, value = mm(qf, torch.cat([Wq, Wk, Wv], 1)).chunk(3, -1)
        elif v is k:
            query = mm(qf, Wq)
            key, value = mm(copy_to_group(k, g), torch.cat([Wk, Wv], 1)).chunk(2, -1)
        else:
            query = mm(qf, Wq)
            key, value = mm(copy_to_group(k, g), Wk), mm(copy_to_group(v, g), Wv)
        message = linear_attention(
            query.reshape(B, L, heads, hd), key.reshape(B, S, heads, hd),
            value.reshape(B, S, heads, hd), q_mask, kv_mask,
            kv_reduce=blk.kv_reduce).reshape(B, L, heads * hd)
        m = reduce_from_group(mm(message, blk.merge.kernel).float(), g).to(cd)
        t = m + q.to(cd)
        y = _ln(t, blk.norm1.scale, blk.norm1.bias, 1e-5, nd).to(cd)
        h = torch.relu(mm(copy_to_group(y, g), blk.ffn_in.kernel))
        f = reduce_from_group((h @ blk.ffn_out.kernel.to(cd)).float(), g).to(cd)
        u = q.to(cd) + f
        return _ln(u, blk.norm2.scale, blk.norm2.bias, 1e-5, nd).to(cd)


def _blocks(model):
    return [(name, m) for name, m in model.named_modules() if isinstance(m, AttentionBlock)]


@torch.no_grad()
def shard_params_tensor_parallel(model: torch.nn.Module, mesh: Mesh, axis: str = "model",
                                 optimizer: torch.optim.Optimizer = None) -> torch.nn.Module:
    """Cut ``model``'s block kernels to this rank's Megatron shards, in
    place (the ``Parameter`` objects stay; an ``optimizer``'s state
    tensors are cut alike), and set each block's tensor-parallel forward.
    Refuses ``num_heads`` or the FFN width not dividing the axis. Running it
    on a model already sharded does nothing."""
    n, i, group = mesh.axis_size(axis), mesh.coord(axis), mesh.group(axis)
    for name, blk in _blocks(model):
        if blk.tp is not None:
            continue
        if blk.num_heads % n or (blk.d_model * blk.ffn_mult) % n:
            raise ValueError(
                f"tensor parallelism over {n} ranks needs num_heads ({blk.num_heads}) and "
                f"the FFN width ({blk.d_model * blk.ffn_mult}) divisible by {n}")
        for pname, p in blk.named_parameters():
            dim = _shard_dim(_spec_for(pname, axis))
            if dim is None:
                continue
            state = optimizer.state.get(p, {}) if optimizer is not None else {}
            for k, t in state.items():
                if isinstance(t, torch.Tensor) and t.shape == p.shape:
                    state[k] = _cut(t, dim, n, i)
            p.data = _cut(p.data, dim, n, i)
        blk.tp = TensorParallelBlock(group, n)
    return model


@torch.no_grad()
def full_state_dict(model: torch.nn.Module, mesh: Mesh, axis: str = "model") -> Dict:
    """The whole model's ``state_dict`` on every rank: each shard gathered
    along its sharded dimension over ``axis``."""
    group = mesh.group(axis)
    out = {}
    for name, t in model.state_dict().items():
        dim = _shard_dim(_spec_for(name, axis)) if _is_sharded(model, name) else None
        out[name] = t if dim is None else all_gather_cat(t, group, dim)
    return out


def _is_sharded(model, name: str) -> bool:
    blk_name = name.rsplit(".", 2)[0]
    blk = dict(_blocks(model)).get(blk_name)
    return blk is not None and blk.tp is not None


@torch.no_grad()
def full_optimizer_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                         mesh: Mesh, axis: str = "model") -> Dict:
    """``optimizer.state_dict()`` with every sharded moment gathered over
    ``axis`` (the checkpoint a single-process run would save)."""
    group = mesh.group(axis)
    dims = _param_dims(model, axis)
    sd = optimizer.state_dict()
    # state_dict() shares the live state's dicts: gather into copies.
    sd["state"] = {idx: dict(st) for idx, st in sd["state"].items()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for idx, st in sd["state"].items():
        dim = dims.get(id(params[idx]))
        if dim is None:
            continue
        for k, t in st.items():
            if isinstance(t, torch.Tensor) and t.dim() > 0:
                st[k] = all_gather_cat(t, group, dim)
    return sd


def _param_dims(model, axis) -> Dict[int, int]:
    out = {}
    for name, p in model.named_parameters():
        if _is_sharded(model, name):
            dim = _shard_dim(_spec_for(name, axis))
            if dim is not None:
                out[id(p)] = dim
    return out


def shard_state(model_state: Dict, opt_state: Dict, optimizer, model, mesh: Mesh,
                axis: str = "model"):
    """Cut whole-model checkpoints (:func:`full_state_dict`,
    :func:`full_optimizer_state`) to this rank's shards, for
    ``load_state_dict`` into a sharded model and its optimizer."""
    n, i = mesh.axis_size(axis), mesh.coord(axis)
    model_state = {name: (_cut(t, _shard_dim(_spec_for(name, axis)), n, i)
                          if _is_sharded(model, name) and _spec_for(name, axis) else t)
                   for name, t in model_state.items()}
    dims = _param_dims(model, axis)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for idx, st in opt_state["state"].items():
        dim = dims.get(id(params[idx]))
        if dim is None:
            continue
        for k, t in st.items():
            if isinstance(t, torch.Tensor) and t.dim() > 0:
                st[k] = _cut(t, dim, n, i)
    return model_state, opt_state


def tensor_parallel_apply(model: torch.nn.Module, mesh: Mesh, data_axis: str = "data",
                          model_axis: str = "model") -> Callable:
    """Combined data and tensor parallelism for inference: ``model``
    broadcast from rank 0 and cut to this rank's shards; the returned
    ``fn(*arrays)`` runs this rank's rows of the batch (the whole batch where
    it does not divide ``data_axis``) and gathers the output over
    ``data_axis``."""
    replicate(model, mesh)
    shard_params_tensor_parallel(model, mesh, model_axis)
    n = mesh.axis_size(data_axis)

    def wrapped(*arrays):
        if n == 1 or arrays[0].shape[0] % n:
            return model(*arrays)
        i, m = mesh.coord(data_axis), arrays[0].shape[0] // n
        out = model(*(a[i * m:(i + 1) * m] for a in arrays))
        return all_gather_cat(out, mesh.group(data_axis))

    return wrapped


def tensor_parallel_step(step_fn: Callable, mesh: Mesh, data_axis: str = "data",
                         model_axis: str = "model") -> Callable:
    """2-D (data x model) parallelism for a ``train.steps`` generator step.

    At the first call the state is broadcast from rank 0 and the step's
    model (``step_fn.model``) cut to this rank's shards, its Adam moments
    with it (a model already cut, as the trainer does, stays). Each call
    runs this rank's rows of the batch, averages the gradients over
    ``data_axis`` (each shard's over its own data ranks) and the metrics."""
    from scream_tpu_torch.parallel.dp import bn_synced, replicate_optimizer

    model = step_fn.model
    group, n = mesh.group(data_axis), mesh.axis_size(data_axis)
    ready = []

    def wrapped(state, batch, *args, **kw):
        if not ready:
            if not any(b.tp is not None for _, b in _blocks(model)):
                replicate_optimizer(state.optimizer, mesh)
                shard_params_tensor_parallel(model, mesh, model_axis, state.optimizer)
            ready.append(True)
        if n == 1 or batch_size(batch) % n:
            return step_fn(state, batch, *args, **kw)
        disc = args[0] if args else kw.get("disc")
        with grads_averaged(state.optimizer, group, n), bn_synced(disc, group, n):
            state, metrics, fake = step_fn(state, shard_batch(batch, mesh), *args, **kw)
        if fake is not None:
            fake = all_gather_cat(fake, group)
        return state, mean_metrics(metrics, group, n), fake

    return wrapped
