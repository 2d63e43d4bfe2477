"""Expert parallelism: a mixture-of-experts FFN with its experts spread over
ranks (port of ``scream_tpu/parallel/ep.py``).

The expert dimension of the weight stacks is cut over an ``expert`` axis:
each rank runs only its experts and the routed outputs combine with one
all-reduce. The dispatch is the dense-masked (Mesh-TensorFlow einsum) one
of the JAX package: each rank evaluates its experts on every token and the
routing weights zero the tokens not routed to them. For these workloads
(N <= ~20k tokens, a handful of experts) that is a few large products and
one all-reduce; a capacity-bucketed all-to-all dispatch pays off only at
much larger expert counts.

:func:`expert_parallel_moe_ffn` takes the whole parameter dict on every
rank (as the JAX function takes it and shards it itself) and gives, on
every rank, the output and, through autograd, the whole gradients of the
parameters and the input: each rank's share (its experts' slices, and the
gate's and input's part through its experts) is summed over the axis in
the backward.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch

from scream_tpu_torch.parallel.mesh import Mesh, copy_to_group, reduce_from_group


def make_expert_mesh(n_experts_shards: int, n_ranks: Optional[int] = None) -> Mesh:
    """A 1-D ``(expert,)`` mesh (bound inside a world of that size)."""
    import torch.distributed as dist

    have = n_ranks if n_ranks is not None else (
        dist.get_world_size() if dist.is_initialized() else None)
    if have is not None and have < n_experts_shards:
        raise ValueError(f"expert mesh needs {n_experts_shards} devices, got {have}")
    mesh = Mesh({"expert": n_experts_shards})
    if dist.is_initialized() and dist.get_world_size() == n_experts_shards:
        mesh.bind()
    return mesh


def _xavier(shape, generator):
    """flax's ``xavier_uniform`` on the last two axes (in, out), the leading
    axes a receptive field: bound ``sqrt(6 / (fan_in + fan_out))``."""
    rf = math.prod(shape[:-2])
    bound = math.sqrt(6.0 / (shape[-2] * rf + shape[-1] * rf))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def init_moe_ffn_params(generator: torch.Generator, d_model: int, d_hidden: int,
                        n_experts: int) -> Dict[str, torch.Tensor]:
    """Xavier-uniform MoE FFN weights: gate ``(d, E)``, w_in ``(E, d, f)``,
    w_out ``(E, f, d)`` (the JAX package's initializer, drawn from
    ``generator``)."""
    return {"gate": _xavier((d_model, n_experts), generator),
            "w_in": _xavier((n_experts, d_model, d_hidden), generator),
            "w_out": _xavier((n_experts, d_hidden, d_model), generator)}


def moe_params_from_numpy(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A numpy MoE parameter tree (``gate``, ``w_in``, ``w_out``; e.g. the
    JAX package's :func:`init_moe_ffn_params`, read outside this package)
    as float32 tensors."""
    return {k: torch.from_numpy(np.array(tree[k], dtype=np.float32, copy=True))
            for k in ("gate", "w_in", "w_out")}


def _route(gate, x):
    probs = torch.softmax(x @ gate, dim=-1)  # (B, L, E)
    top = torch.argmax(probs, dim=-1)  # (B, L)
    weight = torch.gather(probs, -1, top[..., None])  # (B, L, 1)
    return probs, top, weight


def moe_ffn_reference(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Single-device top-1 MoE FFN, the oracle of the EP path: softmax gate,
    top-1 routing, relu FFN per expert, the output scaled by the winning
    gate probability. ``x`` ``(B, L, d)``."""
    probs, top, weight = _route(params["gate"], x)
    h = torch.relu(torch.einsum("bld,edf->belf", x, params["w_in"]))
    y = torch.einsum("belf,efd->beld", h, params["w_out"])  # (B, E, L, d)
    onehot = torch.nn.functional.one_hot(top, probs.shape[-1]).to(x.dtype)  # (B, L, E)
    return torch.einsum("beld,ble->bld", y, onehot) * weight


def expert_parallel_moe_ffn(mesh: Mesh, params: Dict[str, torch.Tensor], x: torch.Tensor,
                            axis: str = "expert") -> torch.Tensor:
    """Top-1 MoE FFN with the experts spread over ``axis``: rank ``i`` runs
    experts ``[i E/n, (i+1) E/n)`` on every token (the gate is computed on
    every rank, it is tiny) and one all-reduce sums the routed outputs.
    Equal to :func:`moe_ffn_reference`; the expert count must divide over
    the axis."""
    n, i, group = mesh.axis_size(axis), mesh.coord(axis), mesh.group(axis)
    n_experts = params["w_in"].shape[0]
    assert n_experts % n == 0, (
        f"{n_experts} experts not divisible over {n} expert shards")
    e_loc = n_experts // n
    gate, x = copy_to_group(params["gate"], group), copy_to_group(x, group)
    w_in = copy_to_group(params["w_in"], group)[i * e_loc:(i + 1) * e_loc]
    w_out = copy_to_group(params["w_out"], group)[i * e_loc:(i + 1) * e_loc]
    _, top, weight = _route(gate, x)
    # Global ids of this rank's experts; route the tokens whose winner is local.
    local_ids = i * e_loc + torch.arange(e_loc, device=x.device)
    onehot_local = (top[..., None] == local_ids).to(x.dtype)  # (B, L, e_loc)
    h = torch.relu(torch.einsum("bld,edf->belf", x, w_in))
    y = torch.einsum("belf,efd->beld", h, w_out)  # (B, e_loc, L, d)
    out_local = torch.einsum("beld,ble->bld", y, onehot_local) * weight
    return reduce_from_group(out_local, group)
