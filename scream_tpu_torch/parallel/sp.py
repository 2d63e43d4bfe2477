"""Sequence parallelism: linear attention with the points spread over ranks
(port of ``scream_tpu/parallel/sp.py``).

Each rank of the ``seq`` axis holds a slice of every cloud's points. Linear
attention needs only one cross-rank term::

    KV_local = K_shard^T V_shard     (per rank, tiny: H x D x Dv)
    KV       = sum over seq ranks    (one all-reduce of ~d_model^2)
    out      = Q_shard KV            (queries stay on their rank)

so a layer costs one all-reduce of a matrix whose size does not depend on
the point count. The JAX package gets every other reduction over the point
axis from GSPMD; here :func:`points_parallel` places them by hand. In the
model's forward and loss they are (a grep for sums over axis 1):

* ``models/attention.py:linear_attention``: ``KV`` and ``K_sum``;
* ``models/point_transformer.py``: the masked loss's per-item sums (both
  models' ``loss``) and ``PointTransformer.forward``'s default
  ``src_center``, the masked centroid (GT-free, ``center_mode="none"``).

The rest of the forward works point by point (the PE, the embedding, the
LayerNorms over features, the FFN, the head). The GAN renderer splats all
the points of a cloud: it is not offered on a seq mesh. Every sum is
autograd-aware: its backward sums the gradients over the seq ranks.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from scream_tpu_torch.models.attention import AttentionBlock, linear_attention
from scream_tpu_torch.parallel.mesh import Mesh, all_reduce_sum


def _pair_sum(group):
    """The ``kv_reduce`` hook: ``(KV, K_sum)`` summed over ``group`` in one
    all-reduce of their concatenation."""

    def reduce(kv):
        KV, K_sum = kv
        flat = all_reduce_sum(torch.cat([KV.reshape(-1), K_sum.reshape(-1)]), group)
        return flat[:KV.numel()].view_as(KV), flat[KV.numel():].view_as(K_sum)

    return reduce


def sequence_parallel_linear_attention(
    mesh: Mesh,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
    axis_name: str = "seq",
) -> torch.Tensor:
    """Linear attention over q/k/v whose sequence axis (1) is spread over
    ``axis_name``: called on every rank of the axis with its slice (see
    :func:`shard_points`), returns that rank's slice of the output. The
    body is :func:`~scream_tpu_torch.models.attention.linear_attention`'s,
    with ``(KV, K_sum)`` summed over the axis."""
    return linear_attention(q, k, v, q_mask=q_mask, kv_mask=kv_mask, eps=eps,
                            kv_reduce=_pair_sum(mesh.group(axis_name)))


def shard_points(x: torch.Tensor, mesh: Mesh, axis_name: str = "seq") -> torch.Tensor:
    """This rank's slice of ``x``'s point axis (1): slice ``i`` of
    ``n`` equal slices on coordinate ``i`` of ``axis_name``."""
    n, i = mesh.axis_size(axis_name), mesh.coord(axis_name)
    if x.shape[1] % n:
        raise ValueError(f"point axis {x.shape[1]} does not divide the {axis_name} "
                         f"axis ({n})")
    m = x.shape[1] // n
    return x[:, i * m:(i + 1) * m]


@contextlib.contextmanager
def points_parallel(model: torch.nn.Module, mesh: Mesh, axis_name: str = "seq"):
    """While open, ``model`` (a ``PointTransformer`` or ``DEMTransformer``)
    runs on this rank's slice of the points: its attention blocks sum
    ``(KV, K_sum)`` over ``axis_name`` and its loss and default centroid sum
    their per-item sums over it. The blocks must run unfused (the fused
    kernels reduce over the rank's own points)."""
    group = mesh.group(axis_name)
    blocks = [m for m in model.modules() if isinstance(m, AttentionBlock)]
    for b in blocks:
        b.kv_reduce = _pair_sum(group)
    model.point_reduce = lambda t: all_reduce_sum(t, group)
    try:
        yield model
    finally:
        for b in blocks:
            b.kv_reduce = None
        model.point_reduce = None
