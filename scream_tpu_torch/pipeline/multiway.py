"""Multiway registration: N scans into one global frame by pose-graph
synchronization (port of ``scream_tpu/pipeline/multiway.py``).

Pairwise relative poses from the GT-free serving path
(:func:`~scream_tpu_torch.pipeline.register.register_pairs`) are averaged
over every edge and loop closure into absolute poses: a chain composes its
drift linearly, the synchronization spreads it.

Conventions. Edge ``(i, j)`` carries ``T_ij`` with ``p_j = R_ij p_i + t_ij``
(scan i into scan j's frame). Absolute poses map scans into the world,
``p_w = R_i p_i + t_i``, with the gauge ``T_0 = I``; consistency is
``R_i = R_j R_ij`` and ``t_i = R_j t_ij + t_j``.

Algorithm (the JAX package's):

1. **Init** by composing measurements along a BFS spanning tree from scan
   0, on the host (tens of scans).
2. **Chordal rotation averaging**, damped Jacobi: each sweep sets
   ``R_i <- proj_SO3(deg_i R_i + sum_j w_ij R_j R_ij + sum_j w_ji R_j R_ji^T)``
   on the device, a Python loop of sweeps. The per-node sums are products
   with the dense (N, E) incidence matrices, a fixed order of addition on
   any device, so the card's poses are the same bits from run to run
   (``index_add_`` on CUDA adds in atomic order). The projection
   ``_project_so3`` is ``so3.make_valid``: a batched ``torch.linalg.svd``
   on the caller's device, which on a CUDA device makes the host wait
   (twice a call on the H100: 202 waits in 100 sweeps and the gauge).
3. **Translation synchronization**: ``t_i - t_j = R_j t_ij`` with
   ``t_0 = 0``, weighted least squares through the dense normal equations
   of the ``3(N-1)`` unknowns, one ``torch.linalg.solve``.

:func:`refine_to_map` then optionally polishes each pose by scan-to-map ICP.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from scream_tpu_torch.data.batching import pad_cloud
from scream_tpu_torch.geometry.icp import registration_icp
from scream_tpu_torch.geometry.so3 import make_valid as _project_so3
from scream_tpu_torch.pipeline.register import _default_capacity, register_pairs
from scream_tpu_torch.utils.device import resolve_device


class MultiwayResult(NamedTuple):
    poses: np.ndarray  # (N, 4, 4) absolute scan -> world transforms
    edges: List[Tuple[int, int]]  # the pairwise edges used
    edge_fitness: np.ndarray  # (E,) pairwise ICP fitness (the edge weights)


def _spanning_tree_init(n: int, edges, rel: np.ndarray) -> np.ndarray:
    """BFS-compose measurements from scan 0 -> ``(N, 4, 4)`` initial poses.
    A scan with no edge path to scan 0 raises: synchronization is undefined
    there."""
    adj = {k: [] for k in range(n)}
    for e, (i, j) in enumerate(edges):
        adj[i].append((j, e, False))  # forward: T_ij maps i -> j
        adj[j].append((i, e, True))  # reverse: inv(T_ij)
    poses = [None] * n
    poses[0] = np.eye(4, dtype=np.float32)
    queue = [0]
    while queue:
        i = queue.pop(0)
        for j, e, rev in adj[i]:
            if poses[j] is not None:
                continue
            T = rel[e]
            T = np.linalg.inv(T) if rev else T
            # R_i = R_j R_ij  =>  T_j = T_i @ inv(T_ij).
            poses[j] = (poses[i] @ np.linalg.inv(T)).astype(np.float32)
            queue.append(j)
    missing = [k for k, p in enumerate(poses) if p is None]
    if missing:
        raise ValueError(
            f"pose graph is disconnected: scans {missing} share no edge "
            "path with scan 0 — add edges covering them")
    return np.stack(poses)


def synchronize_poses(
    n: int,
    edges: Sequence[Tuple[int, int]],
    rel_transforms,
    weights=None,
    sweeps: int = 100,
    device="cuda",
) -> np.ndarray:
    """Absolute poses ``(N, 4, 4)`` (numpy) from pairwise measurements.

    ``edges``: ``(i, j)`` per measurement; ``rel_transforms``: ``(E, 4, 4)``
    with ``p_j = R p_i + t``; ``weights``: ``(E,)`` nonnegative edge
    confidences (uniform by default; a zero-weight edge still counts for
    connectivity through the spanning-tree init); ``sweeps``: damped-Jacobi
    chordal sweeps. The sweeps and the solve run on ``device``. Gauge:
    ``poses[0] == eye(4)`` exactly.
    """
    rel = np.asarray(rel_transforms, np.float32).reshape(-1, 4, 4)
    edges = [(int(i), int(j)) for i, j in edges]
    E = len(edges)
    if rel.shape[0] != E:
        raise ValueError(f"{E} edges but {rel.shape[0]} transforms")
    if n <= 1:
        return np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4)).copy()
    if E == 0:
        raise ValueError(f"pose graph is disconnected: {n} scans share no edges")
    w = (np.ones(E, np.float32) if weights is None
         else np.asarray(weights, np.float32))
    if w.shape != (E,):
        raise ValueError(f"weights shape {w.shape} != ({E},)")

    init = _spanning_tree_init(n, edges, rel)
    dev = resolve_device(device)
    src_np = np.asarray([i for i, _ in edges])
    dst_np = np.asarray([j for _, j in edges])
    src = torch.as_tensor(src_np, device=dev)
    dst = torch.as_tensor(dst_np, device=dev)
    # Incidence (N, E): the per-node sums of edge terms as products, one
    # fixed order of addition (a scatter-add on CUDA adds in atomic order).
    inc_src = torch.zeros((n, E), dtype=torch.float32)
    inc_src[src_np, np.arange(E)] = 1.0
    inc_dst = torch.zeros((n, E), dtype=torch.float32)
    inc_dst[dst_np, np.arange(E)] = 1.0
    inc_src, inc_dst = inc_src.to(dev), inc_dst.to(dev)
    R_rel = torch.as_tensor(rel[:, :3, :3], device=dev)
    t_rel = torch.as_tensor(rel[:, :3, 3], device=dev)
    w_t = torch.as_tensor(w, device=dev)

    # Per-node incident weight: the damping self-term's weight.
    deg = inc_src @ w_t + inc_dst @ w_t
    sum_nodes = lambda inc, x: (inc @ x.reshape(E, 9)).reshape(n, 3, 3)

    # Chordal rotation averaging (R_i = R_j R_ij), damped Jacobi: plain
    # Jacobi oscillates with period 2 on a bipartite graph (a scan chain);
    # averaging with each node's own rotation, weighted by its incident
    # weight, makes the sweep a contraction.
    R = torch.as_tensor(init[:, :3, :3], device=dev)
    for _ in range(sweeps):
        contrib_i = w_t[:, None, None] * (R[dst] @ R_rel)  # to node i: R_j R_ij
        contrib_j = w_t[:, None, None] * (R[src] @ R_rel.transpose(-1, -2))  # R_i R_ij^T
        acc = deg[:, None, None] * R + sum_nodes(inc_src, contrib_i)
        acc = acc + sum_nodes(inc_dst, contrib_j)
        # Nodes with no incident weight keep their estimate.
        keep = acc.abs().sum((1, 2), keepdim=True) < 1e-12
        R = _project_so3(torch.where(keep, R, acc))
    # The chordal objective is invariant under a global left rotation: fix
    # the gauge R_0 = I once at the end.
    R = _project_so3(torch.einsum("kj,nkl->njl", R[0], R))
    R[0] = torch.eye(3, device=dev)

    # Translation synchronization: t_i - t_j = R_j t_ij, t_0 = 0. Zero-weight
    # edges keep an epsilon row (1e-4 of a real edge, 1e4 x the ridge): a node
    # whose every edge failed the fitness gate falls back to its
    # measurement-derived translation instead of the ridge's zero.
    w_ls = torch.where(w_t > 0, w_t, torch.full_like(w_t, 1e-4))
    rhs_e = torch.einsum("ejk,ek->ej", R[dst], t_rel)  # (E, 3)
    # sel[k]: t_k's place in the unknowns [t_1 .. t_{N-1}]; node 0 is zero.
    sel = np.zeros((n, 3, 3 * (n - 1)), np.float32)
    for k in range(1, n):
        sel[k, :, 3 * (k - 1):3 * k] = np.eye(3)
    sel = torch.as_tensor(sel, device=dev)
    A = ((sel[src] - sel[dst]) * torch.sqrt(w_ls)[:, None, None]).reshape(-1, 3 * (n - 1))
    b = (rhs_e * torch.sqrt(w_ls)[:, None]).reshape(-1)
    AtA = A.T @ A + 1e-8 * torch.eye(3 * (n - 1), device=dev)
    t = torch.linalg.solve(AtA, A.T @ b).reshape(n - 1, 3)

    out = np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4)).copy()
    out[:, :3, :3] = R.cpu().numpy()
    out[1:, :3, 3] = t.cpu().numpy()
    return out


def default_edges(n: int, window: int = 2) -> List[Tuple[int, int]]:
    """The scan-stream topology: each scan paired with the next ``window``
    (the chain, and skip edges that close loops against drift)."""
    return [(i, j) for i in range(n) for j in range(i + 1, min(i + window + 1, n))]


def refine_to_map(
    clouds: Sequence[np.ndarray],
    poses: np.ndarray,
    icp_thresh: float,
    max_iteration: int = 30,
    rounds: int = 1,
    device="cuda",
) -> np.ndarray:
    """Scan-to-map ICP polish of synchronized poses.

    Each round re-registers every scan but scan 0 (the gauge), at its
    current pose, against the union of the other scans in the world frame,
    and keeps the refinement only if its ICP fitness does not drop below
    the fitness at the current pose (``registration_icp`` at
    ``max_iteration=0`` measures without an update). Scans pad to
    ``_default_capacity`` of the largest scan and the map to that of all the
    points, so a stream of calls reuses shapes. The single-pair ICP runs on
    ``device``.
    """
    clouds = [np.asarray(c, np.float32) for c in clouds]
    n = len(clouds)
    poses = np.array(poses, np.float32)
    if n <= 1 or rounds < 1:
        return poses
    dev = resolve_device(device)
    on = lambda a: torch.as_tensor(a).to(dev)

    def to_world(k):
        R, t = poses[k, :3, :3], poses[k, :3, 3]
        return (clouds[k] @ R.T + t).astype(np.float32)

    scan_cap = _default_capacity(max(len(c) for c in clouds))
    map_cap = _default_capacity(sum(len(c) for c in clouds))
    for _ in range(rounds):
        world = [to_world(k) for k in range(n)]
        for k in range(1, n):
            m = np.concatenate([world[i] for i in range(n) if i != k])
            sp, sm = (on(a) for a in pad_cloud(world[k], scan_cap))
            mp, mm = (on(a) for a in pad_cloud(m, map_cap))
            base = registration_icp(sp, mp, icp_thresh, max_iteration=0,
                                    src_mask=sm, tgt_mask=mm)
            res = registration_icp(sp, mp, icp_thresh, max_iteration=max_iteration,
                                   src_mask=sm, tgt_mask=mm)
            if float(res.fitness) >= float(base.fitness):
                poses[k] = res.transformation.cpu().numpy() @ poses[k]
                world[k] = to_world(k)
    return poses


def register_multiway(
    model: Callable,
    clouds: Sequence[np.ndarray],
    edges: Optional[Sequence[Tuple[int, int]]] = None,
    sweeps: int = 100,
    min_fitness: float = 0.0,
    refine_rounds: int = 0,
    refine_icp_thresh: Optional[float] = None,
    device="cuda",
    **register_kwargs,
) -> MultiwayResult:
    """Align N raw scans ``(N_k, 3)`` into scan 0's frame, GT-free.

    Pairwise poses come from :func:`register_pairs` on ``device``
    (``register_kwargs`` go to it: normalize, thresholds, passes,
    batch_size, capacity), weighted by their ICP fitness, then synchronized
    (:func:`synchronize_poses`). ``edges`` default to :func:`default_edges`.
    Edges whose fitness is below ``min_fitness`` keep their connectivity but
    weigh (near) nothing. ``refine_rounds`` rounds of :func:`refine_to_map`
    follow, at ``refine_icp_thresh`` (default the pairwise ``icp_thresh``).
    ``model`` is a :class:`PointTransformer` on ``device``.

    Returns absolute ``poses`` with ``poses[0] = I``: ``scan_k @ R_k.T + t_k``
    places scan k in scan 0's frame.
    """
    clouds = [np.asarray(c, np.float32) for c in clouds]
    n = len(clouds)
    if n == 0:
        return MultiwayResult(np.zeros((0, 4, 4), np.float32), [], np.zeros((0,), np.float32))
    if n == 1:
        return MultiwayResult(np.eye(4, dtype=np.float32)[None], [],
                              np.zeros((0,), np.float32))
    if edges is None:
        edges = default_edges(n)
    edges = [(int(i), int(j)) for i, j in edges]
    if not edges:
        raise ValueError(f"no edges for {n} scans (window too small?)")
    for i, j in edges:
        if not (0 <= i < n and 0 <= j < n) or i == j:
            raise ValueError(f"bad edge ({i}, {j}) for {n} scans")

    results = register_pairs(model, [(clouds[i], clouds[j]) for i, j in edges],
                             device=device, **register_kwargs)
    rel = np.stack([r.transform for r in results])
    fit = np.asarray([r.fitness for r in results], np.float32)
    w = np.where(fit >= min_fitness, fit, 0.0).astype(np.float32)
    poses = synchronize_poses(n, edges, rel, weights=w, sweeps=sweeps, device=device)
    if refine_rounds > 0:
        thresh = (refine_icp_thresh if refine_icp_thresh is not None
                  else register_kwargs.get("icp_thresh", 0.1))
        poses = refine_to_map(clouds, poses, thresh, rounds=refine_rounds, device=device)
    return MultiwayResult(poses, edges, fit)
