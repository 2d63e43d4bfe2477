"""Pipeline parallelism: a GPipe microbatch schedule over a ``pipe`` axis
(port of ``scream_tpu/parallel/pp.py``).

Rank ``s`` of the ``pipe`` axis holds stage ``s``'s parameters. The JAX
package runs the schedule as one ``lax.scan`` of ``ppermute`` ticks inside a
``shard_map`` and differentiates through it; here each stage runs its own
loop and hands activations on with point-to-point sends:

* forward (fill and drain): stage 0 takes microbatch ``j`` from its
  input, stage ``s > 0`` receives it from stage ``s - 1``; each stage
  applies ``stage_fn`` and sends the result on (asynchronously, so stage
  ``s`` works on microbatch ``j + 1`` while stage ``s + 1`` works on ``j``).
  The last stage holds the finished microbatches; :func:`pipeline_parallel_apply`
  broadcasts them to every stage, as the JAX function's psum does.
* backward (training): the last stage computes the loss over all the
  microbatches and its backward; then, microbatch by microbatch in reverse,
  each stage receives the gradient of its outputs from the next stage,
  backpropagates through its stage (its parameters' gradients accumulate
  over the microbatches, GPipe's gradient accumulation) and sends the
  gradient of its inputs to the previous stage. Each stage's inputs are
  autograd leaves, so no graph crosses a rank.

Sends and receives pair in the same order on both ends (forward by
microbatch, backward in reverse), so NCCL's in-order matching and gloo's
tags agree. Under gloo CUDA tensors travel through the host
(``parallel/mesh.py``). Activations are pytrees (tensors, tuples, lists,
dicts) of the same structure and shapes in and out of every stage.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from scream_tpu_torch.parallel.mesh import Mesh, all_gather_cat, make_mesh, recv, send


def make_pipeline_mesh(n_stages: int, n_ranks: Optional[int] = None) -> Mesh:
    """A ``(data, pipe)`` mesh with ``n_stages`` on ``pipe`` (data 1): the
    JAX package's 1-D ``(pipe,)`` mesh, with the data axis every trainer
    mesh of the port carries."""
    if n_ranks is not None and n_ranks < n_stages:
        raise ValueError(f"need {n_stages} devices for {n_stages} stages, have {n_ranks}")
    if n_stages == 1:
        raise ValueError("a pipeline needs at least 2 stages")
    return make_mesh(n_data=1, n_pipe=n_stages, n_ranks=n_ranks)


def stack_stage_params(stage_params_list: Sequence[Dict[str, torch.Tensor]]):
    """Stack per-stage parameter dicts along a new leading stage axis."""
    keys = list(stage_params_list[0])
    return {k: torch.stack([p[k] for p in stage_params_list]) for k in keys}


def stage_params(stacked: Dict[str, torch.Tensor], mesh: Mesh, axis: str = "pipe"):
    """This rank's stage of a stacked parameter dict (the JAX function's
    ``P(axis)`` sharding of the leading axis)."""
    s = mesh.coord(axis)
    return {k: v[s] for k, v in stacked.items()}


class _Stage:
    """One rank's place in the pipeline: its stage index, its neighbours'
    global ranks and the group."""

    def __init__(self, mesh: Mesh, axis: str):
        self.group = mesh.group(axis)
        self.n = mesh.axis_size(axis)
        self.s = mesh.coord(axis)
        self.first, self.last = self.s == 0, self.s == self.n - 1
        self.prev = None if self.first else dist.get_global_rank(self.group, self.s - 1)
        self.next = None if self.last else dist.get_global_rank(self.group, self.s + 1)
        self.last_rank = dist.get_global_rank(self.group, self.n - 1)
        self.device = mesh.device


def _tag(j: int, leaf: int, n_leaves: int, backward: bool) -> int:
    return 2 * (j * n_leaves + leaf) + int(backward)


def _forward(stage: _Stage, stage_fn: Callable, params, microbatches, grad: bool):
    """Run this stage over every microbatch: returns ``(inputs, outputs)``,
    per microbatch the flat input leaves (autograd leaves where ``grad``)
    and the flat output leaves."""
    leaves, spec = pytree.tree_flatten(microbatches)
    n_micro, n_leaves = leaves[0].shape[0], len(leaves)
    inputs, outputs, pending = [], [], []
    for j in range(n_micro):
        if stage.first:
            x = [leaf[j] for leaf in leaves]
        else:
            x = [recv(leaf.shape[1:], leaf.dtype, stage.prev, stage.device,
                      _tag(j, li, n_leaves, False)) for li, leaf in enumerate(leaves)]
        if grad:
            x = [t.detach().requires_grad_(t.is_floating_point()) for t in x]
        y = pytree.tree_leaves(stage_fn(params, pytree.tree_unflatten(x, spec)))
        if not stage.last:
            pending += [send(t, stage.next, _tag(j, li, n_leaves, False))
                        for li, t in enumerate(y)]
        inputs.append(x)
        outputs.append(y)
    for h in pending:
        h.wait()
    return inputs, outputs, spec


def _backward(stage: _Stage, inputs, outputs) -> List[List[torch.Tensor]]:
    """GPipe's drain in reverse: the last stage has run its loss's backward;
    every other stage receives its outputs' gradients, backpropagates and
    passes its inputs' gradients back. Returns stage 0's input gradients
    per microbatch (None elsewhere)."""
    n_leaves = len(inputs[0])
    pending, first_grads = [], []
    for j in reversed(range(len(inputs))):
        if not stage.last:
            grads = [recv(t.shape, t.dtype, stage.next, stage.device,
                          _tag(j, li, n_leaves, True)) for li, t in enumerate(outputs[j])]
            pairs = [(t, g) for t, g in zip(outputs[j], grads) if t.requires_grad]
            if pairs:
                torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs])
        g_in = [x.grad if x.grad is not None else torch.zeros_like(x) for x in inputs[j]]
        if stage.first:
            first_grads.append(g_in)
        else:
            pending += [send(g, stage.prev, _tag(j, li, n_leaves, True))
                        for li, g in enumerate(g_in)]
    for h in pending:
        h.wait()
    return first_grads[::-1] if stage.first else None


def _stacked(outputs, spec):
    """Per-microbatch flat leaves -> the pytree with a leading n_micro axis."""
    cols = [torch.stack([o[li] for o in outputs]) for li in range(len(outputs[0]))]
    return pytree.tree_unflatten(cols, spec)


def _broadcast_from_last(stage: _Stage, tree_like, tree=None):
    """``tree`` (held by the last stage) on every stage; ``tree_like`` gives
    the structure, shapes and dtypes to the others."""
    leaves, spec = pytree.tree_flatten(tree if stage.last else tree_like)
    out = []
    for t in leaves:
        buf = t.detach().clone() if stage.last else torch.empty_like(t)
        dist.broadcast(buf, stage.last_rank, group=stage.group)
        out.append(buf)
    return pytree.tree_unflatten(out, spec)


def _data_rows(tree, mesh: Mesh, data_axis: Optional[str]):
    """Each leaf's rows (dim 1, after the microbatch axis) of this data rank."""
    if data_axis is None or mesh.axis_size(data_axis) == 1:
        return tree
    n, i = mesh.axis_size(data_axis), mesh.coord(data_axis)
    return pytree.tree_map(lambda t: t[:, i * (t.shape[1] // n):(i + 1) * (t.shape[1] // n)],
                           tree)


@torch.no_grad()
def pipeline_parallel_apply(stage_fn: Callable, stacked_params, microbatches, mesh: Mesh,
                            axis: str = "pipe", data_axis: Optional[str] = None):
    """Run ``n_micro`` microbatches through the ``n_stages`` stages of
    ``axis``, rank ``s`` applying ``stage_fn(params_s, x) -> y`` (``y`` of
    ``x``'s structure and shapes) with its stage of ``stacked_params``
    (:func:`stack_stage_params`; or a callable's own closure with
    ``stacked_params=None``). ``microbatches`` (leading ``n_micro`` axis)
    are given to every rank; stage 0 takes them. ``data_axis``: each data
    rank runs its own pipeline over its rows of every microbatch (leaf dim
    1), gathered back at the end.

    Returns the outputs (leading ``n_micro`` axis) on every rank, equal to
    applying the stages in sequence."""
    stage = _Stage(mesh, axis)
    params = None if stacked_params is None else stage_params(stacked_params, mesh, axis)
    local = _data_rows(microbatches, mesh, data_axis)
    _, outputs, spec = _forward(stage, stage_fn, params, local, grad=False)
    out = _broadcast_from_last(stage, local, _stacked(outputs, spec) if stage.last else None)
    if data_axis is not None and mesh.axis_size(data_axis) > 1:
        out = pytree.tree_map(lambda t: all_gather_cat(t, mesh.group(data_axis), 1), out)
    return out


def pipeline_backward(stage_fn: Callable, loss_fn: Callable, params, microbatches, targets,
                      mesh: Mesh, axis: str = "pipe", remat: bool = False):
    """The GPipe training pass: forward over the microbatches, the last
    stage's ``loss_fn(preds, targets)`` over all of them (``preds`` with the
    leading ``n_micro`` axis) and its backward, then the reverse drain.
    Gradients accumulate into ``params``' leaves (this rank's stage).
    Returns ``(loss, first_grads)``: the loss on every stage of the axis,
    and on stage 0 the gradients of its inputs per microbatch (for a
    caller whose microbatches come from a differentiable prefix)."""
    stage = _Stage(mesh, axis)
    fn = stage_fn
    if remat:
        from torch.utils.checkpoint import checkpoint

        fn = lambda p, x: checkpoint(stage_fn, p, x, use_reentrant=False)
    inputs, outputs, spec = _forward(stage, fn, params, microbatches, grad=True)
    loss = None
    if stage.last:
        loss = loss_fn(_stacked(outputs, spec), targets)
        loss.backward()
    first_grads = _backward(stage, inputs, outputs)
    loss = _broadcast_from_last(stage, torch.zeros((), device=stage.device),
                                loss.detach() if stage.last else None)
    return loss, first_grads


def pipeline_parallel_grads(stage_fn: Callable, loss_fn: Callable, stacked_params,
                            microbatches, targets, mesh: Mesh, axis: str = "pipe",
                            remat: bool = False):
    """Loss and this rank's stage's parameter gradients through the GPipe
    pipeline: ``(loss, grads)``, ``grads`` a dict like this rank's stage of
    ``stacked_params`` (the JAX function returns the stacked gradients
    sharded one stage a device: this is that device's slice). Make
    ``loss_fn`` a mean over microbatches for the gradients of one
    large-batch step. ``remat`` recomputes each stage in the backward
    (``torch.utils.checkpoint``)."""
    params = {k: v.detach().clone().requires_grad_()
              for k, v in stage_params(stacked_params, mesh, axis).items()}
    loss, _ = pipeline_backward(stage_fn, loss_fn, params, microbatches, targets, mesh,
                                axis, remat)
    return loss, {k: v.grad if v.grad is not None else torch.zeros_like(v)
                  for k, v in params.items()}


def pipeline_train_step(stage_fn: Callable, loss_fn: Callable,
                        optimizer: torch.optim.Optimizer, params: Dict[str, torch.Tensor],
                        microbatches, targets, mesh: Mesh, axis: str = "pipe",
                        remat: bool = False):
    """One pipelined training step on this rank's stage: ``params`` (its
    stage's parameters, which ``optimizer`` updates) get their gradients
    from :func:`pipeline_backward`, then one update. Each rank holds only
    its stage's parameters and Adam moments. Returns the loss."""
    optimizer.zero_grad(set_to_none=True)
    loss, _ = pipeline_backward(stage_fn, loss_fn, params, microbatches, targets, mesh,
                                axis, remat)
    optimizer.step()
    return loss
