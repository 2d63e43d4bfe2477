"""Pipeline parallelism for the flagship PointTransformer (port of
``scream_tpu/parallel/pp_flagship.py``).

``parallel/pp.py`` pipelines stacks of identical stages. The flagship model
is not one: embed + PE, six *shared* self-attention stems applied to both
clouds, six (self, cross) block pairs on the source, and a 3-layer
coordinate head. As in the JAX package:

* the embed and the head run outside the pipeline (together a few percent
  of the forward's work);
* the 18 block applications in between go into uniform slots: each stage
  holds ``k`` slots, each a trunk block and a mode, 0 = stem (tgt then src,
  shared weights), 1 = self on src, 2 = cross src <- tgt, 3 = no-op (the
  padding when ``n_stages`` does not divide the schedule);
* the pipeline state is ``(src_feats, tgt_feats, masks as floats)``, so each
  microbatch is self-contained as it flows from stage to stage.

The stages apply the model's own blocks (every rank holds the whole model),
so the gradients land on the standard model: after the backward each
parameter's gradient sits on the rank that used it (a block on its stage,
the embed on stage 0, the head on the last stage) and one sum over the
``pipe`` ranks gives every rank the whole gradient, the single-process
step's. The forward applies the blocks op for op as ``_Trunk.forward``
does, microbatch by microbatch.

Composition with data parallelism: on a ``(data, pipe)`` mesh each data row
runs its own pipeline over its rows (the trainer wraps the step in
``dp.data_parallel_step``; :func:`flagship_pp_forward` takes ``data_axis``).
"""

from __future__ import annotations

from typing import Optional

import torch

from scream_tpu_torch.config import ModelConfig
from scream_tpu_torch.models.point_transformer import PointTransformer, masked_centroid
from scream_tpu_torch.parallel.mesh import Mesh, all_gather_cat, average_grads
from scream_tpu_torch.parallel.pp import (_Stage, _broadcast_from_last, _forward, _stacked,
                                          pipeline_backward)

# Slot modes.
MODE_STEM, MODE_SELF, MODE_CROSS, MODE_NOOP = 0, 1, 2, 3


def flagship_slot_schedule(cfg: ModelConfig):
    """The flagship's block applications in order, as (trunk block name,
    mode): ``_Trunk.forward``'s shared stems (each on tgt then src), then
    alternating (cross_self_i, cross_attn_i) on src."""
    if cfg.separate_stems:
        raise ValueError("flagship PP covers the shared-stem PointTransformer")
    slots = [(f"stem_{i}", MODE_STEM) for i in range(cfg.self_layers)]
    for i in range(cfg.cross_layers):
        slots.append((f"cross_self_{i}", MODE_SELF))
        slots.append((f"cross_attn_{i}", MODE_CROSS))
    return slots


def pack_flagship_stages(cfg: ModelConfig, n_stages: int):
    """The schedule cut into ``n_stages`` stages of ``k`` slots: ``(stages,
    k)``, ``stages[s]`` a dict of ``"blocks"`` (``k`` trunk block names,
    None for a no-op) and ``"modes"`` (an int32 tensor of ``k`` modes); the
    last stage padded with no-op slots where ``n_stages`` does not divide
    the schedule (the JAX function stacks the blocks' parameters with
    zero-parameter no-op slots; here a stage names the model's blocks)."""
    slots = flagship_slot_schedule(cfg)
    k = -(-len(slots) // n_stages)
    stages = []
    for s in range(n_stages):
        chunk = slots[s * k:(s + 1) * k]
        chunk = chunk + [(None, MODE_NOOP)] * (k - len(chunk))
        stages.append({"blocks": [name for name, _ in chunk],
                       "modes": torch.tensor([m for _, m in chunk], dtype=torch.int32)})
    return stages, k


def make_flagship_stage_fn(model: PointTransformer):
    """``stage_fn(stage, state) -> state`` applying a stage's slots (a dict
    of :func:`pack_flagship_stages`) to the pipeline state with ``model``'s
    blocks."""
    trunk = model.trunk

    def stage_fn(stage, state):
        src_f, tgt_f = state["src_feats"], state["tgt_feats"]
        sm, tm = state["src_mask"] > 0.5, state["tgt_mask"] > 0.5
        for name, mode in zip(stage["blocks"], stage["modes"].tolist()):
            if mode == MODE_NOOP:
                continue
            blk = getattr(trunk, name)
            if mode == MODE_STEM:
                # shared weights, tgt first then src: _Trunk's order
                tgt_f = blk(tgt_f, tgt_f, tgt_f, tm, tm)
                src_f = blk(src_f, src_f, src_f, sm, sm)
            elif mode == MODE_SELF:
                src_f = blk(src_f, src_f, src_f, sm, sm)
            else:
                src_f = blk(src_f, tgt_f, tgt_f, sm, tm)
        return {"src_feats": src_f, "tgt_feats": tgt_f,
                "src_mask": state["src_mask"], "tgt_mask": state["tgt_mask"]}

    return stage_fn


def _pipeline_state(model, src, tgt, src_mask, tgt_mask, src_center, n_micro):
    """The embed and the microbatched pipeline state."""
    B = src.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} must divide into {n_micro} microbatches")
    if src_center is None:
        src_center = masked_centroid(src, src_mask)
    src_f, tgt_f = model.trunk.embed(src, tgt, src_center)
    mb = lambda x: x.reshape((n_micro, B // n_micro) + x.shape[1:])
    return (src_f, tgt_f), {"src_feats": mb(src_f), "tgt_feats": mb(tgt_f),
                            "src_mask": mb(src_mask.to(src_f.dtype)),
                            "tgt_mask": mb(tgt_mask.to(src_f.dtype))}


def _stage_of(model, mesh: Mesh, axis: str):
    stages, _ = pack_flagship_stages(model.cfg, mesh.axis_size(axis))
    return stages[mesh.coord(axis)]


def _unmb(x):
    return x.reshape((-1,) + x.shape[2:])


@torch.no_grad()
def flagship_pp_forward(model: PointTransformer, src, tgt, src_mask, tgt_mask, src_center,
                        mesh: Mesh, n_micro: int, axis: str = "pipe",
                        data_axis: Optional[str] = None) -> torch.Tensor:
    """``model``'s forward with its block stack pipelined over ``axis``:
    ``src_pred`` for the whole batch on every rank. The batch must divide
    into ``n_micro`` microbatches (per data rank where ``data_axis`` splits
    it). Equal, bit for bit, to ``model(...)`` where the blocks' products
    do not depend on the batch size."""
    if data_axis is not None and mesh.axis_size(data_axis) > 1:
        n, i = mesh.axis_size(data_axis), mesh.coord(data_axis)
        m = src.shape[0] // n
        cut = lambda t: None if t is None else t[i * m:(i + 1) * m]
        out = flagship_pp_forward(model, cut(src), cut(tgt), cut(src_mask), cut(tgt_mask),
                                  cut(src_center), mesh, n_micro, axis)
        return all_gather_cat(out, mesh.group(data_axis))
    stage = _Stage(mesh, axis)
    _, state = _pipeline_state(model, src, tgt, src_mask, tgt_mask, src_center, n_micro)
    _, outputs, spec = _forward(stage, make_flagship_stage_fn(model),
                                _stage_of(model, mesh, axis), state, grad=False)
    feats = _broadcast_from_last(stage, state["src_feats"],
                                 _stacked(outputs, spec)["src_feats"] if stage.last else None)
    return model.trunk.head(_unmb(feats))


def make_pp_registration_train_step(model: PointTransformer, mesh: Mesh, n_micro: int,
                                    center_mode: str = "trans", axis: str = "pipe"):
    """The registration generator step with the flagship forward pipelined
    over ``axis``: ``step(state, batch, disc=None, stage_hook=None) ->
    (state, metrics, None)``, as ``train.steps.make_registration_train_step``
    (point loss only: the GAN's renderer and discriminator live outside the
    pipeline, and the reference ships GAN off by default). Every rank holds
    the whole model and its optimizer; the gradients are summed over the
    pipe ranks before the update, so every rank takes the single-process
    update. On a ``(data, pipe)`` mesh wrap it in
    ``dp.data_parallel_step``."""
    from scream_tpu_torch.pipeline.register import gt_center_hint

    stage = _Stage(mesh, axis)
    slots = _stage_of(model, mesh, axis)
    stage_fn = make_flagship_stage_fn(model)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(state, batch, disc=None, stage_hook=None):
        if disc is not None:
            raise ValueError("--mesh pipe=N does not combine with GAN training")
        mark = stage_hook or (lambda name: None)
        src, tgt = batch["src"], batch["tgt"]
        src_mask, tgt_mask = batch["src_mask"], batch["tgt_mask"]
        state.optimizer.zero_grad(set_to_none=True)
        src_center = gt_center_hint(batch["rot"], batch["trans"], center_mode)
        (src_f, tgt_f), mbs = _pipeline_state(model, src, tgt, src_mask, tgt_mask,
                                              src_center, n_micro)

        def loss_fn(out, _):
            src_pred = model.trunk.head(_unmb(out["src_feats"])).float()
            return PointTransformer.loss(src_pred, src, batch["rot"], batch["trans"],
                                         src_mask)

        loss, first = pipeline_backward(stage_fn, loss_fn, slots, mbs, None, mesh, axis)
        if stage.first:
            # The embed's backward, from the stage-0 inputs' gradients.
            g_src = torch.cat([g[0] for g in first])
            g_tgt = torch.cat([g[1] for g in first])
            torch.autograd.backward([src_f, tgt_f], [g_src, g_tgt])
        mark("backward")
        average_grads(params, stage.group, stage.n, op="sum")
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        mark("optimizer")
        return state, {"point_loss": loss, "loss": loss}, None

    step.model = model
    return step
