"""Every parallel mode once over an n-rank world, each against the single
process on the same rank (the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

    python -m scream_tpu_torch.parallel.dryrun --ranks 4 --device cpu

spawns the ranks (gloo on the CPU; on CUDA NCCL where every rank has a card,
else gloo with the ranks sharing one) and runs, at small sizes in fp32:

* ``dp``: a data-parallel registration step (mesh ``data=n``) against the
  single-process step, parameters within 1e-5;
* ``dp_gan``: the same with the GAN term, then the discriminator step:
  the generator's parameters and the discriminator's BatchNorm running
  averages 1e-5 (``dp_gan``), the discriminator's gradients 1e-5 relative
  to each one's norm (``dp_gan_disc``; Adam's sign-like first step makes
  its updated weights no measure);
* ``sp`` (even n): sequence-parallel linear attention (1e-5), the forward
  with the points spread over ``seq`` (2e-4) and a ``data x seq`` step
  (2e-5);
* ``tp`` (even n): the ``data x model`` forward (2e-4) and step (1e-5);
* ``pp`` (even n): a 2-stage pipeline against the sequential stack (1e-4),
  its gradients (1e-5), the flagship forward on ``data x pipe`` bit for bit
  against the model run on the same pieces (``pp_flagship_forward``: the
  embed and head on each data rank's rows, the blocks on each microbatch)
  and within 2e-4 of the model on the whole batch (``..._whole``: the JAX
  tests' bar for a forward whose products run at other shapes; on the CPU
  it is bit for bit too, on the card cuBLAS picks a product's kernel by its
  row count),
  and the flagship step (1e-5);
* ``ep``: the expert-parallel MoE FFN and its gradients (1e-5).

Rank 0 prints one JSON line of the largest errors. The checks are
``_require`` calls, which raise after every mode has run, naming each one
outside its bar (they survive ``python -O``).
"""

from __future__ import annotations

import argparse
import copy
import json
from typing import Dict

import torch

BARS = {"dp": 1e-5, "dp_gan": 1e-5, "dp_gan_disc": 1e-5, "sp_attention": 1e-5, "sp_forward": 2e-4,
        "sp_step": 2e-5, "tp_forward": 2e-4, "tp_step": 1e-5, "pp_apply": 1e-4,
        "pp_grads": 1e-5, "pp_flagship_forward": 0.0, "pp_flagship_forward_whole": 2e-4,
        "pp_flagship_step": 1e-5,
        "ep": 1e-5, "ep_grads": 1e-5}


def _require(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun: {msg}")


def _max_err(a, b) -> float:
    if isinstance(a, dict):
        return max(_max_err(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return max(_max_err(x, y) for x, y in zip(a, b))
    return float((a.detach().float().cpu() - b.detach().float().cpu()).abs().max())


def _check(errs: Dict[str, float], name: str, err: float) -> None:
    errs[name] = err


def failures(errs: Dict[str, float]) -> list:
    """The modes whose error is not within its bar (NaN included)."""
    return [f"{k}: max error {v:g} > {BARS[k]:g}" for k, v in errs.items()
            if not v <= BARS[k]]


def _batch(device, B=8, N=64, seed=0):
    from scream_tpu_torch.data import PairLoader, SyntheticPairDataset

    ds = SyntheticPairDataset(length=B, n_src=N - 8, n_tgt=N - 8, seed=seed)
    b = next(iter(PairLoader(ds, batch_size=B, src_capacity=N, tgt_capacity=N,
                             num_workers=0)))
    return {k: torch.as_tensor(v).to(device) for k, v in b.items()}


def _model(device, d=32, heads=4, layers=1):
    from scream_tpu_torch.config import ModelConfig
    from scream_tpu_torch.models import PointTransformer

    cfg = ModelConfig(d_model=d, num_heads=heads, self_layers=layers, cross_layers=layers,
                      dtype="float32", fused_attention=False, fused_block_tail=False)
    return PointTransformer(cfg, device=device, generator=torch.Generator().manual_seed(0))


def _trained(model, batch, wrap=None, use_gan=False, disc=None):
    """One generator step (and with the GAN a discriminator step) on a copy
    of ``model``: ``(model, disc, metrics)``."""
    from scream_tpu_torch.config import RenderConfig, TrainConfig
    from scream_tpu_torch.train.optim import discriminator_optimizer, generator_optimizer
    from scream_tpu_torch.train.steps import (DiscState, init_train_state,
                                              make_disc_logit_fn, make_discriminator_step,
                                              make_registration_train_step)

    model = copy.deepcopy(model)
    rcfg = RenderConfig(rho=6.0, width=32, multi_view=False)
    opt, sched = generator_optimizer(model.parameters(), TrainConfig(), 10)
    step = make_registration_train_step(
        model, use_gan=use_gan, disc_apply=make_disc_logit_fn() if use_gan else None,
        render_cfg=rcfg)
    dstep = make_discriminator_step(rcfg) if use_gan else None
    if disc is not None:
        disc = copy.deepcopy(disc)
        dstate = DiscState(disc, discriminator_optimizer(disc.parameters(), TrainConfig()))
    if wrap is not None:
        step, dstep = wrap(step, dstep)
    _, metrics, fake = step(init_train_state(opt, sched), batch, disc)
    if use_gan:
        dstep(dstate, fake, *(batch[k] for k in ("src", "tgt", "src_mask", "tgt_mask",
                                                  "rot", "trans")))
    return model, disc, metrics


def _dp(mesh_world, device, errs):
    from scream_tpu_torch.models import PatchDiscriminator
    from scream_tpu_torch.parallel import (data_parallel_arrays_step, data_parallel_step,
                                           make_mesh)

    mesh = make_mesh(n_data=mesh_world)
    batch, model = _batch(device), _model(device)
    wrap = lambda s, d: (data_parallel_step(s, mesh),
                         d and data_parallel_arrays_step(d, mesh))
    want, _, m1 = _trained(model, batch)
    got, _, m2 = _trained(model, batch, wrap)
    _check(errs, "dp", max(_max_err(dict(want.named_parameters()),
                                     dict(got.named_parameters())),
                           abs(float(m1["point_loss"]) - float(m2["point_loss"]))))
    disc = PatchDiscriminator(input_nc=2, device=device,
                              generator=torch.Generator().manual_seed(1))
    want, dwant, _ = _trained(model, batch, use_gan=True, disc=disc)
    got, dgot, _ = _trained(model, batch, wrap, use_gan=True, disc=disc)
    stats = lambda d: {k: v for k, v in d.state_dict().items() if "running" in k}
    _check(errs, "dp_gan", max(_max_err(dict(want.named_parameters()),
                                        dict(got.named_parameters())),
                               _max_err(stats(dwant), stats(dgot))))
    # Adam moves each weight by about lr * sign(gradient), so a gradient
    # near 0 flips on fp32 noise: the discriminator is held by its
    # gradients (averaged over the ranks), relative to each one's norm.
    _check(errs, "dp_gan_disc", max(
        float((a.grad - b.grad).norm() / a.grad.norm().clamp_min(1e-30))
        for a, b in zip(dwant.parameters(), dgot.parameters())))


def _sp(world, device, errs):
    from scream_tpu_torch.models import linear_attention
    from scream_tpu_torch.parallel import (data_seq_parallel_step, make_mesh,
                                           points_parallel,
                                           sequence_parallel_linear_attention, shard_points)
    from scream_tpu_torch.parallel.mesh import all_gather_cat

    mesh = make_mesh(n_data=world // 2, n_seq=2)
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 64, 4, 8, generator=g).to(device) for _ in range(3))
    qm, km = (torch.rand(2, 64, generator=g).to(device) > 0.2 for _ in range(2))
    got = sequence_parallel_linear_attention(
        mesh, *(shard_points(t, mesh) for t in (q, k, v, qm, km)))
    _check(errs, "sp_attention", _max_err(
        linear_attention(q, k, v, qm, km),
        all_gather_cat(got, mesh.group("seq"), 1)))

    batch, model = _batch(device), _model(device)
    args = [batch["src"], batch["tgt"], batch["src_mask"], batch["tgt_mask"]]
    center = batch["trans"].transpose(-1, -2)
    with torch.no_grad():
        want = model(*args, center)
        with points_parallel(model, mesh):
            got = model(*(shard_points(t, mesh) for t in args), center)
    _check(errs, "sp_forward", _max_err(want, all_gather_cat(got, mesh.group("seq"), 1)))
    w, _, _ = _trained(model, batch)
    s, _, _ = _trained(model, batch, lambda st, d: (data_seq_parallel_step(st, mesh), d))
    _check(errs, "sp_step", _max_err(dict(w.named_parameters()), dict(s.named_parameters())))


def _tp(world, device, errs):
    from scream_tpu_torch.parallel import make_mesh, tensor_parallel_apply, tensor_parallel_step
    from scream_tpu_torch.parallel.tp import full_state_dict

    mesh = make_mesh(n_data=world // 2, n_model=2)
    batch, model = _batch(device), _model(device)
    args = (batch["src"], batch["tgt"], batch["src_mask"], batch["tgt_mask"],
            batch["trans"].transpose(-1, -2))
    with torch.no_grad():
        want = model(*args)
        got = tensor_parallel_apply(copy.deepcopy(model), mesh)(*args)
    _check(errs, "tp_forward", _max_err(want, got))
    w, _, _ = _trained(model, batch)
    t, _, _ = _trained(model, batch, lambda st, d: (tensor_parallel_step(st, mesh), d))
    _check(errs, "tp_step", _max_err(w.state_dict(), full_state_dict(t, mesh)))


def _flagship_in_pieces(model, args, n_data, n_micro):
    """``model``'s forward on the pieces the pipelined forward runs: the
    embed and the head on each data rank's rows, the blocks (in schedule
    order, one process) on each microbatch of them."""
    from scream_tpu_torch.parallel.pp_flagship import (make_flagship_stage_fn,
                                                       pack_flagship_stages)

    stage_fn = make_flagship_stage_fn(model)
    (stage,), _ = pack_flagship_stages(model.cfg, 1)
    out = []
    for src, tgt, sm, tm, ctr in zip(*(a.chunk(n_data) for a in args)):
        src_f, tgt_f = model.trunk.embed(src, tgt, ctr)
        feats = [stage_fn(stage, {"src_feats": s_, "tgt_feats": t_,
                                  "src_mask": m_.to(s_.dtype), "tgt_mask": n_.to(s_.dtype)}
                          )["src_feats"]
                 for s_, t_, m_, n_ in zip(src_f.chunk(n_micro), tgt_f.chunk(n_micro),
                                           sm.chunk(n_micro), tm.chunk(n_micro))]
        out.append(model.trunk.head(torch.cat(feats)))
    return torch.cat(out)


def _pp(world, device, errs):
    from torch.func import functional_call

    from scream_tpu_torch.models import AttentionBlock
    from scream_tpu_torch.parallel import (dp, make_mesh, pipeline_parallel_apply,
                                           pipeline_parallel_grads, stack_stage_params)
    from scream_tpu_torch.parallel.pp_flagship import (flagship_pp_forward,
                                                       make_pp_registration_train_step)

    mesh = make_mesh(n_data=world // 2, n_pipe=2)
    g = torch.Generator().manual_seed(3)
    blocks = [AttentionBlock(32, 4, generator=g).to(device) for _ in range(2)]
    stacked = stack_stage_params([{k: v.detach() for k, v in b.named_parameters()}
                                  for b in blocks])
    stage_fn = lambda p, h: functional_call(blocks[0], p, (h, h, h))
    x = torch.randn(4, 2, 16, 32, generator=g).to(device)
    tgt = torch.randn(4, 2, 16, 32, generator=g).to(device)
    with torch.no_grad():
        want = x
        for b in blocks:
            want = torch.stack([b(h, h, h) for h in want])
    _check(errs, "pp_apply", _max_err(want, pipeline_parallel_apply(stage_fn, stacked, x, mesh)))
    loss_fn = lambda preds, t: torch.mean((preds - t) ** 2)
    leaves = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    h = x
    for s in range(2):
        p = {k: v[s] for k, v in leaves.items()}
        h = torch.stack([stage_fn(p, m) for m in h])
    loss_fn(h, tgt).backward()
    _, grads = pipeline_parallel_grads(stage_fn, loss_fn, stacked, x, tgt, mesh)
    s = mesh.coord("pipe")
    _check(errs, "pp_grads", _max_err({k: v.grad[s] for k, v in leaves.items()}, grads))

    batch, model = _batch(device), _model(device)
    args = (batch["src"], batch["tgt"], batch["src_mask"], batch["tgt_mask"],
            batch["trans"].transpose(-1, -2))
    with torch.no_grad():
        got = flagship_pp_forward(model, *args, mesh, n_micro=2, data_axis="data")
        whole = model(*args)
        rows = _flagship_in_pieces(model, args, mesh.axis_size("data"), 2)
    _check(errs, "pp_flagship_forward", _max_err(rows, got))
    _check(errs, "pp_flagship_forward_whole", _max_err(whole, got))
    w, _, _ = _trained(model, batch)
    f, _, _ = _trained(model, batch, lambda st, d: (dp.data_parallel_step(
        make_pp_registration_train_step(st.model, mesh, n_micro=2), mesh), d))
    _check(errs, "pp_flagship_step", _max_err(dict(w.named_parameters()),
                                              dict(f.named_parameters())))


def _ep(world, device, errs):
    from scream_tpu_torch.parallel import (expert_parallel_moe_ffn, init_moe_ffn_params,
                                           make_expert_mesh, moe_ffn_reference)

    mesh = make_expert_mesh(world)
    g = torch.Generator().manual_seed(4)
    params = {k: v.to(device) for k, v in init_moe_ffn_params(g, 16, 32, 2 * world).items()}
    x = torch.randn(2, 24, 16, generator=g).to(device)
    tgt = torch.randn(2, 24, 16, generator=g).to(device)
    p1 = {k: v.clone().requires_grad_() for k, v in params.items()}
    p2 = {k: v.clone().requires_grad_() for k, v in params.items()}
    want, got = moe_ffn_reference(p1, x), expert_parallel_moe_ffn(mesh, p2, x)
    _check(errs, "ep", _max_err(want, got))
    torch.mean((want - tgt) ** 2).backward()
    torch.mean((got - tgt) ** 2).backward()
    _check(errs, "ep_grads", _max_err({k: v.grad for k, v in p1.items()},
                                      {k: v.grad for k, v in p2.items()}))


def run_modes(mesh, strict: bool = True) -> Dict[str, float]:
    """Every mode on this rank of the world ``mesh`` spans; returns the
    largest errors (each comparison is made on every rank). ``strict``:
    raise, after every mode has run, if any is not within its bar."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    world, device, errs = mesh.size, mesh.device, {}
    _dp(world, device, errs)
    if world % 2 == 0:
        _sp(world, device, errs)
        _tp(world, device, errs)
        _pp(world, device, errs)
    _ep(world, device, errs)
    if strict:
        bad = failures(errs)
        _require(not bad, "; ".join(bad))
    return errs


def _rank(mesh, out_path):
    errs = run_modes(mesh)
    line = json.dumps({"dryrun": "ok", "ranks": mesh.size, "device": str(mesh.device.type),
                       "max_err": errs})
    print(line, flush=True)
    if out_path and torch.distributed.get_rank() == 0:
        with open(out_path, "w") as f:
            f.write(line + "\n")


def dryrun_multichip(n_ranks: int, device="cpu", out_path=None) -> None:
    """Spawn ``n_ranks`` ranks and run :func:`run_modes` on them; raises if
    any rank fails a check. ``out_path``: rank 0's JSON line is written
    there too."""
    from scream_tpu_torch.parallel import launch

    launch(_rank, {"data": n_ranks}, device, args=(out_path,))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    a = ap.parse_args(argv)
    dryrun_multichip(a.ranks, a.device, a.out)


if __name__ == "__main__":
    main()
