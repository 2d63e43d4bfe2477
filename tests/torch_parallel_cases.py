"""The port's parallel modes as the CPU tests run them: one body a case, each
run on every rank of a gloo world (``run_all``, ``run_trainers``) and,
without a mesh, in the test process itself (the single-process results).

The inputs (weights converted from the JAX package's inits, batches made
with numpy from seeds) come in a file the test writes; rank 0 writes the
results to another. This module imports torch and the port only: the
spawned ranks import it, and nothing of JAX.
"""

import numpy as np
import torch

from scream_tpu_torch.config import EvalConfig, ModelConfig, RenderConfig, TrainConfig
from scream_tpu_torch.models import AttentionBlock, PointTransformer
from scream_tpu_torch.train.optim import generator_optimizer
from scream_tpu_torch.train.steps import init_train_state, make_registration_train_step

TINY = dict(d_model=32, num_heads=4, self_layers=1, cross_layers=1, dtype="float32")


def np_grads(model):
    return {k: p.grad.detach().cpu().numpy().copy() for k, p in model.named_parameters()}


def np_state(module_or_dict):
    d = module_or_dict.state_dict() if isinstance(module_or_dict, torch.nn.Module) \
        else module_or_dict
    return {k: v.detach().cpu().numpy().copy() for k, v in d.items()}


def tensors(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def model_from(state, **cfg):
    """The tiny model (``cfg`` on top) with ``state`` (None: a seeded init)."""
    m = PointTransformer(ModelConfig(**{**TINY, **cfg}), device="cpu")
    if state is not None:
        m.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()}, strict=True)
    return m


def fail_on_rank1(mesh):
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 fails")


def step_result(state, batch, wrap=None, steps=1, **cfg):
    """One (or ``steps``) generator step(s) from ``state``: parameters and
    point loss. ``wrap(step) -> step`` makes it a mesh's step."""
    model = model_from(state, **cfg)
    opt, sched = generator_optimizer(model.parameters(), TrainConfig(), 10)
    step = make_registration_train_step(model)
    if wrap is not None:
        step = wrap(step)
    st = init_train_state(opt, sched)
    for _ in range(steps):
        st, metrics, _ = step(st, tensors(batch))
    return model, float(metrics["point_loss"])


def stage_block(d=32, heads=4):
    return AttentionBlock(d, heads, 4)


def stage_fn_for(block):
    from torch.func import functional_call

    def stage_fn(p, h):
        if isinstance(h, tuple):
            s, t = h
            return functional_call(block, p, (s, t, t)), t
        return functional_call(block, p, (h, h, h))

    return stage_fn


def sequential(stage_fn, stage_params, x):
    """Each microbatch through every stage in turn."""
    for p in stage_params:
        if isinstance(x, tuple):
            outs = [stage_fn(p, (s, t)) for s, t in zip(*x)]
            x = tuple(torch.stack([o[i] for o in outs]) for i in range(2))
        else:
            x = torch.stack([stage_fn(p, h) for h in x])
    return x


def pp_loss(preds, targets):
    return torch.mean((preds - targets) ** 2)


def moe_params(tree):
    from scream_tpu_torch.parallel import moe_params_from_numpy

    return moe_params_from_numpy(tree)


def run_all(mesh, in_path, out_path):
    """Every library mode on this 4-rank world; rank 0 saves the results."""
    from scream_tpu_torch.parallel import (data_parallel_step, data_seq_parallel_step,
                                           expert_parallel_moe_ffn, make_expert_mesh,
                                           make_mesh, pipeline_parallel_apply,
                                           pipeline_parallel_grads, pipeline_train_step,
                                           points_parallel, sequence_parallel_linear_attention,
                                           shard_points, stack_stage_params,
                                           tensor_parallel_apply, tensor_parallel_step)
    from scream_tpu_torch.parallel import dryrun
    from scream_tpu_torch.parallel.mesh import all_gather_cat
    from scream_tpu_torch.parallel.pp_flagship import (flagship_pp_forward,
                                                       make_pp_registration_train_step)
    from scream_tpu_torch.parallel.tp import full_state_dict

    inp = torch.load(in_path, weights_only=False)
    out = {}
    # DP over the 4 ranks.
    dp = make_mesh(n_data=4)
    m, loss = step_result(inp["state"], inp["batch"], lambda s: data_parallel_step(s, dp))
    out["dp"] = dict(params=np_state(m), point_loss=loss, grads=np_grads(m))

    # The partitioning contract: on a data-only mesh each rank runs the
    # fused block on its rows with no collective.
    calls = {"n": 0}
    real = {name: getattr(torch.distributed, name)
            for name in ("all_reduce", "all_gather", "broadcast", "send", "recv", "isend")}

    def counting(fn):
        def call(*a, **kw):
            calls["n"] += 1
            return fn(*a, **kw)
        return call

    blk = AttentionBlock(128, 8, 4, fused_attn=True)
    blk.load_state_dict({k: torch.as_tensor(v) for k, v in inp["block128"].items()})
    xq, qm = torch.as_tensor(inp["block_x"]), torch.as_tensor(inp["block_m"])
    rows = slice(dp.coord("data") * 2, dp.coord("data") * 2 + 2)
    for name, fn in real.items():
        setattr(torch.distributed, name, counting(fn))
    try:
        with torch.no_grad():
            local = blk(xq[rows], xq[rows], xq[rows], qm[rows], qm[rows])
    finally:
        for name, fn in real.items():
            setattr(torch.distributed, name, fn)
    out["partition_collectives"] = calls["n"]
    out["partition_fused"] = all_gather_cat(local, dp.group("data")).numpy()

    # SP: attention with the sequence over 4 ranks, with and without masks.
    sp = make_mesh(n_data=1, n_seq=4)
    a = {k: torch.as_tensor(v) for k, v in inp["sp"].items()}
    got = sequence_parallel_linear_attention(
        sp, *(shard_points(a[k], sp) for k in ("q", "k", "v", "qm", "km")))
    out["sp_attention"] = all_gather_cat(got, sp.group("seq"), 1).numpy()
    got = sequence_parallel_linear_attention(sp, *(shard_points(a["q2"], sp),) * 3)
    out["sp_attention_nomask"] = all_gather_cat(got, sp.group("seq"), 1).numpy()
    # ...the transformer forward with the points over the 4 ranks...
    f = {k: torch.as_tensor(v) for k, v in inp["sp_fwd"].items()}
    model = model_from(inp["sp_fwd_state"])
    with torch.no_grad(), points_parallel(model, sp):
        got = model(*(shard_points(f[k], sp) for k in ("src", "tgt", "m", "m")), f["center"])
    out["sp_forward"] = all_gather_cat(got, sp.group("seq"), 1).numpy()
    # ...and a data x seq step.
    ds = make_mesh(n_data=2, n_seq=2)
    m, loss = step_result(inp["state"], inp["batch_sp"],
                          lambda s: data_seq_parallel_step(s, ds))
    out["sp_step"] = dict(params=np_state(m), point_loss=loss, grads=np_grads(m))

    # TP: data x model forward and step.
    tp = make_mesh(n_data=2, n_model=2)
    b = tensors(inp["batch"])
    args = (b["src"], b["tgt"], b["src_mask"], b["tgt_mask"], b["trans"].transpose(-1, -2))
    with torch.no_grad():
        out["tp_forward"] = tensor_parallel_apply(model_from(inp["state"]), tp)(*args).numpy()
    m, loss = step_result(inp["state"], inp["batch"], lambda s: tensor_parallel_step(s, tp))
    out["tp_step"] = dict(params=np_state(full_state_dict(m, tp)), point_loss=loss)
    out["tp_local_q"] = tuple(m.trunk.stem_0.q_proj.kernel.shape)

    # PP: homogeneous stacks over pipe=4 (data 1) and pipe=2 (data 2).
    block = stage_block()
    fn = stage_fn_for(block)
    for key, n_stages in (("pp4", 4), ("pp2", 2)):
        mesh = make_mesh(n_data=4 // n_stages, n_pipe=n_stages)
        stacked = stack_stage_params([{k: torch.as_tensor(v) for k, v in p.items()}
                                      for p in inp[f"{key}_stages"]])
        x = torch.as_tensor(inp[f"{key}_x"])
        out[f"{key}_apply"] = pipeline_parallel_apply(fn, stacked, x, mesh).numpy()
        if key == "pp4":
            s, t = torch.as_tensor(inp["pp4_src"]), torch.as_tensor(inp["pp4_tgt"])
            res = pipeline_parallel_apply(fn, stacked, (s, t), mesh)
            out["pp4_tree"] = tuple(r.numpy() for r in res)
            tgt = torch.as_tensor(inp["pp4_target"])
            for remat in (False, True):
                loss, grads = pipeline_parallel_grads(fn, pp_loss, stacked, x, tgt, mesh,
                                                      remat=remat)
                grads = {k: all_gather_cat(v[None], mesh.group("pipe")).numpy()
                         for k, v in grads.items()}
                out[f"pp4_grads_{remat}"] = dict(loss=float(loss), grads=grads)
            params = {k: v[mesh.coord("pipe")].clone().requires_grad_()
                      for k, v in stacked.items()}
            opt = torch.optim.Adam(params.values(), lr=1e-3, eps=1e-8)
            loss = pipeline_train_step(fn, pp_loss, opt, params, x, tgt, mesh)
            out["pp4_train"] = dict(loss=float(loss), params={
                k: all_gather_cat(v.detach()[None], mesh.group("pipe")).numpy()
                for k, v in params.items()})

    # The flagship pipeline: forward on pipe 2 and 4 and on data 2 x pipe 2,
    # and the train step on data 2 x pipe 2.
    fl = {k: torch.as_tensor(v) for k, v in inp["flag"].items()}
    fargs = (fl["src"], fl["tgt"], fl["sm"], fl["tm"], fl["ctr"])
    flag_model = model_from(inp["flag_state"], **inp["flag_cfg"])
    for n_stages in (2, 4):
        mesh = make_mesh(n_data=4 // n_stages, n_pipe=n_stages)
        out[f"flag_forward_{n_stages}"] = flagship_pp_forward(
            flag_model, *fargs, mesh, n_micro=4).numpy()
    mesh = make_mesh(n_data=2, n_pipe=2)
    out["flag_forward_data"] = flagship_pp_forward(flag_model, *fargs, mesh, n_micro=2,
                                                   data_axis="data").numpy()
    m, loss = step_result(inp["flag_state"], inp["flag_batch"],
                          lambda s: data_parallel_step(
                              make_pp_registration_train_step(s.model, mesh, n_micro=2),
                              mesh), **inp["flag_cfg"])
    out["flag_step"] = dict(params=np_state(m), point_loss=loss, grads=np_grads(m))

    # EP over the 4 ranks, 8 and 4 experts, with gradients.
    ep = make_expert_mesh(4)
    x, tgt = torch.as_tensor(inp["ep_x"]), torch.as_tensor(inp["ep_tgt"])
    for key in ("ep8", "ep4"):
        params = {k: v.requires_grad_() for k, v in moe_params(inp[key]).items()}
        y = expert_parallel_moe_ffn(ep, params, x)
        torch.mean((y - tgt) ** 2).backward()
        out[key] = dict(y=y.detach().numpy(),
                        grads={k: v.grad.numpy() for k, v in params.items()})

    # The dryrun's modes on this world.
    out["dryrun"] = dryrun.run_modes(make_mesh(n_data=4))
    if torch.distributed.get_rank() == 0:
        torch.save(out, out_path)


# ---------------------------------------------------------------------------
# Trainers.


def tiny_trainer(state, n_pairs=16, batch_size=8, mesh=None, use_gan=False, disc_state=None,
                 epochs=3):
    from scream_tpu_torch.data import PairLoader, SyntheticPairDataset
    from scream_tpu_torch.train import RegistrationTrainer

    n = 48 if use_gan else 64
    ds = SyntheticPairDataset(length=n_pairs, n_src=n, n_tgt=n, seed=5 if use_gan else 11)
    mk = lambda: PairLoader(ds, batch_size=batch_size, src_capacity=n, shuffle=False,
                            num_workers=0)
    tr = RegistrationTrainer(
        mk(), mk(), model_cfg=ModelConfig(**TINY),
        train_cfg=TrainConfig(batch_size=batch_size, epochs=epochs, use_gan=use_gan,
                              log_every=1000),
        eval_cfg=EvalConfig(icp_max_iter=3),
        render_cfg=RenderConfig(rho=6.0, width=32, multi_view=False),
        mesh=mesh, device="cpu")
    tr.init()
    tr.load_weights({k: torch.as_tensor(v) for k, v in state.items()})
    if disc_state is not None:
        tr.disc_state.disc.load_state_dict({k: torch.as_tensor(v)
                                            for k, v in disc_state.items()})
    return tr


def trainer_result(tr):
    """One epoch and the validation: the whole model's weights, the
    discriminator's state, the epoch's and the validation's metrics."""
    train = tr.train_epoch(1)
    val = tr.evaluate()
    out = dict(params=np_state(tr._full_state_dict()), train=train, val=val)
    if tr.use_gan:
        out["disc"] = np_state(tr.disc_state.disc)
    return out


def run_trainers(mesh, in_path, out_path):
    """The trainer cases on this 4-rank world; rank 0 saves the results."""
    from scream_tpu_torch.parallel import make_mesh

    inp = torch.load(in_path, weights_only=False)
    out = {}
    out["dp"] = trainer_result(tiny_trainer(inp["state"], mesh=make_mesh(n_data=4)))
    tp = make_mesh(n_data=2, n_model=2)
    out["tp"] = trainer_result(tiny_trainer(inp["state"], mesh=tp))
    out["partial"] = trainer_result(tiny_trainer(inp["state"], n_pairs=22,
                                                 mesh=make_mesh(n_data=4)))
    out["gan"] = trainer_result(tiny_trainer(inp["gan_state"], n_pairs=8, use_gan=True,
                                             disc_state=inp["disc_state"],
                                             mesh=make_mesh(n_data=4)))
    sp = tiny_trainer(inp["state"], mesh=make_mesh(n_data=2, n_seq=2))
    out["sp"] = dict(fused=(sp.model_cfg.fused_attention, sp.model_cfg.fused_block_tail),
                     train=sp.train_epoch(1))
    pp = tiny_trainer(inp["state"], mesh=make_mesh(n_data=2, n_pipe=2))
    out["pp"] = trainer_result(pp)
    if torch.distributed.get_rank() == 0:
        torch.save(out, out_path)

