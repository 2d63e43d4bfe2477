"""The port's parallel layer (``scream_tpu_torch/parallel``) on a gloo world of
4 CPU ranks against the port's single process and the JAX package's same
modes on its 8-device virtual CPU mesh, at the JAX tests' bars.

One world runs every case once for the module (``torch_parallel_cases.run_all``):
weights come from the JAX package's inits through ``utils/convert.py`` and
``moe_params_from_numpy``, inputs from numpy seeds. Bars (the JAX tests'):
DP step 1e-5; SP attention 1e-5, sharded-points forward 2e-4, data x seq
step 2e-5; TP forward 2e-4, step 1e-5; PP 1e-4 against the sequential
stack, grads and the Adam step 1e-5; the flagship forward bit for bit
against the port's sequential forward (the JAX forward at 1e-4 relative,
the port's forward bar), its step 1e-5; EP 1e-5 with gradients. Adam moves
a parameter by about lr * sign(gradient), so against the JAX package the
updated parameters are held where the gradient's sign is clear, as the
port's step tests hold them; against the port's single process, everywhere.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import torch_parallel_cases as cases
from scream_tpu.config import ModelConfig as JModelConfig
from scream_tpu.config import TrainConfig as JTrainConfig
from scream_tpu.data import PairLoader as JPairLoader
from scream_tpu.data import SyntheticPairDataset as JSynthetic
from scream_tpu.models.attention import AttentionBlock as JAttentionBlock
from scream_tpu.models.attention import linear_attention as j_linear_attention
from scream_tpu.models.point_transformer import PointTransformer as JPointTransformer
from scream_tpu import parallel as jpar
from scream_tpu.parallel.pp_flagship import (flagship_pp_forward as j_flagship_forward,
                                             make_pp_registration_train_step as j_pp_step)
from scream_tpu.train import optim as joptim
from scream_tpu.train.steps import init_train_state as j_init_state
from scream_tpu.train.steps import make_registration_train_step as j_make_step
from scream_tpu_torch.models import AttentionBlock, linear_attention
from scream_tpu_torch.parallel import (is_data_only, launch, make_mesh, moe_ffn_reference,
                                       parse_mesh_spec, tensor_parallel_specs)
from scream_tpu_torch.utils.convert import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def jax_batch(length, n, cap, seed):
    ds = JSynthetic(length=length, n_src=n, n_tgt=n, seed=seed)
    loader = JPairLoader(ds, batch_size=length, src_capacity=cap, tgt_capacity=cap,
                         num_workers=0)
    return {k: np.asarray(v) for k, v in next(iter(loader)).items()}


def jax_init(model, batch):
    return model.init(jax.random.PRNGKey(0), batch["src"], batch["tgt"], batch["src_mask"],
                      batch["tgt_mask"], np.swapaxes(batch["trans"], -1, -2))["params"]


def jax_step(params, batch, wrap=None):
    """The JAX package's generator step, optionally on a mesh."""
    model = JPointTransformer(JModelConfig(**cases.TINY))
    opt = joptim.generator_optimizer(JTrainConfig(), steps_per_epoch=10)
    step = j_make_step(model, opt)
    if wrap is not None:
        step = wrap(step)
    state = j_init_state(jax.tree_util.tree_map(jnp.array, params), opt)
    state, metrics, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return params_from_jax(np_tree(state.params)), float(metrics["point_loss"])


def block_params(d, heads, seed, x):
    blk = JAttentionBlock(d_model=d, num_heads=heads, ffn_mult=4, dtype=jnp.float32)
    return blk, blk.init(jax.random.PRNGKey(seed), x, x, x)["params"]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    batch = jax_batch(8, 48, 64, 3)
    model = JPointTransformer(JModelConfig(**cases.TINY))
    params = jax_init(model, batch)
    inp = dict(batch=batch, state=params_from_jax(np_tree(params)), jparams=params,
               batch_sp=jax_batch(4, 64, 64, 5))
    x128 = rng.standard_normal((8, 64, 128)).astype(np.float32)
    _, p128 = block_params(128, 8, 7, jnp.asarray(x128))
    inp.update(block128=params_from_jax(np_tree(p128)), block_x=x128,
               block_m=rng.random((8, 64)) > 0.2)
    inp["sp"] = dict(q=rng.standard_normal((2, 64, 4, 8)).astype(np.float32),
                     k=rng.standard_normal((2, 64, 4, 8)).astype(np.float32),
                     v=rng.standard_normal((2, 64, 4, 8)).astype(np.float32),
                     qm=rng.random((2, 64)) > 0.2, km=rng.random((2, 64)) > 0.2,
                     q2=rng.standard_normal((1, 32, 2, 8)).astype(np.float32))
    src = rng.standard_normal((1, 128, 3)).astype(np.float32)
    fwd = dict(src=src, tgt=rng.standard_normal((1, 128, 3)).astype(np.float32),
               m=np.ones((1, 128), bool), center=np.zeros((1, 1, 3), np.float32))
    inp["sp_fwd"] = fwd
    inp["sp_fwd_params"] = jax_init(model, dict(src=fwd["src"], tgt=fwd["tgt"],
                                                src_mask=fwd["m"], tgt_mask=fwd["m"],
                                                trans=np.zeros((1, 3, 1), np.float32)))
    inp["sp_fwd_state"] = params_from_jax(np_tree(inp["sp_fwd_params"]))
    x0 = jnp.zeros((2, 16, 32), jnp.float32)
    for key, n_stages, n_micro in (("pp4", 4, 8), ("pp2", 2, 3)):
        blk = JAttentionBlock(32, 4, dtype=jnp.float32)
        stages = [blk.init(jax.random.PRNGKey(i), x0, x0, x0)["params"]
                  for i in range(n_stages)]
        inp[f"{key}_jstages"] = stages
        inp[f"{key}_stages"] = [params_from_jax(np_tree(p)) for p in stages]
        inp[f"{key}_x"] = rng.standard_normal((n_micro, 2, 16, 32)).astype(np.float32)
    inp["pp4_src"] = rng.standard_normal((6, 1, 16, 32)).astype(np.float32)
    inp["pp4_tgt"] = rng.standard_normal((6, 1, 16, 32)).astype(np.float32)
    inp["pp4_target"] = rng.standard_normal((8, 2, 16, 32)).astype(np.float32)
    # The flagship: d 128 (8 heads), 1 + 1 layers (3 slots: 4 stages pad one
    # no-op slot), B 8, 64 and 96 points.
    fcfg = dict(d_model=128, num_heads=8, self_layers=1, cross_layers=1)
    B, N, M = 8, 64, 96
    fl = dict(src=rng.standard_normal((B, N, 3)).astype(np.float32),
              tgt=rng.standard_normal((B, M, 3)).astype(np.float32),
              sm=rng.random((B, N)) > 0.1, tm=rng.random((B, M)) > 0.1,
              ctr=rng.standard_normal((B, 1, 3)).astype(np.float32))
    jflag = JPointTransformer(JModelConfig(**{**cases.TINY, **fcfg}))
    inp["flag_jparams"] = jflag.init(jax.random.PRNGKey(0), fl["src"], fl["tgt"], fl["sm"],
                                     fl["tm"], fl["ctr"])["params"]
    inp.update(flag=fl, flag_cfg=fcfg, flag_state=params_from_jax(np_tree(inp["flag_jparams"])))
    inp["flag_batch"] = dict(src=fl["src"], tgt=fl["tgt"], src_mask=fl["sm"], tgt_mask=fl["tm"],
                             rot=np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy(),
                             trans=(rng.standard_normal((B, 3, 1)) * 0.1).astype(np.float32))
    for key, e in (("ep8", 8), ("ep4", 4)):
        inp[key] = np_tree(jpar.init_moe_ffn_params(jax.random.PRNGKey(e), 16, 32, e))
    inp["ep_x"] = rng.standard_normal((2, 24, 16)).astype(np.float32)
    inp["ep_tgt"] = rng.standard_normal((2, 24, 16)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """The 4-rank gloo world's results for every case (one launch)."""
    d = tmp_path_factory.mktemp("parallel")
    keep = {k: v for k, v in inputs.items() if not k.startswith(("j", "flag_j", "sp_fwd_p",
                                                                   "pp4_j", "pp2_j"))}
    torch.save(keep, d / "in.pt")
    launch(cases.run_all, {"data": 4}, "cpu", args=(str(d / "in.pt"), str(d / "out.pt")))
    return torch.load(d / "out.pt", weights_only=False)


def assert_params(got, want, atol, grads=None):
    """Every parameter within ``atol``; with ``grads`` (the port's
    single-process gradients) only where the gradient's sign is clear
    (above 1e-3 of its tensor's largest), as the port's step tests hold
    updates against the JAX package's."""
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if grads is not None:
            a = np.abs(grads[k])
            keep = a > 1e-3 * a.max()
            g, w = g[keep], w[keep]
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=k)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


class TestMeshSpec:
    """``parse_mesh_spec`` accepts and refuses what the JAX package's does
    (``tests/test_parallel_trainer.py``, ``test_parallel.py``)."""

    def test_parse(self):
        m = parse_mesh_spec("data=4,seq=2")
        assert m.shape == {"data": 4, "seq": 2}
        assert parse_mesh_spec("auto", n_ranks=8).shape["data"] == 8
        assert parse_mesh_spec("all", n_ranks=8).shape["data"] == 8
        assert parse_mesh_spec("seq=2", n_ranks=8).shape["data"] == 4
        for spec in ("data=4,seq=2", "data=2,model=2", "data=2,pipe=4", "seq=2", "auto"):
            j = jpar.parse_mesh_spec(spec)
            assert parse_mesh_spec(spec, n_ranks=8).shape == dict(j.shape), spec

    def test_parse_model_and_pipe_axes(self):
        assert parse_mesh_spec("data=2,model=2").shape == {"data": 2, "seq": 1, "model": 2}
        m = parse_mesh_spec("data=2,pipe=4")
        assert m.axis_names == ("data", "pipe") and m.shape["pipe"] == 4

    @pytest.mark.parametrize("spec,match", [
        ("8", "axis=N"), ("data=4,expert=2", "unknown mesh axes"),
        ("data=2,seq=2,model=2", "model= with"), ("seq=2,pipe=4", "pipe"),
        ("data=5,seq=2", "needs 10 devices"), ("data=4,seq=0", "axes must be >= 1"),
        ("data=-2", "axes must be >= 1")])
    def test_refusals(self, spec, match):
        with pytest.raises(ValueError, match=match):
            jpar.parse_mesh_spec(spec)
        with pytest.raises(ValueError, match=match):
            parse_mesh_spec(spec, n_ranks=8)

    def test_unbound_mesh_says_so(self):
        m = make_mesh(n_data=2)
        assert not m.bound
        with pytest.raises(RuntimeError, match="not bound"):
            m.group("data")

    def test_binding_needs_a_world(self):
        with pytest.raises(RuntimeError, match="running torch.distributed world"):
            make_mesh(n_data=3).bind()

    def test_failing_rank_fails_the_launch(self):
        """A rank that fails makes the launch raise: nothing runs on in a
        single process instead."""
        with pytest.raises(Exception, match="rank 1 fails"):
            launch(cases.fail_on_rank1, {"data": 2}, "cpu")


class TestPartitioningContract:
    """``ops/partitioning.py`` has no counterpart: on a data-only mesh each
    rank runs the fused kernels on its rows with no collective."""

    def test_data_only_meshes(self):
        assert is_data_only(make_mesh(n_data=8))
        assert not is_data_only(make_mesh(n_data=4, n_seq=2))
        assert not is_data_only(make_mesh(n_data=2, n_model=2))
        assert not is_data_only(make_mesh(n_data=2, n_pipe=2))
        for spec in ("data=8", "data=4,seq=2", "data=2,model=2"):
            assert is_data_only(parse_mesh_spec(spec, n_ranks=8)) == \
                jpar.is_data_only(jpar.parse_mesh_spec(spec)), spec

    def test_fused_block_per_rank_without_collectives(self, world, inputs):
        assert world["partition_collectives"] == 0
        blk = AttentionBlock(128, 8, 4, fused_attn=True)
        blk.load_state_dict({k: torch.as_tensor(v) for k, v in inputs["block128"].items()})
        x, m = torch.as_tensor(inputs["block_x"]), torch.as_tensor(inputs["block_m"])
        with torch.no_grad():
            want = blk(x, x, x, m, m).numpy()
        # The JAX test's bar; on the CPU the kernels' plain versions are
        # batched products whose last bits may depend on the row count.
        np.testing.assert_allclose(world["partition_fused"], want, atol=1e-5, rtol=0)

    def test_fusion_rule(self):
        from scream_tpu_torch.config import ModelConfig
        from scream_tpu_torch.train.trainer import disable_unpartitionable_fusion

        cfg = ModelConfig()
        assert disable_unpartitionable_fusion(cfg, make_mesh(n_data=4)) is cfg
        for mesh in (make_mesh(n_data=2, n_seq=2), make_mesh(n_data=2, n_model=2),
                     make_mesh(n_data=2, n_pipe=2)):
            off = disable_unpartitionable_fusion(cfg, mesh)
            assert off.fused_attention is False and off.fused_block_tail is False


class TestDataParallel:
    def test_step_matches_single_and_jax(self, world, inputs):
        single, loss = cases.step_result(inputs["state"], inputs["batch"])
        got = world["dp"]
        assert got["point_loss"] == pytest.approx(loss, rel=1e-5)
        assert_params(got["params"], cases.np_state(single), 1e-5)
        want, jloss = jax_step(inputs["jparams"], inputs["batch"],
                               lambda s: jpar.data_parallel_step(s, jpar.make_mesh()))
        assert got["point_loss"] == pytest.approx(jloss, rel=1e-5)
        assert_params(got["params"], want, 1e-5, grads=cases.np_grads(single))


class TestSequenceParallel:
    def test_attention(self, world, inputs):
        a = inputs["sp"]
        t = {k: torch.as_tensor(v) for k, v in a.items()}
        want = linear_attention(t["q"], t["k"], t["v"], t["qm"], t["km"]).numpy()
        np.testing.assert_allclose(world["sp_attention"], want, atol=1e-5)
        mesh = jpar.make_mesh(n_data=1, n_seq=8)
        j = jpar.sequence_parallel_linear_attention(
            mesh, *(jnp.asarray(a[k]) for k in ("q", "k", "v", "qm", "km")))
        np.testing.assert_allclose(world["sp_attention"], np.asarray(j), atol=1e-5)
        q2 = jnp.asarray(a["q2"])
        np.testing.assert_allclose(world["sp_attention_nomask"],
                                   np.asarray(j_linear_attention(q2, q2, q2)), atol=1e-5)
        t2 = torch.as_tensor(a["q2"])
        np.testing.assert_allclose(world["sp_attention_nomask"],
                                   linear_attention(t2, t2, t2).numpy(), atol=1e-5)

    def test_forward_with_sharded_points(self, world, inputs):
        f = inputs["sp_fwd"]
        model = cases.model_from(inputs["sp_fwd_state"])
        t = {k: torch.as_tensor(v) for k, v in f.items()}
        with torch.no_grad():
            want = model(t["src"], t["tgt"], t["m"], t["m"], t["center"]).numpy()
        np.testing.assert_allclose(world["sp_forward"], want, atol=2e-4)
        from jax.sharding import NamedSharding, PartitionSpec as P

        jm = JPointTransformer(JModelConfig(**cases.TINY))
        mesh = jpar.make_mesh(n_data=1, n_seq=8)
        fwd = jax.jit(lambda p, s, tg, m: jm.apply({"params": p}, s, tg, m, m, f["center"]))
        j = fwd(jax.device_put(inputs["sp_fwd_params"], NamedSharding(mesh, P())),
                jax.device_put(f["src"], NamedSharding(mesh, P(None, "seq", None))),
                jax.device_put(f["tgt"], NamedSharding(mesh, P(None, "seq", None))),
                jax.device_put(f["m"], NamedSharding(mesh, P(None, "seq"))))
        np.testing.assert_allclose(world["sp_forward"], np.asarray(j), atol=2e-4)

    def test_data_seq_step(self, world, inputs):
        got = world["sp_step"]
        single, loss = cases.step_result(inputs["state"], inputs["batch_sp"])
        assert got["point_loss"] == pytest.approx(loss, rel=1e-5)
        assert_params(got["params"], cases.np_state(single), 2e-5)
        want, jloss = jax_step(inputs["jparams"], inputs["batch_sp"],
                               lambda s: jpar.data_seq_parallel_step(
                                   s, jpar.make_mesh(n_data=4, n_seq=2)))
        assert got["point_loss"] == pytest.approx(jloss, rel=1e-5)
        assert_params(got["params"], want, 2e-5, grads=cases.np_grads(single))


class TestTensorParallel:
    def test_specs_name_the_jax_parameters(self, inputs):
        jspecs = jpar.tensor_parallel_specs(inputs["jparams"])
        flat = {".".join(p.key for p in path if hasattr(p, "key")): tuple(spec)
                for path, spec in jax.tree_util.tree_flatten_with_path(
                    jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
        specs = tensor_parallel_specs(cases.model_from(inputs["state"]))
        assert specs == flat
        assert sum(s == (None, "model") for s in specs.values()) == 12
        assert sum(s == ("model", None) for s in specs.values()) == 6

    def test_forward(self, world, inputs):
        b = cases.tensors(inputs["batch"])
        args = (b["src"], b["tgt"], b["src_mask"], b["tgt_mask"],
                b["trans"].transpose(-1, -2))
        with torch.no_grad():
            want = cases.model_from(inputs["state"])(*args).numpy()
        np.testing.assert_allclose(world["tp_forward"], want, atol=2e-4)
        jm = JPointTransformer(JModelConfig(**cases.TINY))
        fwd = jpar.tensor_parallel_apply(
            lambda p, *a: jm.apply({"params": p}, *a),
            jpar.make_mesh(n_data=2, n_seq=1, n_model=4), inputs["jparams"])
        j = fwd(*(np.asarray(a) for a in args))
        np.testing.assert_allclose(world["tp_forward"], np.asarray(j), atol=2e-4)

    def test_step_and_shards(self, world, inputs):
        assert world["tp_local_q"] == (32, 16)  # the rank's half of the columns
        got = world["tp_step"]
        single, loss = cases.step_result(inputs["state"], inputs["batch"])
        assert got["point_loss"] == pytest.approx(loss, rel=1e-5)
        assert_params(got["params"], cases.np_state(single), 1e-5)
        want, jloss = jax_step(inputs["jparams"], inputs["batch"],
                               lambda s: jpar.tensor_parallel_step(
                                   s, jpar.make_mesh(n_data=2, n_seq=1, n_model=4)))
        assert got["point_loss"] == pytest.approx(jloss, rel=1e-5)
        assert_params(got["params"], want, 1e-5, grads=cases.np_grads(single))

    def test_refuses_heads_not_dividing(self):
        from scream_tpu_torch.parallel import shard_params_tensor_parallel

        class Axis:
            shape = {"data": 1, "seq": 1, "model": 3}

            def axis_size(self, a):
                return self.shape.get(a, 1)

            def coord(self, a):
                return 0

            def group(self, a=None):
                return None

        with pytest.raises(ValueError, match="num_heads"):
            shard_params_tensor_parallel(cases.model_from(None), Axis())


class TestPipelineParallel:
    def _jstage(self):
        blk = JAttentionBlock(32, 4, dtype=jnp.float32)
        return blk, lambda p, h: blk.apply({"params": p}, h, h, h)

    @pytest.mark.parametrize("key", ["pp4", "pp2"])
    def test_matches_sequential(self, world, inputs, key):
        fn = cases.stage_fn_for(cases.stage_block())
        stages = [{k: torch.as_tensor(v) for k, v in p.items()} for p in inputs[f"{key}_stages"]]
        with torch.no_grad():
            want = cases.sequential(fn, stages, torch.as_tensor(inputs[f"{key}_x"])).numpy()
        np.testing.assert_allclose(world[f"{key}_apply"], want, atol=1e-4)
        _, jfn = self._jstage()
        n = len(stages)
        j = jpar.pipeline_parallel_apply(jfn, jpar.stack_stage_params(inputs[f"{key}_jstages"]),
                                         jnp.asarray(inputs[f"{key}_x"]),
                                         jpar.make_pipeline_mesh(n))
        np.testing.assert_allclose(world[f"{key}_apply"], np.asarray(j), atol=1e-4)

    def test_pytree_state(self, world, inputs):
        fn = cases.stage_fn_for(cases.stage_block())
        stages = [{k: torch.as_tensor(v) for k, v in p.items()} for p in inputs["pp4_stages"]]
        with torch.no_grad():
            want = cases.sequential(fn, stages, (torch.as_tensor(inputs["pp4_src"]),
                                                 torch.as_tensor(inputs["pp4_tgt"])))
        for g, w in zip(world["pp4_tree"], want):
            np.testing.assert_allclose(g, w.numpy(), atol=1e-4)

    @pytest.fixture(scope="class")
    def jax_grads(self, inputs):
        """The JAX package's pipelined loss and gradients (one trace), and
        its Adam step from them (optax's update, as pipeline_train_step)."""
        _, jfn = self._jstage()
        p = jpar.stack_stage_params(inputs["pp4_jstages"])
        loss, grads = jpar.pipeline_parallel_grads(
            jfn, lambda a, t: jnp.mean((a - t) ** 2), p, jnp.asarray(inputs["pp4_x"]),
            jnp.asarray(inputs["pp4_target"]), jpar.make_pipeline_mesh(4))
        opt = optax.adam(1e-3)
        updates, _ = opt.update(grads, opt.init(p), p)
        return float(loss), params_from_jax(np_tree(grads)), \
            params_from_jax(np_tree(optax.apply_updates(p, updates)))

    def _sequential_grads(self, inputs):
        fn = cases.stage_fn_for(cases.stage_block())
        leaves = {k: torch.stack([torch.as_tensor(p[k]) for p in inputs["pp4_stages"]])
                  .requires_grad_() for k in inputs["pp4_stages"][0]}
        x, tgt = torch.as_tensor(inputs["pp4_x"]), torch.as_tensor(inputs["pp4_target"])
        preds = cases.sequential(fn, [{k: v[s] for k, v in leaves.items()} for s in range(4)], x)
        loss = cases.pp_loss(preds, tgt)
        loss.backward()
        return float(loss), leaves

    @pytest.mark.parametrize("remat", [False, True])
    def test_grads(self, world, inputs, jax_grads, remat):
        loss, leaves = self._sequential_grads(inputs)
        got = world[f"pp4_grads_{remat}"]
        assert got["loss"] == pytest.approx(loss, rel=1e-6)
        for k, v in leaves.items():
            np.testing.assert_allclose(got["grads"][k], v.grad.numpy(), atol=1e-5, err_msg=k)
        jl, jg, _ = jax_grads
        assert got["loss"] == pytest.approx(jl, rel=1e-6)
        for k, v in jg.items():
            np.testing.assert_allclose(got["grads"][k], v.numpy(), atol=1e-5, err_msg=k)

    def test_train_step(self, world, inputs, jax_grads):
        loss, leaves = self._sequential_grads(inputs)
        torch.optim.Adam(leaves.values(), lr=1e-3, eps=1e-8).step()
        got = world["pp4_train"]
        assert got["loss"] == pytest.approx(loss, rel=1e-6)
        for k, v in leaves.items():
            np.testing.assert_allclose(got["params"][k], v.detach().numpy(), atol=1e-5,
                                       err_msg=k)
        jl, _, jp = jax_grads
        assert got["loss"] == pytest.approx(jl, rel=1e-6)
        for k, v in jp.items():
            np.testing.assert_allclose(got["params"][k], v.numpy(), atol=1e-5, err_msg=k)


class TestFlagshipPipeline:
    def _forward(self, inputs):
        fl = {k: torch.as_tensor(v) for k, v in inputs["flag"].items()}
        model = cases.model_from(inputs["flag_state"], **inputs["flag_cfg"])
        with torch.no_grad():
            return model(fl["src"], fl["tgt"], fl["sm"], fl["tm"], fl["ctr"]).numpy()

    @pytest.mark.parametrize("key", ["flag_forward_2", "flag_forward_4", "flag_forward_data"])
    def test_forward_bit_exact(self, world, inputs, key):
        """2 stages take 2 + 1 of the 3 slots; 4 pad with a no-op stage;
        data 2 x pipe 2 runs a pipeline on each data rank's rows."""
        want = self._forward(inputs)
        np.testing.assert_array_equal(world[key], want)

    def test_forward_against_jax(self, world, inputs):
        fl = inputs["flag"]
        cfg = JModelConfig(**{**cases.TINY, **inputs["flag_cfg"]})
        j = j_flagship_forward(inputs["flag_jparams"], cfg, fl["src"], fl["tgt"], fl["sm"],
                               fl["tm"], fl["ctr"], jpar.make_pipeline_mesh(2), n_micro=4)
        assert rel(world["flag_forward_2"], np.asarray(j)) <= 1e-4

    def test_train_step(self, world, inputs):
        got = world["flag_step"]
        single, loss = cases.step_result(inputs["flag_state"], inputs["flag_batch"],
                                         **inputs["flag_cfg"])
        assert got["point_loss"] == pytest.approx(loss, rel=1e-6)
        assert_params(got["params"], cases.np_state(single), 1e-5)
        from jax.sharding import Mesh

        cfg = JModelConfig(**{**cases.TINY, **inputs["flag_cfg"]})
        opt = joptim.generator_optimizer(JTrainConfig(), 10)
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "pipe"))
        step = j_pp_step(cfg, opt, mesh, n_micro=2, data_axis="data")
        state = j_init_state(jax.tree_util.tree_map(jnp.array, inputs["flag_jparams"]), opt)
        state, metrics, _ = step(state, {k: jnp.asarray(v)
                                         for k, v in inputs["flag_batch"].items()})
        assert got["point_loss"] == pytest.approx(float(metrics["loss"]), rel=1e-5)
        assert_params(got["params"], params_from_jax(np_tree(state.params)), 1e-5,
                      grads=cases.np_grads(single))


class TestExpertParallel:
    @pytest.mark.parametrize("key", ["ep8", "ep4"])
    def test_matches_reference_with_grads(self, world, inputs, key):
        from scream_tpu_torch.parallel import moe_params_from_numpy

        params = {k: v.requires_grad_() for k, v in moe_params_from_numpy(inputs[key]).items()}
        x, tgt = torch.as_tensor(inputs["ep_x"]), torch.as_tensor(inputs["ep_tgt"])
        y = moe_ffn_reference(params, x)
        torch.mean((y - tgt) ** 2).backward()
        got = world[key]
        np.testing.assert_allclose(got["y"], y.detach().numpy(), atol=1e-5)
        for k, v in params.items():
            np.testing.assert_allclose(got["grads"][k], v.grad.numpy(), atol=1e-5, err_msg=k)
        jp = {k: jnp.asarray(v) for k, v in inputs[key].items()}
        mesh = jpar.make_expert_mesh(4)
        if key == "ep8":
            jy = jpar.expert_parallel_moe_ffn(mesh, jp, jnp.asarray(inputs["ep_x"]))
            np.testing.assert_allclose(got["y"], np.asarray(jy), atol=1e-5)
            return
        jy, jg = jax.value_and_grad(lambda p: jnp.mean((jpar.expert_parallel_moe_ffn(
            mesh, p, jnp.asarray(inputs["ep_x"])) - inputs["ep_tgt"]) ** 2))(jp)
        assert float(torch.mean((torch.as_tensor(got["y"]) - tgt) ** 2)) == \
            pytest.approx(float(jy), rel=1e-6)
        for k in jp:
            np.testing.assert_allclose(got["grads"][k], np.asarray(jg[k]), atol=1e-5,
                                       err_msg=k)

    def test_init_and_routing(self):
        from scream_tpu_torch.parallel import init_moe_ffn_params

        p = init_moe_ffn_params(torch.Generator().manual_seed(1), 16, 32, 4)
        assert {k: tuple(v.shape) for k, v in p.items()} == {
            "gate": (16, 4), "w_in": (4, 16, 32), "w_out": (4, 32, 16)}
        j = jpar.init_moe_ffn_params(jax.random.PRNGKey(1), 16, 32, 4)
        for k in p:  # the same distribution: one xavier-uniform bound
            assert float(p[k].abs().max()) <= float(np.abs(np.asarray(j[k])).max()) * 1.2
        x = torch.as_tensor(np.random.default_rng(1).standard_normal((4, 64, 16)),
                            dtype=torch.float32)
        top = torch.argmax(torch.softmax(x @ p["gate"], -1), -1)
        assert len(torch.unique(top)) == 4


class TestDryrun:
    def test_every_mode_within_its_bar(self, world):
        from scream_tpu_torch.parallel.dryrun import BARS

        errs = world["dryrun"]
        assert set(errs) == set(BARS)
        for k, v in errs.items():
            assert v <= BARS[k], (k, v)
