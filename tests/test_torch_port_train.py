"""The port's GAN training step against the JAX package on the CPU, in fp32:
the PatchGAN discriminator, the hinge losses, the optimizers and their LR
schedule, ``in_forward_transform``, the shipped discriminator's converted
weights, and one generator step (GAN off and on) and one discriminator step
from one init on one batch.

Inputs come from seeded numpy; weights reach both packages through the
converters (``params_from_jax``, ``discriminator_from_jax``). The JAX steps
run through the package's own step builders, with an optax stage chained in
front of Adam that keeps the gradients in the optimizer state, so the
gradients of the very step that updated the parameters are compared. Bars,
each max |port - jax| over max |jax| unless stated:

* discriminator logits and BatchNorm running averages: 1e-5 (fp32
  convolutions summed in another order), 1e-4 for the shipped trained
  weights on 64 x 64 renders;
* one Adam update: 1 ulp (the bias corrections are folded in another
  order);
* losses: 1e-5; gradients: 1e-4 relative norm per parameter; parameters
  after the Adam update: 1e-6 absolute (Adam's first step moves each
  parameter by ~lr * sign(grad), lr 2e-4 / 1e-4) wherever the gradient is
  above 1e-3 of its tensor's largest, where its sign is not in doubt;
* the generator's renders enter the GAN losses: the images are held to the
  renderer's bar (``tests/test_torch_port_render.py``), and the losses that
  read them (``g_loss``, ``d_loss``) to 1e-4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scream_tpu.config import ModelConfig as JModelConfig
from scream_tpu.config import RenderConfig as JRenderConfig
from scream_tpu.config import TrainConfig as JTrainConfig
from scream_tpu.models import losses as jlosses
from scream_tpu.models.gan import PatchDiscriminator as JDisc
from scream_tpu.models.point_transformer import PointTransformer as JPT
from scream_tpu.pipeline.register import in_forward_transform as j_in_forward_transform
from scream_tpu.train import optim as joptim
from scream_tpu.train import steps as jsteps
from scream_tpu_torch.config import ModelConfig, RenderConfig, TrainConfig
from scream_tpu_torch.models import PatchDiscriminator, PointTransformer
from scream_tpu_torch.models import losses
from scream_tpu_torch.pipeline.register import in_forward_transform
from scream_tpu_torch.train import (DiscState, discriminator_optimizer,
                                    generator_optimizer, init_train_state,
                                    lr_schedule, make_disc_logit_fn,
                                    make_discriminator_step,
                                    make_registration_train_step)
from scream_tpu_torch.utils.checkpoint import load_discriminator
from scream_tpu_torch.utils.convert import discriminator_from_jax, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 32  # the discriminator needs >= 24 pixels
SPE = 10  # steps per epoch of the LR schedule
KW = dict(d_model=64, num_heads=4, self_layers=1, cross_layers=1, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def rotations(rng, b, max_angle):
    out = []
    for _ in range(b):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        a = rng.uniform(-max_angle, max_angle)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        out.append(np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K)
    return np.stack(out).astype(np.float32)


def make_batch(seed=0, B=2, n=192, m=224):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.6, 0.6, (B, n, 3)).astype(np.float32)
    rot = rotations(rng, B, 0.5)
    trans = rng.uniform(-0.2, 0.2, (B, 3, 1)).astype(np.float32)
    moved = np.einsum("bij,bnj->bni", rot, src) + trans.transpose(0, 2, 1)
    tgt = np.concatenate([moved, rng.uniform(-0.6, 0.6, (B, m - n, 3))], 1)
    tgt = (tgt + rng.normal(0, 0.01, tgt.shape)).astype(np.float32)
    sm = rng.random((B, n)) > 0.1
    tm = rng.random((B, m)) > 0.1
    return dict(src=src, tgt=tgt, src_mask=sm, tgt_mask=tm, rot=rot, trans=trans)


# An optax stage that passes the gradients on and keeps them as its state.
CAPTURE = optax.GradientTransformation(
    lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))


@pytest.fixture(scope="module")
def init():
    """One generator and one discriminator init (numpy trees), one batch."""
    batch = make_batch()
    jmodel = JPT(JModelConfig(**KW))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jmodel.init(jax.random.PRNGKey(0), jb["src"], jb["tgt"], jb["src_mask"],
                         jb["tgt_mask"], jnp.zeros((2, 1, 3)))["params"]
    dvars = JDisc(input_nc=2).init(jax.random.PRNGKey(1), jnp.zeros((1, W, W, 2)),
                                   train=False)
    return dict(batch=batch, jmodel=jmodel, params=np_tree(params),
                dvars={"params": np_tree(dvars["params"]),
                       "batch_stats": np_tree(dvars["batch_stats"])})


def port_models(init):
    model = PointTransformer(ModelConfig(**KW), device="cpu")
    model.load_state_dict(params_from_jax(init["params"]), strict=True)
    disc = PatchDiscriminator(device="cpu")
    disc.load_state_dict(discriminator_from_jax(init["dvars"]), strict=True)
    return model, disc


@pytest.fixture(scope="module")
def jax_steps(init):
    """The JAX package's generator step (GAN off and on) and discriminator
    step, each from the same init: metrics, gradients, parameters after."""
    jdisc = JDisc(input_nc=2)
    rcfg = JRenderConfig(width=W, use_pallas=False)
    jtc = JTrainConfig()
    jb = lambda: {k: jnp.asarray(v) for k, v in init["batch"].items()}
    fresh = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    out = {}
    for use_gan in (False, True):
        opt = optax.chain(CAPTURE, joptim.generator_optimizer(jtc, SPE))
        params = fresh(init["params"])
        step = jsteps.make_registration_train_step(
            init["jmodel"], opt, use_gan=use_gan,
            disc_apply=jsteps.make_disc_logit_fn(jdisc), render_cfg=rcfg)
        state, metrics, fake = step(jsteps.init_train_state(params, opt), jb(),
                                    fresh(init["dvars"]) if use_gan else None)
        out[use_gan] = dict(metrics={k: float(v) for k, v in metrics.items()},
                            grads=params_from_jax(np_tree(state.opt_state[0])),
                            params=params_from_jax(np_tree(state.params)),
                            fake=None if fake is None else np.asarray(fake))
    dopt = optax.chain(CAPTURE, joptim.discriminator_optimizer(jtc))
    dv = fresh(init["dvars"])
    dstate = jsteps.DiscState(dv, dopt.init(dv["params"]))
    dstep = jsteps.make_discriminator_step(jdisc, dopt, rcfg)
    b = jb()
    dstate, d_loss = dstep(dstate, jnp.asarray(out[True]["fake"]), b["src"], b["tgt"],
                           b["src_mask"], b["tgt_mask"], b["rot"], b["trans"])
    out["disc"] = dict(d_loss=float(d_loss),
                       state=discriminator_from_jax(np_tree(dstate.variables)),
                       grads=discriminator_from_jax({"params": np_tree(dstate.opt_state[0]),
                                                     "batch_stats": np_tree(
                                                         dstate.variables["batch_stats"])}))
    return out


def assert_step(model, before, want):
    """Gradients (1e-4 relative norm) and parameters after the update
    (1e-6 absolute where the gradient's sign is clear) against JAX's."""
    got_p = dict(model.named_parameters())
    assert set(got_p) == set(want["grads"])
    for name, p in got_p.items():
        g_want = want["grads"][name].numpy()
        assert rel_norm(p.grad.numpy(), g_want) <= 1e-4, name
        clear = np.abs(g_want) > 1e-3 * np.abs(g_want).max()
        moved = p.detach().numpy() - before[name].numpy()
        want_moved = want["params"][name].numpy() - before[name].numpy()
        assert np.abs(moved - want_moved)[clear].max() <= 1e-6, name
        assert np.abs(moved).max() > 0, name


class TestDiscriminator:
    @pytest.fixture(scope="class")
    def images(self):
        rng = np.random.default_rng(2)
        return rng.uniform(-1, 1, (12, W, W, 2)).astype(np.float32)

    def test_eval_mode_logits(self, init, images):
        want = JDisc(input_nc=2).apply(init["dvars"], jnp.asarray(images), train=False)
        _, disc = port_models(init)
        with torch.no_grad():
            got = disc(t(images), train=False)
        assert rel(got.numpy(), want) <= 1e-5

    def test_batch_stats_mode_logits_and_stats(self, init, images):
        """flax train mode with the stats mutable: the port's batch-stats
        logits and its running averages after one update (biased variance,
        momentum 0.9 in flax's convention)."""
        want, mut = JDisc(input_nc=2).apply(init["dvars"], jnp.asarray(images), train=True,
                                            mutable=["batch_stats"])
        _, disc = port_models(init)
        with torch.no_grad():
            got = disc(t(images), train=True, update_stats=True)
        assert rel(got.numpy(), want) <= 1e-5
        stats = discriminator_from_jax({"params": init["dvars"]["params"],
                                        "batch_stats": np_tree(mut["batch_stats"])})
        for name, buf in disc.named_buffers():
            assert rel(buf.numpy(), stats[name].numpy()) <= 1e-5, name

    def test_frozen_logits_store_nothing(self, init, images):
        _, disc = port_models(init)
        before = {k: v.clone() for k, v in disc.state_dict().items()}
        imgs = t(images).reshape(2, 6, W, W, 2).permute(0, 1, 4, 2, 3)
        make_disc_logit_fn()(disc, imgs)
        for k, v in disc.state_dict().items():
            assert torch.equal(v, before[k]), k

    def test_too_small_input_raises(self):
        with pytest.raises(ValueError, match="24x24"):
            PatchDiscriminator(device="cpu")(torch.zeros((1, 16, 16, 2)))


class TestLossesAndOptim:
    def test_configs_match_jax(self):
        """Every field of the port's TrainConfig and RenderConfig has the JAX
        package's default, and the KITTI GAN render override is the same."""
        import dataclasses

        from scream_tpu.config import kitti_gan_render_config as j_kitti
        from scream_tpu_torch.config import kitti_gan_render_config

        for mine, theirs in ((TrainConfig(), JTrainConfig()), (RenderConfig(), JRenderConfig()),
                             (kitti_gan_render_config(), j_kitti())):
            for f in dataclasses.fields(mine):
                assert getattr(mine, f.name) == getattr(theirs, f.name), f.name

    def test_hinge_losses(self):
        rng = np.random.default_rng(3)
        real, fake = rng.standard_normal((2, 8, 2, 2, 1)).astype(np.float32)
        assert abs(float(losses.generator_hinge_loss(t(fake)))
                   - float(jlosses.generator_hinge_loss(jnp.asarray(fake)))) <= 1e-6
        want = float(jlosses.discriminator_hinge_loss(jnp.asarray(real), jnp.asarray(fake)))
        got = float(losses.discriminator_hinge_loss(t(real), t(fake)))
        assert abs(got - want) <= 1e-6

    def test_adopt_and_adaptive_weight(self):
        for step in (0, 4, 5, 9):
            assert float(losses.adopt_weight(0.3, step, threshold=5)) == pytest.approx(
                float(jlosses.adopt_weight(0.3, step, threshold=5)))
        rng = np.random.default_rng(4)
        a = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (4,))]
        b = [rng.standard_normal(s).astype(np.float32) * 1e-3 for s in ((3, 4), (4,))]
        for mw in (1e4, 10.0):
            want = float(jlosses.calculate_adaptive_weight(
                [jnp.asarray(x) for x in a], [jnp.asarray(x) for x in b], 0.5, max_weight=mw))
            got = float(losses.calculate_adaptive_weight([t(x) for x in a], [t(x) for x in b],
                                                         0.5, max_weight=mw))
            assert got == pytest.approx(want, rel=1e-6)

    @pytest.mark.parametrize("cfg", [TrainConfig(),
                                     TrainConfig(lr_g=3.2e-4, epochs=120, decay_mode="kitti")])
    def test_lr_schedule_steps_like_optax(self, cfg):
        """The LR at b - 1, b and b + 1 of every boundary, from the schedule
        and from the optimizer the scheduler drives."""
        jcfg = JTrainConfig(lr_g=cfg.lr_g, epochs=cfg.epochs, decay_mode=cfg.decay_mode)
        bounds = [e * SPE for e in joptim.decay_epochs(cfg.decay_mode, cfg.epochs)]
        want = joptim.lr_schedule(jcfg.lr_g, joptim.decay_epochs(cfg.decay_mode, cfg.epochs),
                                  SPE, jcfg.lr_decay_gamma, jcfg.min_lr)
        mine = lr_schedule(cfg.lr_g, joptim.decay_epochs(cfg.decay_mode, cfg.epochs), SPE,
                           cfg.lr_decay_gamma, cfg.min_lr)
        probe = sorted({k for b in bounds for k in (b - 1, b, b + 1)})
        for k in probe:
            assert mine(k) == pytest.approx(float(want(k)), rel=1e-6), k
        opt, sched = generator_optimizer([torch.nn.Parameter(torch.zeros(1))], cfg, SPE)
        seen = {}
        for k in range(probe[-1] + 1):
            seen[k] = opt.param_groups[0]["lr"]  # the LR update k runs at
            opt.step()
            sched.step()
        for k in probe:
            assert seen[k] == pytest.approx(float(want(k)), rel=1e-6), k
        assert seen[probe[-1]] < seen[0]

    @pytest.mark.parametrize("which", ["generator", "discriminator"])
    def test_one_adam_update_equals_optax(self, which):
        rng = np.random.default_rng(5)
        p0 = rng.standard_normal((6, 5)).astype(np.float32)
        grads = [rng.standard_normal((6, 5)).astype(np.float32) for _ in range(2)]
        jtc, tc = JTrainConfig(), TrainConfig()
        opt = (joptim.generator_optimizer(jtc, SPE) if which == "generator"
               else joptim.discriminator_optimizer(jtc))
        jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
        p = torch.nn.Parameter(t(p0))
        topt = (generator_optimizer([p], tc, SPE)[0] if which == "generator"
                else discriminator_optimizer([p], tc))
        for g in grads:
            upd, state = opt.update(jnp.asarray(g), state, jp)
            jp = optax.apply_updates(jp, upd)
            p.grad = t(g)
            topt.step()
        # torch and optax fold the bias corrections in another order: 1 ulp.
        np.testing.assert_array_max_ulp(p.detach().numpy(), np.asarray(jp), maxulp=1)


class TestSteps:
    def test_generator_step_without_gan(self, init, jax_steps):
        model, _ = port_models(init)
        before = {k: v.detach().clone() for k, v in model.named_parameters()}
        opt, sched = generator_optimizer(model.parameters(), TrainConfig(), SPE)
        step = make_registration_train_step(model)
        tb = {k: t(v) for k, v in init["batch"].items()}
        state, metrics, fake = step(init_train_state(opt, sched), tb)
        want = jax_steps[False]
        assert fake is None and state.step == 1
        assert rel(float(metrics["point_loss"]), want["metrics"]["point_loss"]) <= 1e-5
        assert_step(model, before, want)

    def test_generator_and_discriminator_steps_with_gan(self, init, jax_steps):
        """The trainer's order: the generator step (GAN on, frozen
        discriminator in batch-stats mode), then the discriminator step on
        its fake render and the GT-aligned real one."""
        model, disc = port_models(init)
        before = {k: v.detach().clone() for k, v in model.named_parameters()}
        d_before = {k: v.detach().clone() for k, v in disc.state_dict().items()}
        opt, sched = generator_optimizer(model.parameters(), TrainConfig(), SPE)
        rcfg = RenderConfig(width=W)
        step = make_registration_train_step(model, use_gan=True,
                                            disc_apply=make_disc_logit_fn(), render_cfg=rcfg)
        tb = {k: t(v) for k, v in init["batch"].items()}
        stages = []
        state, metrics, fake = step(init_train_state(opt, sched), tb, disc, stages.append)
        want = jax_steps[True]
        assert stages == ["forward", "render", "discriminator", "backward", "optimizer"]
        assert rel(float(metrics["point_loss"]), want["metrics"]["point_loss"]) <= 1e-5
        assert rel(float(metrics["g_loss"]), want["metrics"]["g_loss"]) <= 1e-4
        assert rel(float(metrics["loss"]), want["metrics"]["loss"]) <= 1e-5
        np.testing.assert_allclose(fake.numpy(), want["fake"], atol=24.0 ** 2 * 1e-6, rtol=0)
        assert_step(model, before, want)
        # No gradient and no statistics update reached the discriminator.
        assert all(p.grad is None for p in disc.parameters())
        for k, v in disc.state_dict().items():
            assert torch.equal(v, d_before[k]), k

        # The discriminator step on the JAX step's fake images, so that both
        # score the same fakes.
        dstate = DiscState(disc, discriminator_optimizer(disc.parameters(), TrainConfig()))
        dstep = make_discriminator_step(rcfg)
        dstate, d_loss = dstep(dstate, t(want["fake"]), tb["src"], tb["tgt"],
                               tb["src_mask"], tb["tgt_mask"], tb["rot"], tb["trans"])
        dw = jax_steps["disc"]
        assert rel(float(d_loss), dw["d_loss"]) <= 1e-4
        for name, p in disc.named_parameters():
            assert rel_norm(p.grad.numpy(), dw["grads"][name].numpy()) <= 1e-4, name
        for name, v in disc.state_dict().items():
            if "running" in name:  # two updates, real first (biased variance)
                assert rel(v.numpy(), dw["state"][name].numpy()) <= 1e-5, name
            else:
                g = dw["grads"][name].numpy()
                clear = np.abs(g) > 1e-3 * np.abs(g).max()
                diff = (v.numpy() - dw["state"][name].numpy())[clear]
                assert np.abs(diff).max() <= 1e-6, name


class TestInForwardTransform:
    def test_matches_jax(self):
        b = make_batch(seed=7)
        rng = np.random.default_rng(8)
        filt = (np.einsum("bij,bnj->bni", b["rot"], b["src"])
                + b["trans"].transpose(0, 2, 1)).astype(np.float32)
        pred = (filt + rng.normal(0, 0.02, filt.shape)).astype(np.float32)
        scale = np.array([1.3, 0.8], np.float32)
        args = (b["src"], pred, filt, b["src_mask"], b["src_mask"], scale)
        want = j_in_forward_transform(*map(jnp.asarray, args))
        got = in_forward_transform(*map(t, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[:, :3, :3].numpy(), b["rot"], atol=5e-2)


class TestShippedDiscriminator:
    @pytest.fixture(scope="class")
    def shipped(self):
        import sys

        sys.path.insert(0, os.path.join(REPO, "scripts"))
        from torch_port_convert_params import convert_discriminator

        state, sidecar = convert_discriminator(os.path.join(REPO, "params", "discriminator"))
        return state, sidecar

    def test_committed_weights_are_the_orbax_tree_converted(self, shipped):
        state, sidecar = shipped
        d = os.path.join(REPO, "scream_tpu_torch", "weights", "discriminator")
        committed = torch.load(os.path.join(d, "model.pt"), weights_only=True)
        assert sorted(committed) == sorted(state)
        for k, v in state.items():
            assert committed[k].dtype == torch.float32
            assert torch.equal(committed[k], v), k
        with open(os.path.join(d, "model_config.json")) as f:
            assert json.load(f) == sidecar

    def test_logits_on_jax_renders_match_jax(self, shipped):
        """JAX renders GT-aligned sources and the target (3DMatch views,
        64 x 64); the shipped discriminator scores them in both packages, in
        batch-stats and in eval mode."""
        from scream_tpu.models.gan import images_to_nhwc as j_nhwc
        from scream_tpu.ops.render import render_depth_images as j_render
        from scream_tpu.utils.checkpoint import load_params

        b = make_batch(seed=9, n=256, m=256)
        real = np.einsum("bij,bnj->bni", b["rot"], b["src"]) + b["trans"].transpose(0, 2, 1)
        imgs = j_nhwc(j_render(jnp.asarray(real), jnp.asarray(b["tgt"]),
                               jnp.asarray(b["src_mask"]), jnp.asarray(b["tgt_mask"]),
                               use_pallas=False))
        jdisc = JDisc(input_nc=2)
        tmpl = jdisc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 2)), train=False)
        variables = load_params(os.path.join(REPO, "params", "discriminator"),
                                {"params": tmpl["params"], "batch_stats": tmpl["batch_stats"]})
        disc = load_discriminator(os.path.join(REPO, "scream_tpu_torch", "weights",
                                               "discriminator"), device="cpu")
        x = t(np.asarray(imgs))
        for train in (True, False):
            want = (jdisc.apply(variables, imgs, train=True, mutable=["batch_stats"])[0]
                    if train else jdisc.apply(variables, imgs, train=False))
            with torch.no_grad():
                got = disc(x, train=train, update_stats=False)
            assert rel(got.numpy(), want) <= 1e-4, train
