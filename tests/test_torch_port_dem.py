"""The port's ground-generation (OpenGF) slice against the JAX package on the
CPU: synthetic DEM patches, their batching and loader, the split readers
(OpenGF patches and registration pairs, on splits written here), the DEM
metrics, the ``DEMTransformer`` forward and loss, and one
``make_dem_train_step`` with and without the GAN.

Inputs come from seeded numpy; weights reach both packages through the
converters (``params_from_jax`` with ``strict=True``,
``discriminator_from_jax``). Bars: data bit for bit; metrics 1e-6 relative;
the forward 1e-5 relative to its largest value; the step at the GAN step's
bars (``tests/test_torch_port_train.py``): point_loss 1e-5, g_loss 1e-4,
gradients 1e-4 relative norm per parameter, parameters after the Adam
update 1e-6 absolute where the gradient's sign is clear.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scream_tpu.config import ModelConfig as JModelConfig
from scream_tpu.config import RenderConfig as JRenderConfig
from scream_tpu.config import TrainConfig as JTrainConfig
from scream_tpu.data import batching as jbatching
from scream_tpu.data import datasets as jdatasets
from scream_tpu.data import loader as jloader
from scream_tpu.data import synthetic as jsynthetic
from scream_tpu.geometry import metrics as jmetrics
from scream_tpu.models.gan import PatchDiscriminator as JDisc
from scream_tpu.models.point_transformer import DEMTransformer as JDEM
from scream_tpu.train import optim as joptim
from scream_tpu.train import steps as jsteps
from scream_tpu_torch.config import ModelConfig, RenderConfig, TrainConfig
from scream_tpu_torch.data import batching, datasets, loader, synthetic
from scream_tpu_torch.geometry import metrics
from scream_tpu_torch.models import DEMTransformer, PatchDiscriminator
from scream_tpu_torch.train import (generator_optimizer, init_train_state,
                                    make_dem_train_step, make_disc_logit_fn)
from scream_tpu_torch.utils.convert import discriminator_from_jax, params_from_jax

KW = dict(d_model=128, num_heads=8, self_layers=1, cross_layers=1, dtype="float32")
W = 32  # render width (the discriminator needs >= 24 pixels)
SPE = 10  # steps per epoch of the LR schedule


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel workers,
    and these small tensors gain nothing from more threads but contend
    with the other workers for the cores."""
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
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


class Patches:
    """``n`` DEM patches of ``points`` points, item i from default_rng(i)
    (the train CLI's synthetic fallback)."""

    def __init__(self, make, n, points):
        self.make, self.n, self.points = make, n, points

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.make(np.random.default_rng(i), n_dsm=self.points, n_dem=self.points)


class TestData:
    @pytest.mark.parametrize("n_dsm,n_dem,seed", [(1024, 1024, 0), (300, 200, 1),
                                                   (64, 512, 2)])
    def test_make_dem_patch_bit_identical(self, n_dsm, n_dem, seed):
        want = jsynthetic.make_dem_patch(np.random.default_rng(seed), n_dsm, n_dem)
        got = synthetic.make_dem_patch(np.random.default_rng(seed), n_dsm, n_dem)
        assert_batches_equal(got, want)
        assert got["dem_coarse"].shape == (max(16, n_dem // 16), 3)

    def test_collate_dem(self):
        items = [synthetic.make_dem_patch(np.random.default_rng(i), 90 + i, 90 + i)
                 for i in range(3)]
        assert_batches_equal(batching.collate_dem(items, 128, 128, 32),
                             jbatching.collate_dem(items, 128, 128, 32))
        with_c = [dict(it, center=np.array([1.0, 2.0, 3.0])) for it in items]
        got = batching.collate_dem(with_c, 128, 128, 32)
        assert_batches_equal(got, jbatching.collate_dem(with_c, 128, 128, 32))
        assert got["center"].shape == (3, 2)
        with pytest.raises(ValueError, match="center"):
            batching.collate_dem(with_c[:1] + items[1:], 128, 128, 32)

    def test_dem_loader_batches(self):
        kw = dict(batch_size=3, dsm_capacity=96, dem_capacity=96, coarse_capacity=64,
                  shuffle=True, drop_last=True, seed=5)
        got = list(loader.DEMLoader(Patches(synthetic.make_dem_patch, 8, 80), **kw))
        want = list(jloader.DEMLoader(Patches(jsynthetic.make_dem_patch, 8, 80), **kw))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert_batches_equal(a, b)
        with pytest.raises(ValueError, match="must be equal"):
            loader.DEMLoader(Patches(synthetic.make_dem_patch, 2, 8), 1, 96, 128, 64)


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """An OpenGF split (three patches of [dsm | dem] in reference units,
    centres) and a registration split with its info sidecars."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(7)
    og = root / "OpenGF_train"
    (og / "centers").mkdir(parents=True)
    for i in range(1, 4):
        xy = rng.uniform(0, 500, (700, 2))
        dem = np.concatenate([xy, rng.uniform(0, 40, (700, 1))], 1)
        dsm = dem + np.concatenate([rng.normal(0, 0.3, (700, 2)),
                                    rng.uniform(0, 20, (700, 1))], 1)
        np.save(og / f"{i}.npy", np.concatenate([dsm, dem], 1))
        np.save(og / "centers" / f"{i}.npy", rng.uniform(0, 1e4, 3))
    reg = root / "3DMatch_val"
    (reg / "info").mkdir(parents=True)
    names = list(jdatasets.SCENE_NAME_TO_IDX)
    for i in range(3):
        pair = synthetic.make_pair(rng, n_src=300 + 40 * i, n_tgt=320, overlap=0.6)
        T = np.eye(4)
        T[:3, :3], T[:3, 3:] = pair["rot"], pair["trans"]
        np.save(reg / f"src{i}.npy", pair["src"] * 3.0)
        np.save(reg / f"tgt{i}.npy", pair["tgt"] * 3.0)
        np.save(reg / f"T{i}.npy", T)
        np.save(reg / "info" / f"idx{i}.npy", np.array([i, i + 2], np.int32))
        np.save(reg / "info" / f"covariance{i}.npy", np.eye(6) * (i + 1))
    (reg / "info" / "scene_names.txt").write_text("\n".join(names[:3]) + "\n")
    return str(root)


class TestDatasets:
    @pytest.mark.parametrize("with_centers", [False, True])
    def test_opengf_items_equal(self, splits, with_centers):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # a 3-item split is not the canonical size
            got = datasets.OpenGFDataset(splits, "train", with_centers=with_centers)
            want = jdatasets.OpenGFDataset(splits, "train", with_centers=with_centers)
        assert len(got) == len(want) == 3
        for i in range(3):
            assert_batches_equal(got[i], want[i])
        assert len(got[0]["dem_coarse"]) < len(got[0]["dem"])

    @pytest.mark.parametrize("kw", [dict(normalize="unit_sphere", augment=True),
                                    dict(normalize="unit_cube", augment=True,
                                         perturb_both_sides=False, jitter_std=0.0),
                                    dict(normalize="unit_sphere", with_info=True,
                                         max_points=310)])
    def test_pair_items_equal(self, splits, kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = datasets.PairDataset(splits, "3DMatch_val", seed=3, **kw)
            want = jdatasets.PairDataset(splits, "3DMatch_val", seed=3, **kw)
        assert len(got) == len(want) == 3
        for _ in range(2):  # the augmentation draws anew on every visit
            for i in range(3):
                assert_batches_equal(got[i], want[i])

    def test_split_size_check_warns(self, splits):
        with pytest.warns(UserWarning, match="3DMatch_val: found 3 items"):
            datasets.PairDataset(splits, "3DMatch_val")
        with pytest.raises(FileNotFoundError, match="scene_names"):
            datasets.PairDataset(splits, "OpenGF_train", with_info=True)

    def test_voxel_downsample_matches(self):
        from scream_tpu.ops.voxel import voxel_downsample_np

        pts = np.random.default_rng(8).uniform(-300, 300, (4000, 3))
        got = datasets.voxel_downsample(pts, 20.0)
        assert np.array_equal(got, voxel_downsample_np(pts, 20.0))


class TestMetrics:
    @pytest.mark.parametrize("masked", [False, True])
    def test_chamfer_and_heights(self, masked):
        rng = np.random.default_rng(9)
        a = rng.uniform(-1, 1, (3, 150, 3)).astype(np.float32)
        b = (a[:, :120] + rng.normal(0, 0.05, (3, 120, 3))).astype(np.float32)
        ma = rng.random((3, 150)) > 0.2 if masked else None
        mb = rng.random((3, 120)) > 0.2 if masked else None
        j = lambda x: None if x is None else jnp.asarray(x)
        p = lambda x: None if x is None else t(x)
        want = jmetrics.chamfer_distance(jnp.asarray(a), jnp.asarray(b), j(ma), j(mb))
        got = metrics.chamfer_distance(t(a), t(b), p(ma), p(mb))
        assert rel(got.numpy(), want) <= 1e-6
        m = None if ma is None else ma[:, :120] & mb
        for name in ("height_mae", "height_mse"):
            want = getattr(jmetrics, name)(jnp.asarray(a[:, :120]), jnp.asarray(b), j(m))
            got = getattr(metrics, name)(t(a[:, :120]), t(b), p(m))
            assert rel(got.numpy(), want) <= 1e-6, name


def dem_batch(seed=0, B=2, n=256, coarse_cap=32):
    items = [synthetic.make_dem_patch(np.random.default_rng(seed + i), n - 20 * i, n - 20 * i)
             for i in range(B)]
    return batching.collate_dem(items, n, n, coarse_cap)


# An optax stage that passes the gradients on and keeps them as its state.
CAPTURE = optax.GradientTransformation(
    lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))


@pytest.fixture(scope="module")
def init():
    """One DEMTransformer and one discriminator init (numpy trees), one batch."""
    batch = dem_batch()
    jmodel = JDEM(JModelConfig(separate_stems=True, **KW))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jmodel.init(jax.random.PRNGKey(0), jb["dsm"], jb["dem_coarse"], jb["dsm_mask"],
                         jb["dem_coarse_mask"])["params"]
    dvars = JDisc(input_nc=2).init(jax.random.PRNGKey(1), jnp.zeros((1, W, W, 2)),
                                   train=False)
    return dict(batch=batch, jmodel=jmodel, params=np_tree(params),
                dvars={"params": np_tree(dvars["params"]),
                       "batch_stats": np_tree(dvars["batch_stats"])})


def port_model(init):
    model = DEMTransformer(ModelConfig(separate_stems=True, **KW), device="cpu")
    model.load_state_dict(params_from_jax(init["params"]), strict=True)
    return model


class TestDEMTransformer:
    def test_forward_matches_jax(self, init):
        b = init["batch"]
        want = init["jmodel"].apply({"params": init["params"]}, jnp.asarray(b["dsm"]),
                                    jnp.asarray(b["dem_coarse"]), jnp.asarray(b["dsm_mask"]),
                                    jnp.asarray(b["dem_coarse_mask"]))
        model = port_model(init)
        assert any(k.startswith("trunk.stem_src_0.") for k in model.state_dict())
        with torch.no_grad():
            got = model(t(b["dsm"]), t(b["dem_coarse"]), t(b["dsm_mask"]),
                        t(b["dem_coarse_mask"]))
        assert got.dtype == torch.float32 and got.shape == (2, 256, 3)
        m = b["dsm_mask"][..., None]
        assert rel(got.numpy() * m, np.asarray(want) * m) <= 1e-5

    def test_shared_stem_config_gets_separate_stems(self):
        model = DEMTransformer(ModelConfig(**KW), device="cpu")
        assert model.cfg.separate_stems and hasattr(model.trunk, "stem_tgt_0")

    @pytest.mark.parametrize("masked", [False, True])
    def test_loss_matches_jax(self, masked):
        rng = np.random.default_rng(10)
        pred, gt = rng.normal(0, 1, (2, 2, 50, 3)).astype(np.float32)
        m = rng.random((2, 50)) > 0.3 if masked else None
        want = JDEM.loss(jnp.asarray(pred), jnp.asarray(gt), None if m is None else jnp.asarray(m))
        got = DEMTransformer.loss(t(pred), t(gt), None if m is None else t(m))
        assert rel(float(got), float(want)) <= 1e-6


@pytest.fixture(scope="module")
def jax_steps(init):
    """The JAX package's DEM step, GAN off and on, from the same init:
    metrics, gradients and parameters after the update."""
    jdisc = JDisc(input_nc=2)
    rcfg = JRenderConfig(multi_view=False, width=W, use_pallas=False)
    out = {}
    for use_gan in (False, True):
        opt = optax.chain(CAPTURE, joptim.generator_optimizer(JTrainConfig(), SPE))
        params = jax.tree_util.tree_map(jnp.asarray, init["params"])
        step = jsteps.make_dem_train_step(init["jmodel"], opt, use_gan=use_gan,
                                          disc_apply=jsteps.make_disc_logit_fn(jdisc),
                                          render_cfg=rcfg)
        dv = jax.tree_util.tree_map(jnp.asarray, init["dvars"]) if use_gan else None
        state, metrics_, fake = step(jsteps.init_train_state(params, opt),
                                     {k: jnp.asarray(v) for k, v in init["batch"].items()}, dv)
        out[use_gan] = dict(metrics={k: float(v) for k, v in metrics_.items()},
                            grads=params_from_jax(np_tree(state.opt_state[0])),
                            params=params_from_jax(np_tree(state.params)),
                            fake=None if fake is None else np.asarray(fake))
    return out


class TestDEMStep:
    @pytest.mark.parametrize("use_gan", [False, True])
    def test_step_matches_jax(self, init, jax_steps, use_gan):
        model = port_model(init)
        before = {k: v.detach().clone() for k, v in model.named_parameters()}
        opt, sched = generator_optimizer(model.parameters(), TrainConfig(), SPE)
        disc = None
        if use_gan:
            disc = PatchDiscriminator(device="cpu")
            disc.load_state_dict(discriminator_from_jax(init["dvars"]), strict=True)
        step = make_dem_train_step(model, use_gan=use_gan, disc_apply=make_disc_logit_fn(),
                                   render_cfg=RenderConfig(multi_view=False, width=W))
        stages = []
        state, got, fake = step(init_train_state(opt, sched),
                                {k: t(v) for k, v in init["batch"].items()}, disc,
                                stages.append)
        want = jax_steps[use_gan]
        assert state.step == 1
        assert stages == (["forward", "render", "discriminator", "backward", "optimizer"]
                          if use_gan else ["forward", "backward", "optimizer"])
        assert rel(float(got["point_loss"]), want["metrics"]["point_loss"]) <= 1e-5
        if use_gan:
            assert rel(float(got["g_loss"]), want["metrics"]["g_loss"]) <= 1e-4
            assert rel(float(got["loss"]), want["metrics"]["loss"]) <= 1e-4
            assert fake.shape == want["fake"].shape == (2, 1, 2, W, W)
            assert all(p.grad is None for p in disc.parameters())
        else:
            assert fake is None and set(got) == {"point_loss", "loss"}
        params = dict(model.named_parameters())
        assert set(params) == set(want["grads"])
        for name, p in params.items():
            g_want = want["grads"][name].numpy()
            assert rel_norm(p.grad.numpy(), g_want) <= 1e-4, name
            clear = np.abs(g_want) > 1e-3 * np.abs(g_want).max()
            moved = p.detach().numpy() - before[name].numpy()
            want_moved = want["params"][name].numpy() - before[name].numpy()
            assert np.abs(moved - want_moved)[clear].max() <= 1e-6, name

    def test_gan_needs_a_discriminator_query(self, init):
        with pytest.raises(ValueError, match="disc_apply"):
            make_dem_train_step(port_model(init), use_gan=True)


def test_data_package_exports():
    from scream_tpu_torch import data

    for name in ("DEMLoader", "OpenGFDataset", "PairDataset", "collate_dem",
                 "make_dem_patch"):
        assert hasattr(data, name), name
