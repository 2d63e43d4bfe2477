"""The port's weight converter against the JAX package on the CPU: every
leaf of a flax PointTransformer tree is used exactly once, values and the
``(in, out)`` layout round-trip unchanged, and the shipped
``params/point-generator`` checkpoint, read by the JAX package's loader and
converted, gives the JAX model's forward (fp32, <= 1e-4 relative, max
|port - jax| over max |jax|). The converter script converts a checkpoint
without a ``model_config.json`` into the default ``ModelConfig()`` and a
``DEMTransformer`` with ``--dem``; each committed weight directory equals a
fresh conversion of its ``params/`` source, tensor for tensor; the shipped
point and DEM generators' forwards match the JAX forwards (1e-5).
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scream_tpu.config import ModelConfig as JModelConfig
from scream_tpu.models.point_transformer import PointTransformer as JPointTransformer
from scream_tpu_torch.config import ModelConfig
from scream_tpu_torch.models import PointTransformer
from scream_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_rel(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"relative error {err:.3g} > {tol}"


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init_jax(jcfg, N, M, B, seed):
    model = JPointTransformer(jcfg)
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (B, M, 3)).astype(np.float32)
    ones_n, ones_m = np.ones((B, N), bool), np.ones((B, M), bool)
    center = rng.uniform(-0.2, 0.2, (B, 1, 3)).astype(np.float32)
    params = model.init(jax.random.PRNGKey(seed), *map(
        jnp.asarray, (src, tgt, ones_n, ones_m, center)))["params"]
    return model, params


class TestConverter:
    def test_every_leaf_used_exactly_once(self):
        kw = dict(d_model=64, num_heads=4, self_layers=1, cross_layers=1,
                  dtype="float32")
        _, params = _init_jax(JModelConfig(**kw), N=16, M=16, B=1, seed=0)
        tc = ModelConfig(**kw)
        tree = np_tree(params)
        leaves = jax.tree_util.tree_leaves(tree)
        sd = params_from_jax(tree)
        model = PointTransformer(tc, device="cpu")
        assert len(sd) == len(leaves) == len(model.state_dict())
        model.load_state_dict(sd, strict=True)  # no missing, no unexpected keys
        # Round trip: the module holds the flax leaves unchanged, (in, out).
        by_path = {".".join(str(k.key) for k in path): leaf
                   for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
        for key, val in model.state_dict().items():
            np.testing.assert_array_equal(val.numpy(), by_path[key])

    def test_duplicate_key_raises(self):
        with pytest.raises(ValueError):
            params_from_jax({"a.b": np.zeros(1), "a": {"b": np.zeros(1)}})

    def test_shipped_point_generator_checkpoint(self):
        """``params/point-generator`` read by the JAX package's loader, each
        leaf to numpy, converted; one full-width fp32 forward at B=1,
        N=M=128 against the JAX model with the same weights."""
        from scream_tpu.utils.checkpoint import load_params

        jc = JModelConfig(dtype="float32")
        tc = ModelConfig(dtype="float32")
        jmodel, init = _init_jax(jc, N=128, M=128, B=1, seed=1)
        params = load_params(os.path.join(REPO, "params", "point-generator"), init)
        tree = np_tree(params)
        model = PointTransformer(tc, device="cpu")
        model.load_state_dict(params_from_jax(tree), strict=True)
        rng = np.random.default_rng(11)
        pair = rng.uniform(-0.8, 0.8, (2, 1, 128, 3)).astype(np.float32)
        ones = np.ones((1, 128), bool)
        center = pair[0].mean(1, keepdims=True)
        inputs = (pair[0], pair[1], ones, ones, center)
        want = jmodel.apply({"params": params}, *map(jnp.asarray, inputs))
        with torch.no_grad():
            got = model(*map(t, inputs))
        assert_rel(got.numpy(), want)


def _converter():
    spec = importlib.util.spec_from_file_location(
        "torch_port_convert_params",
        os.path.join(REPO, "scripts", "torch_port_convert_params.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The committed conversions: (weights dir, its params/ source, --task, --dem).
SHIPPED = {
    "point-generator": ("point-generator", "3dmatch", False),
    "dem-generator": ("dem-generator", "opengf", True),
    "kitti-generator-hintfree": ("kitti-generator-hintfree", "3dmatch", False),
}


@pytest.fixture(scope="module")
def fresh():
    """A fresh conversion of each committed weight directory's source."""
    conv = _converter()
    return {name: conv.convert(os.path.join(REPO, "params", src), task, dem)
            for name, (src, task, dem) in SHIPPED.items()}


def _tiny_tree_ckpt(tmp_path, dem):
    """A sidecar-less orbax checkpoint of the default architecture, random
    init, and its numpy tree."""
    from scream_tpu.models.point_transformer import DEMTransformer as JDEM
    from scream_tpu.utils.checkpoint import save_params

    z = jnp.zeros((1, 8, 3), jnp.float32)
    ones = jnp.ones((1, 8), bool)
    if dem:
        params = JDEM(JModelConfig(separate_stems=True)).init(
            jax.random.PRNGKey(5), z, z, ones, ones)["params"]
    else:
        params = JPointTransformer(JModelConfig()).init(
            jax.random.PRNGKey(4), z, z, ones, ones, jnp.zeros((1, 1, 3)))["params"]
    path = tmp_path / ("dem" if dem else "point")
    save_params(str(path), params)
    assert not (path / "model_config.json").exists()
    return str(path), np_tree(params)


class TestConverterModes:
    @pytest.mark.parametrize("dem", [False, True])
    def test_sidecarless_checkpoint_converts_with_default_config(self, tmp_path, dem):
        from scream_tpu_torch.models import DEMTransformer
        from scream_tpu_torch.utils.checkpoint import load_params as tload

        src, tree = _tiny_tree_ckpt(tmp_path, dem)
        dst = str(tmp_path / "out")
        argv = ["--src", src, "--dst", dst] + (["--dem"] if dem else ["--task", "kitti"])
        _converter().main(argv)
        cfg, normalize, state = tload(dst)
        assert normalize == ("none" if dem else "unit_cube")
        default = ModelConfig(separate_stems=True) if dem else ModelConfig()
        assert cfg == default
        want = params_from_jax(tree)
        assert state.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(state[k], v), k
        model = (DEMTransformer if dem else PointTransformer)(cfg, device="cpu")
        model.load_state_dict(state, strict=True)

    def test_existing_sidecar_is_kept(self, fresh):
        with open(os.path.join(REPO, "params", "kitti-generator-hintfree",
                               "model_config.json")) as f:
            assert fresh["kitti-generator-hintfree"][1] == json.load(f)

    @pytest.mark.parametrize("name", sorted(SHIPPED))
    def test_committed_weights_equal_a_fresh_conversion(self, fresh, name):
        from scream_tpu_torch.utils.checkpoint import MODEL_FILE, SIDECAR

        state, sidecar = fresh[name]
        d = os.path.join(REPO, "scream_tpu_torch", "weights", name)
        with open(os.path.join(d, SIDECAR)) as f:
            assert json.load(f) == sidecar
        shipped = torch.load(os.path.join(d, MODEL_FILE), map_location="cpu",
                             weights_only=True)
        assert shipped.keys() == state.keys()
        for k, v in state.items():
            assert shipped[k].dtype == torch.float32 and torch.equal(shipped[k], v), k


class TestShippedForwards:
    """The shipped weights through the port against the orbax checkpoints
    through the JAX package, fp32, 1e-5 relative."""

    def test_point_generator(self):
        from scream_tpu.utils.checkpoint import load_params
        from scream_tpu_torch.utils.checkpoint import load_params as tload

        jmodel, init = _init_jax(JModelConfig(dtype="float32"), N=256, M=256, B=2, seed=2)
        params = load_params(os.path.join(REPO, "params", "point-generator"), init)
        cfg, normalize, state = tload(os.path.join(REPO, "scream_tpu_torch", "weights",
                                                   "point-generator"))
        assert normalize == "unit_sphere"
        model = PointTransformer(dataclasses.replace(cfg, dtype="float32"), device="cpu")
        model.load_state_dict(state, strict=True)
        rng = np.random.default_rng(12)
        src, tgt = rng.uniform(-0.8, 0.8, (2, 2, 256, 3)).astype(np.float32)
        ones = np.ones((2, 256), bool)
        ones[1, 200:] = False
        inputs = (src, tgt, ones, np.ones((2, 256), bool), src.mean(1, keepdims=True))
        want = jmodel.apply({"params": params}, *map(jnp.asarray, inputs))
        with torch.no_grad():
            got = model(*map(t, inputs))
        assert_rel(got.numpy(), want, tol=1e-5)

    def test_dem_generator(self):
        from scream_tpu.models.point_transformer import DEMTransformer as JDEM
        from scream_tpu.utils.checkpoint import load_params
        from scream_tpu_torch.models import DEMTransformer
        from scream_tpu_torch.utils.checkpoint import load_params as tload

        rng = np.random.default_rng(13)
        dsm = rng.uniform(-1, 1, (2, 512, 3)).astype(np.float32)
        coarse = rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32)
        dm, cm = np.ones((2, 512), bool), np.ones((2, 64), bool)
        dm[0, 400:] = False
        inputs = (dsm, coarse, dm, cm)
        jmodel = JDEM(JModelConfig(separate_stems=True, dtype="float32"))
        init = jmodel.init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs))["params"]
        params = load_params(os.path.join(REPO, "params", "dem-generator"), init)
        cfg, _, state = tload(os.path.join(REPO, "scream_tpu_torch", "weights",
                                           "dem-generator"))
        model = DEMTransformer(dataclasses.replace(cfg, dtype="float32"), device="cpu")
        model.load_state_dict(state, strict=True)
        want = jmodel.apply({"params": params}, *map(jnp.asarray, inputs))
        with torch.no_grad():
            got = model(*map(t, inputs))
        assert_rel(got.numpy(), want, tol=1e-5)
