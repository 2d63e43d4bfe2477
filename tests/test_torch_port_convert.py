"""The port's weight converter against the JAX package on the CPU: every
leaf of a flax PointTransformer tree is used exactly once, values and the
``(in, out)`` layout round-trip unchanged, and the shipped
``params/point-generator`` checkpoint, read by the JAX package's loader and
converted, gives the JAX model's forward (fp32, <= 1e-4 relative, max
|port - jax| over max |jax|).
"""

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
