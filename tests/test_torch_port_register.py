"""The port's registration pipeline against the JAX package on the CPU:
the protocol helpers, the pose solve, and ``register_batch`` as a whole,
with an oracle predictor and with the trained ``params/demo-3dmatch-d128``
model (converted through ``params_from_jax``), with and without the ICP
subsample, in fp32.

Bars (CLAUDE.md): transforms within 2e-2; ``n_corr`` equal; RE (degrees)
and TE within the same 2e-2; the pose solve's Kabsch within 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scream_tpu.config import ModelConfig as JModelConfig
from scream_tpu.models.point_transformer import PointTransformer as JPointTransformer
from scream_tpu.pipeline import register as jreg
from scream_tpu_torch.config import ModelConfig
from scream_tpu_torch.data import PairLoader, SyntheticPairDataset
from scream_tpu_torch.models import PointTransformer
from scream_tpu_torch.pipeline import register as treg
from scream_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _batch(B=3, n_src=240, n_tgt=250, cap=256, seed=0, with_info=False):
    ds = SyntheticPairDataset(length=B, n_src=n_src, n_tgt=n_tgt, seed=seed,
                              with_info=with_info)
    return next(iter(PairLoader(ds, batch_size=B, src_capacity=cap, num_workers=0)))


def _gt_pred(batch, noise, rng):
    """src under the GT pose (normalized frame) plus noise: an oracle model."""
    rot, trans = batch["rot"], batch["trans"]
    pred = np.einsum("bij,bnj->bni", rot, batch["src"]) + trans.transpose(0, 2, 1)
    return (pred + rng.standard_normal(pred.shape) * noise).astype(np.float32)


def _assert_metrics_close(got, want):
    np.testing.assert_array_equal(got.n_corr.numpy(), np.asarray(want.n_corr))
    np.testing.assert_allclose(got.transform.numpy(), want.transform, atol=2e-2, rtol=0)
    np.testing.assert_allclose(got.re_deg.numpy(), want.re_deg, atol=2e-2, rtol=0)
    np.testing.assert_allclose(got.te.numpy(), want.te, atol=2e-2, rtol=0)
    assert np.isfinite(got.transform.numpy()).all()


class TestHelpers:
    @pytest.mark.parametrize("n,k", [(4096, 1024), (1000, 300), (7, 7)])
    def test_spread_subsample_indices(self, n, k):
        np.testing.assert_array_equal(treg.spread_subsample_indices(n, k),
                                      jreg.spread_subsample_indices(n, k))

    def test_denormalized_gt(self):
        b = _batch()
        want = jreg.denormalized_gt(*(jnp.asarray(b[k]) for k in
                                      ("rot", "trans", "scale", "center")))
        got = treg.denormalized_gt(*(t(b[k]) for k in ("rot", "trans", "scale", "center")))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)

    @pytest.mark.parametrize("mode", ["trans", "neg_rt", "none"])
    def test_gt_center_hint(self, mode):
        b = _batch()
        want = jreg.gt_center_hint(jnp.asarray(b["rot"]), jnp.asarray(b["trans"]), mode)
        got = treg.gt_center_hint(t(b["rot"]), t(b["trans"]), mode)
        if mode == "none":
            assert got is None and want is None
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6)

    def test_unknown_modes_raise(self):
        b = _batch(B=1)
        with pytest.raises(ValueError):
            treg.gt_center_hint(t(b["rot"]), t(b["trans"]), "centroid")
        with pytest.raises(ValueError):
            treg.solve_pose(*(t(b[k]) for k in ("src", "src", "tgt", "src_mask",
                                                "tgt_mask", "scale", "center")),
                            corr="nearest")

    @pytest.mark.parametrize("corr", ["tgt", "src_pred"])
    def test_solve_pose(self, corr):
        b = _batch(seed=4)
        pred = _gt_pred(b, 0.01, np.random.default_rng(0))
        keys = ("src", "tgt", "src_mask", "tgt_mask", "scale", "center")
        js = {k: jnp.asarray(b[k]) for k in keys}
        want = jreg.solve_pose(js["src"], jnp.asarray(pred), js["tgt"], js["src_mask"],
                               js["tgt_mask"], js["scale"], js["center"], 0.1, corr)
        ts = {k: t(b[k]) for k in keys}
        got = treg.solve_pose(ts["src"], t(pred), ts["tgt"], ts["src_mask"],
                              ts["tgt_mask"], ts["scale"], ts["center"], 0.1, corr)
        np.testing.assert_array_equal(got.n_corr.numpy(), want.n_corr)
        np.testing.assert_allclose(got.transform.numpy(), want.transform, atol=1e-5, rtol=0)


class TestRegisterBatch:
    @pytest.mark.parametrize("icp_subsample,use_icp", [(None, True), (100, True), (None, False)])
    def test_oracle_model_matches_jax(self, icp_subsample, use_icp):
        """The pipeline alone: both sides get the same predicted cloud (the
        GT-posed src plus noise), so forward differences cannot hide a
        solve/ICP/metrics difference."""
        b = _batch(with_info=True, seed=2)
        pred = _gt_pred(b, 0.02, np.random.default_rng(1))

        def japply(params, src, tgt, sm, tm, center):
            return params

        want = jreg.register_batch(japply, jnp.asarray(pred),
                                   {k: jnp.asarray(v) for k, v in b.items()},
                                   icp_subsample=icp_subsample, use_icp=use_icp)
        got = treg.register_batch(lambda *a: t(pred), b, icp_subsample=icp_subsample,
                                  use_icp=use_icp, device="cpu")
        _assert_metrics_close(got, want)
        np.testing.assert_allclose(got.rmse.numpy(), want.rmse, atol=2e-2, rtol=0)
        assert (got.re_deg.numpy() < 5).all()

    def test_trained_model_matches_jax(self):
        """register_batch end to end with a trained model: the demo d128
        checkpoint (3 + 3 layers, 8 heads) read by the JAX package,
        converted, run by both packages on the same padded batch."""
        from scream_tpu.utils.checkpoint import load_params

        kw = dict(d_model=128, self_layers=3, cross_layers=3, dtype="float32")
        jmodel = JPointTransformer(JModelConfig(**kw))
        b = _batch(B=2, n_src=200, n_tgt=224, cap=256, seed=5)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        init = jmodel.init(jax.random.PRNGKey(0), jb["src"], jb["tgt"], jb["src_mask"],
                           jb["tgt_mask"], jnp.swapaxes(jb["trans"], -1, -2))["params"]
        params = load_params(os.path.join(REPO, "params", "demo-3dmatch-d128"), init)

        def japply(p, src, tgt, sm, tm, center):
            return jmodel.apply({"params": p}, src, tgt, sm, tm, center)

        want = jreg.register_batch(japply, params, jb)
        model = PointTransformer(ModelConfig(**kw), device="cpu")
        model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        got = treg.register_batch(model, b, device="cpu")
        _assert_metrics_close(got, want)
        assert (np.asarray(want.n_corr) > 20).all()  # a real, well-posed solve
