"""``train --multi-scale`` against the JAX package on the CPU: the
size-bucketed loaders of ``cli._registration_loaders(multi_scale=True)``
(per-bucket synthetic pairs, two overlap tiers for training) and one
training epoch of ``RegistrationTrainer`` on them, at d 128, 1 + 1 layers,
fp32, with the buckets 256 and 512 (``--max-points 512``).

Bars: every batch of both loaders bit for bit, in the same order; the
epoch's train losses within 1e-4 relative (``test_torch_port_trainer.py``'s
bar; validation is that file's); the ``train`` CLI's flag reaches the
bucketed loader, and ``--mesh`` / ``--sample-img-dir`` stay refused with it.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from scream_tpu import cli as jcli
from scream_tpu import config as jconfig
from scream_tpu.train import trainer as jtrainer
from scream_tpu_torch import cli as tcli
from scream_tpu_torch import config
from scream_tpu_torch.data import BucketedPairLoader
from scream_tpu_torch.train import RegistrationTrainer
from scream_tpu_torch.utils.convert import params_from_jax

KW = dict(d_model=128, num_heads=8, self_layers=1, cross_layers=1, dtype="float32")
MAX_POINTS, BATCH, SYNTH = 512, 2, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def loaders(pkg, root, threads=True):
    """The CLI's multi-scale train and validation loaders. Without
    ``threads`` they assemble batches in the consumer's thread: a partly
    consumed threaded iteration has made a timing-dependent number of
    batches ahead, and each item visit draws its own augmentation stream."""
    _, train_cfg, data_cfg, _ = pkg.TASKS["3dmatch"]()
    data_cfg = dataclasses.replace(data_cfg, max_points=MAX_POINTS)
    train_cfg = dataclasses.replace(train_cfg, batch_size=BATCH)
    out = pkg._registration_loaders("3dmatch", data_cfg, train_cfg, root,
                                    synthetic_len=SYNTH, multi_scale=True)
    if not threads:
        for loader in out:
            loader.num_workers = 0
    return out


def test_loaders_bit_for_bit(tmp_path):
    root = str(tmp_path / "no-data")
    (jtr, jva), (ttr, tva) = loaders(jcli, root), loaders(tcli, root)
    assert isinstance(ttr, BucketedPairLoader) and ttr.buckets == jtr.buckets == (256, 512)
    for j, p in ((jtr, ttr), (jva, tva)):
        assert len(p) == len(j)
        seen = set()
        for epoch in range(2):  # the shuffled order advances per epoch
            jb, pb = list(j), list(p)
            assert len(jb) == len(pb) == len(j)
            for a, b in zip(jb, pb):
                assert set(a) == set(b)
                for k in a:
                    assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
                seen.add(a["src"].shape[1])
        assert seen == {256, 512}
    # Train: 2 buckets x 2 overlap tiers x 4 pairs, batches of 2, last dropped.
    assert len(ttr) == 8 and len(tva) == 8


def test_one_epoch_matches_jax(tmp_path):
    root = str(tmp_path / "no-data")
    tc = dict(batch_size=BATCH, log_every=1000)
    jt = jtrainer.RegistrationTrainer(*loaders(jcli, root, threads=False),
                                      model_cfg=jconfig.ModelConfig(**KW),
                                      train_cfg=jconfig.TrainConfig(**tc), val_use_icp=False)
    pt = RegistrationTrainer(*loaders(tcli, root, threads=False),
                             model_cfg=config.ModelConfig(**KW),
                             train_cfg=config.TrainConfig(**tc), val_use_icp=False,
                             device="cpu")
    jt.init()
    pt.init()
    pt.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        lambda x: np.array(x, copy=True), jt.state.params)), strict=True)
    # The JAX trainer's init draws one batch from its train loader (a
    # shuffle and one batch's augmentation); draw it from the port's too.
    next(iter(pt.train_loader))
    assert pt.steps_per_epoch == jt.steps_per_epoch == 8
    w, g = jt.train_epoch(1), pt.train_epoch(1)
    assert pt.state.step == int(jt.state.step) == 8
    assert set(g) == set(w)
    for k in w:
        if k != "pairs_per_sec":
            assert abs(g[k] - w[k]) <= 1e-4 * max(abs(w[k]), 1e-3), (k, g[k], w[k])


def test_train_cli_multi_scale(tmp_path, capsys):
    tcli.main(["train", "3dmatch", "--multi-scale", "--device", "cpu", "--max-points",
               "512", "--d-model", "128", "--self-layers", "1", "--cross-layers", "1",
               "--dtype", "float32", "--epochs", "2", "--batch-size", "4",
               "--synthetic-pairs", "4", "--root", str(tmp_path / "no-data"),
               "--checkpoint-dir", str(tmp_path / "ck")])
    out = capsys.readouterr()
    assert "multi-scale synthetic pairs" in out.err
    final = json.loads(out.out.strip().splitlines()[-1])["final_val"]
    assert set(final) == {"point_loss", "rre", "rte", "success_rate", "success_rre",
                          "success_rte"}
    for flag in (["--mesh", "data=2"], ["--sample-img-dir", "imgs"]):
        with pytest.raises(SystemExit, match="not ported"):
            tcli.main(["train", "3dmatch", "--multi-scale", "--device", "cpu", *flag])
