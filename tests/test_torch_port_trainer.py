"""The port's trainers, checkpoints and ``train`` CLI against the JAX package
on the CPU, in fp32.

* Both trainers from one converted JAX init (d 128, 1 + 1 layers, batch 2,
  2 steps per epoch) over ``fit(epochs=3)``: per-epoch train losses within
  1e-4 relative; validation metrics within 2e-2 relative (registration,
  validated without ICP to keep the JAX compiles in budget; the ICP
  trajectory bar) or, for the DEM, 1e-4 after epoch 1 and 1e-3 after
  epoch 2: Adam moves a parameter by about lr * sign(gradient), so where a
  gradient is near 0 the two packages' last bits can flip its sign and move
  it 2 lr = 4e-4 apart; measured 3.2e-5 after 2 steps and 3.1e-4 after 4.
  Then the port's ``evaluate`` on the JAX trainer's final weights against
  the JAX trainer's: 1e-5 (DEM), 2e-2 (registration, once without ICP and
  once with it).
* ``BestCheckpointer``: the JAX package's gating decisions (min, max, a
  non-finite metric never saves), the persisted best.
* Save -> restore -> resume at the next epoch, ending in the state of the
  run that was never interrupted (GAN on, so the discriminator's state is
  in it).
* The ``train`` CLI with ``--device cpu`` at tiny sizes: ``final_val`` last,
  ``--resume``, ``--init-params``, the refused flags.
* The task presets and ``eval_preset`` equal the JAX package's, field for
  field.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from scream_tpu import config as jconfig
from scream_tpu.data import datasets as jdatasets
from scream_tpu.data import loader as jloader
from scream_tpu.data import synthetic as jsynthetic
from scream_tpu.train import trainer as jtrainer
from scream_tpu_torch import config
from scream_tpu_torch.cli import main as cli_main
from scream_tpu_torch.data import datasets, loader, synthetic
from scream_tpu_torch.train import DEMTrainer, RegistrationTrainer
from scream_tpu_torch.utils.checkpoint import BestCheckpointer, load_params
from scream_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(d_model=128, num_heads=8, self_layers=1, cross_layers=1, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel workers,
    and these small tensors gain nothing from more threads but contend
    with the other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


class Patches:
    def __init__(self, make, n, points, seed=0):
        self.make, self.n, self.points, self.seed = make, n, points, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.make(np.random.default_rng(self.seed + i), n_dsm=self.points,
                         n_dem=self.points)


# Loaders without worker threads, so that which items a partly consumed
# iteration visits (and so each item's augmentation stream) is deterministic.
def reg_loaders(ds_mod, loader_mod, shuffle=True):
    train = ds_mod.SyntheticPairDataset(length=4, n_src=110, n_tgt=120, augment=True)
    val = ds_mod.SyntheticPairDataset(length=4, n_src=110, n_tgt=120, seed=1)
    return (loader_mod.PairLoader(train, 2, 128, shuffle=shuffle, drop_last=True,
                                  num_workers=0),
            loader_mod.PairLoader(val, 2, 128, num_workers=0))


def dem_loaders(make, loader_mod, shuffle=True):
    mk = lambda ds, sh: loader_mod.DEMLoader(ds, 2, 128, 128, 32, shuffle=sh,
                                             drop_last=True, num_workers=0)
    return mk(Patches(make, 4, 100), shuffle), mk(Patches(make, 2, 100, seed=50), False)


def record(trainer):
    """Wrap the trainer's epoch and validation to keep what they return."""
    seen = {"train": [], "val": []}
    epoch, evaluate = trainer.train_epoch, trainer.evaluate
    trainer.train_epoch = lambda e: seen["train"].append(epoch(e)) or seen["train"][-1]
    trainer.evaluate = lambda: seen["val"].append(evaluate()) or seen["val"][-1]
    return seen


def assert_close(got, want, tol, skip=()):
    keys = [k for k in want if k not in skip]
    assert set(got) >= set(keys)
    for k in keys:
        assert abs(got[k] - want[k]) <= tol * max(abs(want[k]), 1e-3), (k, got[k], want[k])


@pytest.mark.parametrize("task", ["registration", "dem"])
def test_trainer_matches_jax(task):
    """One JAX init in both trainers; fit(epochs=3) runs epochs 1 and 2."""
    tc = dict(batch_size=2, log_every=1000)
    if task == "dem":
        jt = jtrainer.DEMTrainer(*dem_loaders(jsynthetic.make_dem_patch, jloader),
                                 model_cfg=jconfig.ModelConfig(separate_stems=True, **KW),
                                 train_cfg=jconfig.TrainConfig(**tc))
        pt = DEMTrainer(*dem_loaders(synthetic.make_dem_patch, loader),
                        model_cfg=config.ModelConfig(separate_stems=True, **KW),
                        train_cfg=config.TrainConfig(**tc), device="cpu")
        tols, tol_eval = (1e-4, 1e-3), 1e-5
    else:
        jt = jtrainer.RegistrationTrainer(*reg_loaders(jdatasets, jloader),
                                          model_cfg=jconfig.ModelConfig(**KW),
                                          train_cfg=jconfig.TrainConfig(**tc),
                                          val_use_icp=False)
        pt = RegistrationTrainer(*reg_loaders(datasets, loader),
                                 model_cfg=config.ModelConfig(**KW),
                                 train_cfg=config.TrainConfig(**tc), val_use_icp=False,
                                 device="cpu")
        tols, tol_eval = (2e-2, 2e-2), 2e-2
    jt.init()
    pt.init()
    pt.model.load_state_dict(params_from_jax(np_tree(jt.state.params)), strict=True)
    # The JAX trainer's init draws one batch from its train loader for the
    # shapes, which advances the loader's shuffle and the first batch's
    # augmentation streams; draw it from the port's too, so that both
    # trainers see the same batches.
    next(iter(pt.train_loader))
    assert pt.steps_per_epoch == jt.steps_per_epoch == 2
    jseen, pseen = record(jt), record(pt)
    want, got = jt.fit(epochs=3), pt.fit(epochs=3)
    assert pt.state.step == int(jt.state.step) == 4
    assert len(pseen["train"]) == len(jseen["train"]) == 2
    for g, w in zip(pseen["train"], jseen["train"]):
        assert_close(g, w, 1e-4, skip=("pairs_per_sec",))
    for g, w, tol in zip(pseen["val"], jseen["val"], tols):
        assert_close(g, w, tol)
    assert got == pseen["val"][-1] and all(math.isfinite(v) for v in got.values())
    pt.model.load_state_dict(params_from_jax(np_tree(jt.state.params)), strict=True)
    assert_close(pt.evaluate(), want, tol_eval)
    if task == "registration":  # validation with ICP, as the reference runs it
        jt.val_use_icp = pt.val_use_icp = True
        with_icp = pt.evaluate()
        assert_close(with_icp, jt.evaluate(), 2e-2)
        assert with_icp["rre"] != got["rre"]


@pytest.mark.parametrize("mode,metrics", [("min", [3.0, 2.0, 2.5, float("nan"), 1.0]),
                                          ("max", [0.1, float("inf"), 0.3, 0.2, 0.3, 0.5])])
def test_best_checkpointer_gates_like_jax(tmp_path, mode, metrics):
    from scream_tpu.utils.checkpoint import BestCheckpointer as JBest

    mine = BestCheckpointer(str(tmp_path / "port"), mode=mode)
    theirs = JBest(str(tmp_path / "jax"), mode=mode)
    state = {"w": torch.arange(3.0)}
    sidecar = dataclasses.asdict(config.ModelConfig(**KW))
    for m in metrics:
        want = theirs.improved(m)
        if want:
            theirs.best = m
        assert mine.maybe_save(m, state, sidecar) == want, m
    assert mine.best == theirs.best
    cfg, _, saved = mine.restore()
    assert cfg == config.ModelConfig(**KW) and torch.equal(saved["w"], state["w"])
    # The best persists: a new checkpointer on the directory gates against it.
    again = BestCheckpointer(str(tmp_path / "port"), mode=mode)
    assert again.best == mine.best
    assert not again.improved(mine.best)
    assert BestCheckpointer(str(tmp_path / "port"),
                            mode="max" if mode == "min" else "min").best is None
    with pytest.raises(ValueError, match="mode"):
        BestCheckpointer(str(tmp_path / "x"), mode="mean")


def gan_dem_trainer(checkpoint_dir, seed=0):
    # The loader's order is not part of the saved state (nor in the JAX
    # package), so the runs compared read their batches in a fixed order.
    tc = config.TrainConfig(batch_size=2, log_every=1000, use_gan=True)
    t = DEMTrainer(*dem_loaders(synthetic.make_dem_patch, loader, shuffle=False),
                   model_cfg=config.ModelConfig(separate_stems=True, **KW), train_cfg=tc,
                   render_cfg=config.RenderConfig(multi_view=False, width=32),
                   checkpoint_dir=checkpoint_dir, device="cpu")
    t.init(seed=seed)
    return t


def test_save_restore_resumes_where_the_run_stopped(tmp_path, capsys):
    """fit(3) at once, against fit(2), then a fresh trainer (another seed)
    restored from the saved state and fit(3): it resumes at epoch 2 and ends
    in the same generator, Adam and discriminator state."""
    whole = gan_dem_trainer(str(tmp_path / "whole"))
    whole_val = whole.fit(epochs=3)
    cut = gan_dem_trainer(str(tmp_path / "cut"))
    cut.fit(epochs=2)
    capsys.readouterr()
    resumed = gan_dem_trainer(str(tmp_path / "cut"), seed=7)
    resumed.restore_state(str(tmp_path / "cut" / "state"))
    assert resumed.state.step == 2
    resumed_val = resumed.fit(epochs=3)
    assert "resuming at epoch 2 (restored step 2)" in capsys.readouterr().out
    assert resumed.state.step == whole.state.step == 4
    assert resumed_val == whole_val
    for a, b in ((resumed.model, whole.model), (resumed.disc_state.disc, whole.disc_state.disc)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb), ka
    for a, b in ((resumed.state.optimizer, whole.state.optimizer),
                 (resumed.disc_state.optimizer, whole.disc_state.optimizer)):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        for i in sb:
            for k in sb[i]:
                assert torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k]))
    assert resumed.state.optimizer.param_groups[0]["lr"] == whole.state.optimizer.param_groups[0]["lr"]


def test_dem_trainer_checkpoint_metric(tmp_path):
    loaders = dem_loaders(synthetic.make_dem_patch, loader)
    t = DEMTrainer(*loaders, train_cfg=config.TrainConfig(), device="cpu")
    assert t.train_cfg.checkpoint_metric == "chamfer"
    with pytest.raises(ValueError, match="checkpoint_metric"):
        DEMTrainer(*loaders, train_cfg=config.TrainConfig(checkpoint_metric="success_rate"),
                   device="cpu")
    from scream_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="bound to a running world"):
        DEMTrainer(*loaders, device="cpu", mesh=make_mesh(n_data=2))
    # The GAN sample dump is ported: the directory is taken, not refused.
    assert RegistrationTrainer(*loaders, device="cpu",
                               sample_img_dir=str(tmp_path)).sample_img_dir == str(tmp_path)


TINY = ["--device", "cpu", "--max-points", "256", "--d-model", "128", "--self-layers", "1",
        "--cross-layers", "1"]


def run_cli(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"  # as one_torch_thread
    proc = subprocess.run([sys.executable, "-m", "scream_tpu_torch", *args],
                          capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout, json.loads(proc.stdout.strip().splitlines()[-1])["final_val"]


def test_train_cli_opengf_and_resume(tmp_path, capsys):
    """``python -m scream_tpu_torch train`` in a subprocess, then its
    ``--resume`` in this process."""
    ck = str(tmp_path / "ck")
    out, final = run_cli(["train", "opengf", *TINY, "--epochs", "2", "--checkpoint-dir", ck])
    assert set(final) == {"chamfer", "height_mae"}
    assert all(math.isfinite(v) for v in final.values())
    assert "epoch 1" in out and "resuming" not in out
    cfg, _, _ = load_params(os.path.join(ck, "best"))
    assert cfg.d_model == 128 and cfg.separate_stems
    cli_main(["train", "opengf", *TINY, "--epochs", "3", "--resume", "--checkpoint-dir", ck])
    out = capsys.readouterr().out
    assert "resuming at epoch 2 (restored step 4)" in out and "epoch 2" in out
    final = json.loads(out.strip().splitlines()[-1])["final_val"]
    assert set(final) == {"chamfer", "height_mae"}


def test_train_cli_3dmatch_in_process(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    cli_main(["train", "3dmatch", *TINY, "--epochs", "2", "--batch-size", "4",
              "--synthetic-pairs", "8", "--checkpoint-dir", ck])
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["final_val"]
    assert set(final) == {"point_loss", "rre", "rte", "success_rate", "success_rre",
                          "success_rte"}
    # Warm start from the best weights: a fresh optimizer, epoch 1 again.
    cli_main(["train", "3dmatch", *TINY, "--epochs", "2", "--batch-size", "4",
              "--synthetic-pairs", "8", "--init-params", os.path.join(ck, "best"),
              "--checkpoint-dir", str(tmp_path / "ck2")])
    out = capsys.readouterr()
    assert "initialized generator params" in out.err and "epoch 1" in out.out


# The mesh specs the JAX command refuses, with its messages.
MESH_REFUSALS = {"data=2,expert=2": "unknown mesh axes", "8": "axis=N",
                 "seq=2,pipe=2": "pipe= composes with data= only"}


@pytest.mark.parametrize("flag", [["--mesh", "data=2,expert=2"], ["--multi-scale", "--mesh", "8"],
                                  ["--sample-img-dir", "imgs", "--mesh", "seq=2,pipe=2"]])
def test_train_cli_refuses_unported_flags(flag):
    with pytest.raises(SystemExit, match=MESH_REFUSALS[flag[-1]]):
        cli_main(["train", "kitti", *TINY, *flag])


def test_presets_equal_jax():
    for task in ("threedmatch", "kitti", "opengf"):
        mine = getattr(config, f"{task}_presets")()
        theirs = getattr(jconfig, f"{task}_presets")()
        for a, b in zip(mine, theirs):
            fa = {f.name for f in dataclasses.fields(a)}
            assert fa == {f.name for f in dataclasses.fields(b)}, type(a).__name__
            for name in fa:
                assert getattr(a, name) == getattr(b, name), (task, type(a).__name__, name)
    for protocol in ("3dmatch", "3dlomatch", "3dzeromatch", "kitti", "opengf"):
        assert dataclasses.asdict(config.eval_preset(protocol)) == dataclasses.asdict(
            jconfig.eval_preset(protocol))
    with pytest.raises(ValueError, match="protocol"):
        config.eval_preset("eth")
    for mine, theirs in ((config.DataConfig(), jconfig.DataConfig()),
                         (config.EvalConfig(), jconfig.EvalConfig()),
                         (config.TrainConfig(), jconfig.TrainConfig())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def test_logging_and_profiling_utils(tmp_path, capsys):
    from scream_tpu.utils import logging as jlogging
    from scream_tpu_torch.utils import logging as tlogging
    from scream_tpu_torch.utils.profiling import ThroughputMeter, annotate, trace

    path = str(tmp_path / "m.jsonl")
    log = tlogging.MetricsLogger(path, print_every=3)
    log.log(7, {"loss": torch.tensor(0.5)}, prefix="val")
    log.close()
    with open(path) as f:
        assert json.loads(f.read()) == {"step": 7, "prefix": "val", "loss": 0.5}
    assert "val step 7  loss: 0.50000" in capsys.readouterr().err
    assert tlogging.progressbar(3, 12) == jlogging.progressbar(3, 12)
    timer = tlogging.StepTimer(warmup=1)
    for _ in range(4):
        timer.tick()
    assert len(timer.times) == 2 and timer.mean >= 0.0
    meter = ThroughputMeter(warmup_steps=1)
    assert math.isnan(meter.items_per_sec)
    for _ in range(4):
        meter.step(8)
    assert meter.items_per_sec > 0 and meter.summary()["steps"] == 4.0
    with trace(str(tmp_path / "prof")):
        with annotate("matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "matmul" in f.read()
    with trace(None):
        pass
