"""The user-facing multi-GPU path of the port: the trainers' ``mesh=`` on a
gloo world of 4 CPU ranks and ``--mesh`` on the ``train``, ``evaluate`` and
``register`` commands, against the port's single process and the JAX
package's same modes on its 8-device virtual CPU mesh.

One world runs every trainer case once (``torch_parallel_cases.run_trainers``),
each from the JAX trainer's init (``utils/convert.py``): one epoch of
* DP (data 4) and TP (data 2 x model 2): the parameters within 1e-5 of the
  single process, the epoch's losses within 1e-4 of the JAX trainers'
  (data 8; data 2 x model 4; the existing trainer bar), validation equal to
  the single process's and its point loss within 1e-4 of JAX's;
* the trailing partial batch (22 pairs in batches of 8: 6 do not divide 4
  ranks and run whole on each), against both;
* the GAN (data 4): the generator's parameters and the discriminator's
  BatchNorm running averages within 1e-5 of the single process's and of
  the JAX GAN trainer's under its mesh;
* data x seq (the fused kernels off, finite) and data x pipe (against the
  single process, 1e-5).
The commands with ``--mesh data=2 --device cpu`` print what they print
without it (the JAX test asserts ``n_pairs``).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from scream_tpu.config import EvalConfig as JEvalConfig
from scream_tpu.config import ModelConfig as JModelConfig
from scream_tpu.config import RenderConfig as JRenderConfig
from scream_tpu.config import TrainConfig as JTrainConfig
from scream_tpu.data import PairLoader as JPairLoader
from scream_tpu.data import SyntheticPairDataset as JSynthetic
from scream_tpu.parallel import make_mesh as j_make_mesh
from scream_tpu.train import RegistrationTrainer as JRegistrationTrainer
from scream_tpu_torch.parallel import launch
from scream_tpu_torch.utils.convert import discriminator_from_jax, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def jax_trainer(mesh, n_pairs=16, use_gan=False):
    """The JAX tests' tiny trainer (``tests/test_parallel_trainer.py``)."""
    n = 48 if use_gan else 64
    ds = JSynthetic(length=n_pairs, n_src=n, n_tgt=n, seed=5 if use_gan else 11)
    mk = lambda: JPairLoader(ds, batch_size=8, src_capacity=n, shuffle=False, num_workers=0)
    tr = JRegistrationTrainer(
        mk(), mk(), model_cfg=JModelConfig(**cases.TINY),
        train_cfg=JTrainConfig(batch_size=8, epochs=3, use_gan=use_gan, log_every=1000),
        eval_cfg=JEvalConfig(icp_max_iter=3),
        render_cfg=JRenderConfig(rho=6.0, width=32, multi_view=False), mesh=mesh)
    tr.init()
    return tr


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trainers' first epochs on their meshes (one init each)."""
    out = {}
    for key, mesh, kw in (("dp", j_make_mesh(n_data=8), {}),
                          ("tp", j_make_mesh(n_data=2, n_seq=1, n_model=4), {}),
                          ("partial", j_make_mesh(n_data=8), {"n_pairs": 22}),
                          ("gan", j_make_mesh(n_data=8), {"use_gan": True, "n_pairs": 8})):
        jt = jax_trainer(mesh, **kw)
        init = dict(state=params_from_jax(np_tree(jt.state.params)))
        if kw.get("use_gan"):
            init["disc_state"] = discriminator_from_jax(np_tree(jt.disc_state.variables))
        train = {k: float(v) for k, v in jt.train_epoch(1).items()}
        res = dict(init=init, train=train)
        if key == "gan":
            res["disc"] = discriminator_from_jax(np_tree(jt.disc_state.variables))
        else:
            res["val"] = jt.evaluate()
        out[key] = res
    return out


@pytest.fixture(scope="module")
def world(jax_runs, tmp_path_factory):
    d = tmp_path_factory.mktemp("trainers")
    inp = dict(state=jax_runs["dp"]["init"]["state"],
               gan_state=jax_runs["gan"]["init"]["state"],
               disc_state=jax_runs["gan"]["init"]["disc_state"])
    torch.save(inp, d / "in.pt")
    launch(cases.run_trainers, {"data": 4}, "cpu",
           args=(str(d / "in.pt"), str(d / "out.pt")))
    return torch.load(d / "out.pt", weights_only=False)


def single(state, **kw):
    return cases.trainer_result(cases.tiny_trainer(state, **kw))


def assert_params(got, want, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), atol=atol, rtol=0,
                                   err_msg=k)


def assert_rel(got, want, tol, keys):
    for k in keys:
        assert abs(got[k] - want[k]) <= tol * max(abs(want[k]), 1e-3), (k, got[k], want[k])


@pytest.mark.parametrize("key", ["dp", "tp", "partial"])
def test_epoch_matches_single_and_jax(world, jax_runs, key):
    """One epoch over the mesh: the single process's parameters (1e-5) and
    validation; the JAX trainer's losses (1e-4)."""
    got = world[key]
    kw = {"n_pairs": 22} if key == "partial" else {}
    want = single(jax_runs[key]["init"]["state"], **kw)
    assert_params(got["params"], want["params"], 1e-5)
    assert_rel(got["train"], want["train"], 1e-5, ("point_loss", "loss"))
    assert_rel(got["val"], want["val"], 1e-5, want["val"])
    assert_rel(got["train"], jax_runs[key]["train"], 1e-4, ("point_loss", "loss"))
    assert_rel(got["val"], jax_runs[key]["val"], 1e-4, ("point_loss",))


def test_gan_under_mesh(world, jax_runs):
    """The discriminator's BatchNorm takes the global batch's statistics:
    its running averages match the single process's and the JAX trainer's
    under its mesh (1e-5)."""
    got = world["gan"]
    init = jax_runs["gan"]["init"]
    want = single(init["state"], n_pairs=8, use_gan=True, disc_state=init["disc_state"])
    stats = [k for k in want["disc"] if "running" in k]
    assert stats
    assert_params({k: got["disc"][k] for k in stats}, {k: want["disc"][k] for k in stats},
                  1e-5)
    assert_params(got["params"], want["params"], 1e-5)
    for k in stats:
        np.testing.assert_allclose(got["disc"][k], jax_runs["gan"]["disc"][k].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    assert_rel(got["train"], jax_runs["gan"]["train"], 1e-4, ("point_loss",))
    assert all(np.isfinite(got["train"][k]) for k in ("g_loss", "d_loss"))


def test_seq_and_pipe_meshes(world, jax_runs):
    assert world["sp"]["fused"] == (False, False)
    assert np.isfinite(world["sp"]["train"]["point_loss"])
    got = world["pp"]
    want = single(jax_runs["dp"]["init"]["state"])
    assert_params(got["params"], want["params"], 1e-5)
    assert_rel(got["train"], want["train"], 1e-5, ("point_loss",))


def test_pipe_mesh_refuses_the_gan():
    from scream_tpu_torch.parallel import Mesh
    from scream_tpu_torch.train import RegistrationTrainer

    mesh = Mesh({"data": 1, "pipe": 2})
    mesh.device_mesh = object()  # bound for the constructor's checks
    with pytest.raises(ValueError, match="pipe=N does not combine with GAN"):
        RegistrationTrainer([], [], train_cfg=cases.TrainConfig(use_gan=True), mesh=mesh,
                            device="cpu")


TINY_FLAGS = ["--device", "cpu", "--d-model", "32", "--self-layers", "1",
              "--cross-layers", "1", "--dtype", "float32"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The three commands with and without ``--mesh data=2``, all at once."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(6):
        s = rng.standard_normal((200, 3)).astype(np.float32)
        np.save(d / f"s{i}.npy", s)
        np.save(d / f"t{i}.npy", s @ np.eye(3, dtype=np.float32) + 0.02)
        lines.append(f"{d / f's{i}.npy'} {d / f't{i}.npy'}")
    (d / "pairs.txt").write_text("\n".join(lines) + "\n")
    cmds = {
        "train": ["train", "3dmatch", "--root", str(d / "none"), "--epochs", "2",
                  "--max-points", "128", "--synthetic-pairs", "16"],
        "evaluate": ["evaluate", "3dzeromatch", "--root", str(d / "none"), "--batch-size",
                     "8", "--icp-max-iter", "3", "--max-points", "256"],
        "register": ["register", "--manifest", str(d / "pairs.txt"), "--batch-size", "4"],
    }
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = {}
    for name, args in cmds.items():
        for mesh in (None, "data=2"):
            extra = ["--checkpoint-dir", str(d / f"ck_{name}_{mesh}")] if name == "train" else []
            if name == "train" and mesh is None:
                extra += ["--batch-size", "16"]  # the mesh's default, 8 a data rank
            flags = TINY_FLAGS + extra + (["--mesh", mesh] if mesh else [])
            procs[name, mesh] = subprocess.Popen(
                [sys.executable, "-m", "scream_tpu_torch", *args, *flags], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for key, p in procs.items():
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, (key, se[-3000:])
        out[key] = [ln for ln in so.splitlines() if ln.startswith("{")]
    return out


@pytest.mark.parametrize("command", ["train", "evaluate", "register"])
def test_cli_mesh_equals_single_process(cli_runs, command):
    single, mesh = cli_runs[command, None], cli_runs[command, "data=2"]
    assert len(single) == len(mesh) >= 1
    if command == "register":
        assert len(mesh) == 6
        for a, b in zip(single, mesh):
            a, b = json.loads(a), json.loads(b)
            np.testing.assert_allclose(b["transform"], a["transform"], atol=1e-5)
            assert a["pair"] == b["pair"] and a["n_corr"] == b["n_corr"]
        return
    a, b = json.loads(single[-1]), json.loads(mesh[-1])
    if command == "evaluate":
        assert a["n_pairs"] == b["n_pairs"] == 16
        assert a == b
    else:
        assert a["final_val"].keys() == b["final_val"].keys()
        for k, v in a["final_val"].items():
            assert b["final_val"][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


def test_cli_mesh_refusals(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    a = np.zeros((10, 3), np.float32)
    np.save(tmp_path / "a.npy", a)
    for args, msg in (
            (["--src", str(tmp_path / "a.npy"), "--tgt", str(tmp_path / "a.npy"),
              "--mesh", "data=2"], "--mesh shards the batched manifest/scans paths only"),
            (["--scans", str(tmp_path / "a.npy"), str(tmp_path / "a.npy"), "--mesh",
              "data=2,expert=2"], "unknown mesh axes"),
            (["--scans", str(tmp_path / "a.npy"), str(tmp_path / "a.npy"), "--mesh", "data=3",
              "--batch-size", "8"], "must divide by the mesh data axis")):
        p = subprocess.run([sys.executable, "-m", "scream_tpu_torch", "register", *args,
                            "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=120)
        assert p.returncode != 0 and msg in p.stderr, (args, p.stderr[-2000:])
