"""The port's GT-free serving against the JAX package on the CPU, in fp32:
``register_pair``, ``register_pairs`` and ``register_pair_robust`` with a
small random model and with the shipped hint-free checkpoint (converted
weights), their helpers, the torch checkpoint (bit-identical to the orbax
one converted), ``load_cloud_any``, and the ``register`` CLI in a
subprocess on the CPU.

Bars (the repository's ICP trajectory bars, the whole pipeline ending in ICP):
transforms within 2e-2 per entry, fitness and inlier RMSE within 2e-2,
``n_corr`` within 2 % (at least 1) of the JAX count, ``score_margin``
within 2e-2 and ``ambiguous`` equal. ``n_corr`` is not held exactly: one
threshold-boundary point of the pose solve may flip under another fp32
summation order in the forward, and with ``passes >= 2`` it comes from the
pass the fitness gate keeps, and that gate can tie within one ICP inlier,
where either pass is a right answer (their transforms and fitness agree
within the bars above). Both sides run fp32 (JAX's CPU
backend cannot run the bf16 dots); the port's fp32 blocks run the plain
body on CPU tensors.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scream_tpu.config import ModelConfig as JModelConfig
from scream_tpu.data import las as jlas
from scream_tpu.data import ply as jply
from scream_tpu.data.synthetic import make_pair
from scream_tpu.models.point_transformer import PointTransformer as JPointTransformer
from scream_tpu.pipeline import register as jreg
from scream_tpu.utils.checkpoint import load_params as jload_params
from scream_tpu_torch.config import ModelConfig
from scream_tpu_torch.data import las as tlas
from scream_tpu_torch.data import ply as tply
from scream_tpu_torch.models import PointTransformer
from scream_tpu_torch.pipeline import register as treg
from scream_tpu_torch.utils import checkpoint as tckpt
from scream_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HINTFREE_ORBAX = os.path.join(REPO, "params", "point-generator-hintfree")
HINTFREE_TORCH = os.path.join(REPO, "scream_tpu_torch", "weights",
                              "point-generator-hintfree")
TOL = 2e-2


def _models(kind):
    """(jax apply_fn, jax params, port model), same fp32 weights."""
    if kind == "random":
        fields = dict(d_model=64, num_heads=4, self_layers=1, cross_layers=1)
    else:
        with open(os.path.join(HINTFREE_ORBAX, "model_config.json")) as f:
            fields = {k: v for k, v in json.load(f).items() if k != "normalize"}
    jm = JPointTransformer(JModelConfig(dtype="float32", **fields))
    z = jnp.zeros((1, 8, 3), jnp.float32)
    params = jm.init(jax.random.PRNGKey(3), z, z, jnp.ones((1, 8), bool),
                     jnp.ones((1, 8), bool), jnp.zeros((1, 1, 3)))["params"]
    if kind == "hintfree":
        params = jload_params(HINTFREE_ORBAX, params)
    tm = PointTransformer(ModelConfig(dtype="float32", **fields), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))

    def apply_fn(p, s, t, sm, tm_, c):
        return jm.apply({"params": p}, s, t, sm, tm_, c)

    return apply_fn, params, tm


@pytest.fixture(scope="module")
def hintfree():
    return _models("hintfree")


@pytest.fixture(scope="module")
def random_model():
    return _models("random")


def _pairs(n, points, seed=100, max_angle_deg=30.0):
    rng = np.random.default_rng(seed)
    return [make_pair(rng, n_src=points, n_tgt=points - 7, overlap=0.7, noise=0.0,
                      max_angle=np.deg2rad(max_angle_deg)) for _ in range(n)]


def _assert_same(got, want, robust=False):
    np.testing.assert_allclose(got.transform, want.transform, atol=TOL, rtol=0)
    assert abs(got.fitness - want.fitness) <= TOL
    assert abs(got.inlier_rmse - want.inlier_rmse) <= TOL
    assert abs(got.n_corr - want.n_corr) <= max(1, TOL * want.n_corr), \
        (got.n_corr, want.n_corr)
    assert np.isfinite(got.transform).all()
    if robust:
        assert abs(got.score_margin - want.score_margin) <= TOL
        assert got.ambiguous == want.ambiguous
        assert abs(got.runner_up_fitness - want.runner_up_fitness) <= TOL


class TestHelpers:
    @pytest.mark.parametrize("n", [1, 256, 257, 4000, 16384, 16385, 20000])
    def test_default_capacity(self, n):
        assert treg._default_capacity(n) == jreg._default_capacity(n)

    @pytest.mark.parametrize("mode", ["unit_sphere", "unit_cube"])
    def test_normalize_union(self, rng, mode):
        a = rng.standard_normal((50, 3)).astype(np.float32) * 3 + 1
        b = rng.standard_normal((40, 3)).astype(np.float32)
        (gc, gs), (wc, ws) = treg._normalize_union(a, b, mode), jreg._normalize_union(a, b, mode)
        np.testing.assert_array_equal(gc, wc)
        assert gs == ws and gs.dtype == ws.dtype

    def test_unknown_normalize_raises(self, rng):
        a = rng.standard_normal((5, 3)).astype(np.float32)
        with pytest.raises(ValueError):
            treg._normalize_union(a, a, "unit_ball")

    @pytest.mark.parametrize("kind", ["axis7", "oct24", "ico60"])
    def test_rotation_starts(self, kind):
        got, want = treg._rotation_starts(kind), jreg._rotation_starts(kind)
        assert len(got) == len(want)
        np.testing.assert_array_equal(np.stack(got), np.stack(want))

    def test_passes_must_be_positive(self, random_model):
        p = _pairs(1, 40)[0]
        with pytest.raises(ValueError):
            treg.register_pair(random_model[2], p["src"], p["tgt"], passes=0,
                               device="cpu")
        with pytest.raises(ValueError):
            treg.register_pairs(random_model[2], [(p["src"], p["tgt"])], passes=0,
                                device="cpu")


class TestGTFreeAgainstJax:
    @pytest.mark.parametrize("passes", [1, 2])
    def test_register_pair_random_model(self, random_model, passes):
        apply_fn, params, tm = random_model
        for p in _pairs(2, 120, seed=5):
            want = jreg.register_pair(apply_fn, params, p["src"], p["tgt"], passes=passes)
            got = treg.register_pair(tm, p["src"], p["tgt"], passes=passes, device="cpu")
            _assert_same(got, want)

    def test_register_pair_hintfree(self, hintfree):
        apply_fn, params, tm = hintfree
        for p in _pairs(2, 448):
            want = jreg.register_pair(apply_fn, params, p["src"], p["tgt"], passes=2)
            got = treg.register_pair(tm, p["src"], p["tgt"], passes=2, device="cpu")
            _assert_same(got, want)

    @pytest.mark.parametrize("model,passes", [("random_model", 1), ("hintfree", 2)])
    def test_register_pairs(self, request, model, passes):
        """Pairs at batch 2 with a padded trailing batch; with passes=2 the
        per-pair gates, on the trained model (a random model's passes sit
        on the fitness gate's knife edge, where either side is right)."""
        apply_fn, params, tm = request.getfixturevalue(model)
        n = 5 if passes == 1 else 3
        pairs = [(p["src"], p["tgt"]) for p in _pairs(n, 200, seed=7)]
        want = jreg.register_pairs(apply_fn, params, pairs, batch_size=2, passes=passes)
        got = treg.register_pairs(tm, pairs, batch_size=2, passes=passes, device="cpu")
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            _assert_same(g, w)

    def test_register_pairs_matches_register_pair(self, random_model):
        """One pair through the batched path equals the single-pair path
        (batched vs unbatched ICP: the 2e-2 trajectory bar)."""
        tm = random_model[2]
        p = _pairs(1, 150, seed=9)[0]
        a = treg.register_pair(tm, p["src"], p["tgt"], passes=1, device="cpu")
        b = treg.register_pairs(tm, [(p["src"], p["tgt"])], passes=1, device="cpu")[0]
        _assert_same(a, b)

    def test_register_pair_robust_hintfree(self, hintfree):
        apply_fn, params, tm = hintfree
        p = _pairs(1, 200, seed=11, max_angle_deg=90.0)[0]
        want = jreg.register_pair_robust(apply_fn, params, p["src"], p["tgt"])
        got = treg.register_pair_robust(tm, p["src"], p["tgt"], device="cpu")
        _assert_same(got, want, robust=True)
        assert 0.0 <= got.score_margin <= 1.0

    def test_empty_inputs(self, random_model):
        assert treg.register_pairs(random_model[2], [], device="cpu") == []
        assert treg.register_pairs_robust(random_model[2], [], device="cpu") == []


class TestCheckpoint:
    def test_committed_weights_equal_converted_orbax(self):
        """``model.pt`` is ``params_from_jax`` of the orbax checkpoint, bit
        for bit, and its sidecar is the orbax one."""
        cfg, normalize, state = tckpt.load_params(HINTFREE_TORCH)
        with open(os.path.join(HINTFREE_ORBAX, "model_config.json")) as f:
            side = json.load(f)
        assert normalize == side.pop("normalize") == "unit_sphere"
        assert cfg == dataclasses.replace(ModelConfig(), **side)
        jm = JPointTransformer(dataclasses.replace(JModelConfig(), **side))
        z = jnp.zeros((1, 8, 3), jnp.float32)
        init = jm.init(jax.random.PRNGKey(0), z, z, jnp.ones((1, 8), bool),
                       jnp.ones((1, 8), bool), jnp.zeros((1, 1, 3)))["params"]
        want = params_from_jax(jax.tree_util.tree_map(
            np.asarray, jload_params(HINTFREE_ORBAX, init)))
        assert sorted(state) == sorted(want)
        for k in want:
            assert state[k].dtype == torch.float32
            assert torch.equal(state[k], want[k]), k
        PointTransformer(cfg, device="cpu").load_state_dict(state, strict=True)

    def test_save_load_roundtrip_and_missing(self, tmp_path):
        sd = {"a.kernel": torch.arange(6.0).reshape(2, 3)}
        tckpt.save_params(str(tmp_path), sd, {"d_model": 64, "normalize": "unit_cube"})
        cfg, normalize, got = tckpt.load_params(str(tmp_path))
        assert normalize == "unit_cube" and cfg.d_model == 64
        assert torch.equal(got["a.kernel"], sd["a.kernel"])
        with pytest.raises(FileNotFoundError):
            tckpt.load_params(str(tmp_path / "nothing"))


class TestReaders:
    @pytest.mark.parametrize("binary", [True, False])
    def test_ply_matches_jax(self, rng, tmp_path, binary):
        xyz = rng.uniform(-5, 5, (77, 3)).astype(np.float32)
        p = str(tmp_path / "c.ply")
        jply.write_ply(p, xyz, binary=binary)
        np.testing.assert_array_equal(tply.read_ply(p), jply.read_ply(p))
        q = str(tmp_path / "d.ply")
        tply.write_ply(q, xyz, binary=binary)
        assert open(p, "rb").read() == open(q, "rb").read()

    def test_load_cloud_any_matches_jax(self, rng, tmp_path):
        xyz = rng.uniform(-50, 50, (64, 3))
        cls = rng.integers(0, 3, 64).astype(np.uint8)
        paths = {ext: str(tmp_path / f"c.{ext}") for ext in ("npy", "ply", "las")}
        np.save(paths["npy"], xyz.astype(np.float32))
        jply.write_ply(paths["ply"], xyz)
        jlas.write_las(paths["las"], xyz, cls)
        tlas.write_las(str(tmp_path / "t.las"), xyz, cls)
        assert open(paths["las"], "rb").read() == open(str(tmp_path / "t.las"), "rb").read()
        for p in paths.values():
            got, want = tply.load_cloud_any(p), jply.load_cloud_any(p)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        x, c = tlas.read_las(paths["las"])
        np.testing.assert_array_equal(c, jlas.read_las(paths["las"])[1])

    def test_rejections(self, tmp_path):
        bad = tmp_path / "bad.las"
        bad.write_bytes(b"NOPE" + bytes(300))
        with pytest.raises(ValueError, match="not a LAS"):
            tply.load_cloud_any(str(bad))
        badp = tmp_path / "bad.ply"
        badp.write_bytes(b"nope\n")
        with pytest.raises(ValueError, match="not a PLY"):
            tply.load_cloud_any(str(badp))


class TestCLI:
    def _run(self, *args):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
        return subprocess.run([sys.executable, "-m", "scream_tpu_torch", "register",
                               *args], capture_output=True, text=True, timeout=300,
                              cwd=REPO, env=env)

    def test_register_pair_and_manifest_on_cpu(self, tmp_path):
        """The subprocess's JSON equals the in-process port result (same
        weights, same inputs) for --src/--tgt and --manifest; --out saves
        the transforms."""
        pairs = _pairs(2, 300, seed=13)
        paths = []
        for i, p in enumerate(pairs):
            s, t = str(tmp_path / f"s{i}.npy"), str(tmp_path / f"t{i}.ply")
            np.save(s, p["src"])
            tply.write_ply(t, p["tgt"])
            paths.append((s, t))
        cfg, normalize, state = tckpt.load_params(HINTFREE_TORCH)
        cfg = dataclasses.replace(cfg, dtype="float32")
        model = PointTransformer(cfg, device="cpu")
        model.load_state_dict(state)

        proc = self._run("--src", paths[0][0], "--tgt", paths[0][1], "--params",
                         HINTFREE_TORCH, "--dtype", "float32", "--device", "cpu",
                         "--out", str(tmp_path / "T.npy"))
        assert proc.returncode == 0, proc.stderr
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        ref = treg.register_pair(model, pairs[0]["src"], pairs[0]["tgt"],
                                 normalize=normalize, passes=2, device="cpu")
        np.testing.assert_allclose(np.asarray(out["transform"]), ref.transform, atol=1e-6)
        assert out["n_corr"] == ref.n_corr
        np.testing.assert_allclose(np.load(tmp_path / "T.npy"), ref.transform, atol=1e-6)

        manifest = tmp_path / "pairs.txt"
        manifest.write_text("".join(f"{s} {t}\n" for s, t in paths))
        proc = self._run("--manifest", str(manifest), "--params", HINTFREE_TORCH,
                         "--dtype", "float32", "--device", "cpu", "--passes", "1")
        assert proc.returncode == 0, proc.stderr
        lines = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
        ref = treg.register_pairs(model, [(p["src"], p["tgt"]) for p in pairs],
                                  normalize=normalize, device="cpu")
        assert [ln["pair"] for ln in lines] == [0, 1]
        for ln, r in zip(lines, ref):
            np.testing.assert_allclose(np.asarray(ln["transform"]), r.transform, atol=1e-6)

    def test_unported_modes_and_bad_args_exit(self, tmp_path):
        """Argument errors exit before any model is built (in-process)."""
        from scream_tpu_torch.cli import main

        s = str(tmp_path / "s.npy")
        np.save(s, np.zeros((5, 3), np.float32))
        for argv, msg in ((["--scans", s, s, "--mesh", "data=2"], "not ported"),
                          (["--src", s], "need --src and --tgt"),
                          (["--manifest", s, "--src", s], "exclusive")):
            with pytest.raises(SystemExit, match=msg):
                main(["register", *argv, "--device", "cpu"])
        np.save(s, np.zeros((5, 2), np.float32))
        with pytest.raises(SystemExit, match=r"expected an \(N, 3\)"):
            main(["register", "--src", s, "--tgt", s, "--device", "cpu"])
