"""The port's multiway registration against the JAX package on the CPU, in
fp32: the spanning-tree init, pose-graph synchronization, the scan-to-map
polish, ``register_multiway`` end to end, ``register_pairs_robust``'s lane
diagnostics, the ``register --scans`` CLI and the GT-free measurement script.

Bars: the spanning-tree init bit for bit (host numpy in both); the
synchronized poses within 1e-4 per entry (100 sweeps of fp32 SVD
projections, in another order of addition), the gauge exact; the error
contracts' exceptions and messages equal; ``refine_to_map`` and
``register_multiway`` within 2e-2 (they end in ICP: the repository's ICP
trajectory bar), the edges equal, edge fitness within 2e-2; the robust lanes'
fitness and transforms within 2e-2; the CLI's poses equal to the in-process
result within 1e-6; the measurement script's rows carry the JAX script's
keys and equal the numbers of the port's own calls on the same pairs.
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
from scipy.spatial.transform import Rotation

from scream_tpu.config import ModelConfig as JModelConfig
from scream_tpu.models.point_transformer import PointTransformer as JPointTransformer
from scream_tpu.pipeline import multiway as jmw
from scream_tpu.pipeline import register as jreg
from scream_tpu_torch.cli import main as cli_main
from scream_tpu_torch.config import ModelConfig
from scream_tpu_torch.models import PointTransformer
from scream_tpu_torch.pipeline import multiway as tmw
from scream_tpu_torch.pipeline import register as treg
from scream_tpu_torch.utils import checkpoint as tckpt
from scream_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HINTFREE_TORCH = os.path.join(REPO, "scream_tpu_torch", "weights", "point-generator-hintfree")
SYNC_TOL, TOL = 1e-4, 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(jax apply_fn, jax params, port model): the hint-free architecture
    (d 128, 8 heads of 16) cut to 1 + 1 layers, fp32, one JAX init
    converted into the port."""
    fields = dict(d_model=128, num_heads=8, self_layers=1, cross_layers=1)
    jm = JPointTransformer(JModelConfig(dtype="float32", **fields))
    z = jnp.zeros((1, 8, 3), jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(5), z, z, jnp.ones((1, 8), bool),
                              jnp.ones((1, 8), bool), jnp.zeros((1, 1, 3)))["params"]
    tm = PointTransformer(ModelConfig(dtype="float32", **fields), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    tm.eval()
    return (lambda p, s, t, sm, tm_, c: jm.apply({"params": p}, s, t, sm, tm_, c)), params, tm


# The graphs of tests/test_multiway.py.
def random_poses(rng, n, rot_scale=0.6, trans_scale=2.0):
    T = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = Rotation.from_rotvec(rng.normal(size=3) * rot_scale).as_matrix()
        M[:3, 3] = rng.normal(size=3) * trans_scale
        T.append(M)
    return T


def measurements(T, edges, rng=None, noise=0.0):
    rel = []
    for i, j in edges:
        M = np.linalg.inv(T[j]) @ T[i]  # T_i = T_j @ T_ij
        if noise:
            M[:3, :3] = Rotation.from_rotvec(rng.normal(size=3) * noise).as_matrix() @ M[:3, :3]
            M[:3, 3] += rng.normal(size=3) * noise
        rel.append(M.astype(np.float32))
    return np.stack(rel)


def errors(P, T):
    rot = [np.rad2deg(np.arccos(np.clip((np.trace(P[k][:3, :3] @ T[k][:3, :3].T) - 1) / 2,
                                        -1, 1))) for k in range(len(T))]
    return max(rot), max(np.linalg.norm(P[k][:3, 3] - T[k][:3, 3]) for k in range(len(T)))


def graph(case):
    """(n, edges, rel, weights) of the JAX tests' four synchronization cases."""
    if case == "exact":
        rng = np.random.default_rng(1)
        T = random_poses(rng, 7)
        edges = jmw.default_edges(7, window=2)
        return 7, edges, measurements(T, edges), None
    if case == "noisy":
        rng = np.random.default_rng(0)
        T = random_poses(rng, 8)
        edges = jmw.default_edges(8, window=2)
        return 8, edges, measurements(T, edges, rng=rng, noise=0.02), None
    if case == "zero_weight_edge":
        rng = np.random.default_rng(3)
        T = random_poses(rng, 5)
        edges = jmw.default_edges(5, window=1) + [(0, 4)]
        rel = measurements(T, edges)
        rel[-1] = np.eye(4, dtype=np.float32)  # a garbage loop closure
        w = np.ones(len(edges), np.float32)
        w[-1] = 0.0
        return 5, edges, rel, w
    rng = np.random.default_rng(7)  # a node whose only edge weighs 0
    T = random_poses(rng, 4)
    edges = jmw.default_edges(4, window=1)
    w = np.ones(len(edges), np.float32)
    w[-1] = 0.0
    return 4, edges, measurements(T, edges), w


def scans_of(seed, n, n_scene, n_scan, rot_scale, trans_scale):
    """N views (70-ish % subsets) of one uniform scene, each in its own frame."""
    rng = np.random.default_rng(seed)
    scene = rng.uniform(-1, 1, (n_scene, 3)).astype(np.float32)
    T_gt = random_poses(rng, n, rot_scale=rot_scale, trans_scale=trans_scale)
    scans = []
    for k in range(n):
        inv = np.linalg.inv(T_gt[k])
        pts = scene[rng.choice(n_scene, n_scan, replace=False)]
        scans.append((pts @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32))
    return scans, T_gt, rng


class TestSynchronize:
    @pytest.mark.parametrize("case", ["exact", "noisy", "zero_weight_edge", "zero_weight_node"])
    def test_spanning_tree_init_bit_for_bit(self, case):
        n, edges, rel, _ = graph(case)
        assert np.array_equal(tmw._spanning_tree_init(n, edges, rel),
                              jmw._spanning_tree_init(n, edges, rel))

    @pytest.mark.parametrize("case", ["exact", "noisy", "zero_weight_edge", "zero_weight_node"])
    def test_matches_jax(self, case):
        n, edges, rel, w = graph(case)
        got = tmw.synchronize_poses(n, edges, rel, weights=w, device="cpu")
        want = jmw.synchronize_poses(n, edges, rel, weights=w)
        np.testing.assert_allclose(got, want, atol=SYNC_TOL, rtol=0)
        assert np.array_equal(got[0], np.eye(4, dtype=np.float32))

    @pytest.mark.parametrize("args,match", [
        ((4, [(0, 1), (2, 3)], np.stack([np.eye(4, dtype=np.float32)] * 2)), "disconnected"),
        ((3, [], np.zeros((0, 4, 4), np.float32)), "disconnected"),
        ((3, [(0, 1)], np.stack([np.eye(4, dtype=np.float32)] * 2)), "transforms"),
        ((3, [(0, 1), (1, 2)], np.stack([np.eye(4, dtype=np.float32)] * 2),
          np.ones(3, np.float32)), "weights"),
    ])
    def test_error_contracts(self, args, match):
        with pytest.raises(ValueError, match=match) as want:
            jmw.synchronize_poses(*args)
        with pytest.raises(ValueError, match=match) as got:
            tmw.synchronize_poses(*args, device="cpu")
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("n", [0, 1])
    def test_trivial_sizes(self, n):
        got = tmw.synchronize_poses(n, [], np.zeros((0, 4, 4), np.float32), device="cpu")
        want = jmw.synchronize_poses(n, [], np.zeros((0, 4, 4), np.float32))
        assert got.shape == want.shape == (n, 4, 4) and np.array_equal(got, want)

    @pytest.mark.parametrize("n,window", [(1, 2), (2, 1), (7, 2), (6, 3)])
    def test_default_edges(self, n, window):
        assert tmw.default_edges(n, window) == jmw.default_edges(n, window)


class TestRefineToMap:
    def test_matches_jax(self):
        """The JAX tests' scan-to-map scene: perturbed poses, two rounds."""
        scans, T_gt, rng = scans_of(9, 4, 500, 350, rot_scale=0.1, trans_scale=0.1)
        noisy = np.stack(T_gt).copy()
        for k in range(1, 4):
            noisy[k, :3, :3] = Rotation.from_rotvec(
                rng.normal(size=3) * 0.03).as_matrix() @ noisy[k, :3, :3]
            noisy[k, :3, 3] += rng.normal(size=3) * 0.03
        got = tmw.refine_to_map(scans, noisy, icp_thresh=0.3, rounds=2, device="cpu")
        want = jmw.refine_to_map(scans, noisy, icp_thresh=0.3, rounds=2)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        assert np.array_equal(got[0], noisy[0])  # the gauge is never moved
        (b_rot, b_tr), (a_rot, a_tr) = errors(noisy, T_gt), errors(got, T_gt)
        assert a_rot < 0.75 * b_rot and a_tr < 0.75 * b_tr

    def test_baseline_measures_without_update(self):
        """``refine_to_map``'s baseline: ``registration_icp`` at
        ``max_iteration=0`` returns the init and the fitness measured there,
        as JAX's does."""
        from scream_tpu.geometry import icp as jicp
        from scream_tpu_torch.geometry import icp as ticp

        scans, T_gt, _ = scans_of(9, 2, 500, 350, rot_scale=0.1, trans_scale=0.1)
        init = np.linalg.inv(T_gt[1]) @ T_gt[0]
        init[:3, 3] += 0.02
        init = init.astype(np.float32)
        got = ticp.registration_icp(torch.as_tensor(scans[0]), torch.as_tensor(scans[1]), 0.3,
                                    init=torch.as_tensor(init), max_iteration=0)
        want = jicp.registration_icp(jnp.asarray(scans[0]), jnp.asarray(scans[1]), 0.3,
                                     init=jnp.asarray(init), max_iteration=0)
        np.testing.assert_array_equal(got.transformation.numpy(), init)
        assert int(got.iterations) == int(want.iterations) == 0
        assert abs(float(got.fitness) - float(want.fitness)) <= 1e-6
        assert 0.0 < float(got.fitness) < 1.0

    def test_noop_cases(self):
        P = np.eye(4, dtype=np.float32)[None]
        for rounds in (1, 0):
            got = tmw.refine_to_map([np.zeros((4, 3), np.float32)], P, 0.1, rounds=rounds,
                                    device="cpu")
            np.testing.assert_array_equal(got, P)


class TestRegisterMultiway:
    def test_matches_jax(self, model):
        """Four views of one scene through pairwise serving (5 edges at batch
        4, the trailing batch padded), synchronization and one scan-to-map
        round, in both packages from one init."""
        apply_fn, params, tm = model
        scans, T_gt, _ = scans_of(5, 4, 400, 300, rot_scale=0.06, trans_scale=0.05)
        kw = dict(capacity=512, batch_size=4, icp_max_iter=30, icp_thresh=0.3,
                  dis_thresh=10.0, refine_rounds=1)
        want = jmw.register_multiway(apply_fn, params, scans, **kw)
        got = tmw.register_multiway(tm, scans, device="cpu", **kw)
        assert got.edges == want.edges == jmw.default_edges(4)
        np.testing.assert_allclose(got.edge_fitness, want.edge_fitness, atol=TOL, rtol=0)
        np.testing.assert_allclose(got.poses, want.poses, atol=TOL, rtol=0)
        assert np.array_equal(got.poses[0], np.eye(4, dtype=np.float32))
        assert np.isfinite(got.poses).all()

    def test_contracts(self):
        with pytest.raises(ValueError, match="bad edge"):
            tmw.register_multiway(None, [np.zeros((4, 3))] * 2, edges=[(0, 2)], device="cpu")
        assert tmw.register_multiway(None, [], device="cpu").poses.shape == (0, 4, 4)
        one = tmw.register_multiway(None, [np.zeros((4, 3), np.float32)], device="cpu")
        np.testing.assert_array_equal(one.poses, np.eye(4)[None])
        assert one.edges == [] and one.edge_fitness.shape == (0,)
        with pytest.raises(ValueError, match="no edges"):
            tmw.register_multiway(None, [np.zeros((4, 3), np.float32)] * 2, edges=[],
                                  device="cpu")


def test_robust_lanes_match_jax(model):
    """``register_pairs_robust(return_lanes=True)``: every candidate lane's
    post-polish fitness and transform, and the same results as without the
    lanes."""
    from scream_tpu.data.synthetic import make_pair

    apply_fn, params, tm = model
    p = make_pair(np.random.default_rng(11), n_src=200, n_tgt=193, overlap=0.7,
                  max_angle=np.deg2rad(90.0))
    pairs = [(p["src"], p["tgt"])]
    want, want_lanes = jreg.register_pairs_robust(apply_fn, params, pairs, return_lanes=True)
    got, got_lanes = treg.register_pairs_robust(tm, pairs, return_lanes=True, device="cpu")
    assert len(got_lanes) == len(want_lanes) == 1
    assert len(got_lanes[0]) == len(want_lanes[0]) == 14  # axis7: model + raw lanes
    for (gf, gT), (wf, wT) in zip(got_lanes[0], want_lanes[0]):
        assert abs(gf - wf) <= TOL
        np.testing.assert_allclose(gT, np.asarray(wT), atol=TOL, rtol=0)
    plain = treg.register_pairs_robust(tm, pairs, device="cpu")
    np.testing.assert_array_equal(plain[0].transform, got[0].transform)
    np.testing.assert_allclose(got[0].transform, want[0].transform, atol=TOL, rtol=0)


class TestScansCLI:
    def test_rows_and_out(self, tmp_path, capsys):
        """``register --scans``: one JSON line a scan with its pose, the edge
        summary on stderr, ``--out`` the (N, 4, 4) stack; equal to the
        in-process ``register_multiway`` with the same model."""
        scans, _, _ = scans_of(5, 4, 400, 300, rot_scale=0.06, trans_scale=0.05)
        paths = []
        for k, s in enumerate(scans):
            paths.append(str(tmp_path / f"s{k}.npy"))
            np.save(paths[-1], s)
        out = str(tmp_path / "P.npy")
        with torch.enable_grad():  # the command turns autograd off for its process
            cli_main(["register", "--scans", *paths, "--params", HINTFREE_TORCH, "--dtype",
                      "float32", "--device", "cpu", "--refine-rounds", "1", "--window", "2",
                      "--passes", "1", "--out", out])
        cap = capsys.readouterr()
        lines = [json.loads(ln) for ln in cap.out.strip().splitlines()]
        assert [ln["scan"] for ln in lines] == [0, 1, 2, 3]
        assert "5 pairwise edges, fitness min/median" in cap.err
        cfg, normalize, state = tckpt.load_params(HINTFREE_TORCH)
        m = PointTransformer(dataclasses.replace(cfg, dtype="float32"), device="cpu")
        m.load_state_dict(state)
        m.eval()
        ref = tmw.register_multiway(m, scans, edges=tmw.default_edges(4, 2), refine_rounds=1,
                                    normalize=normalize, passes=1, device="cpu")
        poses = np.stack([np.asarray(ln["pose"], np.float32) for ln in lines])
        np.testing.assert_allclose(poses, ref.poses, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(np.load(out), ref.poses)
        np.testing.assert_array_equal(np.load(out)[0], np.eye(4))

    @pytest.mark.parametrize("extra,msg", [
        (["--robust"], "--robust is a single-pair search"),
        (["--src", "S"], "exclusive with --src/--tgt/--manifest"),
        (["--window", "0"], "--window must be >= 1, got 0"),
        (["--mesh", "data=2"], "not ported"),
    ])
    def test_validation_errors(self, tmp_path, extra, msg):
        """The JAX command's messages, before any model is built."""
        s = str(tmp_path / "s.npy")
        np.save(s, np.zeros((5, 3), np.float32))
        extra = [s if a == "S" else a for a in extra]
        with pytest.raises(SystemExit, match=msg):
            cli_main(["register", "--scans", s, s, *extra, "--device", "cpu"])

    def test_needs_two_scans(self, tmp_path):
        s = str(tmp_path / "s.npy")
        np.save(s, np.zeros((5, 3), np.float32))
        with pytest.raises(SystemExit, match="--scans needs at least two clouds"):
            cli_main(["register", "--scans", s, "--device", "cpu"])


def test_measure_gt_free_rows(capsys):
    """The port's measurement script on 2 fresh pairs (the shipped hint-free
    weights, fp32 as the JAX script runs them): one pass and the robust
    path, one printed row each, with the JAX script's keys; the one-pass
    transforms equal the port's own ``register_pair`` on the same pairs, and
    every row's numbers follow from the script's transforms."""
    from scream_tpu_torch.data.synthetic import make_pair
    from scream_tpu_torch.geometry.metrics import transformation_error

    spec = importlib.util.spec_from_file_location(
        "torch_port_measure_gt_free",
        os.path.join(REPO, "scripts", "torch_port_measure_gt_free.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    rows, transforms = script.run(["--pairs", "2", "--points", "256", "--passes", "1", "0",
                                   "--max-angle-deg", "90", "--device", "cpu"])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert printed == [rows[1], rows[0]]
    keys = {"passes", "starts", "median_re_deg", "median_te", "recall_re15_te0.3",
            "mean_fitness", "wall_s"}  # scripts/measure_gt_free.py's rows
    assert set(rows[1]) == keys and rows[1]["starts"] is None
    assert set(rows[0]) == keys | {"margin_succ_min", "margin_succ_q", "margin_fail_max",
                                   "margins_failed", "ambiguous_frac"}
    assert rows[0]["starts"] == "axis7"

    cfg, normalize, state = tckpt.load_params(HINTFREE_TORCH)
    m = PointTransformer(dataclasses.replace(cfg, dtype="float32"), device="cpu")
    m.load_state_dict(state)
    m.eval()
    rng = np.random.default_rng(100)
    pairs = [make_pair(rng, n_src=256, n_tgt=256, overlap=0.7, noise=0.0,
                       max_angle=np.deg2rad(90.0)) for _ in range(2)]
    out = [treg.register_pair(m, p["src"], p["tgt"], normalize=normalize, passes=1,
                              device="cpu") for p in pairs]
    np.testing.assert_array_equal(transforms[1], np.stack([o.transform for o in out]))
    assert rows[1]["mean_fitness"] == round(float(np.mean([o.fitness for o in out])), 3)
    for passes in (1, 0):
        gt = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
        for k, p in enumerate(pairs):
            gt[k, :3, :3], gt[k, :3, 3] = p["rot"], p["trans"].reshape(3)
        re, te = (x.numpy() for x in transformation_error(
            torch.as_tensor(transforms[passes]), torch.as_tensor(gt)))
        row = rows[passes]
        assert row["median_re_deg"] == round(float(np.median(re)), 2)
        assert row["median_te"] == round(float(np.median(te)), 4)
        assert row["recall_re15_te0.3"] == round(float(np.mean((re <= 15) & (te <= 0.3))), 3)
    assert 0.0 <= rows[0]["mean_fitness"] <= 1.0 and 0.0 <= rows[0]["ambiguous_frac"] <= 1.0
