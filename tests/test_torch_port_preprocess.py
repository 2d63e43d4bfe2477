"""The port's ingestion slice against the JAX package on the CPU: the host
point ops, the raw parsers, the ``preprocess`` command (3dmatch, opengf,
kitti, collate), the raw-tree generator, the OpenGF loader and the
single-pair ICP's exit from a cycle.

Raw trees come from ``scripts/make_synthetic_raw.py`` and its port
``scripts/torch_port_make_raw.py`` at scale 0.001 (seed 11): 8 + 8 3DMatch
test pairs, 27 train and 8 val pairs, 12 KITTI pairs of ~2,700-point
frames, 289 + 75 + 4 OpenGF patches. Bars: the point ops bit for bit with
``scream_tpu.native`` (the plain versions at ``tests/test_native.py``'s
tolerances); the raw parsers, the two generators' trees, the 3DMatch and
OpenGF artifacts with their stdout lines, the collated caches and the
OpenGF items bit for bit; KITTI's voxelized clouds bit for bit, its refined
GT within the ICP trajectory bar (2e-2 per entry) with ICP steps within 1
where both packages' loops exit on the convergence test, and each package's GT within 5e-4 per entry of the generator's pose; the
ICP's cycle exit bit for bit with the loop that runs every step.
"""

import contextlib
import filecmp
import importlib.util
import io
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from scream_tpu import cli as jcli
from scream_tpu import native as jnative
from scream_tpu.data import datasets as jdatasets
from scream_tpu.data import raw as jraw
from scream_tpu.geometry import icp as jicp
from scream_tpu_torch import cli as tcli
from scream_tpu_torch import native as tnative
from scream_tpu_torch.data import datasets as tdatasets
from scream_tpu_torch.data import las as tlas
from scream_tpu_torch.data import preprocess as tpre
from scream_tpu_torch.data import raw as traw
from scream_tpu_torch.geometry import icp as ticp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = "0.001"
TRAJ_TOL = 2e-2  # ICP trajectory bar per entry
# The refined GT against the generator's pose, per entry: the 0.3-voxel
# clouds' centroids are not the shared points, so their ICP optimum sits
# off the pose (up to 1.7e-4 here, in both packages).
GT_TOL = 5e-4
KITTI_CAP = 30  # ICP cap of the function-level KITTI comparison


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    """``main(argv)`` with its stdout captured: the list of lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().strip().splitlines()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The JAX generator's tree, the port generator's tree and the split
    sizes the port generator printed."""
    d = tmp_path_factory.mktemp("raw")
    _run(_script("make_synthetic_raw").main, ["--out", str(d / "jax"), "--scale", SCALE])
    out = _run(_script("torch_port_make_raw").main, ["--out", str(d / "port"), "--scale", SCALE])
    return d / "jax", d / "port", json.loads(out[-1])["expected_splits"]


@pytest.fixture(scope="module")
def artifacts(trees, tmp_path_factory):
    """``preprocess 3dmatch`` and ``opengf`` through both CLIs on the JAX
    generator's tree: ``{package: (out dir, stdout lines)}``."""
    raw = trees[0]
    d = tmp_path_factory.mktemp("artifacts")
    out = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        lines = []
        for task in ("3dmatch", "opengf"):
            lines += _run(main, ["preprocess", task, "--root", str(raw / f"{task}_raw"),
                                 "--out", str(d / name)])
        out[name] = (d / name, lines)
    return out


@pytest.fixture(scope="module")
def kitti(trees, tmp_path_factory):
    """KITTI's test split through both packages' ``KittiOdometry`` (strict
    off, ICP capped at KITTI_CAP), each on its own copy of the tree (the
    refined GT caches under ``icp/``), with every ICP call's result."""
    d = tmp_path_factory.mktemp("kitti")
    out = {}
    for name, cls, mod, kw in (("jax", jraw.KittiOdometry, jicp, {}),
                               ("port", traw.KittiOdometry, ticp, {"device": "cpu"})):
        root = d / name
        shutil.copytree(trees[0] / "kitti_raw", root)
        results, orig = [], mod.registration_icp

        def record(*a, _orig=orig, _results=results, **k):
            res = _orig(*a, **k)
            _results.append(res)
            return res

        mod.registration_icp = record
        try:
            ds = cls(str(root), mode="test", strict=False, icp_max_iteration=KITTI_CAP, **kw)
            items = [ds[i] for i in range(len(ds))]
        finally:
            mod.registration_icp = orig
        out[name] = (ds, items, results)
    return out


class TestPointOps:
    """The port's library against the JAX package's, and the plain versions."""

    @pytest.mark.parametrize("n,voxel", [(500, 0.1), (3000, 0.25), (64, 1.0), (1, 0.5)])
    def test_voxel_downsample(self, n, voxel):
        pts = np.random.default_rng(n).uniform(-3, 3, (n, 3))
        got = tnative.voxel_downsample(pts, voxel)
        assert got.dtype == np.float32
        assert np.array_equal(got, jnative.voxel_downsample(pts, voxel))
        np.testing.assert_allclose(tnative.voxel_downsample_plain(pts, voxel), got, atol=1e-5)

    @pytest.mark.parametrize("fn", ["radius_has_neighbor", "radius_count",
                                    "highest_in_radius_2d"])
    @pytest.mark.parametrize("radius", [0.05, 0.3, 1.0])
    def test_radius_queries(self, fn, radius):
        rng = np.random.default_rng(int(radius * 100))
        q, r = rng.uniform(-2, 2, (300, 3)), rng.uniform(-2, 2, (400, 3))
        got = getattr(tnative, fn)(q, r, radius)
        want = getattr(jnative, fn)(q, r, radius)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(getattr(tnative, fn + "_plain")(q, r, radius), got)

    @pytest.mark.parametrize("suffix", ["", "_plain"])
    def test_boundary_inclusive(self, suffix):
        q, ref = np.array([[0.0, 0.0, 0.0]]), np.array([[1.0, 0.0, 0.0]])
        assert getattr(tnative, "radius_has_neighbor" + suffix)(q, ref, 1.0)[0]
        assert getattr(tnative, "radius_count" + suffix)(q, ref, 1.0)[0] == 1
        assert getattr(tnative, "highest_in_radius_2d" + suffix)(q, ref, 1.0)[0] == 0

    @pytest.mark.parametrize("suffix", ["", "_plain"])
    def test_empty_reference_cloud(self, suffix):
        q = np.random.default_rng(3).uniform(-1, 1, (7, 3))
        empty = np.empty((0, 3))
        assert not getattr(tnative, "radius_has_neighbor" + suffix)(q, empty, 0.5).any()
        assert (getattr(tnative, "radius_count" + suffix)(q, empty, 0.5) == 0).all()
        assert (getattr(tnative, "highest_in_radius_2d" + suffix)(q, empty, 0.5) == -1).all()

    @pytest.mark.parametrize("suffix", ["", "_plain"])
    def test_highest_ties_to_lowest_index(self, suffix):
        ref = np.array([[0.1, 0.0, 5.0], [0.0, 0.1, 5.0], [0.0, 0.0, 1.0]])
        q = np.array([[0.0, 0.0, 0.0], [10.0, 10.0, 0.0]])
        got = getattr(tnative, "highest_in_radius_2d" + suffix)(q, ref, 1.0)
        assert got.tolist() == [0, -1]
        assert np.array_equal(got, jnative.highest_in_radius_2d(q, ref, 1.0))

    def test_library_is_built_from_the_port_source(self, tmp_path, monkeypatch):
        """A build compiles ``scream_tpu_torch/native/pointops.cpp`` (never
        the JAX package's copy) into the build directory, named by its
        hash; a failed build raises."""
        calls = []

        def fake_run(cmd, **kw):
            calls.append(cmd)
            return type("P", (), {"returncode": 1, "stdout": "", "stderr": "boom"})()

        monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(tnative.subprocess, "run", fake_run)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            tnative.build()
        sources = [a for a in calls[0] if a.endswith((".cpp", ".cu", ".c"))]
        assert sources == [str(tnative.SRC)]
        pkg = os.path.join(REPO, "scream_tpu_torch") + os.sep
        assert str(tnative.SRC).startswith(pkg)
        assert os.path.dirname(calls[0][calls[0].index("-o") + 1]) == str(tmp_path)


class TestRawParsers:
    def test_redwood_info_and_covariance_index(self, trees):
        info = trees[0] / "3dmatch_raw" / "info"
        for sub in ("3DMatch", "3DLoMatch"):
            scene = next(p for p in (info / sub).iterdir())
            a = traw.read_redwood_info(str(scene / "gt.info"))
            b = jraw.read_redwood_info(str(scene / "gt.info"))
            assert len(a) == len(b) > 0
            for x, y in zip(a, b):
                assert x["test_pair"] == y["test_pair"]
                assert x["num_fragments"] == y["num_fragments"]
                assert np.array_equal(x["covariance"], y["covariance"])
            ta = traw.load_covariance_index(str(info / sub))
            tb = jraw.load_covariance_index(str(info / sub))
            assert ta.keys() == tb.keys()
            assert all(np.array_equal(ta[k], tb[k]) for k in ta)
        with pytest.raises(FileNotFoundError):
            traw.load_covariance_index(str(info / "missing"))

    def test_threedmatch_items(self, trees):
        root = trees[0] / "3dmatch_raw"
        args = (str(root), str(root / "indoor" / "3DLoMatch.pkl"),
                str(root / "info" / "3DLoMatch"))
        ta, tb = traw.ThreeDMatchPredator(*args), jraw.ThreeDMatchPredator(*args)
        assert len(ta) == len(tb) == 8
        for i in (0, 7):
            a, b = ta[i], tb[i]
            assert a.keys() == b.keys() and a["scene"] == b["scene"]
            for k in a:
                if k != "scene":
                    assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype, k

    def test_fragment_loads_tensor_and_numpy_with_weights_only(self, tmp_path):
        a = np.random.default_rng(5).standard_normal((20, 3)).astype(np.float32)
        torch.save(torch.from_numpy(a), tmp_path / "t.pth")
        torch.save(a.astype(np.float64), tmp_path / "n.pth")
        for name in ("t.pth", "n.pth"):
            got = traw._load_fragment(str(tmp_path / name))
            assert got.dtype == np.float32 and np.array_equal(got, a)
            assert np.array_equal(got, jraw._load_fragment(str(tmp_path / name)))

    def test_sidecars_need_a_covariance(self, tmp_path):
        with pytest.raises(KeyError, match="no covariance"):
            traw.save_info_sidecars([{"idx": np.zeros(2), "scene": "s"}], str(tmp_path))

    def test_kitti_geometry_helpers(self):
        rng = np.random.default_rng(6)
        assert np.array_equal(traw.velo2cam_matrix(), jraw.velo2cam_matrix())
        for e in rng.uniform(-np.pi, np.pi, (5, 3)):
            assert np.array_equal(traw.extrinsic_zyx_rotation(e), jraw.extrinsic_zyx_rotation(e))
        poses = np.tile(np.eye(4), (60, 1, 1))
        poses[:, :3, 3] = np.cumsum(rng.uniform(0, 3, (60, 3)), axis=0)
        ids = list(range(60))
        assert traw.select_kitti_pairs(poses, ids) == jraw.select_kitti_pairs(poses, ids)
        assert traw.KITTI_SEQUENCES == jraw.KITTI_SEQUENCES
        assert traw.KITTI_BAD_TEST_PAIR == jraw.KITTI_BAD_TEST_PAIR
        assert traw.SCENE_NAME_TO_ABBR == jraw.SCENE_NAME_TO_ABBR

    def test_kitti_file_lists(self, trees):
        root = str(trees[0] / "kitti_raw")
        for mode in ("train", "val", "test"):
            assert (traw.KittiOdometry(root, mode=mode, device="cpu").files
                    == jraw.KittiOdometry(root, mode=mode).files)
        with pytest.raises(AssertionError, match="sequence 08"):
            traw.KittiOdometry(str(trees[0] / "3dmatch_raw"), mode="test")

    def test_opengf_helpers(self, trees):
        from scream_tpu.data import las as jlas

        assert tlas.OPENGF_TRAIN_FILES == jlas.OPENGF_TRAIN_FILES
        assert tlas.OPENGF_VAL_FILES == jlas.OPENGF_VAL_FILES
        assert tlas.OPENGF_TEST_FILES == jlas.OPENGF_TEST_FILES
        root = str(trees[0] / "opengf_raw")
        paths = tlas._existing(root, tlas.OPENGF_VAL_FILES + ["train/none.laz"])
        assert paths == jlas._existing(root, jlas.OPENGF_VAL_FILES + ["train/none.laz"])
        assert len(paths) == 3 and all(p.endswith(".las") for p in paths)
        a, b = tlas.read_opengf_cloud(paths[0]), jlas.read_opengf_cloud(paths[0])
        assert all(np.array_equal(x, y) for x, y in zip(a, b)) and (a[1] != 0).all()


class TestGenerator:
    def test_port_generator_writes_the_same_tree(self, trees):
        jax_tree, port_tree, _ = trees
        files = lambda root: sorted(str(p.relative_to(root)) for p in root.rglob("*")
                                    if p.is_file())
        assert files(jax_tree) == files(port_tree)
        names = files(jax_tree)
        assert {os.path.splitext(n)[1] for n in names} >= {".pth", ".pkl", ".info", ".bin",
                                                           ".txt", ".las"}
        for n in names:
            a, b = jax_tree / n, port_tree / n
            if n.endswith(".pth"):
                assert torch.equal(torch.load(a, weights_only=True),
                                   torch.load(b, weights_only=True)), n
            else:
                assert filecmp.cmp(a, b, shallow=False), n


class TestPreprocessCLI:
    def test_3dmatch_and_opengf_bit_for_bit(self, artifacts, trees):
        (jdir, jlines), (pdir, plines) = artifacts["jax"], artifacts["port"]
        assert plines == jlines
        files = lambda root: sorted(str(p.relative_to(root)) for p in root.rglob("*")
                                    if p.is_file())
        names = files(jdir)
        assert names == files(pdir) and len(names) > 600
        for rel in names:
            assert filecmp.cmp(jdir / rel, pdir / rel, shallow=False), rel

    def test_split_sizes_are_the_generators(self, artifacts, trees):
        pdir = str(artifacts["port"][0])
        expected = trees[2]
        for split, n in expected.items():
            if split.startswith("OpenGF"):
                assert len(tdatasets.OpenGFDataset(pdir, split.split("_")[1])) == n, split
            elif not split.startswith("KITTI"):
                assert tdatasets._count_items(os.path.join(pdir, split)) == n, split

    def test_opengf_items_bit_for_bit(self, artifacts):
        pdir = str(artifacts["port"][0])
        for split in ("test", "val"):
            a = tdatasets.OpenGFDataset(pdir, split, with_centers=split == "test")
            b = jdatasets.OpenGFDataset(pdir, split, with_centers=split == "test")
            for i in range(0, len(a), 10):
                x, y = a[i], b[i]
                assert x.keys() == y.keys()
                assert all(np.array_equal(x[k], y[k]) and x[k].dtype == y[k].dtype for k in x)

    def test_missing_info_tree_is_an_error(self, trees, tmp_path):
        root = tmp_path / "raw"
        shutil.copytree(trees[0] / "3dmatch_raw" / "indoor", root / "indoor")
        for pkl in ("train_info.pkl", "val_info.pkl"):
            os.remove(root / "indoor" / pkl)
        with pytest.raises(SystemExit, match="info/3DMatch missing"):
            _run(tcli.main, ["preprocess", "3dmatch", "--root", str(root),
                             "--out", str(tmp_path / "out")])

    def test_skips_and_collate_refuses_opengf(self, tmp_path):
        (tmp_path / "indoor").mkdir()
        lines = _run(tcli.main, ["preprocess", "3dmatch", "--root", str(tmp_path),
                                 "--out", str(tmp_path / "out")])
        want = _run(jcli.main, ["preprocess", "3dmatch", "--root", str(tmp_path),
                                "--out", str(tmp_path / "out")])
        assert lines == want and len(lines) == 4 and all("missing" in ln for ln in lines)
        lines = _run(tcli.main, ["preprocess", "opengf", "--root", str(tmp_path),
                                 "--out", str(tmp_path / "out")])
        assert lines == _run(jcli.main, ["preprocess", "opengf", "--root", str(tmp_path),
                                         "--out", str(tmp_path / "out")])
        assert len(lines) == 3 and all(ln.startswith("skip OpenGF_") for ln in lines)
        with pytest.raises(SystemExit, match="registration"):
            tcli.main(["preprocess", "collate", "--root", str(tmp_path), "--protocol",
                       "opengf", "--out", str(tmp_path / "c")])

    def test_kitti_cli_and_collate(self, trees, artifacts, kitti, tmp_path):
        """``preprocess kitti`` through the port's CLI on the CPU (every
        sequence, the 50,000-step cap): the split sizes the generator
        built and its test split's voxelized clouds equal to the JAX
        package's items; then ``preprocess collate`` for kitti and 3dmatch
        in both packages: the same caches."""
        root = tmp_path / "kitti_raw"
        shutil.copytree(trees[0] / "kitti_raw", root)
        out = tmp_path / "data"
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            lines = _run(tcli.main, ["preprocess", "kitti", "--root", str(root),
                                     "--out", str(out), "--device", "cpu"])
        expected = trees[2]
        assert lines == [f"KITTI_{m}: {expected[f'KITTI_{m}']} pairs"
                         for m in ("train", "val", "test")]
        icp = [ln for ln in err.getvalue().splitlines() if ln.startswith("[refine_gt_icp]")]
        assert len(icp) == 12 and all(" on cpu: " in ln and "of 50000" in ln for ln in icp)
        _, jitems, _ = kitti["jax"]
        kept = [it for i, it in enumerate(jitems) if i != 1]  # the test split drops item 1
        for i, it in enumerate(kept):
            for key in ("src", "tgt"):
                got = np.load(out / "KITTI_test" / f"{key}{i}.npy")
                assert np.array_equal(got, jnative.voxel_downsample(it[key], 0.7))
        shutil.copytree(artifacts["port"][0] / "3DMatch_test", out / "3DMatch_test")
        for proto in ("kitti", "3dmatch"):
            caches = []
            for name, main in (("jax", jcli.main), ("port", tcli.main)):
                c = tmp_path / f"cache_{proto}_{name}"
                meta = json.loads(_run(main, ["preprocess", "collate", "--root", str(out),
                                              "--out", str(c), "--protocol", proto])[-1])
                caches.append((c, meta))
            (ca, ma), (cb, mb) = caches
            ma.pop("build_s"), mb.pop("build_s")
            assert ma == mb and ma["n_items"] == (expected["KITTI_test"] if proto == "kitti"
                                                  else expected["3DMatch_test"])
            names = sorted(os.listdir(ca))
            assert names == sorted(os.listdir(cb))
            for n in names:
                if n.endswith(".npy"):
                    assert np.array_equal(np.load(ca / n), np.load(cb / n)), n


class TestKitti:
    def test_voxelized_clouds_bit_for_bit(self, kitti):
        (jds, jitems, _), (tds, titems, _) = kitti["jax"], kitti["port"]
        assert tds.files == jds.files and len(titems) == 4
        for a, b in zip(titems, jitems):
            assert a["pair"] == b["pair"]
            assert np.array_equal(a["src"], b["src"]) and np.array_equal(a["tgt"], b["tgt"])

    def test_refined_gt_and_steps(self, kitti):
        """The refined GT within the trajectory bar of the JAX package's and
        near the generator's pose; the steps within 1 where both packages'
        loops exit on the convergence test. At metric scale the fp32
        distance expansion moves the RMSE by ~1e-4 a step, 100x the 1e-6
        exit test, so a loop exits only on an exact fixed point of its
        transform and otherwise cycles to the cap: which of the two a pair
        meets follows the Kabsch's last bits, which differ between the
        packages (pair (8, 2, 3) here: 5 steps in the port, the cap in the
        JAX package; its transforms agree within 7e-5)."""
        (jds, jitems, jres), (tds, titems, tres) = kitti["jax"], kitti["port"]
        assert len(jres) == len(tres) == len(titems)
        both_exit = 0
        for a, b, ra, rb in zip(titems, jitems, tres, jres):
            Ta = np.concatenate([a["rot"], a["trans"]], 1)
            Tb = np.concatenate([b["rot"], b["trans"]], 1)
            assert np.abs(Ta - Tb).max() <= TRAJ_TOL
            sa, sb = int(ra.iterations), int(np.asarray(rb.iterations))
            if max(sa, sb) < KITTI_CAP:
                assert abs(sa - sb) <= 1, (a["pair"], sa, sb)
                both_exit += 1
            odo = tds.odometry_gt(*a["pair"])[:3]
            assert np.abs(Ta - odo).max() <= GT_TOL and np.abs(Tb - odo).max() <= GT_TOL
        assert both_exit >= 2
        # The cap is reached by at least one pair (a cycle) and not by all.
        steps = [int(r.iterations) for r in tres]
        assert KITTI_CAP in steps and min(steps) < KITTI_CAP

    def test_refine_gt_icp_pads_to_powers_of_two(self, kitti, capsys):
        tds, titems, tres = kitti["port"]
        assert all(r.transformation.shape == (4, 4) for r in tres)
        src = np.random.default_rng(7).uniform(-5, 5, (300, 3)).astype(np.float32)
        T = tpre.refine_gt_icp(src, src, np.eye(4), max_iteration=5, device="cpu")
        assert T.dtype == np.float64 and np.allclose(T, np.eye(4), atol=1e-5)
        line = capsys.readouterr().err.strip().splitlines()[-1]
        assert re.match(r"\[refine_gt_icp\] 300 x 300 points \(padded 512 x 512\) on cpu: "
                        r"\d+ ICP steps of 5", line), line

    def test_augmented_items(self, kitti):
        """Per-item seeded augmentation, with the cached refined GT."""
        (jds, _, _), (tds, _, _) = kitti["jax"], kitti["port"]
        a = traw.KittiOdometry(os.path.dirname(tds.root), mode="test", strict=False,
                               data_augmentation=True, seed=3, device="cpu")
        b = jraw.KittiOdometry(os.path.dirname(jds.root), mode="test", strict=False,
                               data_augmentation=True, seed=3)
        for i in (0, 3):
            x, y = a[i], b[i]
            assert np.array_equal(x["src"], y["src"]) and np.array_equal(x["tgt"], y["tgt"])


CYCLE_CAPS = (40, 41)


@pytest.fixture(scope="module")
def cycling_pair(kitti):
    """A KITTI pair whose ICP cycles, padded as ``refine_gt_icp`` pads it,
    and the results of the loop without the exit (every step, the
    convergence test each time) at each of CYCLE_CAPS."""
    tds, titems, tres = kitti["port"]
    k = next(i for i, r in enumerate(tres) if int(r.iterations) == KITTI_CAP)
    drive, t0, t1 = tds.files[k]
    M = tds.odometry_gt(drive, t0, t1)
    s0 = tnative.voxel_downsample(tds._velodyne(drive, t0), 0.3)
    s1 = tnative.voxel_downsample(tds._velodyne(drive, t1), 0.3)

    def pad(p):
        cap_n = 1 << max(len(p) - 1, 1).bit_length()
        out = torch.zeros((cap_n, 3))
        out[:len(p)] = torch.as_tensor(p)
        return out, torch.arange(cap_n) < len(p)

    (src, sm), (tgt, tm) = pad((s0 @ M[:3, :3].T + M[:3, 3]).astype(np.float32)), pad(s1)
    init = torch.eye(4)[None]
    s, t, smb, tmb = ticp._prepare(src[None], tgt[None], init, sm[None], tm[None])
    step, converged, measure = ticp._make_icp_fns(
        s, t, smb, tmb, ticp._f32_square(0.2), 1e-6, 1e-6, nn=ticp.nn_bounded_single)
    st, want = ticp._init_icp_state(init), {}
    for n in range(1, max(CYCLE_CAPS) + 1):
        assert not bool(converged(st)[0])
        T_new, fit, rmse = step(st.T_pending)
        st = ticp._State(st.T_pending, T_new, fit, rmse, st.fitness, st.rmse, st.it + 1)
        if n in CYCLE_CAPS:
            assert not bool(converged(st)[0])
            want[n] = ticp._finish(st, converged, measure)
    return (src, tgt, sm, tm), want


class TestIcpCycle:
    @pytest.mark.parametrize("cap", CYCLE_CAPS)
    def test_cycle_exit_equals_running_every_step(self, cycling_pair, cap, monkeypatch):
        """``registration_icp`` leaves a cycling loop at the first repeated
        state, after fewer NN calls than steps, with the bits of the loop
        that runs all ``cap`` steps."""
        (src, tgt, sm, tm), want = cycling_pair
        calls, nn = [], ticp.nn_bounded_single

        def counted(*a, **k):
            calls.append(1)
            return nn(*a, **k)

        monkeypatch.setattr(ticp, "nn_bounded_single", counted)
        got = ticp.registration_icp(src, tgt, 0.2, max_iteration=cap, src_mask=sm,
                                    tgt_mask=tm)
        assert int(got.iterations) == cap and len(calls) < cap
        for g, w in zip(got, want[cap]):
            assert torch.equal(g, w[0])
