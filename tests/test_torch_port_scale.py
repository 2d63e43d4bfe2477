"""``scripts/torch_port_make_splits.py`` and ``scripts/torch_port_run_scale.py``
against the JAX package's scripts on the CPU.

Bars: the registration splits (3DMatch family with the redwood sidecars,
zero overlap, KITTI) and the OpenGF split written by the port's functions at
8 items each equal, file by file and bit for bit, the trees of the JAX
script's ``_registration_split`` and of its OpenGF loop (the JAX package's
``make_dem_patch`` / ``save_opengf_split``), from the same seed and in the
same order of draws; the runner's command lines are the JAX script's with
the port's weights; on a tree it reports a protocol's items from the tree
and the ``evaluate`` command's JSON, and a failing protocol at rc 1.
"""

import filecmp
import importlib.util
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jms = _load("make_synthetic_splits")
tms = _load("torch_port_make_splits")
trs = _load("torch_port_run_scale")


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only and not cmp.funny_files, cmp.report()
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    for d in cmp.common_dirs:
        _same_tree(os.path.join(a, d), os.path.join(b, d))


@pytest.mark.parametrize("split", ["3dmatch", "3dzeromatch", "kitti"])
def test_registration_split_bit_for_bit(tmp_path, split):
    name, ov, extent, n_range, with_info, zero = tms.REGISTRATION[split]
    n_range = n_range or (256, 512)  # the 3DMatch family's --n-lo/--n-hi, cut for the CPU
    if split == "kitti":
        n_range = (512, 1024)
    for mod, side in ((jms, "jax"), (tms, "port")):
        n = mod._registration_split(str(tmp_path / side / name), 8, np.random.default_rng(7),
                                    ov, extent, n_range, with_info=with_info, zero=zero)
        assert n == 8
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_opengf_split_bit_for_bit(tmp_path):
    """The port's ``_opengf_split`` against the JAX script's OpenGF loop,
    written out here with the JAX package's functions (the loop is inline in
    the JAX script's ``main``)."""
    rng = np.random.default_rng(7)

    def patches():
        for _ in range(8):
            pt = jms.make_dem_patch(rng, n_dsm=int(rng.integers(1024, 4096)),
                                    n_dem=int(rng.integers(1024, 4096)), extent=50.0)
            pt["center"] = np.zeros(3, np.float32)
            yield pt

    assert jms.save_opengf_split(patches(), str(tmp_path / "jax" / "OpenGF_test"),
                                 save_centers=True) == 8
    assert tms._opengf_split(str(tmp_path / "port" / "OpenGF_test"), 8,
                             np.random.default_rng(7)) == 8
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_runner_argv_is_the_jax_scripts():
    for proto in trs.PARAMS:
        argv = trs.evaluate_argv(proto, "R", 16, 4096, "cuda")
        assert argv[:3] == ["evaluate", proto, "--root"]
        assert argv[argv.index("--params") + 1].endswith(
            os.path.join("weights", {"kitti": "kitti-generator",
                                     "opengf": "dem-generator"}.get(proto, "point-generator")))
        assert ("--bucketed" in argv) == proto.startswith("3d")
        if proto == "kitti":  # argparse keeps the last --max-points
            assert argv[argv.index("--batch-size") + 1] == "8" and argv[-1] == "8192"
        assert os.path.isdir(os.path.dirname(argv[argv.index("--params") + 1]))


def test_runner_on_a_tree(tmp_path, monkeypatch):
    """The 3dmatch protocol of a 3-pair tree on the CPU through the runner
    (the point-generator swapped for the small hint-free weights): rc 0, the
    items counted from the tree, the CLI's JSON as the result; a protocol
    that fails is rc 1 with its error, and the others still run."""
    tms._registration_split(str(tmp_path / "3DMatch_test"), 3, np.random.default_rng(2),
                            (0.6, 0.9), 1.5, (150, 200), with_info=True)
    monkeypatch.setitem(trs.PARAMS, "3dmatch", "point-generator-hintfree")
    row = trs.run_protocol("3dmatch", str(tmp_path), 4, 512, "cpu")
    assert row["rc"] == 0 and row["items"] == 3 and row["peak_device_mem_gib"] is None
    assert row["wall_s"] > 0 and row["peak_rss_mb"] > 0
    res = row["result"]
    assert 1 <= res["n_pairs"] <= 3 and all(np.isfinite(v) for v in res.values())
    assert trs.tree_items(str(tmp_path), "opengf") == 0
    monkeypatch.setitem(trs.PARAMS, "kitti", "no-such-weights")
    bad = trs.run_protocol("kitti", str(tmp_path), 4, 512, "cpu")
    assert bad["rc"] == 1 and "error" in bad["result"]
