"""The port's visualization (``utils/viz_html.py``, ``utils/viz.py``, the
``visualize`` CLI) and the QA helpers of ``data/preprocess.py`` against the
JAX package on the CPU.

Bars: ``export_registration_html`` / ``export_scene_html`` byte-equal to
the JAX package's on the same arrays; the stdlib depth-grid PNG's pixels
equal ``plt.imsave``'s (the JAX package's writer); ``visualize`` with the
trained ``params/demo-3dmatch-d128`` (converted here), both packages in
fp32, RE and TE within 2e-2 of the JAX command's and ``display_gated``
equal, every PNG key noting the skip where matplotlib is missing; the QA
helpers' returned stats equal the JAX helpers' (and their PNGs written).
"""

import base64
import dataclasses
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from scream_tpu import cli as jcli
from scream_tpu.data import preprocess as jpre
from scream_tpu.utils import viz as jviz
from scream_tpu.utils import viz_html as jhtml
from scream_tpu_torch import cli as tcli
from scream_tpu_torch.data import preprocess as tpre
from scream_tpu_torch.utils import viz as tviz
from scream_tpu_torch.utils import viz_html as thtml
from scream_tpu_torch.utils.checkpoint import save_params
from scream_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "params", "demo-3dmatch-d128")
ARCH = {"d_model": 128, "num_heads": 8, "self_layers": 3, "cross_layers": 3}
TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(rng, n):
    return rng.standard_normal((n, 3)).astype(np.float32)


@pytest.mark.parametrize("n_src", [300, 70000])
def test_viz_html_byte_equal(tmp_path, n_src):
    """The registration scene with every layer, and past ``max_points``
    (the seeded subsample)."""
    rng = np.random.default_rng(n_src)
    src, tgt, pred = _cloud(rng, n_src), _cloud(rng, 400), _cloud(rng, n_src)
    T = np.eye(4)
    T[:3, 3] = [0.1, -0.2, 0.3]
    corr = (src[:50], pred[:50])
    paths = []
    for mod, name in ((jhtml, "jax.html"), (thtml, "port.html")):
        paths.append(mod.export_registration_html(
            str(tmp_path / name), src, tgt, T_gt=T, T_est=T * 0.99, src_pred=pred,
            corr=corr, title="pair 3"))
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def test_depth_grid_png_pixels_equal_imsave(tmp_path):
    import matplotlib.image as mpimg

    rng = np.random.default_rng(1)
    imgs = rng.uniform(-1, 1, (3, 2, 64, 64)).astype(np.float32)
    np.testing.assert_array_equal(tviz.depth_images_to_rgb(imgs), jviz.depth_images_to_rgb(imgs))
    jviz.save_depth_image_grid(imgs, str(tmp_path / "jax.png"))
    tviz.save_depth_image_grid(imgs, str(tmp_path / "port.png"))
    want, got = mpimg.imread(tmp_path / "jax.png"), mpimg.imread(tmp_path / "port.png")
    assert got.shape == (64, 192, 3) and want.shape[:2] == (64, 192)
    np.testing.assert_array_equal(got, want[..., :3])
    assert want.shape[-1] == 3 or (want[..., 3] == 1).all()


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """A 3DMatch_test tree of 2 pairs (the port's split writer) and the demo
    d 128 checkpoint converted to a weights directory of the port."""
    import importlib.util

    from scream_tpu.config import ModelConfig as JModelConfig
    from scream_tpu.models.point_transformer import PointTransformer as JPT
    from scream_tpu.utils.checkpoint import load_params

    root = tmp_path_factory.mktemp("viz")
    spec = importlib.util.spec_from_file_location(
        "torch_port_make_splits", os.path.join(REPO, "scripts", "torch_port_make_splits.py"))
    ms = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ms)
    ms._registration_split(str(root / "tree" / "3DMatch_test"), 2, np.random.default_rng(3),
                           (0.6, 0.9), 1.5, (300, 400), with_info=True)
    z = np.zeros((1, 8, 3), np.float32)
    init = jax.jit(JPT(JModelConfig(**ARCH)).init)(jax.random.PRNGKey(0), z, z, None, None,
                                                   np.zeros((1, 1, 3), np.float32))["params"]
    params = load_params(DEMO, init)
    save_params(str(root / "weights"),
                params_from_jax(jax.tree_util.tree_map(np.asarray, params)), dict(ARCH))
    return root


def _fp32(mod):
    """The command's model overrides, then fp32 compute."""
    orig = mod._apply_model_overrides
    return lambda cfg, args: dataclasses.replace(orig(cfg, args), dtype="float32")


def test_visualize_matches_jax(demo, monkeypatch, capsys):
    """The zero-overlap flow (its NN solve on src_pred, the flow's selected
    correspondences, the display gate at 3 deg) with the HTML, in both
    packages."""
    mode, item = "zero", 1
    flags = ["visualize", "--root", str(demo / "tree"), "--split", "3DMatch_test",
             "--item", str(item), "--mode", mode, "--html"]
    for name in ("plot_registration", "plot_prediction_error", "plot_prediction_flow"):
        monkeypatch.setattr(jviz, name, lambda *a, **k: None)
    monkeypatch.setattr(jcli, "_apply_model_overrides", _fp32(jcli))
    jcli.main(flags + ["--out", str(demo / f"jax_{mode}"), "--params", DEMO,
                       *sum((["--" + k.replace("_", "-"), str(v)] for k, v in ARCH.items()
                             if k != "num_heads"), [])])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(tcli, "_apply_model_overrides", _fp32(tcli))
    monkeypatch.setattr(tcli, "_have_matplotlib", lambda: False)
    tcli.main(flags + ["--out", str(demo / f"port_{mode}"), "--params", str(demo / "weights"),
                       "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.keys() == want.keys()
    assert abs(got["re_deg"] - want["re_deg"]) <= TOL and abs(got["te"] - want["te"]) <= TOL
    assert got["display_gated"] == want["display_gated"]
    for k, v in got.items():
        if k.endswith(("before", "gt", "predicted", "estimated", "pred_error", "flow")):
            assert v == {"png_skipped": "matplotlib not installed"}, k
    # The HTML's first layer (the target) decodes to the item's target.
    with open(got["html"]) as f:
        data = json.loads(re.search(r"const DATA = (\{.*?\});\n", f.read()).group(1))
    tgt = np.frombuffer(base64.b64decode(data["layers"][0]["b64"]), np.float32).reshape(-1, 3)
    from scream_tpu_torch.data import PairDataset

    ds = PairDataset(str(demo / "tree"), "3DMatch_test", with_info=False,
                     normalize="unit_sphere")
    np.testing.assert_array_equal(tgt, ds[item]["tgt"].astype(np.float32))


def test_qa_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    pairs = tmp_path / "pairs"
    pairs.mkdir()
    for i in range(3):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = rng.standard_normal(3)
        np.save(pairs / f"src{i}.npy", _cloud(rng, 50 + i))
        np.save(pairs / f"tgt{i}.npy", _cloud(rng, 60))
        np.save(pairs / f"T{i}.npy", T)
    got = tpre.check_saved_pairs(str(pairs), out_dir=str(tmp_path / "png"), max_images=1,
                                 verbose=False)
    want = jpre.check_saved_pairs(str(pairs), verbose=False)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert sorted(os.listdir(tmp_path / "png")) == ["pair0_raw.png", "pair0_registered.png"]

    gf = tmp_path / "gf"
    (gf / "centers").mkdir(parents=True)
    for i in range(1, 4):
        np.save(gf / f"{i}.npy", rng.standard_normal((40, 6)).astype(np.float32))
        np.save(gf / "centers" / f"{i}.npy", rng.standard_normal(2 if i == 1 else 3))
    out = tpre.check_opengf_test(str(gf), out_path=str(tmp_path / "gf.png"), verbose=False)
    assert out == jpre.check_opengf_test(str(gf), verbose=False)
    assert os.path.exists(tmp_path / "gf.png")
    assert tpre.check_opengf_test(str(tmp_path / "none"), verbose=False) == \
        jpre.check_opengf_test(str(tmp_path / "none"), verbose=False)


def test_gan_sample_dump_matches_jax(tmp_path):
    """``_maybe_dump_gan_sample`` against the JAX trainer's: the same file
    name and pixels at a dump step, nothing off it, and without a directory
    the step is never read."""
    import matplotlib.image as mpimg
    from types import SimpleNamespace

    from scream_tpu.train import trainer as jtrainer
    from scream_tpu_torch.train import trainer as ttrainer

    fake = np.random.default_rng(2).uniform(-1, 1, (2, 3, 2, 64, 64)).astype(np.float32)
    for step in (6, 7):
        for mod, arr, side in ((jtrainer, fake, "jax"), (ttrainer, torch.from_numpy(fake), "port")):
            t = SimpleNamespace(sample_img_dir=str(tmp_path / side), state=SimpleNamespace(
                step=step), train_cfg=SimpleNamespace(save_img_iter=3))
            mod._maybe_dump_gan_sample(t, arr, 2)
    assert os.listdir(tmp_path / "jax") == os.listdir(tmp_path / "port") == ["epoch2_step6.png"]
    want = mpimg.imread(tmp_path / "jax" / "epoch2_step6.png")
    np.testing.assert_array_equal(mpimg.imread(tmp_path / "port" / "epoch2_step6.png"),
                                  want[..., :3])

    class Unread:
        @property
        def step(self):
            raise AssertionError("the step was read without a directory")

    ttrainer._maybe_dump_gan_sample(SimpleNamespace(sample_img_dir=None, state=Unread()),
                                    torch.from_numpy(fake), 1)
