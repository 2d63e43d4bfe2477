"""The port's ``convert`` (``utils/torch_convert.py``, the ``convert`` CLI)
and ``selftest`` against the JAX package on the CPU.

* ``convert`` on random state_dicts in the reference's layout (point, dem
  and disc at d 128, 1 + 1 layers; written from a seeded port init by
  ``chip_smoke.reference_state_dict``, BatchNorm's ``num_batches_tracked``
  included): bit for bit the JAX ``convert_*`` followed by
  ``params_from_jax`` / ``discriminator_from_jax``, and the round trip
  gives back the init; a missing key, a stray layer key, an unrelated key
  and a state_dict of another model behave as in the JAX converter; the CLI
  on a ``torch.save``'d file writes a weights directory the port loads,
  and its ``n_params`` is the JAX command's.
* ``selftest`` on this GPU-less host: ``{"ok": false, ...}`` and a nonzero
  exit, in-process and through the CLI.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from scream_tpu.utils import torch_convert as jconv
from scream_tpu_torch import cli, selftest
from scream_tpu_torch.config import ModelConfig
from scream_tpu_torch.models import DEMTransformer, PointTransformer
from scream_tpu_torch.models.gan import PatchDiscriminator
from scream_tpu_torch.utils import torch_convert as tconv
from scream_tpu_torch.utils.checkpoint import load_params
from scream_tpu_torch.utils.convert import discriminator_from_jax, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _port_init(kind):
    g = torch.Generator().manual_seed({"point": 1, "dem": 2, "disc": 3}[kind])
    if kind == "disc":
        net = PatchDiscriminator(device="cpu", generator=g)
        with torch.no_grad():  # running stats away from their (0, 1) init
            for k, v in net.state_dict().items():
                if "running" in k:
                    v.copy_(torch.rand(v.shape, generator=g) + 0.5)
        return net.state_dict()
    cfg = ModelConfig(d_model=128, self_layers=1, cross_layers=1,
                      separate_stems=kind == "dem")
    cls = DEMTransformer if kind == "dem" else PointTransformer
    return cls(cfg, device="cpu", generator=g).state_dict()


@pytest.fixture(scope="module")
def states():
    """Per kind: the seeded port init and its reference-layout state_dict."""
    return {k: (s, chip_smoke.reference_state_dict(s, k))
            for k in ("point", "dem", "disc") for s in [_port_init(k)]}


def _jax_state(sd, kind):
    """The JAX converter followed by the port's flax-tree mapping."""
    if kind == "disc":
        params, stats = jconv.convert_discriminator(sd)
        return discriminator_from_jax({"params": params, "batch_stats": stats})
    fn = jconv.convert_dem_transformer if kind == "dem" else jconv.convert_point_transformer
    return params_from_jax(fn(sd))


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kind", ["point", "dem", "disc"])
def test_convert_matches_jax_bit_for_bit(states, kind):
    init, sd = states[kind]
    tree, state, sidecar = tconv.convert_state_dict(sd, kind)
    _assert_same(state, _jax_state(sd, kind))
    _assert_same(state, {k: v.float() for k, v in init.items()})
    jtree = (dict(zip(("params", "batch_stats"), jconv.convert_discriminator(sd)))
             if kind == "disc" else
             {"point": jconv.convert_point_transformer,
              "dem": jconv.convert_dem_transformer}[kind](sd))
    assert tconv.tree_size(tree) == sum(x.size for x in jax.tree_util.tree_leaves(jtree))
    if kind == "disc":
        assert sidecar == {"input_nc": 2, "ndf": 64, "n_layers": 3}
    else:
        assert sidecar == {"d_model": 128, "num_heads": 8, "self_layers": 1,
                           "cross_layers": 1, **({"separate_stems": True}
                                                 if kind == "dem" else {})}


@pytest.mark.parametrize("edit,exc", [
    ("drop", KeyError),          # a missing leaf of a layer
    ("stray_layer", KeyError),   # a second stem layer with only its q_proj
    ("unrelated", None),         # ignored, as by the JAX converter
    ("other_model", ValueError),  # no attention layers at all
])
def test_bad_keys_raise_as_jax(states, edit, exc):
    sd = dict(states["point"][1])
    if edit == "drop":
        del sd["cross.1.layer.merge.weight"]
    elif edit == "stray_layer":
        sd["stem.1.q_proj.weight"] = sd["stem.0.q_proj.weight"]
    elif edit == "unrelated":
        sd["generator.pixel_grid"] = torch.zeros(3)
    else:
        sd = {"foo.weight": torch.zeros((2, 2))}
    if exc is None:
        _assert_same(tconv.convert_state_dict(sd, "point")[1], _jax_state(sd, "point"))
        return
    with pytest.raises(exc):
        jconv.convert_point_transformer(sd)
    with pytest.raises(exc):
        tconv.convert_state_dict(sd, "point")


@pytest.mark.parametrize("kind", ["point", "disc"])
def test_convert_cli_on_saved_pth(states, kind, tmp_path, capsys):
    init, sd = states[kind]
    pth, out = tmp_path / f"{kind}.pth", tmp_path / "weights"
    torch.save(sd, pth)
    cli.main(["convert", "--pth", str(pth), "--out", str(out), "--model", kind])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["out"] == str(out) and line["model"] == kind
    assert line["n_params"] == sum(v.numel() for v in init.values())
    if kind == "disc":
        from scream_tpu_torch.utils.checkpoint import load_discriminator

        _assert_same(load_discriminator(str(out), device="cpu").state_dict(), init)
    else:
        cfg, normalize, state = load_params(str(out))
        assert (cfg.d_model, cfg.self_layers, cfg.cross_layers) == (128, 1, 1)
        assert normalize is None
        _assert_same(state, init)
    with pytest.raises(SystemExit):
        cli.main(["convert", "--pth", str(pth), "--out", str(out), "--model", "nope"])


def test_selftest_refuses_without_gpu(capsys):
    assert selftest.main() == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] is False and "CUDA" in out["error"]
    with pytest.raises(SystemExit) as e:
        cli.main(["selftest"])
    assert e.value.code == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["ok"] is False


def test_selftest_bars_are_the_tpu_selftests(tmp_path):
    """Every bar the JAX selftest gates (``scream_tpu/selftest.py``) is in the
    port's, at the same value, and ``SELFTEST_TPU.json``'s run meets them."""
    with open(os.path.join(REPO, "SELFTEST_TPU.json")) as f:
        tpu = json.load(f)
    jax_bars = {"nn_dist_max_err": 1e-4, "nn_idx_mismatches": 0, "nn_unmasked_max_err": 1e-4,
                "nn_unmasked_idx_mismatches": 0, "bounded_nn_max_err": 1e-4,
                "bounded_icp_transform_max_err": 1e-3, "chunked_icp_transform_max_err": 1e-4,
                "chunked_icp_iter_max_diff": 1, "batched_icp_step_max_err": 1e-5,
                "batched_icp_transform_max_err": 2e-2, "batched_icp_iter_max_diff": 1,
                "splat_max_err": 1e-4, "splat_grad_rel_err": 1e-3,
                "fused_tail_rel_err": 3e-2, "fused_tail_grad_rel_err": 3e-2,
                "fused_attn_rel_err": 5e-2, "fused_attn_grad_rel_err": 5e-2}
    for k, bar in jax_bars.items():
        assert selftest.BARS[k] == bar, k
        assert k in tpu and (tpu[k] <= bar if k in selftest._AT_MOST else tpu[k] < bar), k
