"""The PyTorch port's config, data path and package rules against the JAX
package: same config fields and defaults, bit-identical synthetic data and
batches for the same seed, no JAX import anywhere in the port, and no silent
CPU fallback when CUDA is asked for."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from scream_tpu import config as jcfg
from scream_tpu.data import batching as jbatching
from scream_tpu.data import datasets as jdatasets
from scream_tpu.data import loader as jloader
from scream_tpu.data import synthetic as jsynthetic
from scream_tpu_torch import config as tcfg
from scream_tpu_torch.data import batching as tbatching
from scream_tpu_torch.data import datasets as tdatasets
from scream_tpu_torch.data import loader as tloader
from scream_tpu_torch.data import synthetic as tsynthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_dict(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


class TestConfig:
    def test_model_config_fields_and_defaults(self):
        j = {f.name: f.default for f in dataclasses.fields(jcfg.ModelConfig)}
        t = {f.name: f.default for f in dataclasses.fields(tcfg.ModelConfig)}
        assert j == t

    def test_eval_config_matches_register_batch_fields(self):
        j = jcfg.EvalConfig()
        for f in dataclasses.fields(tcfg.EvalConfig):
            assert getattr(j, f.name) == f.default, f.name

    @pytest.mark.parametrize("name", ["bfloat16", "float32"])
    def test_dtypes(self, name):
        c = tcfg.ModelConfig(dtype=name, norm_dtype=name)
        assert c.compute_dtype == getattr(torch, name)
        assert c.norm_compute_dtype == getattr(torch, name)

    def test_unknown_dtype_raises(self):
        with pytest.raises(ValueError):
            tcfg.ModelConfig(dtype="float7").compute_dtype


class TestSyntheticData:
    """numpy on both sides: same seed -> bit-identical arrays."""

    @pytest.mark.parametrize("seed", [0, 7])
    def test_make_scene(self, seed):
        a = jsynthetic.make_scene(np.random.default_rng(seed), 300)
        b = tsynthetic.make_scene(np.random.default_rng(seed), 300)
        np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("overlap,noise", [(0.7, 0.0), (0.0, 0.01), (0.4, 0.002)])
    def test_make_pair(self, overlap, noise):
        a = jsynthetic.make_pair(np.random.default_rng(3), 200, 240, overlap=overlap, noise=noise)
        b = tsynthetic.make_pair(np.random.default_rng(3), 200, 240, overlap=overlap, noise=noise)
        _assert_same_dict(a, b)

    @pytest.mark.parametrize("kw", [
        dict(),
        dict(augment=True, with_info=True),
        dict(normalize="unit_cube", extent=4.0),
        dict(normalize="unit_sphere_raw", overlap=0.3),
    ])
    def test_dataset_items(self, kw):
        ja = jdatasets.SyntheticPairDataset(length=4, n_src=120, n_tgt=150, seed=5, **kw)
        tb = tdatasets.SyntheticPairDataset(length=4, n_src=120, n_tgt=150, seed=5, **kw)
        assert len(ja) == len(tb) == 4
        for i in range(4):
            _assert_same_dict(ja[i], tb[i])

    def test_unknown_normalize_raises(self):
        with pytest.raises(ValueError):
            tdatasets.SyntheticPairDataset(normalize="unit_blob")[0]


class TestBatching:
    def test_pad_cloud(self, rng):
        pts = rng.standard_normal((37, 3)).astype(np.float32)
        for a, b in zip(jbatching.pad_cloud(pts, 64), tbatching.pad_cloud(pts, 64)):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError):
            tbatching.pad_cloud(pts, 16)

    @pytest.mark.parametrize("with_info", [False, True])
    def test_collate_pairs(self, with_info):
        ds = tdatasets.SyntheticPairDataset(length=3, n_src=90, n_tgt=100, seed=1,
                                            with_info=with_info)
        items = [ds[i] for i in range(3)]
        _assert_same_dict(jbatching.collate_pairs(items, 128, 112),
                          tbatching.collate_pairs(items, 128, 112))

    def test_collate_rejects_mixed_sidecars(self):
        a = tdatasets.SyntheticPairDataset(length=1, n_src=8, n_tgt=8, with_info=True)[0]
        b = tdatasets.SyntheticPairDataset(length=1, n_src=8, n_tgt=8)[0]
        with pytest.raises(ValueError):
            tbatching.collate_pairs([a, b], 8)

    @pytest.mark.parametrize("workers,shuffle,drop_last", [(0, False, False), (2, True, True)])
    def test_pair_loader(self, workers, shuffle, drop_last):
        ds = tdatasets.SyntheticPairDataset(length=7, n_src=60, n_tgt=70, seed=2)
        jl = jloader.PairLoader(ds, batch_size=3, src_capacity=64, tgt_capacity=80,
                                shuffle=shuffle, drop_last=drop_last, seed=4,
                                num_workers=workers)
        tl = tloader.PairLoader(ds, batch_size=3, src_capacity=64, tgt_capacity=80,
                                shuffle=shuffle, drop_last=drop_last, seed=4,
                                num_workers=workers)
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(tl)
        for a, b in zip(jb, tb):
            _assert_same_dict(a, b)

    def test_loader_forwards_item_errors(self):
        class Bad:
            def __len__(self):
                return 4

            def __getitem__(self, i):
                raise KeyError(i)

        with pytest.raises(KeyError):
            list(tloader.PairLoader(Bad(), batch_size=2, src_capacity=8, num_workers=2))


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|scream_tpu)\b", re.M)


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "torch_port_make_raw.py")]
    for root, _, names in os.walk(os.path.join(REPO, "scream_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


class TestPackageRules:
    def test_port_imports_no_jax_and_nothing_of_scream_tpu(self):
        """The card's machine has no JAX: no module of the port, nor the
        chip smoke script, may import it or the JAX package (whose
        ``__init__`` imports jax). ``scream_tpu_torch`` itself is allowed."""
        files = _port_sources()
        assert len(files) > 10
        assert os.path.join(REPO, "scream_tpu_torch", "native", "__init__.py") in files
        offenders = []
        for path in files:
            with open(path) as f:
                src = f.read()
            for m in _FORBIDDEN.finditer(src):
                offenders.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
        assert not offenders, offenders

    def test_port_compiles_no_source_of_the_jax_package(self):
        """Both native builds take their sources from ``scream_tpu_torch/``:
        the CUDA library from ``csrc/``, the host point ops from ``native/``
        (the port's own copy of the JAX package's ``pointops.cpp``)."""
        from scream_tpu_torch import native
        from scream_tpu_torch.ops import _build

        pkg = os.path.join(REPO, "scream_tpu_torch") + os.sep
        sources = [str(p) for p in _build._sources()] + [str(native.SRC)]
        assert all(os.path.realpath(p).startswith(pkg) for p in sources), sources
        jax_src = os.path.join(REPO, "scream_tpu") + os.sep
        for path in _port_sources():
            with open(path) as f:
                src = f.read()
            for m in re.finditer(r"[\"'][^\"']*\.(?:cpp|cu|cc|c)[\"']", src):
                assert "scream_tpu/" not in m.group(0).replace("scream_tpu_torch/", ""), (
                    path, m.group(0))
        assert not native.library_path().is_relative_to(jax_src)

    def test_no_torch_extension_builder(self):
        """Kernels build with plain nvcc + ctypes, never through PyTorch's
        extension builder or its headers."""
        pkg = os.path.join(REPO, "scream_tpu_torch")
        for root, _, names in os.walk(pkg):
            for n in names:
                if n.endswith((".py", ".cu", ".cuh", ".h")):
                    with open(os.path.join(root, n)) as f:
                        src = f.read()
                    assert "cpp_extension" not in src, n
                    assert "torch/extension.h" not in src, n

    def test_cuda_request_without_gpu_raises(self, monkeypatch):
        from scream_tpu_torch.config import ModelConfig
        from scream_tpu_torch.models import PointTransformer
        from scream_tpu_torch.pipeline.register import register_batch
        from scream_tpu_torch.utils import resolve_device

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            PointTransformer(ModelConfig(d_model=32, num_heads=2, self_layers=1,
                                         cross_layers=1))
        batch = tbatching.collate_pairs(
            [tdatasets.SyntheticPairDataset(length=1, n_src=8, n_tgt=8)[0]], 8)
        with pytest.raises(RuntimeError, match="cuda"):
            register_batch(lambda *a: a[0], batch)
        assert resolve_device("cpu") == torch.device("cpu")

    def test_kernel_wrappers_reject_other_devices(self):
        from scream_tpu_torch.ops import attn_cuda, nn_cuda, splat_cuda, tail_cuda

        x = torch.empty((1, 4, 3), device="meta")
        with pytest.raises(ValueError):
            nn_cuda.nn_exact(x, x)
        with pytest.raises(ValueError):
            nn_cuda.nn_bounded(x, x, 0.01)
        with pytest.raises(ValueError):
            nn_cuda.nn_bounded_single(x, x, 0.01)
        with pytest.raises(ValueError):
            nn_cuda.nn_tile_boxes(x)
        with pytest.raises(ValueError):
            attn_cuda.attn_stats(torch.empty((1, 4, 256), device="meta"),
                                 None, None, None, num_heads=8)
        with pytest.raises(ValueError):
            splat_cuda.max_splat(x[..., :2], x[..., :2], 24.0, 64)
        y = torch.empty((1, 4, 512), device="meta")
        with pytest.raises(ValueError):
            tail_cuda.block_tail(y, y, None, None, None, None, None, None, None,
                                 dtype=torch.bfloat16, norm_dtype=torch.float32)


class TestBuild:
    def test_missing_nvcc_raises_clearly(self, monkeypatch):
        from scream_tpu_torch.ops import _build

        monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()

    def test_library_named_by_source_hash_under_build(self):
        from scream_tpu_torch.ops import _build

        p = _build.library_path()
        assert p == _build.library_path()
        assert p.parent == _build.BUILD_DIR
        assert "build" in p.parts and p.suffix == ".so"
        assert {s.name for s in _build._sources()} == {"attn.cu", "nn.cu", "splat.cu",
                                                        "tail.cu"}

    def test_launch_counters_reset(self):
        from scream_tpu_torch import ops
        from scream_tpu_torch.ops import nn_cuda

        for w in ops.WRAPPERS:
            w.launches = 3
        ops.reset_launch_counts()
        assert set(ops.launch_counts().values()) == {0}
        assert sorted(ops.launch_counts()) == ["attn_apply", "attn_stats",
                                               "block_tail", "max_splat", "nn_bounded",
                                               "nn_bounded_single", "nn_exact",
                                               "nn_tile_boxes"]
        for w in (nn_cuda.nn_bounded, nn_cuda.nn_bounded_single):
            w.device_launches = 3
        ops.reset_launch_counts()
        assert nn_cuda.nn_bounded.device_launches == 0
        assert nn_cuda.nn_bounded_single.device_launches == 0
