"""The port's evaluation slice against the JAX package on the CPU: the
bucket ladder, the bucketed, concatenated, skipping and sharded loaders and
the collated cache (bit for bit, both ways), device prefetch, chunked ICP
and its early exit, ``register_batch_requeue``, the five protocols and the
``evaluate`` CLI.

Inputs come from numpy seeds; split trees are written by the writers of
``scripts/make_synthetic_splits.py``. Models: d 128, 8 heads, 1 + 1 layers,
fp32, one random init carried into the port by ``params_from_jax``. Bars:
loaders and caches bit for bit; ICP under the repository's trajectory bars
(transforms 2e-2, iterations within 1); the early exit bit for bit with
the loop that never leaves early; protocols: pair counts and success
counts equal, RE / TE statistics within 2e-2, OpenGF metrics within 1e-5
relative.
"""

import dataclasses
import importlib.util
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scream_tpu import cli as jcli
from scream_tpu import eval as jeval
from scream_tpu.config import EvalConfig as JEvalConfig
from scream_tpu.config import ModelConfig as JModelConfig
from scream_tpu.data import batching as jbatching
from scream_tpu.data import collated as jcollated
from scream_tpu.data import datasets as jdatasets
from scream_tpu.data import loader as jloader
from scream_tpu.data.preprocess import save_opengf_split
from scream_tpu.data.synthetic import make_dem_patch
from scream_tpu.geometry import icp as jicp
from scream_tpu.models.point_transformer import DEMTransformer as JDEM
from scream_tpu.models.point_transformer import PointTransformer as JPT
from scream_tpu.pipeline import register as jreg
from scream_tpu_torch import cli as tcli
from scream_tpu_torch import eval as teval
from scream_tpu_torch.config import ModelConfig, eval_preset
from scream_tpu_torch.data import batching as tbatching
from scream_tpu_torch.data import collated as tcollated
from scream_tpu_torch.data import datasets as tdatasets
from scream_tpu_torch.data import loader as tloader
from scream_tpu_torch.geometry import icp as ticp
from scream_tpu_torch.models import DEMTransformer, PointTransformer
from scream_tpu_torch.pipeline import register as treg
from scream_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(d_model=128, num_heads=8, self_layers=1, cross_layers=1, dtype="float32")
TOL = 2e-2
CAP = 256  # protocol trees: clouds of 150-250 points, one padded shape
LADDER = (512, 768, 1024)  # the loader tree: clouds of 200-1,000 points fill all three


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _splits_module():
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_splits", os.path.join(REPO, "scripts", "make_synthetic_splits.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_tree(root, seed, n_match, n_kitti, n_opengf, n_range):
    """A split tree in the readers' layout, by make_synthetic_splits.py's
    own writers: 3DMatch_test (info sidecars), KITTI_test (extent 40) and
    OpenGF_test (extent 50 metric patches, centres)."""
    mk = _splits_module()
    rng = np.random.default_rng(seed)
    mk._registration_split(os.path.join(root, "3DMatch_test"), n_match, rng, (0.5, 0.9),
                           1.5, n_range, with_info=True)
    mk._registration_split(os.path.join(root, "KITTI_test"), n_kitti, rng, (0.5, 0.9),
                           40.0, n_range, with_info=False)

    def patches():
        for _ in range(n_opengf):
            n = int(rng.integers(*n_range))
            pt = make_dem_patch(rng, n_dsm=n, n_dem=n, extent=50.0)
            pt["center"] = np.zeros(3, np.float32)
            yield pt

    save_opengf_split(patches(), os.path.join(root, "OpenGF_test"), save_centers=True)
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Loader tree: clouds of 200-1,000 points over the LADDER buckets."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return _write_tree(str(tmp_path_factory.mktemp("loader_tree")), 5, 14, 7, 3,
                           (200, 1000))


@pytest.fixture(scope="module")
def ptree(tmp_path_factory):
    """Protocol tree: 16 3DMatch pairs, 8 KITTI pairs, 6 OpenGF patches."""
    return _write_tree(str(tmp_path_factory.mktemp("protocol_tree")), 9, 16, 8, 6,
                       (150, 250))


def _quiet(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **k)


def _pair_ds(pkg, root, split="3DMatch_test", **kw):
    return _quiet(pkg.PairDataset, root, split, **kw)


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


class TestBuckets:
    @pytest.mark.parametrize("n", [1, 255, 256, 257, 1024, 1025, 4096, 16384])
    def test_bucket_for(self, n):
        ladder = (256, 512, 1024, 2048, 4096, 8192, 16384)
        assert tbatching.bucket_for(n, ladder) == jbatching.bucket_for(n, ladder)

    def test_bucket_for_too_large_raises(self):
        for fn in (tbatching.bucket_for, jbatching.bucket_for):
            with pytest.raises(ValueError):
                fn(5000, (1024, 4096))

    @pytest.mark.parametrize("cap,smallest", [(4096, 1024), (8192, 1024), (4096, 256),
                                              (3000, 1024), (700, 1024), (256, 256)])
    def test_buckets_for(self, cap, smallest):
        assert tcli._buckets_for(cap, smallest) == jcli._buckets_for(cap, smallest)

    def test_eval_splits(self):
        assert tcli.EVAL_SPLITS == jcli.EVAL_SPLITS


class TestLoaders:
    @pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False), (True, True)])
    def test_bucketed_loader(self, tree, shuffle, drop_last):
        kw = dict(batch_size=3, buckets=LADDER, shuffle=shuffle,
                  drop_last=drop_last, seed=4)
        got = tloader.BucketedPairLoader(_pair_ds(tdatasets, tree, with_info=True), **kw)
        want = jloader.BucketedPairLoader(_pair_ds(jdatasets, tree, with_info=True), **kw)
        assert got._assignment == want._assignment
        assert len(got) == len(want)
        got, want = list(got), list(want)  # one epoch each (shuffle draws)
        if not drop_last:
            assert len({b["src"].shape[1] for b in got}) == 3  # every bucket fills
        _assert_batches_equal(got, want)

    def test_concat_dataset(self):
        def parts(pkg):
            return [pkg.SyntheticPairDataset(length=5, n_src=n, n_tgt=n + 30, seed=s)
                    for s, n in ((1, 180), (2, 400), (3, 700))]

        got, want = tdatasets.ConcatDataset(parts(tdatasets)), jdatasets.ConcatDataset(parts(jdatasets))
        assert len(got) == len(want) == 15
        for i in (0, 4, 5, 14):
            assert tloader._default_size_fn(got, i) == jloader._default_size_fn(want, i)
        with pytest.raises(IndexError):
            got[15]
        kw = dict(batch_size=4, buckets=LADDER, num_workers=2)
        _assert_batches_equal(tloader.BucketedPairLoader(got, **kw),
                              jloader.BucketedPairLoader(want, **kw))

    def test_skip_dataset(self, tree):
        got = teval.SkipDataset(_pair_ds(tdatasets, tree, "KITTI_test",
                                         normalize="unit_cube"), (1, 3))
        want = jeval.SkipDataset(_pair_ds(jdatasets, tree, "KITTI_test",
                                          normalize="unit_cube"), (1, 3))
        assert len(got) == len(want) == 5
        assert [tloader._default_size_fn(got, i) for i in range(5)] == \
            [jloader._default_size_fn(want, i) for i in range(5)]
        _assert_batches_equal(tloader.PairLoader(got, 2, 1024),
                              jloader.PairLoader(want, 2, 1024))
        kw = dict(batch_size=2, buckets=LADDER)
        _assert_batches_equal(tloader.BucketedPairLoader(got, **kw),
                              jloader.BucketedPairLoader(want, **kw))

    @pytest.mark.parametrize("shard,count", [(0, 1), (0, 3), (2, 3), (1, 4)])
    def test_host_shard(self, tree, shard, count):
        got = tloader.HostShardDataset(_pair_ds(tdatasets, tree, with_info=True), shard, count)
        want = jloader.HostShardDataset(_pair_ds(jdatasets, tree, with_info=True), shard, count)
        assert len(got) == len(want)
        kw = dict(batch_size=2, buckets=LADDER)
        _assert_batches_equal(tloader.BucketedPairLoader(got, **kw),
                              jloader.BucketedPairLoader(want, **kw))

    def test_host_shard_defaults_without_process_group(self, tree):
        ds = tloader.HostShardDataset(_pair_ds(tdatasets, tree))
        assert (ds.shard, ds.count) == (0, 1) and len(ds) == 14
        with pytest.raises(IndexError):
            ds[14]
        with pytest.raises(ValueError):
            tloader.HostShardDataset(ds, 3, 3)

    def test_size_probe_reads_headers_with_cap(self, tree):
        got = _pair_ds(tdatasets, tree, max_points=300)
        want = _pair_ds(jdatasets, tree, max_points=300)
        sizes = [tloader._default_size_fn(got, i) for i in range(len(got))]
        assert sizes == [jloader._default_size_fn(want, i) for i in range(len(want))]
        assert max(max(s) for s in sizes) == 300

    @pytest.mark.parametrize("size", [1, 2, 5])
    def test_prefetch_to_device_cpu(self, tree, size):
        batches = list(tloader.BucketedPairLoader(_pair_ds(tdatasets, tree, with_info=True),
                                                  3, buckets=LADDER))
        staged = list(tloader.prefetch_to_device(iter(batches), size=size, device="cpu",
                                                 skip=("idx", "scene")))
        assert len(staged) == len(batches)
        for s, b in zip(staged, batches):
            assert s.keys() == b.keys()
            for k, v in b.items():
                if k in ("idx", "scene"):
                    assert s[k] is v
                else:
                    assert isinstance(s[k], torch.Tensor)
                    np.testing.assert_array_equal(s[k].numpy(), v)

    def test_prefetch_cuda_without_gpu_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        with pytest.raises(RuntimeError):
            next(tloader.prefetch_to_device(iter([{"a": np.zeros(2)}]), device="cuda"))


class TestCollated:
    BUCKETS = LADDER

    @pytest.fixture(scope="class")
    def caches(self, tree, tmp_path_factory):
        root = tmp_path_factory.mktemp("caches")
        out = {}
        for name, pkg, lib in (("port", tdatasets, tcollated), ("jax", jdatasets, jcollated)):
            ds = _pair_ds(pkg, tree, with_info=True)
            out[name] = str(root / name)
            lib.build_collated_cache(ds, out[name], buckets=self.BUCKETS, verbose=False)
        return out

    def test_port_cache_equals_jax_cache(self, caches):
        names = sorted(os.listdir(caches["jax"]))
        assert sorted(os.listdir(caches["port"])) == names
        for f in names:
            if f.endswith(".npy"):
                a, b = (np.load(os.path.join(caches[k], f)) for k in ("port", "jax"))
                np.testing.assert_array_equal(a, b, err_msg=f)
                assert a.dtype == b.dtype, f
        meta = {k: json.load(open(os.path.join(v, "collated_meta.json")))
                for k, v in caches.items()}
        for m in meta.values():
            m.pop("build_s")
        assert meta["port"] == meta["jax"]

    @pytest.mark.parametrize("reader,built", [("port", "jax"), ("jax", "port")])
    def test_each_reads_the_other(self, caches, reader, built):
        lib = tcollated if reader == "port" else jcollated
        other = jcollated if reader == "port" else tcollated
        assert lib.has_collated_cache(caches[built])
        _assert_batches_equal(lib.CollatedPairLoader(caches[built], 3),
                              other.CollatedPairLoader(caches[reader], 3))

    def test_batches_equal_bucketed_loader(self, tree, caches):
        coll = list(tcollated.CollatedPairLoader(caches["port"], 3))
        buck = list(tloader.BucketedPairLoader(_pair_ds(tdatasets, tree, with_info=True), 3,
                                               buckets=self.BUCKETS))
        by_cap = lambda bs, c: [b for b in bs if b["src"].shape[1] == c]
        for cap in self.BUCKETS:
            _assert_batches_equal(by_cap(coll, cap), by_cap(buck, cap))

    def test_collated_or_build_and_guards(self, tree, tmp_path, caches, capsys):
        ds = _pair_ds(tdatasets, tree, with_info=True)
        loader = tcollated.collated_or_build(ds, str(tmp_path / "c"), 4, buckets=self.BUCKETS)
        assert len(loader) == len(jcollated.CollatedPairLoader(caches["jax"], 4))
        tcollated.collated_or_build(ds, str(tmp_path / "c"), 4, buckets=(512, 1024))
        assert "WARNING" in capsys.readouterr().err
        with pytest.raises(FileNotFoundError):
            tcollated.CollatedPairLoader(str(tmp_path / "none"), 4)
        meta = tmp_path / "c" / "collated_meta.json"
        m = json.loads(meta.read_text())
        m["version"] = 2
        meta.write_text(json.dumps(m))
        with pytest.raises(ValueError):
            tcollated.CollatedPairLoader(str(tmp_path / "c"), 4)


def _icp_inputs(B=6, N=200, seed=3, angle=0.15):
    """Batched clouds with a known pose and a perturbed init."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    th = rng.uniform(-angle, angle, (B, 3))
    init = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    tgt = np.empty_like(src)
    for b in range(B):
        cx, cy, cz = np.cos(th[b])
        sx, sy, sz = np.sin(th[b])
        R = (np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
             @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
             @ np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]))
        tgt[b] = src[b] @ R.T + rng.uniform(-0.05, 0.05, 3) + rng.normal(0, 0.003, (N, 3))
        init[b, :3, 3] = rng.uniform(-0.03, 0.03, 3)
    sm = np.ones((B, N), bool)
    sm[1, 150:] = False
    tm = np.ones((B, N), bool)
    tm[2, 170:] = False
    return src, tgt, sm, tm, init


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


class TestChunkedICP:
    @pytest.fixture(scope="class")
    def inputs(self):
        return _icp_inputs()

    def _port(self, inputs, chunk, max_iteration=30):
        src, tgt, sm, tm, init = inputs
        return ticp.registration_icp_batched(_t(src), _t(tgt), 0.3, init=_t(init),
                                             max_iteration=max_iteration, src_mask=_t(sm),
                                             tgt_mask=_t(tm), chunk=chunk)

    @staticmethod
    def _close(got, want):
        np.testing.assert_allclose(np.asarray(got.transformation),
                                   np.asarray(want.transformation), atol=TOL, rtol=0)
        np.testing.assert_allclose(np.asarray(got.fitness), np.asarray(want.fitness),
                                   atol=TOL, rtol=0)
        d_it = np.abs(np.asarray(got.iterations, np.int64) - np.asarray(want.iterations))
        assert d_it.max() <= 1, (got.iterations, want.iterations)

    @pytest.mark.parametrize("chunk,max_iteration", [(8, 30), (3, 30), (8, 100), (1, 5)])
    def test_chunked_vs_continuous(self, inputs, chunk, max_iteration):
        want = self._port(inputs, None, max_iteration)
        got = self._port(inputs, chunk, max_iteration)
        self._close(got, want)
        assert int(got.iterations.max()) <= max_iteration

    def test_chunked_vs_jax_chunked(self, inputs):
        src, tgt, sm, tm, init = inputs
        want = jicp.registration_icp_batched(*map(jnp.asarray, (src, tgt)), 0.3,
                                             init=jnp.asarray(init), max_iteration=30,
                                             src_mask=jnp.asarray(sm),
                                             tgt_mask=jnp.asarray(tm), chunk=8)
        self._close(self._port(inputs, 8), want)

    def test_chunk_below_one_raises(self, inputs):
        with pytest.raises(ValueError):
            self._port(inputs, 0)

    def test_early_exit_is_exact(self, inputs, monkeypatch):
        """At KITTI's 1,000-iteration budget every lane converges early; the
        loop that leaves once none is alive gives the bits of the loop that
        runs all 1,000 steps."""
        got = self._port(inputs, None, 1000)
        assert int(got.iterations.max()) < 200
        monkeypatch.setattr(ticp, "EXIT_EVERY", 10 ** 9)
        want = self._port(inputs, None, 1000)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _models():
    """(jax apply_fn, jax params, port model) and the DEM twins, same fp32
    weights from one random init."""
    z = jnp.zeros((1, 8, 3), jnp.float32)
    ones = jnp.ones((1, 8), bool)
    jm = JPT(JModelConfig(**KW))
    jp = jm.init(jax.random.PRNGKey(7), z, z, ones, ones, jnp.zeros((1, 1, 3)))["params"]
    tm = PointTransformer(ModelConfig(**KW), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)), strict=True)
    jd = JDEM(JModelConfig(separate_stems=True, **KW))
    jdp = jd.init(jax.random.PRNGKey(8), z, z, ones, ones)["params"]
    td = DEMTransformer(ModelConfig(separate_stems=True, **KW), device="cpu")
    td.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jdp)), strict=True)
    return (lambda p, s, t, sm, tm_, c: jm.apply({"params": p}, s, t, sm, tm_, c), jp, tm.eval(),
            lambda p, d, c, dm, cm: jd.apply({"params": p}, d, c, dm, cm), jdp, td.eval())


@pytest.fixture(scope="module")
def models():
    return _models()


def _loader(pkg, ds_pkg, root, split, normalize, with_info, skip=False):
    ds = _pair_ds(ds_pkg, root, split, normalize=normalize, with_info=with_info, max_points=CAP)
    if skip:
        ds = (teval if pkg is tloader else jeval).SkipDataset(ds, (124, 142))
    return pkg.PairLoader(ds, batch_size=8, src_capacity=CAP)


def _assert_stats(got, want, count_keys, stat_keys):
    assert got.keys() == want.keys()
    for k in count_keys:
        assert got[k] == want[k], (k, got[k], want[k])
    for k in stat_keys:
        assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])


class TestRequeue:
    @staticmethod
    def _close(got, want):
        for f in ("transform", "re_deg", "te"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       atol=TOL, rtol=0, err_msg=f)

    def test_matches_jax_on_3dmatch_pairs(self, models, ptree):
        """The whole requeue path (forward, solve, chunked ICP, acceptance)
        against JAX's on the pairs with a well-posed pose solve, and
        against the port's fused path on all."""
        apply_fn, jp, tm = models[:3]
        batch = next(iter(_loader(tloader, tdatasets, ptree, "3DMatch_test", "unit_sphere",
                                  True)))
        kw = dict(dis_thresh=0.1, corr="tgt", icp_thresh=0.1, icp_max_iter=60)
        got = treg.register_batch_requeue(tm, batch, icp_chunk=8, device="cpu", **kw)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want = jreg.register_batch_requeue(apply_fn, jp, jb, icp_chunk=8, **kw)
        n_got, n_want = got.n_corr.numpy(), np.asarray(want.n_corr)
        assert (np.abs(n_got - n_want) <= np.maximum(1, 0.02 * n_want)).all()
        # Below 3 correspondences the pose solve leaves the rotation
        # undetermined (any SVD basis is right): hold the other pairs.
        ok = n_want >= 3
        assert ok.sum() >= 6
        for f in ("transform", "re_deg", "te", "rmse"):
            np.testing.assert_allclose(getattr(got, f).numpy()[ok],
                                       np.asarray(getattr(want, f))[ok], atol=TOL, rtol=0,
                                       err_msg=f)
        fused = treg.register_batch(tm, batch, device="cpu", **kw)
        np.testing.assert_allclose(got.transform.numpy(), fused.transform.numpy(), atol=1e-5,
                                   rtol=0)

    def test_presolved_kitti_batch(self, models, ptree):
        """KITTI's thresholds and metric scale from one presolved stage (the
        JAX package's, given to both): chunked ICP and the acceptance
        against JAX's; the port's own presolve gives its un-presolved
        result and its fused path's."""
        apply_fn, jp, tm = models[:3]
        batch = next(iter(_loader(tloader, tdatasets, ptree, "KITTI_test", "unit_cube", False)))
        kw = dict(dis_thresh=1.5, corr="tgt", icp_thresh=1.0, icp_max_iter=60,
                  center_mode="neg_rt")
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jpre = jreg._register_solve_stage(apply_fn, jp, jb, 1.5, "tgt", "neg_rt", False)
        want = jreg.register_batch_requeue(apply_fn, jp, jb, icp_chunk=8, presolved=jpre, **kw)
        tpre = (treg.PoseSolution(*(_t(x) for x in jpre[0])),) + tuple(_t(x) for x in jpre[1:])
        got = treg.register_batch_requeue(tm, batch, icp_chunk=8, device="cpu",
                                          presolved=tpre, **kw)
        self._close(got, want)
        own = treg.register_batch_requeue(tm, batch, icp_chunk=8, device="cpu", **kw)
        presolved = treg._register_solve_stage(
            tm, treg.to_device(batch, "cpu", treg.BATCH_KEYS), 1.5, "tgt", "neg_rt")
        again = treg.register_batch_requeue(tm, batch, icp_chunk=8, device="cpu",
                                            presolved=presolved, **kw)
        fused = treg.register_batch(tm, batch, device="cpu", **kw)
        assert torch.equal(again.transform, own.transform)
        np.testing.assert_allclose(own.transform.numpy(), fused.transform.numpy(), atol=1e-5,
                                   rtol=0)

    def test_accept_if_better(self):
        rng = np.random.default_rng(2)
        gt = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
        gt[:, :3, 3] = rng.normal(0, 1, (5, 3))
        a, b = gt.copy(), gt.copy()
        a[:, :3, 3] += rng.normal(0, 0.1, (5, 3))
        b[:, :3, 3] += rng.normal(0, 0.1, (5, 3))
        got = treg._accept_if_better(_t(a), _t(b), _t(gt))
        want = jreg._accept_if_better(*map(jnp.asarray, (a, b, gt)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


REG_COUNTS = ("n_pairs",)
REG_STATS = ("registration_recall", "rre", "rte", "pair_recall", "success_rre",
             "success_rte")


class TestProtocols:
    @pytest.mark.parametrize("protocol", ["3dmatch", "3dzeromatch"])
    def test_evaluate_registration(self, models, ptree, protocol):
        apply_fn, jp, tm = models[:3]
        cfg = eval_preset(protocol)
        got = _quiet(teval.evaluate_registration, tm,
                     _loader(tloader, tdatasets, ptree, "3DMatch_test", "unit_sphere", True),
                     cfg, device="cpu")
        want = _quiet(jeval.evaluate_registration, apply_fn, jp,
                      _loader(jloader, jdatasets, ptree, "3DMatch_test", "unit_sphere", True),
                      JEvalConfig(**dataclasses.asdict(cfg)))
        _assert_stats(got, want, REG_COUNTS, REG_STATS)
        assert round(got["pair_recall"] * got["n_pairs"]) == \
            round(want["pair_recall"] * want["n_pairs"])
        for k in got:
            if k.startswith("rr/"):
                assert abs(got[k] - want[k]) <= 1e-12, k

    @pytest.mark.parametrize("icp_chunk", [None, 8])
    def test_evaluate_kitti(self, models, ptree, icp_chunk):
        apply_fn, jp, tm = models[:3]
        kw = dict(icp_chunk=icp_chunk)
        got = teval.evaluate_kitti(
            tm, _loader(tloader, tdatasets, ptree, "KITTI_test", "unit_cube", False, True),
            device="cpu", **kw)
        want = jeval.evaluate_kitti(
            apply_fn, jp,
            _loader(jloader, jdatasets, ptree, "KITTI_test", "unit_cube", False, True), **kw)
        _assert_stats(got, want, ("n_pairs",), ("success_rate", "success_rre", "success_rte"))
        assert round(got["success_rate"] * 8) == round(want["success_rate"] * 8)

    def test_evaluate_open_gf(self, models, ptree):
        japply, jdp, td = models[3:]

        def loader(pkg, ds_pkg):
            return pkg.DEMLoader(_quiet(ds_pkg.OpenGFDataset, ptree, "test"), batch_size=4,
                                 dsm_capacity=CAP, dem_capacity=CAP, coarse_capacity=64)

        got = teval.evaluate_open_gf(td, loader(tloader, tdatasets), device="cpu")
        want = jeval.evaluate_open_gf(japply, jdp, loader(jloader, jdatasets))
        assert got.keys() == want.keys() and got["n_patches"] == want["n_patches"] == 6
        for k in ("chamfer_x1000", "height_mae_x1000", "height_mse_x1000"):
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got[k], want[k])

    def test_no_counted_pairs_raises(self, models, ptree):
        tm = models[2]
        ds = tdatasets.SyntheticPairDataset(length=2, n_src=100, n_tgt=100, with_info=True)
        items = []
        for i in range(2):
            it = ds[i]
            it["idx"] = np.array([3, 4], np.int32)  # gap 1: not counted
            items.append(it)
        with pytest.raises(ValueError, match="no counted"):
            teval.evaluate_3d_match(tm, tloader.PairLoader(items, 2, 128), device="cpu")

    def test_missing_covariance_raises(self, models):
        ds = tdatasets.SyntheticPairDataset(length=2, n_src=100, n_tgt=100)
        with pytest.raises(ValueError, match="covariance"):
            teval.evaluate_3d_match(models[2], tloader.PairLoader(ds, 2, 128), device="cpu")

    def test_empty_scenes_warn(self, models, ptree):
        ds = _pair_ds(tdatasets, ptree, with_info=True, max_points=CAP)
        two = tloader.PairLoader([ds[i] for i in range(3)], 3, CAP)
        with pytest.warns(UserWarning, match="no counted"):
            teval.evaluate_3d_lo_match(models[2], two, device="cpu")


class TestEvaluateCLI:
    FLAGS = ["--device", "cpu", "--max-points", str(CAP), "--d-model", "128",
             "--self-layers", "1", "--cross-layers", "1", "--dtype", "float32"]

    @pytest.fixture(scope="class")
    def jax_keys(self):
        """The keys the JAX command prints: the protocol functions' dicts
        (the registration one with every scene populated, as on the
        synthetic fallback, where item i is scene i % 8)."""
        reg = set(REG_STATS) | set(REG_COUNTS) | {f"rr/{s}" for s in jeval.SCENE_NAMES}
        return {"3dmatch": reg, "3dzeromatch": reg, "3dlomatch": reg,
                "kitti": {"success_rate", "success_rre", "success_rte", "n_pairs"},
                "opengf": {"chamfer_x1000", "height_mae_x1000", "height_mse_x1000",
                           "n_patches"}}

    @pytest.mark.parametrize("protocol", ["3dmatch", "3dzeromatch", "kitti", "opengf"])
    def test_keys(self, protocol, jax_keys, capsys):
        tcli.main(["evaluate", protocol, *self.FLAGS, "--root", "no-such-root"])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert torch.is_grad_enabled()  # the command leaves the process as it was
        assert set(out) == jax_keys[protocol]
        assert all(np.isfinite(v) for v in out.values())

    def test_bucketed_and_cache_dir(self, ptree, tmp_path, capsys):
        flags = self.FLAGS + ["--root", ptree]
        outs = []
        for extra in (["--bucketed"], ["--cache-dir", str(tmp_path / "cache")], []):
            tcli.main(["evaluate", "3dmatch", *flags, *extra])
            outs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
        assert outs[0]["n_pairs"] == outs[1]["n_pairs"] == outs[2]["n_pairs"] == 16
        for k in outs[0]:
            assert abs(outs[0][k] - outs[1][k]) <= 1e-12, k
        assert os.path.exists(tmp_path / "cache" / "collated_meta.json")

    @pytest.mark.parametrize("argv,msg", [
        (["3dmatch", "--experimental-icp-chunk", "4"], "kitti protocol only"),
        (["kitti", "--experimental-icp-chunk", "0"], ">= 1"),
        (["kitti", "--mesh", "data=2,expert=2"], "unknown mesh axes"),
    ])
    def test_refusals(self, argv, msg):
        with pytest.raises(SystemExit, match=msg):
            tcli.main(["evaluate", *argv, "--device", "cpu"])
