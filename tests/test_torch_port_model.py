"""The PyTorch port's model against the JAX package on the CPU, in fp32:
position embedding, linear attention, the attention block (plain body and the
fused kernels' plain versions against the Pallas kernels in interpret mode),
and the full PointTransformer forward (the weight converter and the shipped
checkpoint are in ``test_torch_port_convert.py``).

Tolerance: <= 1e-4 relative, measured as max |port - jax| over max |jax|
(valid rows only where rows are masked). Inputs come from seeded numpy; the
same parameters reach both sides through ``params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scream_tpu.config import ModelConfig as JModelConfig
from scream_tpu.models.attention import AttentionBlock as JAttentionBlock
from scream_tpu.models.attention import linear_attention as j_linear_attention
from scream_tpu.models.attention import sinusoidal_pe as j_sinusoidal_pe
from scream_tpu.models.point_transformer import PointTransformer as JPointTransformer
from scream_tpu.ops.attn_pallas import attention_block as j_attention_block
from scream_tpu_torch.config import ModelConfig
from scream_tpu_torch.models import AttentionBlock, PointTransformer
from scream_tpu_torch.models.attention import linear_attention, sinusoidal_pe
from scream_tpu_torch.ops import attn_cuda, tail_cuda
from scream_tpu_torch.utils.convert import params_from_jax

REL = 1e-4


def assert_rel(got, want, tol=REL, rows=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if rows is not None:
        m = np.asarray(rows)[..., None]
        got, want = got * m, want * m
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"relative error {err:.3g} > {tol}"


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def small_cfgs(**kw):
    base = dict(d_model=64, num_heads=4, self_layers=1, cross_layers=1,
                dtype="float32")
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


class TestEmbeddingAndAttention:
    @pytest.mark.parametrize("d_model", [64, 100, 256])
    def test_sinusoidal_pe(self, rng, d_model):
        xyz = rng.uniform(-1.2, 1.2, (2, 50, 3)).astype(np.float32)
        want = j_sinusoidal_pe(jnp.asarray(xyz), d_model)
        got = sinusoidal_pe(t(xyz), d_model)
        assert_rel(got.numpy(), want)

    @pytest.mark.parametrize("masked", [False, True])
    def test_linear_attention(self, rng, masked):
        q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
        k = rng.standard_normal((2, 30, 4, 16)).astype(np.float32)
        v = rng.standard_normal((2, 30, 4, 16)).astype(np.float32)
        qm = rng.random((2, 40)) > 0.2 if masked else None
        km = rng.random((2, 30)) > 0.2 if masked else None
        want = j_linear_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  None if qm is None else jnp.asarray(qm),
                                  None if km is None else jnp.asarray(km))
        got = linear_attention(t(q), t(k), t(v), None if qm is None else t(qm),
                               None if km is None else t(km))
        assert_rel(got.numpy(), want)


def _block_args(rng, B=2, L=64, S=48, d=64, hid=256):
    a = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.1
    xq, xkv = a(B, L, d), a(B, S, d)
    qm, km = rng.random((B, L)) > 0.2, rng.random((B, S)) > 0.2
    params = {
        "q_proj": {"kernel": a(d, d)}, "k_proj": {"kernel": a(d, d)},
        "v_proj": {"kernel": a(d, d)}, "merge": {"kernel": a(d, d)},
        "norm1": {"scale": 1.0 + a(d), "bias": a(d)},
        "norm2": {"scale": 1.0 + a(d), "bias": a(d)},
        "ffn_in": {"kernel": a(d, hid)}, "ffn_out": {"kernel": a(hid, d)},
    }
    return xq, xkv, qm, km, params


def _weights(params):
    p = params
    return (p["q_proj"]["kernel"], p["k_proj"]["kernel"], p["v_proj"]["kernel"],
            p["merge"]["kernel"], p["norm1"]["scale"], p["norm1"]["bias"],
            p["ffn_in"]["kernel"], p["ffn_out"]["kernel"], p["norm2"]["scale"],
            p["norm2"]["bias"])


class TestAttentionBlock:
    @pytest.mark.parametrize("mode", ["self", "cross"])
    def test_plain_block_matches_flax_module(self, rng, mode):
        xq, xkv, qm, km, params = _block_args(rng)
        if mode == "self":
            xkv, km = xq, qm
        jblk = JAttentionBlock(d_model=64, num_heads=4, ffn_mult=4,
                               fused_tail=False, fused_attn=False)
        jx, jkv = jnp.asarray(xq), jnp.asarray(xkv)
        want = jblk.apply({"params": params}, jx, jkv if mode == "cross" else jx,
                          jkv if mode == "cross" else jx, jnp.asarray(qm),
                          jnp.asarray(km))
        blk = AttentionBlock(64, 4, 4, fused_attn=False)
        blk.load_state_dict(params_from_jax(params))
        tx, tkv = t(xq), t(xkv)
        kv = tkv if mode == "cross" else tx
        got = blk(tx, kv, kv, t(qm), t(km))
        assert_rel(got.detach().numpy(), want, rows=qm)

    @pytest.mark.parametrize("L,S", [(256, 256), (100, 300)])
    def test_fused_plain_versions_match_pallas_kernels(self, rng, L, S):
        """The fused path's kernels, run as their plain versions on the CPU,
        against the Pallas stats/apply kernels in interpret mode, at the
        kernel's width (d 256, 8 heads)."""
        xq, xkv, qm, km, params = _block_args(rng, B=2, L=L, S=S, d=256, hid=1024)
        W = _weights(params)
        want = j_attention_block(jnp.asarray(xq), jnp.asarray(xkv), jnp.asarray(qm),
                                 jnp.asarray(km), *map(jnp.asarray, W), num_heads=8,
                                 dtype=jnp.float32, norm_dtype=jnp.float32,
                                 use_pallas=True, interpret=True)
        got = attn_cuda.attention_block_fused(
            t(xq), t(xkv), t(qm), t(km), *map(t, W), num_heads=8,
            dtype=torch.float32, norm_dtype=torch.float32)
        assert_rel(got.numpy(), want, rows=qm)

    def test_stats_are_the_diagonal_head_blocks(self, rng):
        """The stats kernel keeps only the per-head blocks of the TPU's full
        d x d KV: its plain version equals the per-head einsum of the unfused
        attention."""
        xq, xkv, qm, km, params = _block_args(rng, B=2, L=8, S=70, d=256, hid=1024)
        Wk, Wv = params["k_proj"]["kernel"], params["v_proj"]["kernel"]
        KV, ksum = attn_cuda.attn_stats(t(xkv), t(km).float(), t(Wk), t(Wv), num_heads=8)
        K = np.asarray(jax.nn.elu(jnp.asarray(xkv @ Wk)) + 1.0) * km[..., None]
        V = (xkv @ Wv) * km[..., None]
        Kh, Vh = K.reshape(2, 70, 8, 32), V.reshape(2, 70, 8, 32)
        assert KV.shape == (2, 8, 32, 32) and ksum.shape == (2, 256)
        assert_rel(KV.numpy(), np.einsum("bshd,bshv->bhdv", Kh, Vh))
        assert_rel(ksum.numpy(), K.sum(1))

    def test_fused_block_backward_recomputes_plain(self, rng):
        xq, xkv, qm, km, params = _block_args(rng, B=1, L=40, S=30, d=256, hid=1024)
        proj = t(rng.standard_normal((1, 40, 256)).astype(np.float32))

        def grads(fused):
            ins = [t(xq).requires_grad_(), t(xkv).requires_grad_()]
            W = [t(w).requires_grad_() for w in _weights(params)]
            kw = dict(num_heads=8, cd=torch.float32, nd=torch.float32,
                      attn_eps=1e-6, ln_eps=1e-5)
            if fused:
                out = attn_cuda.attention_block_fused(
                    ins[0], ins[1], t(qm), t(km), *W, num_heads=8,
                    dtype=torch.float32, norm_dtype=torch.float32)
            else:
                out = attn_cuda.block_plain(ins[0], ins[1], t(qm), t(km), *W, **kw)
            (out * proj).sum().backward()
            return [x.grad.numpy() for x in ins + W]

        for g_fused, g_plain in zip(grads(True), grads(False)):
            np.testing.assert_allclose(g_fused, g_plain, rtol=1e-5, atol=1e-6)

    def test_fusable_block_rule(self):
        fusable = lambda *a: attn_cuda.jax_fusable_block(*a) and attn_cuda.kernels_take(*a)
        assert fusable(256, 1024, 8, torch.bfloat16)
        assert fusable(128, 512, 8, torch.bfloat16)
        assert fusable(256, 1024, 8, torch.float32)
        assert fusable(128, 512, 8, torch.float32)
        assert fusable(256, 1024, 16, torch.bfloat16)
        assert fusable(384, 1536, 8, torch.bfloat16)
        assert not fusable(512, 2048, 16, torch.bfloat16)
        # Head dims the head-specific kernels lack (24 at d 384, 128 at d 256)
        # go to the head-generic pair; fp32 at d 384 is out of the JAX rule's
        # budget at hidden 4 d.
        assert fusable(384, 1536, 16, torch.bfloat16)
        assert not attn_cuda.head_cell(384, 16, torch.bfloat16)
        assert fusable(256, 1024, 2, torch.bfloat16)
        assert not attn_cuda.head_cell(256, 2, torch.bfloat16)
        assert not attn_cuda.jax_fusable_block(384, 1536, 8, torch.float32)
        assert not attn_cuda.jax_fusable_block(512, 2048, 16, torch.bfloat16)

    @pytest.mark.parametrize("L,S", [(128, 128), (100, 200)])
    def test_fused_plain_versions_match_pallas_kernels_d128(self, rng, L, S):
        """The hint-free width (d 128, 8 heads of 16): the fused path's
        plain versions against the Pallas kernels in interpret mode, fp32."""
        xq, xkv, qm, km, params = _block_args(rng, B=2, L=L, S=S, d=128, hid=512)
        W = _weights(params)
        want = j_attention_block(jnp.asarray(xq), jnp.asarray(xkv), jnp.asarray(qm),
                                 jnp.asarray(km), *map(jnp.asarray, W), num_heads=8,
                                 dtype=jnp.float32, norm_dtype=jnp.float32,
                                 use_pallas=True, interpret=True)
        got = attn_cuda.attention_block_fused(
            t(xq), t(xkv), t(qm), t(km), *map(t, W), num_heads=8,
            dtype=torch.float32, norm_dtype=torch.float32)
        assert_rel(got.numpy(), want, rows=qm)
        KV, ksum = attn_cuda.attn_stats(t(xkv), t(km).float(), t(W[1]), t(W[2]),
                                        num_heads=8)
        assert KV.shape == (2, 8, 16, 16) and ksum.shape == (2, 128)

    @pytest.mark.parametrize("mode", ["self", "cross"])
    def test_plain_block_d128_matches_flax_module(self, rng, mode):
        xq, xkv, qm, km, params = _block_args(rng, B=2, L=40, S=56, d=128, hid=512)
        if mode == "self":
            xkv, km = xq, qm
        jblk = JAttentionBlock(d_model=128, num_heads=8, ffn_mult=4,
                               fused_tail=False, fused_attn=False)
        jx, jkv = jnp.asarray(xq), jnp.asarray(xkv)
        want = jblk.apply({"params": params}, jx, jkv, jkv, jnp.asarray(qm),
                          jnp.asarray(km))
        blk = AttentionBlock(128, 8, 4, fused_attn=False)
        blk.load_state_dict(params_from_jax(params))
        tkv = t(xkv)
        got = blk(t(xq), tkv, tkv, t(qm), t(km))
        assert_rel(got.detach().numpy(), want, rows=qm)

    def test_cpu_default_dispatch_is_plain_body(self, rng, monkeypatch):
        calls = []
        monkeypatch.setattr(attn_cuda, "attention_block_fused",
                            lambda *a, **k: calls.append(1))
        blk = AttentionBlock(256, 8, 4, dtype=torch.bfloat16)
        x = torch.zeros((1, 4, 256))
        blk(x, x, x)
        assert not calls
        AttentionBlock(256, 8, 4, fused_attn=True)(x, x, x)
        assert calls == [1]


class TestCudaRouting:
    """The block's decision on CUDA tensors, built here by patching the
    routing predicate: where the JAX package runs a Pallas kernel on the TPU
    the port runs its CUDA kernels or raises, never plain code in the
    kernel's place, unless the caller asks for it. The fused kernels record
    their head count, the tail kernel "tail"."""

    @pytest.fixture
    def cuda_like(self, monkeypatch):
        from scream_tpu_torch.utils import device as device_util

        monkeypatch.setattr(device_util, "on_cuda", lambda x: True)
        calls = []
        monkeypatch.setattr(attn_cuda, "attention_block_fused",
                            lambda *a, **k: calls.append(k["num_heads"]) or a[0])
        monkeypatch.setattr(tail_cuda, "block_tail",
                            lambda *a, **k: calls.append("tail") or a[1])
        return calls

    @staticmethod
    def _run(d, heads, dtype=torch.bfloat16, ffn_mult=4, **kw):
        blk = AttentionBlock(d, heads, ffn_mult, dtype=dtype, **kw)
        x = torch.zeros((1, 4, d))
        return blk(x, x, x)

    @pytest.mark.parametrize("d,dtype", [(128, torch.bfloat16), (256, torch.bfloat16),
                                         (128, torch.float32), (256, torch.float32)])
    def test_kernel_shapes_run_the_fused_kernels(self, cuda_like, d, dtype):
        self._run(d, 8, dtype)
        assert cuda_like == [8]

    @pytest.mark.parametrize("d,heads", [(256, 2), (384, 16)])
    def test_head_generic_shapes_run_the_fused_kernels(self, cuda_like, d, heads):
        """Head dims no head-specific kernel takes (128 at d 256, 24 at d 384)
        run the head-generic pair."""
        self._run(d, heads)
        assert cuda_like == [heads]

    @pytest.mark.parametrize("d,heads,dtype,ffn_mult", [(512, 8, torch.bfloat16, 2),
                                                        (384, 8, torch.float32, 1)])
    def test_admitted_shapes_the_kernels_do_not_take_raise(self, cuda_like, d, heads,
                                                           dtype, ffn_mult):
        """The width cells: the JAX rule fuses the block (its smaller hidden
        width fits the VMEM budget) and no CUDA kernel takes the width."""
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            self._run(d, heads, dtype, ffn_mult=ffn_mult)
        assert not cuda_like

    def test_tail_kernel_shapes_raise(self, cuda_like):
        """d 512: the fused block is out of the JAX rule's budget and the TPU
        runs its tail kernel, so the port runs its tail kernel; so it does at
        fp32 d 384, where the TPU runs the tail kernel too. Only a tail asked
        for where no kernel is written raises: fp32 at d 512, which the JAX
        rule does not admit, under ``fused_block_tail=True``."""
        self._run(512, 16)
        # fused_attn=True with separate k and v: the plain attention, whose
        # tail the TPU runs as its kernel.
        blk = AttentionBlock(256, 8, 4, dtype=torch.bfloat16, fused_attn=True)
        x = torch.zeros((1, 4, 256))
        blk(x, x, x.clone())
        self._run(384, 8, torch.float32)
        assert cuda_like == ["tail", "tail", "tail"]
        with pytest.raises(NotImplementedError, match="tail"):
            self._run(512, 8, torch.float32, fused_tail=True)
        assert cuda_like == ["tail", "tail", "tail"]

    def test_explicit_plain_requests_run_the_plain_body(self, cuda_like):
        out = self._run(512, 16, fused_tail=False)
        assert out.shape == (1, 4, 512)
        self._run(512, 16, fused_attn=False, fused_tail=False)
        self._run(256, 8, fused_attn=False, fused_tail=False)
        self._run(128, 8, torch.float32, fused_attn=False, fused_tail=False)
        assert not cuda_like
        # fused_attn=False alone asks for the plain attention and leaves the
        # tail on auto, as in the JAX package: the tail kernel runs.
        self._run(512, 16, fused_attn=False)
        self._run(256, 8, fused_attn=False)
        assert cuda_like == ["tail", "tail"]

    def test_shapes_without_a_tpu_kernel_run_the_plain_body(self, cuda_like):
        """d 1024: neither JAX rule holds, so the TPU runs XLA there too."""
        assert self._run(1024, 8).shape == (1, 4, 1024)
        assert not cuda_like

    def test_model_config_reaches_the_blocks(self):
        _, tc = small_cfgs(fused_attention=False, fused_block_tail=False)
        blk = PointTransformer(tc, device="cpu").trunk.stem_0
        assert blk.fused_attn is False and blk.fused_tail is False


def _init_jax(jcfg, N=40, M=48, B=2, seed=0):
    model = JPointTransformer(jcfg)
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (B, M, 3)).astype(np.float32)
    sm = rng.random((B, N)) > 0.1
    tm = rng.random((B, M)) > 0.1
    center = rng.uniform(-0.2, 0.2, (B, 1, 3)).astype(np.float32)
    args = (src, tgt, sm, tm, center)
    params = model.init(jax.random.PRNGKey(seed), *map(jnp.asarray, args))["params"]
    return model, params, args


class TestPointTransformer:
    @pytest.mark.parametrize("fused", [None, True])
    def test_forward_matches_jax(self, fused):
        """``fused=True`` sends every block through the fused kernels' plain
        versions at their width (d 256, 8 heads); the JAX side runs its
        unfused XLA body (the Pallas kernels need the TPU or interpret mode,
        which the module does not expose)."""
        width = dict(d_model=64, num_heads=4) if fused is None \
            else dict(d_model=256, num_heads=8)
        jc, _ = small_cfgs(**width)
        _, tc = small_cfgs(fused_attention=fused, **width)
        jmodel, params, args = _init_jax(jc)
        want = jmodel.apply({"params": params}, *map(jnp.asarray, args))
        model = PointTransformer(tc, device="cpu")
        model.load_state_dict(params_from_jax(np_tree(params)))
        with torch.no_grad():
            got = model(*map(t, args))
        assert got.dtype == torch.float32 and got.shape == (2, 40, 3)
        assert_rel(got.numpy(), want, rows=args[2])

    def test_default_center_is_masked_centroid(self):
        jc, tc = small_cfgs()
        jmodel, params, (src, tgt, sm, tm, _) = _init_jax(jc)
        want = jmodel.apply({"params": params}, jnp.asarray(src), jnp.asarray(tgt),
                            jnp.asarray(sm), jnp.asarray(tm))
        model = PointTransformer(tc, device="cpu")
        model.load_state_dict(params_from_jax(np_tree(params)))
        with torch.no_grad():
            got = model(t(src), t(tgt), t(sm), t(tm))
        assert_rel(got.numpy(), want, rows=sm)

    def test_seeded_init_is_reproducible(self):
        _, tc = small_cfgs()
        a = PointTransformer(tc, device="cpu", generator=torch.Generator().manual_seed(3))
        b = PointTransformer(tc, device="cpu", generator=torch.Generator().manual_seed(3))
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
