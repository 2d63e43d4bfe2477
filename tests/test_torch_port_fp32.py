"""The float32 configuration's kernels (``csrc/attn_f32.cu``,
``csrc/tail_f32.cu``) through what the CPU can reach, against the JAX
package.

* The fp32 plain versions, which the kernels are held to on the card,
  against the Pallas kernels in interpret mode at HIGHEST precision:
  ``_stats_kernel`` and ``_apply_kernel`` at d 128 and 256 over 300 rows
  (ragged against the 256-row tile), 1e-5 of the largest value;
  ``_tail_kernel`` at d 384 over 300 rows, 2e-5 (``test_torch_port_tail.py``'s
  fp32 bar).
* A model of the fp32 stats kernel's summation order (each 64-row tile's
  partial sums in row order, then the tiles in tile order): within 1e-6 of
  the plain version, the same bits on a second run, exact zeros for an
  all-masked batch.
* The routing of the fp32 configuration on CUDA (faked, as
  ``test_torch_port_tail.py`` fakes it): the fused kernels at d 128 / 256,
  the tail kernel at d 384 and under ``fused_attention=False``, as the JAX
  rules send them on the TPU; and each wrapper, given fp32 tensors it takes
  a CUDA route for, calls its fp32 C entry point (a recording stand-in for
  the library) with the shapes and the promotion chunk, and counts the
  launch.
* ``tests/data/torch_port_fp32_reference.npz``
  (``scripts/torch_port_make_fp32_reference.py``), the JAX forwards that
  ``chip_smoke.py`` holds the card to: recomputed here within 1e-5, and met
  by the port's CPU forwards from ``scream_tpu_torch/weights`` within 1e-5.
"""

import dataclasses
import importlib.util
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from scream_tpu.ops import attn_pallas as jattn
from scream_tpu.ops import ffn_pallas
from scream_tpu_torch.models import AttentionBlock, PointTransformer
from scream_tpu_torch.ops import _build, attn_cuda, tail_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 8
HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def block_inputs(seed, B, S, d):
    """x (B, S, d), a mask with the last batch's tail masked, the block's
    weights (fp32, ``(in, out)``) and LayerNorm params."""
    rng = np.random.default_rng(seed)
    hid = 4 * d
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    mask = rng.random((B, S)) > 0.2
    mask[-1, S // 2:] = False
    Wq, Wk, Wv, Wm, W1, W2 = w(d, d), w(d, d), w(d, d), w(d, d), w(d, hid), w(hid, d)
    g1, g2 = (rng.uniform(0.5, 1.5, d).astype(np.float32) for _ in range(2))
    b1, b2 = ((rng.standard_normal(d) * 0.1).astype(np.float32) for _ in range(2))
    return x, mask, (Wq, Wk, Wv, Wm, g1, b1, W1, W2, g2, b2)


def jax_stats(x, mask, Wk, Wv):
    """``attn_pallas._stats_kernel`` in interpret mode at HIGHEST precision,
    fp32 (the ``pallas_call`` of ``_attention_block_pallas``): the full
    ``(B, d, d)`` KV and ``(B, d)`` K_sum."""
    B, S, d = x.shape
    T = jattn._TILE_R
    xs, mf, Sp = jattn._pad_rows(jnp.asarray(x), jnp.asarray(mask), T)
    Wkv = jnp.concatenate([jnp.asarray(Wk), jnp.asarray(Wv)], axis=1)
    row3 = lambda b, i: (b, i, 0)
    KV, ks = pl.pallas_call(
        partial(jattn._stats_kernel, d=d, prec=HIGHEST, cd=jnp.float32),
        grid=(B, Sp // T),
        in_specs=[pl.BlockSpec((1, T, d), row3, memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, T, 1), row3, memory_space=pltpu.VMEM),
                  pl.BlockSpec((d, 2 * d), lambda b, i: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=[pl.BlockSpec((1, d, d), lambda b, i: (b, 0, 0), memory_space=pltpu.VMEM),
                   pl.BlockSpec((1, 1, d), lambda b, i: (b, 0, 0), memory_space=pltpu.VMEM)],
        out_shape=[jax.ShapeDtypeStruct((B, d, d), jnp.float32),
                   jax.ShapeDtypeStruct((B, 1, d), jnp.float32)],
        interpret=True,
    )(xs, mf, Wkv)
    return np.asarray(KV), np.asarray(ks)[:, 0]


def diag_blocks(KV):
    """The per-head diagonal blocks ``(B, H, hd, hd)`` of a full KV."""
    B, d = KV.shape[0], KV.shape[1]
    hd = d // H
    K = KV.reshape(B, H, hd, H, hd)
    return np.stack([K[:, h, :, h] for h in range(H)], 1)


def jax_apply(x, mask, KV, ksum, Wq, Wm, g1, b1, W1, W2, g2, b2):
    """``attn_pallas._apply_kernel`` in interpret mode at HIGHEST precision,
    fp32, as ``_attention_block_pallas`` calls it for fp32: the full KV with
    its cross-head blocks zeroed, not split hi/lo."""
    B, L, d = x.shape
    hid = W1.shape[1]
    T = jattn._TILE_R
    f32 = jnp.float32
    xs, mf, Lp = jattn._pad_rows(jnp.asarray(x), jnp.asarray(mask), T)
    hid_of = jnp.arange(d) // (d // H)
    KVm = jnp.where((hid_of[:, None] == hid_of[None, :])[None], jnp.asarray(KV), 0.0)
    hsel = (hid_of[:, None] == jnp.arange(H)[None, :]).astype(f32)
    row3 = lambda b, i: (b, i, 0)
    head = lambda b, i: (b, 0, 0)
    vec = lambda shape: pl.BlockSpec(shape, lambda b, i: (0, 0), memory_space=pltpu.VMEM)
    per_b = lambda shape: pl.BlockSpec(shape, head, memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        partial(jattn._apply_kernel, prec=HIGHEST, cd=f32, nd=f32, attn_eps=1e-6,
                ln_eps=1e-5, split_kv=False),
        grid=(B, Lp // T),
        in_specs=[pl.BlockSpec((1, T, d), row3, memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, T, 1), row3, memory_space=pltpu.VMEM),
                  vec((d, d)), per_b((1, d, d)), per_b((1, d, d)), per_b((1, 1, d)),
                  vec((d, H)), vec((H, d)), vec((d, d)), vec((1, d)), vec((1, d)),
                  vec((d, hid)), vec((hid, d)), vec((1, d)), vec((1, d))],
        out_specs=pl.BlockSpec((1, T, d), row3, memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((B, Lp, d), f32),
        interpret=True,
    )(xs, mf, jnp.asarray(Wq), KVm, KVm, jnp.asarray(ksum).reshape(B, 1, d), hsel, hsel.T,
      jnp.asarray(Wm), jnp.asarray(g1).reshape(1, d), jnp.asarray(b1).reshape(1, d),
      jnp.asarray(W1), jnp.asarray(W2), jnp.asarray(g2).reshape(1, d),
      jnp.asarray(b2).reshape(1, d))
    return np.asarray(out)[:, :L]


class TestPlainVersionsAgainstPallas:
    """The fp32 kernels' plain versions against the TPU kernels."""

    @pytest.mark.parametrize("d", [128, 256])
    def test_stats(self, d):
        x, mask, W = block_inputs(d, 2, 300, d)
        KVj, ksj = jax_stats(x, mask, W[1], W[2])
        KV, ks = attn_cuda.attn_stats(t(x), t(mask).float(), t(W[1]), t(W[2]), num_heads=H)
        assert KV.dtype == torch.float32 and KV.shape == (2, H, d // H, d // H)
        assert rel(KV.numpy(), diag_blocks(KVj)) <= 1e-5
        assert rel(ks.numpy(), ksj) <= 1e-5

    @pytest.mark.parametrize("d", [128, 256])
    def test_apply(self, d):
        """Both fed the JAX stats kernel's KV and K_sum; masked query rows
        compared too (Q' = 0 there, so the message is 0 in both)."""
        x, mask, (Wq, Wk, Wv, Wm, g1, b1, W1, W2, g2, b2) = block_inputs(d + 1, 2, 300, d)
        KVj, ksj = jax_stats(x, mask, Wk, Wv)
        want = jax_apply(x, mask, KVj, ksj, Wq, Wm, g1, b1, W1, W2, g2, b2)
        got = attn_cuda.attn_apply(
            t(x), t(mask).float(), t(diag_blocks(KVj)), t(ksj), t(Wq), t(Wm), t(g1), t(b1),
            t(W1), t(W2), t(g2), t(b2), attn_eps=1e-6, ln_eps=1e-5, norm_dtype=torch.float32)
        assert got.dtype == torch.float32
        assert rel(got.numpy(), want) <= 1e-5

    def test_tail_d384(self):
        """The width where the fp32 fused block is over the JAX budget and
        the TPU runs the tail kernel."""
        rng = np.random.default_rng(384)
        d, hid, R = 384, 1536, 300
        assert ffn_pallas.fusable(d, hid, jnp.float32)
        assert not jattn.fusable_block(d, hid, H, jnp.float32)
        w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
        args = (rng.standard_normal((1, R, d)).astype(np.float32),
                rng.standard_normal((1, R, d)).astype(np.float32), w(d, d),
                rng.uniform(0.5, 1.5, d).astype(np.float32),
                (rng.standard_normal(d) * 0.1).astype(np.float32), w(d, hid), w(hid, d),
                rng.uniform(0.5, 1.5, d).astype(np.float32),
                (rng.standard_normal(d) * 0.1).astype(np.float32))
        jtail = ffn_pallas._make_block_tail("float32", "float32", 1e-5, True, True)
        want = np.asarray(jtail(*map(jnp.asarray, args)))
        got = tail_cuda.block_tail(*map(t, args), dtype=torch.float32,
                                   norm_dtype=torch.float32)
        assert got.dtype == torch.float32
        assert rel(got.numpy(), want) <= 2e-5


def stats_in_kernel_order(x, mask, Wk, Wv):
    """The fp32 stats kernel's summation order on CPU tensors: per 64-row
    tile (``attn_cuda.STATS_F32_TILE``) the partial ``K'^T V`` and ``K_sum``
    over the tile's rows in row order, then the tiles added in tile order
    (``attn_stats_f32_reduce_kernel``). The kernel fuses each product into
    an FMA, which this model does not: it holds the order, not the bits."""
    B, S, d = x.shape
    hd = d // H
    mc = mask[..., None]
    kp = (attn_cuda._elu1(x @ Wk) * mc).reshape(B, S, H, hd)
    vm = (x @ Wv * mc).reshape(B, S, H, hd)
    KV, ksum = torch.zeros((B, H, hd, hd)), torch.zeros((B, H, hd))
    for t0 in range(0, S, attn_cuda.STATS_F32_TILE):
        pkv, pks = torch.zeros_like(KV), torch.zeros_like(ksum)
        for r in range(t0, min(t0 + attn_cuda.STATS_F32_TILE, S)):
            pkv = pkv + kp[:, r, :, :, None] * vm[:, r, :, None, :]
            pks = pks + kp[:, r]
        KV, ksum = KV + pkv, ksum + pks
    return KV, ksum.reshape(B, d)


@pytest.mark.parametrize("B,S,d", [(2, 300, 256), (3, 129, 128)])
def test_stats_summation_order_meets_plain(B, S, d):
    x, mask, W = block_inputs(S + d, B, S, d)
    mask[0] = False  # an all-masked batch
    args = (t(x), t(mask).float(), t(W[1]), t(W[2]))
    KV, ks = stats_in_kernel_order(*args)
    KV2, ks2 = stats_in_kernel_order(*args)
    assert torch.equal(KV, KV2) and torch.equal(ks, ks2)
    assert (KV[0] == 0).all() and (ks[0] == 0).all()
    KVp, ksp = attn_cuda.attn_stats_plain(*args, num_heads=H)
    assert rel(KV.numpy(), KVp.numpy()) <= 1e-6
    assert rel(ks.numpy(), ksp.numpy()) <= 1e-6


def jax_route(d, fused_attn):
    """The route the JAX package takes on the TPU for an fp32 self-attention
    block at hidden 4d (``models/attention.py:199-243``)."""
    use_fa = fused_attn if fused_attn is not None else jattn.fusable_block(
        d, 4 * d, H, jnp.float32)
    if use_fa:
        return "fused"
    return "tail" if ffn_pallas.fusable(d, 4 * d, jnp.float32) else "plain"


@pytest.mark.parametrize("d,fused_attn,want", [(128, None, "fused"), (256, None, "fused"),
                                               (384, None, "tail"), (512, None, "plain"),
                                               (128, False, "tail"), (256, False, "tail")])
def test_fp32_routes_on_cuda_follow_the_jax_rules(monkeypatch, d, fused_attn, want):
    from scream_tpu_torch.utils import device as device_util

    assert jax_route(d, fused_attn) == want
    monkeypatch.setattr(device_util, "on_cuda", lambda x: True)
    calls = []
    monkeypatch.setattr(attn_cuda, "attention_block_fused",
                        lambda *a, **k: calls.append(("fused", k["dtype"])) or a[0])
    monkeypatch.setattr(tail_cuda, "block_tail",
                        lambda *a, **k: calls.append(("tail", k["dtype"])) or a[1])
    blk = AttentionBlock(d, H, 4, dtype=torch.float32, fused_attn=fused_attn)
    x = torch.zeros((1, 4, d))
    out = blk(x, x, x)
    assert out.shape == (1, 4, d)
    assert calls == ([] if want == "plain" else [(want, torch.float32)])


class _Lib:
    """Stands in for the kernel library: records each entry point called
    and its integer and float arguments, returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, [a for a in args if isinstance(a, (int, float))
                                      and not isinstance(a, bool)]))
            return 0
        return entry


@pytest.fixture
def fake_cuda(monkeypatch):
    """CPU tensors take the CUDA route of every wrapper and reach ``_Lib``;
    the device checks and the stream are stood in for."""
    lib = _Lib()
    monkeypatch.setattr(_build, "route", lambda x: True)
    monkeypatch.setattr(_build, "kernels", lambda: lib)
    monkeypatch.setattr(_build, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda x: 0)
    return lib


@pytest.mark.parametrize("d", [128, 256])
def test_fp32_tensors_launch_the_fp32_attention_kernels(fake_cuda, d):
    B, L, hid = 2, 100, 4 * d
    x, mask, (Wq, Wk, Wv, Wm, g1, b1, W1, W2, g2, b2) = block_inputs(d, B, L, d)
    n0 = (attn_cuda.attn_stats.launches, attn_cuda.attn_apply.launches)
    KV, ks = attn_cuda.attn_stats(t(x), t(mask).float(), t(Wk), t(Wv), num_heads=H)
    assert KV.shape == (B, H, d // H, d // H) and ks.shape == (B, d)
    attn_cuda.attn_apply(t(x), t(mask).float(), KV, ks, t(Wq), t(Wm), t(g1), t(b1),
                         t(W1), t(W2), t(g2), t(b2), attn_eps=1e-6, ln_eps=1e-5,
                         norm_dtype=torch.bfloat16)
    names = [c[0] for c in fake_cuda.calls]
    assert names == ["scream_attn_stats_f32", "scream_attn_apply_f32"]
    stats_ints, apply_args = fake_cuda.calls[0][1], fake_cuda.calls[1][1]
    # Pointers are ints too: the shapes and the head count come last but
    # for the stream (0).
    assert stats_ints[-5:] == [B, L, d, H, 0]
    assert apply_args[-9:-2] == [B, L, d, H, hid, pytest.approx(1e-6), pytest.approx(1e-5)]
    assert apply_args[-2] == 1  # bf16 norm dtype
    assert (attn_cuda.attn_stats.launches, attn_cuda.attn_apply.launches) == (n0[0] + 1,
                                                                              n0[1] + 1)
    # bf16 tensors keep the bf16 kernels.
    fake_cuda.calls.clear()
    bf = torch.bfloat16
    attn_cuda.attn_stats(t(x).to(bf), t(mask).float(), t(Wk).to(bf), t(Wv).to(bf),
                         num_heads=H)
    assert [c[0] for c in fake_cuda.calls] == ["scream_pack_stats", "scream_attn_stats"]


@pytest.mark.parametrize("d", [128, 256, 384])
def test_fp32_tensors_launch_the_fp32_tail_kernel(fake_cuda, d):
    rng = np.random.default_rng(d)
    hid, R = 4 * d, 70
    x, q = (t(rng.standard_normal((1, R, d)).astype(np.float32)) for _ in range(2))
    Wm, W1, W2 = torch.ones(d, d), torch.ones(d, hid), torch.ones(hid, d)
    p = torch.ones(d)
    n0 = tail_cuda.block_tail.launches
    out = tail_cuda.block_tail(x, q, Wm, p, p, W1, W2, p, p, dtype=torch.float32,
                               norm_dtype=torch.float32)
    assert out.shape == (1, R, d) and out.dtype == torch.float32
    assert [c[0] for c in fake_cuda.calls] == ["scream_block_tail_f32"]
    # x, q, Wm, g1, b1, W1, W2, g2, b2, the pack's scratch, out; then the
    # shapes, eps, the norm dtype and the stream.
    args = fake_cuda.calls[0][1]
    assert len(args) == 17 and args[-6:] == [R, d, hid, pytest.approx(1e-5), 0, 0]
    assert tail_cuda.block_tail.launches == n0 + 1
    fake_cuda.calls.clear()
    blob = attn_cuda.pack_block_weights_f32(Wm, W1, W2)
    assert blob.shape == (2 * (d * d + 2 * d * hid),)
    assert [c[0] for c in fake_cuda.calls] == ["scream_pack_block_f32"]
    assert fake_cuda.calls[0][1][-3:] == [d, hid, 0]
    with pytest.raises(ValueError, match="fp32"):
        tail_cuda.block_tail(torch.zeros(1, 4, 512), torch.zeros(1, 4, 512),
                             torch.zeros(512, 512), torch.ones(512), torch.ones(512),
                             torch.zeros(512, 2048), torch.zeros(2048, 512), torch.ones(512),
                             torch.ones(512), dtype=torch.float32, norm_dtype=torch.float32)


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "torch_port_make_fp32_reference",
        os.path.join(REPO, "scripts", "torch_port_make_fp32_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference():
    mod = _reference_script()
    with np.load(mod.OUT) as f:
        return mod, {k: f[k] for k in f.files}


@pytest.mark.parametrize("key", ["point_generator", "point_generator_hintfree"])
def test_reference_file_is_the_jax_forward(reference, key):
    """The file cannot go stale: the JAX package's fp32 CPU forward, made
    afresh from the seed, matches it."""
    mod, ref = reference
    assert int(ref["seed"]) == mod.SEED
    assert rel(mod.jax_forward(key, int(ref["seed"])), ref[key]) <= 1e-5


@pytest.mark.parametrize("key", ["point_generator", "point_generator_hintfree"])
def test_port_cpu_forward_meets_reference(reference, key):
    """The port's fp32 CPU forward with the shipped torch weights, the path
    ``chip_smoke.py`` also compares the card with."""
    from scream_tpu_torch.utils.checkpoint import load_params

    mod, ref = reference
    cfg, _, state = load_params(os.path.join(REPO, "scream_tpu_torch", "weights",
                                             mod.MODELS[key][0]))
    model = PointTransformer(dataclasses.replace(cfg, dtype="float32"), device="cpu")
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = model(*map(t, mod.reference_inputs(key, int(ref["seed"]))))
    assert got.dtype == torch.float32
    assert rel(got.numpy(), ref[key]) <= 1e-5
