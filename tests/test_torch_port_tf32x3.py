"""A CPU model of the split-TF32 ("3xTF32") arithmetic of the fp32 attention
and tail kernels (``csrc/attn_f32.cu``, ``csrc/tail_f32.cu``,
``csrc/tf32_tile.cuh``, ``csrc/tf32_tail.cuh``), against the JAX package.

* The split: ``attn_cuda.tf32_rna`` (bit arithmetic on an int32 view)
  against round-to-nearest, ties away from zero, done in float64; ``hi`` and
  ``lo`` carry at most 10 explicit mantissa bits and ``hi + lo`` is the
  input within 2^-22 of it.
* The packs: the plain versions of the weight packs (stats; apply, and the
  tail's at every width) equal, bit for bit, a numpy restatement of the
  pack kernels' index arithmetic and of the tail's geometry, and each k8
  step read through the wgmma descriptor's layout (LBO 128, SBO 256 bytes)
  gives the weights' hi and lo blocks.
* The products: every product of the kernels, A and B split, per k8 step
  the three passes ``lo hi``, ``hi lo``, ``hi hi`` each added into an fp32
  accumulator with one rounding, the accumulator added into an fp32 master
  sum every ``F32_PROMOTE_K`` k values. Held against the JAX package's
  ``_stats_kernel`` and ``_apply_kernel`` at HIGHEST in interpret mode (the
  stats alone; the whole block through ``attention_block``) within a
  quarter of the fp32 bars (stats 1e-5, apply 2e-5), once with
  round-to-nearest adds and once with every add truncated toward zero (the
  published behaviour of NVIDIA tensor cores' fp32 accumulation, taken at
  its worst), at every fp32 cell of ``attn_cuda.KERNEL_CELLS`` (the
  head-specific kernels' and the head-generic pair's) and on the first attention
  block's input of the two fp32 reference forwards
  (``tests/data/torch_port_fp32_reference.npz``). The tail's model, in its
  d-wide passes and hidden chunks, against ``_tail_kernel`` within a
  quarter of its 2e-5 bar at d 128-384 and ffn_mult 1-4. The kernels'
  promotion chunk is the model's, and every product's stages and hidden
  chunks fall on its boundaries.
"""

import dataclasses
import os
import re
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
from scream_tpu_torch.models import PointTransformer
from scream_tpu_torch.ops import attn_cuda, tail_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIGHEST = jax.lax.Precision.HIGHEST
STATS_BAR, APPLY_BAR, TAIL_BAR = 1e-5 / 4, 2e-5 / 4, 2e-5 / 4
CELLS = [(d, d // hd) for d, hds in attn_cuda.KERNEL_CELLS[torch.float32].items()
         for hd in hds]


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


def rna_f64(x):
    """TF32 rounding in float64: 11 significant bits, ties away from zero;
    below 2^-126 the fp32 subnormal grid (2^-136 steps for TF32)."""
    x = np.asarray(x, np.float64)
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -149)))
    step = 2.0 ** (np.maximum(e, -126) - 10)
    return np.sign(x) * np.floor(np.abs(x) / step + 0.5) * step


def test_tf32_rna_rounds_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * np.exp(rng.uniform(-60, 60, 20000))).astype(np.float32)
    # Ties: exactly half a TF32 ulp above a TF32 value, both signs.
    ties = ((rng.integers(0x00800000, 0x7E000000, 2000) & ~0x1FFF) | 0x1000).astype(np.int32)
    x = np.concatenate([x, ties.view(np.float32), -ties.view(np.float32),
                        np.float32([0.0, 1.0, -1.5, 2.0 ** -130, -(2.0 ** -140)])])
    got = attn_cuda.tf32_rna(t(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.float64), rna_f64(x))
    tie_got = got[20000:22000].astype(np.float64)
    assert (np.abs(tie_got) > np.abs(ties.view(np.float32))).all()  # away from zero


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e4, 1e30])
def test_split_carries_22_bits(scale):
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    x = t((rng.standard_normal(50000) * scale).astype(np.float32))
    hi, lo = attn_cuda.split_tf32(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()  # <= 10 explicit mantissa bits
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    assert (hi.double().abs() >= lo.double().abs() * 2 ** 10).all()


def stage_src(i, ns):
    """``csrc/tf32_tile.cuh:stage_src`` restated: element ``i`` of a stage
    half with ``ns`` columns holds (k-row, column)."""
    kk, nn, c, g = i % 4, (i // 4) % 8, (i // 32) % 2, (i // 64) % (ns // 8)
    return 8 * (i // (8 * ns)) + 4 * c + kk, 8 * g + nn


def split_np(v):
    hi, lo = attn_cuda.split_tf32(t(np.ascontiguousarray(v, np.float32)))
    return hi.numpy(), lo.numpy()


def kernel_pack_stats(Wk, Wv, heads):
    """``pack_stats_f32_kernel``'s index arithmetic on every output float."""
    d = Wk.shape[0]
    hd, sp = d // heads, d // 32
    o = np.arange(4 * d * d)
    s = o // 8192
    k, col = stage_src(o % 4096, 128)
    k, col = k + 32 * (s % sp), col + 128 * (s // sp)
    h, w = col // (2 * hd), col % (2 * hd)
    v = np.where(w < hd, Wk[k, h * hd + np.minimum(w, hd - 1)],
                 Wv[k, h * hd + np.maximum(w - hd, 0)])
    hi, lo = split_np(v)
    return np.where((o // 4096) & 1, lo, hi)


def block_geometry(d):
    """``csrc/tf32_tail.cuh:Block<d>`` restated: (nd, passes, ksd, hc, ksh).
    At d 384 three 64-column passes a warpgroup and 64-column hidden
    chunks; below, one pass of d / 2 and 128-column chunks; every stage
    half 4,096 floats."""
    nd, hc = (64, 64) if d > 256 else (d // 2, 128)
    return nd, d // 2 // nd, 4096 // (2 * nd), hc, 4096 // hc


def kernel_pack_block(Wq, Wm, W1, W2):
    """``pack_block_f32_kernel``'s index arithmetic on every output float:
    ``[Wq]``, ``Wm``, then per hidden chunk its W1 and W2 stages; a d-wide
    stage of pass ``p`` holds packed column ``c`` = column ``(c // nd) (d /
    2) + p nd + c % nd``."""
    d, hid = W1.shape
    nd, passes, ksd, hc, ksh = block_geometry(d)
    kst = d // ksd
    s_d, s_w1, per = passes * kst, d // ksh, hc // ksd
    s_w2, sq = passes * per, 1 if Wq is None else 2
    out = np.empty(2 * (sq * d * d + 2 * d * hid), np.float32)
    for st in range(out.size // 8192):
        idx = np.arange(st * 8192, (st + 1) * 8192)
        wide, n0, ns = True, 0, 2 * nd
        if st < sq * s_d:
            src = Wq if sq == 2 and st < s_d else Wm
            p, k0 = (st % s_d) // kst, (st % kst) * ksd
        else:
            r, ch = (st - sq * s_d) % (s_w1 + s_w2), (st - sq * s_d) // (s_w1 + s_w2)
            if r < s_w1:
                src, k0, n0, ns, wide = W1, r * ksh, ch * hc, hc, False
            else:
                src, p, k0 = W2, (r - s_w1) // per, ch * hc + (r - s_w1) % per * ksd
        k, col = stage_src(idx % 4096, ns)
        if wide:
            col = col // nd * (d // 2) + p * nd + col % nd
        hi, lo = split_np(src[k0 + k, n0 + col])
        out[idx] = np.where((idx // 4096) & 1, lo, hi)
    return out


def read_b(half, ns, step, n0, n):
    """The (8, n) B operand a wgmma of k8 step ``step`` reads from a stage
    half with ``ns`` columns, its descriptor at column ``n0`` (start 32 (ns
    step + n0) bytes, LBO 128: the two k halves, SBO 256: the 8-column
    groups, each core-matrix row 16 bytes)."""
    base = (32 * ns * step + 32 * n0) // 4
    k, c = np.meshgrid(np.arange(8), np.arange(n), indexing="ij")
    return half[base + (c // 8) * 64 + (k // 4) * 32 + (c % 8) * 4 + k % 4]


@pytest.mark.parametrize("d,heads,hid", [(128, 8, 512), (256, 4, 384), (256, 16, 1024)])
def test_plain_packs_are_the_kernels_layout(d, heads, hid):
    rng = np.random.default_rng(d + heads + hid)
    Wq, Wm, Wk, Wv = (rng.standard_normal((d, d)).astype(np.float32) for _ in range(4))
    W1 = rng.standard_normal((d, hid)).astype(np.float32)
    W2 = rng.standard_normal((hid, d)).astype(np.float32)
    stats = attn_cuda.pack_stats_weights_f32(t(Wk), t(Wv), num_heads=heads).numpy()
    apply = attn_cuda.pack_block_weights_f32(t(Wm), t(W1), t(W2), Wq=t(Wq)).numpy()
    np.testing.assert_array_equal(stats.view(np.int32), kernel_pack_stats(Wk, Wv, heads)
                                  .view(np.int32))
    np.testing.assert_array_equal(apply.view(np.int32), kernel_pack_block(Wq, Wm, W1, W2)
                                  .view(np.int32))
    # The descriptor's view: W1's first chunk is stage 2 (d / (4096 / d)) of
    # the apply blob; warpgroup 1 reads its columns 64-127, k8 step 1 of
    # stage 1 of the chunk (k-rows 40-47).
    s = 2 * d // (4096 // d) + 1
    hi_w, lo_w = split_np(W1[40:48, 64:128])
    st = apply[s * 8192:(s + 1) * 8192]
    np.testing.assert_array_equal(read_b(st[:4096], 128, 1, 64, 64), hi_w)
    np.testing.assert_array_equal(read_b(st[4096:], 128, 1, 64, 64), lo_w)
    # The stats blob: column group 1, k-part 0, k8 step 3, warpgroup 0.
    hd = d // heads
    packed = np.concatenate([Wk.reshape(d, heads, hd), Wv.reshape(d, heads, hd)],
                            -1).reshape(d, 2 * d)
    st = stats[(d // 32) * 8192:(d // 32 + 1) * 8192]
    np.testing.assert_array_equal(read_b(st[:4096], 128, 3, 0, 64),
                                  split_np(packed[24:32, 128:192])[0])


@pytest.mark.parametrize("d,hid", [(128, 512), (256, 1024), (384, 1536), (384, 384),
                                   (384, 1152)])
def test_plain_tail_pack_is_the_kernels_layout(d, hid):
    """The fp32 tail's blob (the apply blob without Wq) at every width,
    and at d 384 at hidden 1 and 3 x d: the plain pack equals the kernel's
    index arithmetic bit for bit, its geometry is the header's, and the
    descriptors read the weights' columns where the warpgroups' products
    put them."""
    rng = np.random.default_rng(d + hid)
    Wm = rng.standard_normal((d, d)).astype(np.float32)
    W1 = rng.standard_normal((d, hid)).astype(np.float32)
    W2 = rng.standard_normal((hid, d)).astype(np.float32)
    assert attn_cuda.f32_block_geometry(d) == block_geometry(d)
    blob = attn_cuda.pack_block_weights_f32(t(Wm), t(W1), t(W2)).numpy()
    assert blob.size == 2 * (d * d + 2 * d * hid)
    np.testing.assert_array_equal(blob.view(np.int32),
                                  kernel_pack_block(None, Wm, W1, W2).view(np.int32))
    nd, passes, ksd, hc, ksh = block_geometry(d)
    # Wm, warpgroup 1, its last pass, k-stage 1, k8 step 0: output columns
    # d / 2 + (passes - 1) nd .. of k-rows ksd .. ksd + 7.
    st = blob[((passes - 1) * (d // ksd) + 1) * 8192:][:8192]
    c0 = d // 2 + (passes - 1) * nd
    np.testing.assert_array_equal(read_b(st[:4096], 2 * nd, 0, nd, nd),
                                  split_np(Wm[ksd:ksd + 8, c0:c0 + nd])[0])
    # The second hidden chunk: its W1 stage 1 (warpgroup 1, k8 step 2) and
    # its W2 pass 0 stage 0 (warpgroup 0, k8 step 1, the lo half).
    s_d, s_w1 = passes * (d // ksd), d // ksh
    ch = s_d + (s_w1 + passes * (hc // ksd))
    st = blob[(ch + 1) * 8192:][:8192]
    np.testing.assert_array_equal(read_b(st[:4096], hc, 2, hc // 2, hc // 2),
                                  split_np(W1[ksh + 16:ksh + 24, hc + hc // 2:2 * hc])[0])
    st = blob[(ch + s_w1) * 8192:][:8192]
    np.testing.assert_array_equal(read_b(st[4096:], 2 * nd, 1, 0, nd),
                                  split_np(W2[hc + 8:hc + 16, :nd])[1])


def round32(x64, mode):
    """float64 -> fp32, to nearest ("rn") or toward zero ("rz")."""
    r = x64.float()
    if mode == "rz":
        over = r.double().abs() > x64.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def mm3(A, B, mode, master=None):
    """``A @ B`` (fp32) as the kernels compute it: both split; per k8 step
    the passes lo(A) hi(B), hi(A) lo(B), hi(A) hi(B), each an exact sum of 8
    products added into the fp32 chunk accumulator with one rounding
    (``mode``); every ``F32_PROMOTE_K`` k values the chunk is added into an
    fp32 master sum (round to nearest; zeros, or ``master`` to go on from)
    and starts afresh."""
    promote_k = attn_cuda.F32_PROMOTE_K
    K = A.shape[1]
    assert K % 8 == 0 and promote_k % 8 == 0
    (Ah, Al), (Bh, Bl) = (tuple(p.double() for p in attn_cuda.split_tf32(M)) for M in (A, B))
    if master is None:
        master = torch.zeros((A.shape[0], B.shape[1]), dtype=torch.float32)
    chunk = torch.zeros_like(master)
    for k0 in range(0, K, 8):
        ks = slice(k0, k0 + 8)
        for a, b in ((Al, Bh), (Ah, Bl), (Ah, Bh)):
            chunk = round32(chunk.double() + a[:, ks] @ b[ks], mode)
        if (k0 + 8) % promote_k == 0 or k0 + 8 == K:
            master, chunk = master + chunk, torch.zeros_like(master)
    return master


def model_stats(x, mask, Wk, Wv, heads, mode):
    """The stats kernel: ``[k|v]`` on the 3xTF32 model, then K', V and the
    per-head sums in fp32 (the kernel's fmaf chains over 64-row tiles; their
    order is ``test_torch_port_fp32.py``'s model)."""
    B, S, d = x.shape
    hd = d // heads
    kv = mm3(x.reshape(B * S, d), torch.cat([Wk, Wv], 1), mode).reshape(B, S, 2 * d)
    m = mask[..., None]
    kp = (attn_cuda._elu1(kv[..., :d]) * m).reshape(B, S, heads, hd)
    vm = (kv[..., d:] * m).reshape(B, S, heads, hd)
    return torch.einsum("bshd,bshv->bhdv", kp, vm), kp.sum(1).reshape(B, d)


def layer_norm(t_, g, b, eps):
    mu = t_.mean(-1, keepdim=True)
    var = torch.clamp((t_ * t_).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (t_ - mu) * (torch.rsqrt(var + eps) * g) + b


def model_apply(x, mask, KV, ksum, Wq, Wm, g1, b1, W1, W2, g2, b2, mode, eps=1e-6,
                ln_eps=1e-5):
    """The apply kernel: its four products on the 3xTF32 model, the
    attention and LayerNorms in fp32."""
    B, L, d = x.shape
    H, hd = KV.shape[1], KV.shape[2]
    x2 = x.reshape(B * L, d)
    qp = attn_cuda._elu1(mm3(x2, Wq, mode)) * mask.reshape(-1, 1)
    qh = qp.reshape(B, L, H, hd)
    att = torch.einsum("blhd,bhdv->blhv", qh, KV)
    z = (qh * ksum.reshape(B, 1, H, hd)).sum(-1)
    msg = (att * (1.0 / (z + eps))[..., None]).reshape(B * L, d)
    y = layer_norm(mm3(msg, Wm, mode) + x2, g1, b1, ln_eps)
    f = mm3(torch.relu(mm3(y, W1, mode)), W2, mode)
    return layer_norm(x2 + f, g2, b2, ln_eps).reshape(B, L, d)


def wide3(A, W, mode, master):
    """A d-wide product into ``master`` in the kernels' passes
    (``tf32_tail.cuh:wide_mma``): pass ``p`` makes columns ``p nd ..`` of
    each warpgroup's ``d / 2`` over all of ``A``'s k."""
    d = W.shape[1]
    nd, passes = block_geometry(d)[:2]
    master = master.clone()
    for p in range(passes):
        for c0 in (p * nd, d // 2 + p * nd):
            master[:, c0:c0 + nd] = mm3(A, W[:, c0:c0 + nd], mode, master[:, c0:c0 + nd])
    return master


def model_tail(x, q, Wm, g1, b1, W1, W2, g2, b2, mode, ln_eps=1e-5):
    """The fp32 tail kernel (``tf32_tail.cuh:tail_rows``) in its order: the
    merge in its passes, LN1, then per hidden chunk of ``hc`` columns h =
    relu of its W1 product (promoted every k stage) and its W2 product in
    passes added into f's master, then LN2; the LayerNorms in fp32."""
    R, d = x.shape
    hc = block_geometry(d)[3]
    zeros = torch.zeros((R, d))
    y = layer_norm(wide3(x, Wm, mode, zeros) + q, g1, b1, ln_eps)
    f = zeros
    for c0 in range(0, W1.shape[1], hc):
        h = torch.relu(mm3(y, W1[:, c0:c0 + hc], mode))
        f = wide3(h, W2[c0:c0 + hc], mode, f)
    return layer_norm(q + f, g2, b2, ln_eps)


@pytest.mark.parametrize("d,mult", [(128, 4), (256, 4), (384, 4), (384, 1), (384, 3)])
def test_model_tail_meets_pallas_tail(d, mult):
    """The fp32 tail's model against ``ffn_pallas._tail_kernel`` (interpret
    mode, HIGHEST) within a quarter of the 2e-5 tail bar, with
    round-to-nearest and with truncating adds, on 201 rows (ragged against
    the 64-row tile and the Pallas kernel's 256); and its passes and chunks
    give the bits of one product over the whole k (the promotion points are
    the same)."""
    rng = np.random.default_rng(d * mult)
    R, hid = 201, mult * d
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
    args = (rng.standard_normal((R, d)).astype(np.float32),
            rng.standard_normal((R, d)).astype(np.float32), w(d, d),
            rng.uniform(0.5, 1.5, d).astype(np.float32),
            (rng.standard_normal(d) * 0.1).astype(np.float32), w(d, hid), w(hid, d),
            rng.uniform(0.5, 1.5, d).astype(np.float32),
            (rng.standard_normal(d) * 0.1).astype(np.float32))
    jtail = ffn_pallas._make_block_tail("float32", "float32", 1e-5, True, True)
    want = np.asarray(jtail(*(jnp.asarray(a[None] if a.ndim == 2 and a.shape[0] == R else a)
                              for a in args)))[0]
    errs = {}
    for mode in ("rn", "rz"):
        got = model_tail(*map(t, args), mode)
        errs[mode] = rel(got.numpy(), want)
    assert max(errs.values()) <= TAIL_BAR, errs
    x, Wm = t(args[0]), t(args[2])
    assert torch.equal(wide3(x, Wm, "rz", torch.zeros((R, d))), mm3(x, Wm, "rz"))


def jax_stats(x, mask, Wk, Wv, heads):
    """``attn_pallas._stats_kernel`` in interpret mode at HIGHEST, fp32: the
    per-head diagonal blocks ``(B, H, hd, hd)`` of its KV, and K_sum."""
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
    hd = d // heads
    K = np.asarray(KV).reshape(B, heads, hd, heads, hd)
    return np.stack([K[:, h, :, h] for h in range(heads)], 1), np.asarray(ks)[:, 0]


def check_block(x, mask, W, heads):
    """The model against the Pallas kernels on one self-attention input:
    stats against ``_stats_kernel``, and the model's whole block (its stats,
    then its apply) against ``attention_block`` through ``_stats_kernel``
    and ``_apply_kernel``; with round-to-nearest and with truncating adds.
    Returns the errors."""
    Wq, Wk, Wv, Wm, g1, b1, W1, W2, g2, b2 = W
    KVj, ksj = jax_stats(x, mask, Wk, Wv, heads)
    j = jnp.asarray
    want = np.asarray(jattn.attention_block(
        j(x), j(x), j(mask), j(mask), *map(j, W), num_heads=heads, dtype=jnp.float32,
        norm_dtype=jnp.float32, use_pallas=True, interpret=True))
    errs = {}
    for mode in ("rn", "rz"):
        KV, ks = model_stats(t(x), t(mask).float(), t(Wk), t(Wv), heads, mode)
        errs["stats_" + mode] = max(rel(KV.numpy(), KVj), rel(ks.numpy(), ksj))
        got = model_apply(t(x), t(mask).float(), KV, ks, *map(t, (Wq, Wm, g1, b1, W1, W2, g2,
                                                                   b2)), mode)
        errs["apply_" + mode] = rel(got.numpy(), want)
    assert max(errs["stats_rn"], errs["stats_rz"]) <= STATS_BAR, errs
    assert max(errs["apply_rn"], errs["apply_rz"]) <= APPLY_BAR, errs
    return errs


def block_weights(rng, d, hid):
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
    g1, g2 = (rng.uniform(0.5, 1.5, d).astype(np.float32) for _ in range(2))
    b1, b2 = ((rng.standard_normal(d) * 0.1).astype(np.float32) for _ in range(2))
    return w(d, d), w(d, d), w(d, d), w(d, d), g1, b1, w(d, hid), w(hid, d), g2, b2


@pytest.mark.parametrize("d,heads", CELLS)
def test_model_meets_pallas_kernels_at_each_cell(d, heads):
    """Small rows (2 x 80, ragged against both tiles; the second batch's
    tail masked) at hidden 4 d."""
    rng = np.random.default_rng(d * heads)
    x = rng.standard_normal((2, 80, d)).astype(np.float32)
    mask = rng.random((2, 80)) > 0.2
    mask[1, 50:] = False
    check_block(x, mask, block_weights(rng, d, 4 * d), heads)


def reference_block_input(key):
    """The first attention block's input and mask on the fp32 reference
    forward's inputs (``scripts/torch_port_make_fp32_reference.py``), the
    shipped weights in fp32 on the CPU; and that block."""
    import importlib.util

    from scream_tpu_torch.utils.checkpoint import load_params

    spec = importlib.util.spec_from_file_location(
        "torch_port_make_fp32_reference",
        os.path.join(REPO, "scripts", "torch_port_make_fp32_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg, _, state = load_params(os.path.join(REPO, "scream_tpu_torch", "weights",
                                             mod.MODELS[key][0]))
    model = PointTransformer(dataclasses.replace(cfg, dtype="float32"), device="cpu")
    model.load_state_dict(state, strict=True)
    seen = []
    blk = model.trunk.stem_0
    hook = blk.register_forward_pre_hook(
        lambda mod_, a: seen.append((a[0].detach(), a[3])) if not seen else None)
    try:
        with torch.no_grad():
            model(*map(t, mod.reference_inputs(key, mod.SEED)))
    finally:
        hook.remove()
    return seen[0][0], seen[0][1], blk


@pytest.mark.parametrize("key", ["point_generator", "point_generator_hintfree"])
def test_model_meets_pallas_kernels_on_the_reference_inputs(key):
    """The shipped checkpoints' first block (d 256 and d 128, 8 heads) on
    their real input, the first pair (1,024 and 448 rows)."""
    x, m, blk = reference_block_input(key)
    W = tuple(p.detach().numpy() for p in (
        blk.q_proj.kernel, blk.k_proj.kernel, blk.v_proj.kernel, blk.merge.kernel,
        blk.norm1.scale, blk.norm1.bias, blk.ffn_in.kernel, blk.ffn_out.kernel,
        blk.norm2.scale, blk.norm2.bias))
    check_block(x[:1].numpy(), m[:1].numpy(), W, blk.num_heads)


def test_promotion_chunk_divides_every_product():
    """The model's chunk is the kernels' (``csrc/tf32_tile.cuh:kPromoteK``),
    and each product of the kernels restarts its accumulator on a ring-stage
    boundary: the chunk is a multiple of every stage's k-rows (stats 32;
    apply and tail at each width, its d-wide and W1 stages) and divides
    every product's k: d, and the hidden chunk whose W2 product ends in a
    promotion."""
    promote = attn_cuda.F32_PROMOTE_K
    with open(os.path.join(REPO, "scream_tpu_torch", "csrc", "tf32_tile.cuh")) as f:
        header = f.read()
    assert re.findall(r"constexpr int kPromoteK = (\d+);", header) == [str(promote)]
    assert promote % 32 == 0 and attn_cuda.F32_GROUP % promote == 0  # stats
    widths = set(attn_cuda.KERNEL_CELLS[torch.float32]) | set(tail_cuda.KERNEL_WIDTHS_F32)
    assert widths == {128, 256, 384}
    for d in widths:
        nd, passes, ksd, hc, ksh = block_geometry(d)
        assert promote % ksd == 0 and promote % ksh == 0
        assert d % promote == 0 and hc % promote == 0 and passes * nd == d // 2
