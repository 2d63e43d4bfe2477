"""The stats kernel's layout and order (``csrc/attn.cu:attn_stats_kernel``,
``ops/attn_cuda.py:attn_stats``) on the CPU, where the kernel cannot run:

* the sequence partition: every row in exactly one projection item, set by
  the shape alone (``stats_tiles``, and the rows of each item as
  ``attn_stats_kernel`` walks them, restated here), and the sum's walk over
  every row once, in row order (``attn_stats_reduce_kernel``);
* the packed ``[Wk|Wv]`` blob, walked through the wgmma descriptor layout of
  the kernel's ring stages, gives back both weights at d 128 and 256;
* a numpy model of the kernels' arithmetic order (bf16 projection, elu1,
  mask, into the workspace; then per head the 16-row steps of K'^T V and
  the rows of K_sum added in row order) gives the same bits whatever the
  grid, and meets the plain version at the card's bar;
* ``attn_stats_plain`` against the JAX package's ``_stats_kernel`` in
  interpret mode, fp32, at ragged S and with an all-masked batch.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from scream_tpu.ops import attn_pallas as jattn
from scream_tpu_torch.ops import attn_cuda

H = 8


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def item_rows(S, b, t):
    """The workspace rows item ``(b, t)`` of ``attn_stats_kernel`` writes:
    warpgroup ``w`` rows ``128 t + 64 w .. + 63`` (rows at or past ``S``
    hold zeros)."""
    return [range(t * 128 + 64 * w, t * 128 + 64 * w + 64) for w in range(2)]


def sum_steps(S):
    """The 16-row steps ``attn_stats_reduce_kernel`` chains, in order: 64-row
    tiles up to ``ceil(S / 64) * 64``, four steps each."""
    return [range(r, r + 16) for r in range(0, -(-S // 64) * 64, 16)]


def bf16(a):
    """fp32 values rounded to bf16, as fp32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("S", [1, 127, 128, 129, 4000, 4032, 4096])
def test_partition_covers_every_row_once(B, S):
    """Whatever the number of blocks walking the items, each row of each
    batch lies in exactly one item and the workspace holds every row the
    sum reads; the sum takes each row once, in ascending order. The shape
    alone sets both (no card property, no state)."""
    T = attn_cuda.stats_tiles(S)
    sp = T * attn_cuda.STATS_TILE
    for grid in (1, 7, 132):
        seen = np.zeros((B, sp), np.int64)
        for blk in range(min(grid, B * T)):
            for it in range(blk, B * T, grid):
                b, t = divmod(it, T)
                for rng_ in item_rows(S, b, t):
                    seen[b, list(rng_)] += 1
        assert (seen == 1).all()
    steps = [r for st in sum_steps(S) for r in st]
    assert steps == list(range(len(steps))) and S <= len(steps) <= sp
    assert T == attn_cuda.stats_tiles(S)  # no state, no card


def test_partition_at_the_paths_shapes():
    """16 x 4,096: 32 tiles a batch, 512 items; 8 x 4,096 and 8 x 4,000: 32
    tiles, 256 items; 8 x 512 (d 128 serving): 4 tiles, 32 items."""
    assert 16 * attn_cuda.stats_tiles(4096) == 512
    assert 8 * attn_cuda.stats_tiles(4096) == 8 * attn_cuda.stats_tiles(4000) == 256
    assert 8 * attn_cuda.stats_tiles(512) == 32


def walk_stats_blob(blob, d):
    """(Wk, Wv, counts) read from the blob as the kernel's consumers read
    it: stage s (64 packed columns by d k-rows) at s * 128 d bytes, k16 step
    k at 2,048 k bytes on, element (k-row kk of the step, column n) at
    (n // 8) * SBO + (kk // 8) * LBO + (n % 8) * 16 + (kk % 8) * 2 bytes with
    LBO 128, SBO 256; packed column c is k_h or v_h column c % (2 hd) of
    head c // (2 hd)."""
    flat = blob.float().numpy()
    counts = np.zeros(flat.size, np.int64)
    hd, ns = d // H, 2 * d // 64
    W = np.zeros((d, 2 * d), np.float32)
    for s in range(ns):
        k16, kk, n = np.ix_(np.arange(d // 16), np.arange(16), np.arange(64))
        off = k16 * 2048 + (n // 8) * 256 + (kk // 8) * 128 + (n % 8) * 16 + (kk % 8) * 2
        el = ((s * 128 * d + off) // 2).reshape(d, 64)
        np.add.at(counts, el.ravel(), 1)
        W[:, 64 * s:64 * s + 64] = flat[el]
    W = W.reshape(d, H, 2, hd)
    return W[:, :, 0].reshape(d, d), W[:, :, 1].reshape(d, d), counts


@pytest.mark.parametrize("d", [128, 256])
def test_stats_blob_walks_back_to_wk_wv(d):
    rng = np.random.default_rng(d)
    Wk, Wv = (rng.standard_normal((d, d)).astype(np.float32) for _ in range(2))
    blob = attn_cuda.pack_stats_weights(t(Wk), t(Wv), num_heads=H)
    assert blob.dtype == torch.bfloat16 and blob.shape == (2 * d * d,)
    got_k, got_v, counts = walk_stats_blob(blob, d)
    assert (counts == 1).all()  # a permutation of [Wk|Wv]
    np.testing.assert_array_equal(got_k, bf16(Wk))
    np.testing.assert_array_equal(got_v, bf16(Wv))
    # bf16 weights pack to the same blob.
    same = attn_cuda.pack_stats_weights(t(Wk).to(torch.bfloat16), t(Wv).to(torch.bfloat16),
                                          num_heads=H)
    assert torch.equal(same, blob)


@pytest.mark.parametrize("shapes", [((192, 192), (192, 192)), ((256, 256), (256, 128)),
                                    ((128, 256), (128, 256))])
def test_stats_pack_rejects_shapes_the_kernel_does_not_take(shapes):
    with pytest.raises(ValueError):
        attn_cuda.pack_stats_weights(torch.zeros(shapes[0]), torch.zeros(shapes[1]),
                                     num_heads=H)


def emulate_stats(x, mask, Wk, Wv, grid):
    """The kernels' arithmetic in numpy. Pass 1: items (batch, tile) walked
    by ``grid`` persistent blocks, per 64-row half the projection in fp32
    rounded to bf16, K' = bf16(elu1(k)) * m and V = v * m (m the mask in
    bf16) into the workspace. Pass 2, per (batch, head): KV chained over
    the 16-row steps in row order (a step's 16 products summed in fp32, as
    the tensor core's step is modelled here), K_sum added row by row."""
    B, S, d = x.shape
    hd = d // H
    T = attn_cuda.stats_tiles(S)
    sp = T * attn_cuda.STATS_TILE
    ws = np.full((B, sp, 2, H, hd), np.nan, np.float32)
    for blk in range(grid):
        for it in range(blk, B * T, grid):
            b, t = divmod(it, T)
            for rng_ in item_rows(S, b, t):
                rows = np.array(list(rng_))
                ok = rows < S
                xr = np.where(ok[:, None], x[b, np.minimum(rows, S - 1)], 0)
                m = np.where(ok, bf16(mask[b, np.minimum(rows, S - 1)]), 0)[:, None]
                k, v = bf16(xr @ Wk), bf16(xr @ Wv)
                ws[b, rows, 0] = (bf16(np.where(k > 0, k + 1, np.exp(k))) * m).reshape(-1, H, hd)
                ws[b, rows, 1] = (v * m).reshape(-1, H, hd)
    KV = np.zeros((B, H, hd, hd), np.float32)
    ks = np.zeros((B, H, hd), np.float32)
    for st in sum_steps(S):
        rows = list(st)
        KV = KV + np.einsum("bshd,bshv->bhdv", ws[:, rows, 0], ws[:, rows, 1],
                            dtype=np.float32)
        for r in rows:
            ks = ks + ws[:, r, 0]
    return KV, ks.reshape(B, d)


@pytest.mark.parametrize("B,S,d", [(2, 300, 256), (3, 129, 128), (32, 1000, 128)])
def test_emulated_order_is_grid_free_and_meets_plain(B, S, d):
    """The same bits whatever the number of blocks; within the card's bar
    (5e-3 of the largest value) of the plain version on bf16 inputs; an
    all-masked batch gives exact zeros."""
    rng = np.random.default_rng(S + d)
    x = bf16(rng.standard_normal((B, S, d)))
    Wk, Wv = (bf16(rng.standard_normal((d, d)) / np.sqrt(d)) for _ in range(2))
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    mask[-1] = 0.0  # an all-masked batch
    runs = [emulate_stats(x, mask, Wk, Wv, grid) for grid in (1, 7, 132)]
    for KV, ks in runs[1:]:
        assert np.array_equal(KV, runs[0][0]) and np.array_equal(ks, runs[0][1])
    KV, ks = runs[0]
    assert (KV[-1] == 0).all() and (ks[-1] == 0).all()
    bf = torch.bfloat16
    KVp, ksp = attn_cuda.attn_stats_plain(t(x).to(bf), t(mask), t(Wk).to(bf), t(Wv).to(bf),
                                          num_heads=H)
    for got, want in ((KV, KVp.numpy()), (ks, ksp.numpy())):
        assert np.abs(got - want).max() <= 5e-3 * np.abs(want).max()
    assert (KVp[-1] == 0).all() and (ksp[-1] == 0).all()


def jax_stats(x, mask, Wk, Wv):
    """The JAX package's ``_stats_kernel`` in interpret mode, fp32 (the
    ``pallas_call`` of ``attn_pallas._attention_block_pallas``), reduced to
    its per-head diagonal blocks."""
    B, S, d = x.shape
    T = jattn._TILE_R
    xs, mf, Sp = jattn._pad_rows(jnp.asarray(x), jnp.asarray(mask), T)
    Wkv = jnp.concatenate([jnp.asarray(Wk), jnp.asarray(Wv)], axis=1)
    row3 = lambda b, i: (b, i, 0)
    KV, ks = pl.pallas_call(
        partial(jattn._stats_kernel, d=d, prec=jax.lax.Precision.HIGHEST, cd=jnp.float32),
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
    hd = d // H
    KV = np.asarray(KV).reshape(B, H, hd, H, hd)
    diag = np.stack([KV[:, h, :, h] for h in range(H)], 1)
    return diag, np.asarray(ks)[:, 0]


@pytest.mark.parametrize("S,d", [(300, 256), (70, 128), (513, 128)])
def test_stats_plain_matches_jax_stats_kernel(S, d):
    """fp32 on both sides; the JAX kernel sums per 256-row tile then across
    tiles, the plain version in one einsum, so the sums differ by a few fp32
    ulp of the largest partial sums: 1e-5 of the largest value. The second
    batch is all masked: both give exact zeros."""
    rng = np.random.default_rng(S * d)
    B = 2
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    Wk, Wv = ((rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32) for _ in range(2))
    mask = rng.random((B, S)) > 0.25
    mask[1] = False
    want_kv, want_ks = jax_stats(x, mask, Wk, Wv)
    KV, ks = attn_cuda.attn_stats(t(x), t(mask).float(), t(Wk), t(Wv), num_heads=H)
    assert KV.shape == (B, H, d // H, d // H) and ks.shape == (B, d)
    for got, want in ((KV.numpy(), want_kv), (ks.numpy(), want_ks)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert (KV[1] == 0).all() and (ks[1] == 0).all()
    assert (want_kv[1] == 0).all() and (want_ks[1] == 0).all()
