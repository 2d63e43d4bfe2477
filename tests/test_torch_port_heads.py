"""The fused attention block at the cells beyond d 128 / 256 with 8 heads
(``ops/attn_cuda.py:KERNEL_CELLS``): bf16 at d 384 with head dim 48 (8
heads, ``--d-model 384``), and head dims 16, 32 and 64 at d 128, 256 and
384, bf16 and fp32 (fp32 at d 128 / 256: the JAX rule sends fp32 d 384 to
the tail kernel). On the CPU, where the kernels cannot run:

* the plain versions and ``attention_block_fused`` against the JAX
  package's Pallas stats and apply kernels in interpret mode, fp32, at
  ragged row counts with an all-masked batch: 1e-5 relative;
* ``attn_stats`` as the per-head diagonal blocks of the Pallas kernel's full
  ``d x d`` KV;
* the packed ``[Wk|Wv]`` blob walked back to Wk and Wv through the stats
  kernel's stage layout, restated here from ``csrc/attn.cu`` (stages of
  whole ``[k_h | v_h]`` groups, at least 64 columns, by all d k-rows up to
  32 KB, else by 128), and the shared-memory layouts of the kernels,
  restated likewise, within the card's 232,448 bytes a block;
* the stats kernels' work split at head dim 48 and 64: every workspace
  column written once, every KV entry and K_sum column summed by one
  thread, and a numpy model of their order (16-row steps of K'^T V and the
  rows of K_sum in row order) that gives the same bits whatever the grid;
* d 384 ``PointTransformer`` and ``DEMTransformer`` forwards (1 + 1 layers,
  8 heads of 48) from JAX parameters through ``params_from_jax``, fp32,
  the port's blocks on the fused route's plain versions: 1e-5 of JAX's;
* the routing of every (d in {128, 256, 384, 512}, heads dividing d, dtype)
  on CUDA against the JAX rules: the fused kernels at every head count the
  rule admits, raising only at the widths no kernel takes (bf16 d 512 at
  ffn_mult 1-2, fp32 d 384 at ffn_mult 1-3);
* the wrappers hand the head count to the C entry points (the head-specific
  ones at their cells, the head-generic ones of ``csrc/attn_heads.cu`` at
  the rest) and refuse the widths no kernel is written for.

``test_torch_port_heads_any.py`` holds the head-generic kernels' own
arithmetic and layouts.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from scream_tpu.config import ModelConfig as JModelConfig
from scream_tpu.models.point_transformer import DEMTransformer as JDEM
from scream_tpu.models.point_transformer import PointTransformer as JPointTransformer
from scream_tpu.ops import attn_pallas as jattn
from scream_tpu.ops import ffn_pallas
from scream_tpu_torch.config import ModelConfig
from scream_tpu_torch.data import batching, synthetic
from scream_tpu_torch.models import AttentionBlock, DEMTransformer, PointTransformer
from scream_tpu_torch.ops import _build, attn_cuda, tail_cuda
from scream_tpu_torch.utils.convert import params_from_jax

# (d_model, heads) this slice adds in bf16 (those at d <= 256 in fp32 too),
# and every bf16 cell of the kernels.
NEW_CELLS = [(128, 4), (128, 2), (256, 16), (256, 4), (384, 8), (384, 24), (384, 12), (384, 6)]
BF16_CELLS = [(128, 8), (256, 8)] + NEW_CELLS
SMEM = 232448  # dynamic shared memory a block on the H100


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def rel(got, want, rows=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if rows is not None:
        m = np.asarray(rows)[..., None]
        got, want = got * m, want * m
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def block_inputs(d, seed, B=2, L=100, S=300):
    """Ragged rows (L, S not multiples of the kernels' tiles), masked rows,
    and a second batch whose key/value rows are all masked."""
    rng = np.random.default_rng(seed)
    hid = 4 * d
    a = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    xq, xkv = a(B, L, d), a(B, S, d)
    qm, km = rng.random((B, L)) > 0.2, rng.random((B, S)) > 0.2
    km[1] = False
    W = (a(d, d), a(d, d), a(d, d), a(d, d), 1 + a(d), a(d), a(d, hid), a(hid, d),
         1 + a(d), a(d))
    return xq, xkv, qm, km, W


# ---- the plain versions and the fused block against the Pallas kernels ----

@pytest.mark.parametrize("d,heads", NEW_CELLS)
def test_fused_block_and_plain_versions_match_pallas(d, heads):
    xq, xkv, qm, km, W = block_inputs(d, d + heads)
    want = jattn.attention_block(
        jnp.asarray(xq), jnp.asarray(xkv), jnp.asarray(qm), jnp.asarray(km),
        *map(jnp.asarray, W), num_heads=heads, dtype=jnp.float32, norm_dtype=jnp.float32,
        use_pallas=True, interpret=True)
    f32 = torch.float32
    got = attn_cuda.attention_block_fused(t(xq), t(xkv), t(qm), t(km), *map(t, W),
                                          num_heads=heads, dtype=f32, norm_dtype=f32)
    assert got.shape == xq.shape and rel(got.numpy(), want, rows=qm) <= 1e-5
    Wq, Wk, Wv, Wm, g1, b1, W1, W2, g2, b2 = map(t, W)
    KV, ks = attn_cuda.attn_stats_plain(t(xkv), t(km).float(), Wk, Wv, num_heads=heads)
    assert KV.shape == (2, heads, d // heads, d // heads) and (KV[1] == 0).all()
    out = attn_cuda.attn_apply_plain(t(xq), t(qm).float(), KV, ks, Wq, Wm, g1, b1, W1, W2,
                                     g2, b2, attn_eps=1e-6, ln_eps=1e-5, norm_dtype=f32)
    assert rel(out.numpy(), want, rows=qm) <= 1e-5


def jax_full_kv(x, mask, Wk, Wv):
    """The JAX package's ``_stats_kernel`` in interpret mode, fp32: the full
    (B, d, d) KV and (B, d) K_sum."""
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
    return np.asarray(KV), np.asarray(ks)[:, 0]


@pytest.mark.parametrize("d", [128, 256, 384])
def test_stats_are_the_diagonal_blocks_of_the_full_kv(d):
    """Per head, ``attn_stats`` (its plain version on the CPU) is the head's
    diagonal block of the TPU kernel's full KV, at every head count of the
    kernels at this width; K_sum is the same vector."""
    xq, xkv, qm, km, W = block_inputs(d, 7 * d)
    full, want_ks = jax_full_kv(xkv, km, W[1], W[2])
    for heads in sorted({h for dd, h in BF16_CELLS if dd == d}):
        hd = d // heads
        KV, ks = attn_cuda.attn_stats(t(xkv), t(km).float(), t(W[1]), t(W[2]),
                                      num_heads=heads)
        diag = np.stack([full[:, h * hd:(h + 1) * hd, h * hd:(h + 1) * hd]
                         for h in range(heads)], 1)
        assert KV.shape == diag.shape and rel(KV.numpy(), diag) <= 1e-5, heads
        assert rel(ks.numpy(), want_ks) <= 1e-5
        assert (KV[1] == 0).all() and (ks[1] == 0).all()


# ---- the stats kernel's blob and layouts, restated from csrc/attn.cu ----

def stage_geometry(d, heads):
    """(columns, k-rows) of a stats ring stage: whole [k_h | v_h] groups of
    at least 64 columns; all d k-rows where the stage is at most 32 KB,
    else 128 (``stats_cols``, ``stats_krows``)."""
    cols = max(64, 2 * (d // heads))
    return cols, d if cols * d * 2 <= 32768 else 128


def walk_stats_blob(blob, d, heads):
    """(Wk, Wv, counts) read from the blob as the kernel's consumers read it:
    stage s = g KP + p (column group g, k part p of KP = d / ks) at s * 2
    cols * ks bytes; k16 step j at 32 cols j bytes on; element (k-row kk of
    the step, column n) at (n // 8) 256 + (kk // 8) 128 + (n % 8) 16 +
    (kk % 8) 2 bytes; weight row p ks + 16 j + kk, packed column g cols +
    n, which is k_h or v_h column c % (2 hd) of head c // (2 hd)."""
    flat = blob.float().numpy()
    counts = np.zeros(flat.size, np.int64)
    cols, ks = stage_geometry(d, heads)
    kp, hd = d // ks, d // heads
    W = np.zeros((d, 2 * d), np.float32)
    j, kk, n = np.ix_(np.arange(ks // 16), np.arange(16), np.arange(cols))
    off = j * 32 * cols + (n // 8) * 256 + (kk // 8) * 128 + (n % 8) * 16 + (kk % 8) * 2
    for s in range(2 * d // cols * kp):
        g, p = divmod(s, kp)
        el = ((s * 2 * cols * ks + off) // 2).reshape(ks, cols)
        np.add.at(counts, el.ravel(), 1)
        W[p * ks:(p + 1) * ks, g * cols:(g + 1) * cols] = flat[el]
    W = W.reshape(d, heads, 2, hd)
    return W[:, :, 0].reshape(d, d), W[:, :, 1].reshape(d, d), counts


@pytest.mark.parametrize("d,heads", BF16_CELLS)
def test_stats_blob_walks_back_to_wk_wv(d, heads):
    rng = np.random.default_rng(d * heads)
    Wk, Wv = (rng.standard_normal((d, d)).astype(np.float32) for _ in range(2))
    blob = attn_cuda.pack_stats_weights(t(Wk), t(Wv), num_heads=heads)
    assert blob.dtype == torch.bfloat16 and blob.shape == (2 * d * d,)
    assert attn_cuda.stats_stage(d, heads) == stage_geometry(d, heads)
    got_k, got_v, counts = walk_stats_blob(blob, d, heads)
    assert (counts == 1).all()  # a permutation of [Wk|Wv]
    np.testing.assert_array_equal(got_k, bf16(Wk))
    np.testing.assert_array_equal(got_v, bf16(Wv))


def stats_smem(d, heads):
    """Bytes of the projection block (``Stats``): the ring (as many stages of
    at most 8 as fit), the 128-row x tile, two 64-row out tiles, barriers;
    and of the sum block (4 tiles of 128 rows, 2 hd + 8 bf16 apart)."""
    cols, ks = stage_geometry(d, heads)
    stage = cols * ks * 2
    rest = 128 * d * 2 + 2 * 64 * (cols + 8) * 2
    nst = min(8, (SMEM - rest - 16 * 8) // stage)
    return nst, nst * stage + rest + 16 * nst, 4 * 128 * (2 * (d // heads) + 8) * 2


def apply_smem(d, heads):
    """Bytes of the bf16 apply block (``tail::Layout<D, EXTRA>``): ring
    stages of 64 d bytes, the row tile, the hidden chunks, the batch's KV
    and K_sum, row statistics, barriers."""
    cols = 2 if d > 256 else 1
    rest = (128 // cols) * d * 2 + 2 * 64 * 64 * cols * 2 + d * (d // heads) * 4 + d * 4 \
        + 2 * 64 * 8
    nst = min(8, (SMEM - rest - 16 * 8) // (64 * d))
    return nst, nst * 64 * d + rest + 16 * nst


@pytest.mark.parametrize("d,heads", BF16_CELLS)
def test_kernel_layouts_fit_shared_memory(d, heads):
    """The stats projection keeps at least 2 ring stages, the apply kernel
    at least 2 (at d 384, head dim 64: exactly 2; head dim 48: 3), and every
    block of the two fits the card; at d 384 each apply warpgroup's 192
    columns hold whole heads. fp32 (d <= 256): at least 2 ring stages of
    32 KB beside the stats block's x tile, K' | V tile and mask and beside
    the apply block's row tile, two hidden chunks (which hold the KV while
    it is read), K_sum, row statistics and mask."""
    hd = d // heads
    nst, total, reduce_bytes = stats_smem(d, heads)
    assert nst >= 2 and total <= SMEM and reduce_bytes <= SMEM
    nst_a, total_a = apply_smem(d, heads)
    assert nst_a >= 2 and total_a <= SMEM
    assert (d // (2 if d > 256 else 1)) % hd == 0 and hd % 16 == 0
    if d == 384 and hd in (48, 64):
        assert nst_a == {48: 3, 64: 2}[hd]
    if d <= 256:  # fp32 (csrc/attn_f32.cu): 32 KB ring stages after the block's own bytes
        stats_rest = 64 * d * 4 + 64 * 136 * 4 + 64 * 4  # x tile, K' | V tile, mask
        apply_rest = 64 * d * 4 + 2 * 64 * 128 * 4 + d * 4 + 2 * 64 * 8 + 64 * 4
        for rest in (stats_rest, apply_rest):
            nst = min(8, (SMEM - rest - 16 * 8) // 32768)
            assert nst >= 2 and nst * 32768 + rest + 16 * nst <= SMEM
        assert d * hd * 4 <= 2 * 64 * 128 * 4  # the KV fits apply's hidden buffers
        assert (d // 2) % hd == 0  # each warpgroup's d / 2 columns hold whole heads


@pytest.mark.parametrize("d,heads", [(384, 8), (384, 6), (256, 4), (384, 24)])
def test_projection_writes_each_workspace_column_once(d, heads):
    """The projection's out copy: per column group g, thread step q of
    warpgroup thread wt writes 16 bytes at row i // (cols / 8), packed
    column c = 8 (i % (cols / 8)), i = wt + 128 q, to head g HPS + c //
    (2 hd), column c % (2 hd): every (row, head, column) of a 64-row half
    of the workspace once."""
    cols, _ = stage_geometry(d, heads)
    hd = d // heads
    hps = cols // (2 * hd)
    seen = np.zeros((64, heads, 2 * hd), np.int64)
    for g in range(2 * d // cols):
        for q in range(64 * cols // 8 // 128):
            for wt in range(128):
                i = wt + 128 * q
                r, c = i // (cols // 8), 8 * (i % (cols // 8))
                seen[r, g * hps + c // (2 * hd), c % (2 * hd):c % (2 * hd) + 8] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("hd", [16, 32, 48, 64])
def test_sum_covers_each_output_once(hd):
    """The sum block of one head: warp w < (hd / 16)^2 owns KV block (w //
    (hd / 16), w % (hd / 16)) of 16 x 16; the K_sum warp's lane l columns l
    and l + 32 below hd."""
    kvf = hd // 16
    kv = np.zeros((hd, hd), np.int64)
    for w in range(kvf * kvf):
        bi, bj = divmod(w, kvf)
        kv[16 * bi:16 * bi + 16, 16 * bj:16 * bj + 16] += 1
    ks = np.zeros(hd, np.int64)
    for lane in range(32):
        for c in range(-(-hd // 32)):
            if lane + 32 * c < hd:
                ks[lane + 32 * c] += 1
    assert (kv == 1).all() and (ks == 1).all()


def emulate_stats(x, mask, Wk, Wv, heads, grid):
    """The kernels' arithmetic in numpy (``test_torch_port_stats.py``'s model
    at any head count). Pass 1: items (batch, 128-row tile) walked by
    ``grid`` blocks, per 64-row half the projection rounded to bf16, K' =
    bf16(elu1(k)) m and V = v m into the workspace. Pass 2, per (batch,
    head): KV chained over 16-row steps in row order, K_sum row by row."""
    B, S, d = x.shape
    hd = d // heads
    T = attn_cuda.stats_tiles(S)
    ws = np.full((B, T * 128, 2, heads, hd), np.nan, np.float32)
    for blk in range(grid):
        for it in range(blk, B * T, grid):
            b, tt = divmod(it, T)
            for w in range(2):
                rows = np.arange(tt * 128 + 64 * w, tt * 128 + 64 * w + 64)
                ok = rows < S
                xr = np.where(ok[:, None], x[b, np.minimum(rows, S - 1)], 0)
                m = np.where(ok, bf16(mask[b, np.minimum(rows, S - 1)]), 0)[:, None]
                k, v = bf16(xr @ Wk), bf16(xr @ Wv)
                ws[b, rows, 0] = (bf16(np.where(k > 0, k + 1, np.exp(k))) * m).reshape(
                    -1, heads, hd)
                ws[b, rows, 1] = (v * m).reshape(-1, heads, hd)
    KV = np.zeros((B, heads, hd, hd), np.float32)
    ks = np.zeros((B, heads, hd), np.float32)
    for r0 in range(0, -(-S // 64) * 64, 16):
        rows = list(range(r0, r0 + 16))
        KV = KV + np.einsum("bshd,bshv->bhdv", ws[:, rows, 0], ws[:, rows, 1],
                            dtype=np.float32)
        for r in rows:
            ks = ks + ws[:, r, 0]
    return KV, ks.reshape(B, d)


@pytest.mark.parametrize("B,S,d,heads", [(2, 300, 384, 8), (3, 129, 384, 6),
                                         (2, 200, 256, 4)])
def test_emulated_order_is_grid_free_and_meets_plain(B, S, d, heads):
    """Head dim 48 and 64: the same bits whatever the number of blocks;
    within the card's bar (5e-3 of the largest value) of the plain version
    on bf16 inputs; an all-masked batch gives exact zeros."""
    rng = np.random.default_rng(S + d + heads)
    x = bf16(rng.standard_normal((B, S, d)))
    Wk, Wv = (bf16(rng.standard_normal((d, d)) / np.sqrt(d)) for _ in range(2))
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    mask[-1] = 0.0
    runs = [emulate_stats(x, mask, Wk, Wv, heads, grid) for grid in (1, 7, 132)]
    for KV, ks in runs[1:]:
        assert np.array_equal(KV, runs[0][0]) and np.array_equal(ks, runs[0][1])
    KV, ks = runs[0]
    assert (KV[-1] == 0).all() and (ks[-1] == 0).all()
    bf = torch.bfloat16
    KVp, ksp = attn_cuda.attn_stats_plain(t(x).to(bf), t(mask), t(Wk).to(bf), t(Wv).to(bf),
                                          num_heads=heads)
    for got, want in ((KV, KVp.numpy()), (ks, ksp.numpy())):
        assert np.abs(got - want).max() <= 5e-3 * np.abs(want).max()


# ---- d 384 models from JAX parameters ----

D384 = dict(d_model=384, num_heads=8, self_layers=1, cross_layers=1, dtype="float32")


def test_point_transformer_d384_matches_jax():
    rng = np.random.default_rng(384)
    B, N, M = 2, 40, 48
    args = (rng.uniform(-1, 1, (B, N, 3)).astype(np.float32),
            rng.uniform(-1, 1, (B, M, 3)).astype(np.float32),
            rng.random((B, N)) > 0.1, rng.random((B, M)) > 0.1,
            rng.uniform(-0.2, 0.2, (B, 1, 3)).astype(np.float32))
    jmodel = JPointTransformer(JModelConfig(**D384))
    params = jmodel.init(jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"]
    want = jmodel.apply({"params": params}, *map(jnp.asarray, args))
    model = PointTransformer(ModelConfig(fused_attention=True, **D384), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    with torch.no_grad():
        got = model(*map(t, args))
    assert got.dtype == torch.float32 and got.shape == (B, N, 3)
    assert rel(got.numpy(), want, rows=args[2]) <= 1e-5


def test_dem_transformer_d384_matches_jax():
    items = [synthetic.make_dem_patch(np.random.default_rng(i), 200 - 30 * i, 200 - 30 * i)
             for i in range(2)]
    b = batching.collate_dem(items, 200, 200, 32)
    args = (b["dsm"], b["dem_coarse"], b["dsm_mask"], b["dem_coarse_mask"])
    jmodel = JDEM(JModelConfig(separate_stems=True, **D384))
    params = jmodel.init(jax.random.PRNGKey(1), *map(jnp.asarray, args))["params"]
    want = jmodel.apply({"params": params}, *map(jnp.asarray, args))
    model = DEMTransformer(ModelConfig(separate_stems=True, fused_attention=True, **D384),
                           device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    with torch.no_grad():
        got = model(*map(t, args))
    assert got.dtype == torch.float32 and got.shape == (2, 200, 3)
    assert rel(got.numpy(), want, rows=b["dsm_mask"]) <= 1e-5


# ---- routing and the wrappers' checks ----

def refused(d, dtype, ffn_mult=4):
    """Cells the JAX rule admits but no kernel is written for: widths, at
    any head count (bf16 d 512 at ffn_mult 1-2, fp32 d 384 at 1-3)."""
    return (dtype, d) in {("bfloat16", 512), ("float32", 384)} and \
        ffn_mult <= {"bfloat16": 2, "float32": 3}[dtype]


ROUTES = [(d, h, dt) for d in (128, 256, 384, 512) for h in range(1, d + 1) if d % h == 0
          for dt in ("bfloat16", "float32")]


@pytest.mark.parametrize("d,heads,dtype", ROUTES)
def test_cuda_route_follows_the_jax_rules(monkeypatch, d, heads, dtype):
    """A self-attention block on CUDA (``cuda_like``): where the JAX package
    runs its fused kernels the port runs its own or raises naming ROADMAP,
    exactly on the refused cells (none at hidden 4 d); elsewhere the JAX
    route (its tail kernel where that rule holds, else the plain body)."""
    from scream_tpu_torch.utils import device as device_util

    jdt = jnp.dtype(dtype)
    if jattn.fusable_block(d, 4 * d, heads, jdt):
        want = "raise" if refused(d, dtype) else "fused"
    else:
        want = "tail" if ffn_pallas.fusable(d, 4 * d, jdt) else "plain"
    assert attn_cuda.kernels_take(d, 4 * d, heads, getattr(torch, dtype)) == (want == "fused")
    monkeypatch.setattr(device_util, "on_cuda", lambda x: True)
    calls = []
    monkeypatch.setattr(attn_cuda, "attention_block_fused",
                        lambda *a, **k: calls.append(("fused", k["num_heads"])) or a[0])
    monkeypatch.setattr(tail_cuda, "block_tail", lambda *a, **k: calls.append(("tail",)) or a[1])
    blk = AttentionBlock(d, heads, 4, dtype=getattr(torch, dtype))
    x = torch.zeros((1, 4, d))
    try:
        blk(x, x, x)
        got = calls[0][0] if calls else "plain"
    except NotImplementedError as e:
        assert "ROADMAP" in str(e) and f"head dim {d // heads}" in str(e)
        got = "raise"
    assert got == want
    if got == "fused":
        assert calls == [("fused", heads)]


class _Lib:
    """Stands in for the kernel library: records each entry point called
    and its integer arguments, returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, [a for a in args if isinstance(a, int)]))
            return 0
        return entry


@pytest.fixture
def fake_cuda(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(_build, "route", lambda x: True)
    monkeypatch.setattr(_build, "kernels", lambda: lib)
    monkeypatch.setattr(_build, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda x: 0)
    return lib


@pytest.mark.parametrize("d,heads,dtype", [(384, 8, torch.bfloat16), (256, 16, torch.bfloat16),
                                           (128, 2, torch.float32), (256, 4, torch.float32),
                                           (384, 16, torch.bfloat16), (256, 2, torch.bfloat16),
                                           (128, 16, torch.bfloat16), (256, 32, torch.float32)])
def test_wrappers_pass_the_head_count(fake_cuda, d, heads, dtype):
    """The head-specific entry points at their cells; the head-generic ones
    (``csrc/attn_heads.cu``) at the rest, the bf16 stats blob packed at d / 64
    heads (the 64-column groups that kernel projects)."""
    B, L = 2, 100
    xq, xkv, qm, km, W = block_inputs(d, 1, B=B, L=L, S=L)
    Wq, Wk, Wv, Wm, g1, b1, W1, W2, g2, b2 = (t(w).to(dtype) if w.ndim == 2 else t(w)
                                              for w in W)
    x, m = t(xq).to(dtype), t(qm).float()
    wrappers = (attn_cuda.attn_stats, attn_cuda.attn_apply, attn_cuda.attn_stats_heads,
                attn_cuda.attn_apply_heads)
    n0 = [w.launches for w in wrappers]
    KV, ks = attn_cuda.attn_stats(x, m, Wk, Wv, num_heads=heads)
    assert KV.shape == (B, heads, d // heads, d // heads) and ks.shape == (B, d)
    attn_cuda.attn_apply(x, m, KV, ks, Wq, Wm, g1, b1, W1, W2, g2, b2, attn_eps=1e-6,
                         ln_eps=1e-5, norm_dtype=torch.float32)
    names = [c[0] for c in fake_cuda.calls]
    ints = dict(fake_cuda.calls)
    generic = not attn_cuda.head_cell(d, heads, dtype)
    assert generic == ((d, heads) in {(384, 16), (256, 2), (128, 16), (256, 32)})
    # Each wrapper counts only its own kernel's launches.
    assert [w.launches - n for w, n in zip(wrappers, n0)] == \
        ([0, 0, 1, 1] if generic else [1, 1, 0, 0])
    if dtype == torch.float32:
        stats, apply = ("scream_attn_stats_heads_f32", "scream_attn_apply_heads_f32") if generic \
            else ("scream_attn_stats_f32", "scream_attn_apply_f32")
        assert names == [stats, apply]
        assert ints[stats][-5:] == [B, L, d, heads, 0]
        # ... hidden, norm_bf16 (fp32 norm: 0), stream
        assert ints[apply][-7:] == [B, L, d, heads, 4 * d, 0, 0]
    else:
        stats, apply = ("scream_attn_stats_heads", "scream_attn_apply_heads") if generic \
            else ("scream_attn_stats", "scream_attn_apply")
        assert names == ["scream_pack_stats", stats, "scream_pack_weights", apply]
        assert ints["scream_pack_stats"][-3:] == [d, d // 64 if generic else heads, 0]
        assert ints[stats][-5:] == [B, L, d, heads, 0]
        assert ints[apply][-6:] == [B, L, d, heads, 4 * d, 0]


@pytest.mark.parametrize("d,heads,dtype,ffn_mult", [(384, 8, torch.float32, 4),
                                                    (512, 8, torch.bfloat16, 2)])
def test_wrappers_refuse_cells_without_a_kernel(fake_cuda, d, heads, dtype, ffn_mult):
    x = torch.zeros((1, 8, d), dtype=dtype)
    m, W = torch.ones((1, 8)), torch.zeros((d, d), dtype=dtype)
    hid = ffn_mult * d
    with pytest.raises(ValueError, match="head dim"):
        attn_cuda.attn_stats(x, m, W, W, num_heads=heads)
    hd = d // heads
    KV, ks, p = torch.zeros((1, heads, hd, hd)), torch.zeros((1, d)), torch.ones(d)
    with pytest.raises(ValueError, match="head dim"):
        attn_cuda.attn_apply(x, m, KV, ks, W, W, p, p, torch.zeros((d, hid), dtype=dtype),
                             torch.zeros((hid, d), dtype=dtype), p, p, attn_eps=1e-6,
                             ln_eps=1e-5, norm_dtype=torch.float32)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="head dim"):
            attn_cuda.pack_stats_weights(W, W, num_heads=heads)
    assert not fake_cuda.calls


@pytest.mark.parametrize("ffn_mult", [1, 2, 3, 5, 6, 7, 8])
def test_cuda_route_follows_the_jax_rules_at_other_ffn_widths(ffn_mult):
    """``route_block`` for every (d, heads, dtype) cell of ``ROUTES`` at hidden
    = ffn_mult x d on CUDA: the fused kernels where the JAX rule admits its
    kernels and the port has them (every head count at the widths of
    ``HEADS_WIDTHS``), a refusal naming the cell where it has not (the
    widths of ``refused``), else the JAX route (the tail kernel where that
    rule holds and a kernel takes the width, a refusal where none does,
    else plain)."""
    from scream_tpu_torch.models.attention import route_block

    widths = {"bfloat16": (128, 256, 384), "float32": (128, 256)}
    tails = {"bfloat16": (128, 256, 384, 512), "float32": (128, 256, 384)}
    for d, heads, dtype in ROUTES:
        hid, jdt, tdt = ffn_mult * d, jnp.dtype(dtype), getattr(torch, dtype)
        if jattn.fusable_block(d, hid, heads, jdt):
            want = "fused" if d in widths[dtype] else "raise"
            assert (want == "raise") == refused(d, dtype, ffn_mult), (d, heads, dtype)
        elif ffn_pallas.fusable(d, hid, jdt):
            want = "tail" if d in tails[dtype] else "raise"
        else:
            want = "plain"
        assert attn_cuda.kernels_take(d, hid, heads, tdt) == (d in widths[dtype])
        try:
            got = route_block(d, hid, heads, tdt, None, None, True, True)
        except NotImplementedError as e:
            assert "ROADMAP" in str(e) and f"hidden {hid}" in str(e), (d, heads, dtype)
            if jattn.fusable_block(d, hid, heads, jdt):
                assert f"head dim {d // heads}" in str(e)
            got = "raise"
        assert got == want, (d, heads, dtype, got, want)
