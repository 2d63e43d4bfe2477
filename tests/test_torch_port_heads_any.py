"""The head-generic fused attention kernels (``csrc/attn_heads.cu``, stats;
``csrc/attn_heads_apply.cu`` and ``_apply_f32.cu``, apply): every
head count at bf16 d 128-384 and fp32 d 128-256 that the head-specific
kernels (``attn_cuda.HEAD_CELLS``: head dim 16, 32, 48, 64) do not take.
On the CPU, where the kernels cannot run:

* the plain versions and ``attention_block_fused`` against the JAX
  package's Pallas stats and apply kernels in interpret mode, fp32, at
  ragged row counts over three stats chunks with an all-masked batch, at
  head dim 8 (d 128, 16 heads), 24 (d 384, 16), 128 (d 256, 2), 192 (d
  384, 2) and 3 (d 384, 128): 1e-5 of the largest value;
* a numpy model of the kernels' arithmetic at those cells, held to the same
  Pallas kernels within the same 1e-5: the stats summed per chunk of
  ``HEADS_CHUNK`` rows in row order, a tensor-core step of rows at a time
  (16 bf16, 8 fp32) rounded once into the fp32 accumulator, then the
  chunks in chunk order (the fp32 split-TF32 passes are
  ``test_torch_port_heads_tc.py``'s model); apply's
  attend as ``Q' . blockdiag(KV)`` over each slice's band of KV rows in
  split-TF32 (``test_torch_port_heads_tc.py``'s model), the normalizer one
  chain per head; and the stats model on bf16 inputs within
  the card's 5e-3 of the plain version, an all-masked batch exactly 0;
* the sum kernel's work split restated from the source (its items' pairs
  of column blocks that share a head, each warp's n8 tiles; each KV entry
  and K_sum column written once, by an item within one head band, from
  the columns its block stages), at every (d, head dim) of the pair in
  both dtypes, and each kernel's shared memory within the card's 232,448
  bytes;
* the stats blob at a head-generic cell walked back to Wk and Wv (the
  64-column groups ``[k_g | v_g]`` the projection reads), bf16 and fp32;
* PointTransformer forwards at d 384 / 16 heads and d 256 / 2 heads from
  JAX parameters, fp32, the blocks on the fused route's plain versions:
  1e-5 of JAX's;
* the constants the wrappers mirror equal the source's.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scream_tpu.config import ModelConfig as JModelConfig
from scream_tpu.models.point_transformer import PointTransformer as JPointTransformer
from scream_tpu.ops import attn_pallas as jattn
from scream_tpu_torch.config import ModelConfig
from scream_tpu_torch.models import PointTransformer
from scream_tpu_torch.ops import attn_cuda
from scream_tpu_torch.ops.ffn import tail_plain
from scream_tpu_torch.utils.convert import params_from_jax
from test_torch_port_heads_tc import model_attend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "scream_tpu_torch", "csrc", "attn_heads.cuh")
SMEM = 232448  # dynamic shared memory a block on the H100
BAR = 1e-5
# (d_model, heads): head dim 8, 24, 128, 192, 3.
PALLAS_CELLS = [(128, 16), (384, 16), (256, 2), (384, 2), (384, 128)]
# Every (d_model, head dim) the head-generic pair takes beyond the
# head-specific kernels, bf16 (fp32: those at d <= 256).
GENERIC = sorted({(d, hd) for dt, widths in attn_cuda.KERNEL_CELLS.items()
                  for d, hds in widths.items() for hd in hds
                  if not attn_cuda.head_cell(d, d // hd, dt)})


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


def block_inputs(d, seed, B=2, L=100, S=1100):
    """Ragged rows over three stats chunks (S = 1,100), masked rows, and a
    second batch whose key/value rows are all masked."""
    rng = np.random.default_rng(seed)
    hid = 4 * d
    a = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    xq, xkv = a(B, L, d), a(B, S, d)
    qm, km = rng.random((B, L)) > 0.2, rng.random((B, S)) > 0.2
    km[1] = False
    W = (a(d, d), a(d, d), a(d, d), a(d, d), 1 + a(d), a(d), a(d, hid), a(hid, d),
         1 + a(d), a(d))
    return xq, xkv, qm, km, W


@pytest.fixture(scope="module")
def pallas_blocks():
    """Per cell of PALLAS_CELLS: its inputs and the JAX package's fused block
    through the Pallas kernels in interpret mode, fp32 (one compile each,
    shared by the tests below)."""
    out = {}
    for d, heads in PALLAS_CELLS:
        xq, xkv, qm, km, W = block_inputs(d, d + heads)
        want = jattn.attention_block(
            jnp.asarray(xq), jnp.asarray(xkv), jnp.asarray(qm), jnp.asarray(km),
            *map(jnp.asarray, W), num_heads=heads, dtype=jnp.float32,
            norm_dtype=jnp.float32, use_pallas=True, interpret=True)
        out[(d, heads)] = (xq, xkv, qm, km, W, np.asarray(want))
    return out


# ---- the plain versions and the fused block against the Pallas kernels ----

@pytest.mark.parametrize("d,heads", PALLAS_CELLS)
def test_fused_block_and_plain_versions_match_pallas(pallas_blocks, d, heads):
    assert not attn_cuda.head_cell(d, heads, torch.bfloat16)
    assert attn_cuda.kernels_take(d, 4 * d, heads, torch.bfloat16)
    xq, xkv, qm, km, W, want = pallas_blocks[(d, heads)]
    f32 = torch.float32
    got = attn_cuda.attention_block_fused(t(xq), t(xkv), t(qm), t(km), *map(t, W),
                                          num_heads=heads, dtype=f32, norm_dtype=f32)
    assert got.shape == xq.shape and rel(got.numpy(), want, rows=qm) <= BAR
    Wq, Wk, Wv, Wm, g1, b1, W1, W2, g2, b2 = map(t, W)
    KV, ks = attn_cuda.attn_stats_heads(t(xkv), t(km).float(), Wk, Wv, num_heads=heads)
    assert KV.shape == (2, heads, d // heads, d // heads) and (KV[1] == 0).all()
    out = attn_cuda.attn_apply_heads(t(xq), t(qm).float(), KV, ks, Wq, Wm, g1, b1, W1, W2,
                                     g2, b2, attn_eps=1e-6, ln_eps=1e-5, norm_dtype=f32)
    assert rel(out.numpy(), want, rows=qm) <= BAR


# ---- a model of the kernels' arithmetic ----

def model_stats(x, mask, Wk, Wv, heads, bf):
    """The head-generic stats in numpy: ``[k|v]`` rounded to bf16 (``bf``;
    else fp32), ``K' = elu1(k)`` rounded again, times the mask, ``V = v m``;
    then per chunk of HEADS_CHUNK rows (``heads_sum_mma_kernel``'s items)
    each head's K'^T V and K_sum in row order, a tensor-core step of rows
    at a time (m16n8k16 in bf16, m16n8k8 in fp32) summed exactly and added
    into the fp32 accumulator with one rounding (K_sum: K' times a column
    of ones), the chunks added in chunk order (``attn_f32.cu``'s slot
    reduce, ``attn_stats_f32_reduce_kernel``)."""
    B, S, d = x.shape
    hd = d // heads
    r = bf16 if bf else (lambda a: np.asarray(a, np.float32))
    x64 = x.astype(np.float64)
    k, v = r(x64 @ Wk), r(x64 @ Wv)
    m = (bf16(mask) if bf else mask.astype(np.float32))[..., None]
    kp = (r(np.where(k > 0, k + 1, np.exp(k))) * m).reshape(B, S, heads, hd)
    vm = (v * m).reshape(B, S, heads, hd).astype(np.float32)
    step = 16 if bf else 8
    KV = np.zeros((B, heads, hd, hd), np.float32)
    ks = np.zeros((B, heads, hd), np.float32)
    for c0 in range(0, S, attn_cuda.HEADS_CHUNK):
        part = np.zeros_like(KV)
        pks = np.zeros_like(ks)
        for r0 in range(c0, min(S, c0 + attn_cuda.HEADS_CHUNK), step):
            kk = kp[:, r0:r0 + step].astype(np.float64)  # rows past S: the workspace's zeros
            vv = vm[:, r0:r0 + step].astype(np.float64)
            part = (part + np.einsum("bshd,bshv->bhdv", kk, vv)).astype(np.float32)
            pks = (pks + kk.sum(1)).astype(np.float32)
        KV, ks = KV + part, ks + pks
    return KV, ks.reshape(B, d)


def model_apply(x, mask, KV, ks, Wq, Wm, g1, b1, W1, W2, g2, b2, eps=1e-6):
    """The head-generic apply's attention, fp32: ``Q' = elu1(x @ Wq) m``;
    ``att = Q' . blockdiag(KV)`` as the fp32 kernel forms it on the tensor
    cores (``test_torch_port_heads_tc.py``'s model: split-TF32 over each
    64-column fp32 slice's band of KV rows, promoted every 64 k), ``z`` the
    chain of ``Q'[base + i] K_sum[base + i]`` over the column's head
    (``normalize``), the message ``att (1 / (z + eps))``; then the plain
    tail."""
    B, L, d = x.shape
    H, hd = KV.shape[1], KV.shape[2]
    q = (x.astype(np.float64) @ Wq).astype(np.float32)
    qp = (np.where(q > 0, q + 1, np.exp(q)) * mask[..., None]).astype(np.float32)
    cols = np.arange(d)
    base = cols // hd * hd
    att = model_attend(t(qp), t(KV), torch.float32).numpy()
    z = np.zeros((B, L, d), np.float32)
    for i in range(hd):
        z = z + qp[:, :, base + i] * ks[:, base + i][:, None, :]
    msg = att * (np.float32(1) / (z + np.float32(eps)))
    f32 = torch.float32
    return tail_plain(t(msg), t(x), t(Wm), t(g1), t(b1), t(W1), t(W2), t(g2), t(b2), cd=f32,
                      nd=f32, eps=1e-5).numpy()


@pytest.mark.parametrize("d,heads", PALLAS_CELLS)
def test_model_of_the_kernels_meets_pallas(pallas_blocks, d, heads):
    """fp32: the model's stats against the plain stats (which meet the
    Pallas kernel's diagonal blocks), its whole block against the Pallas
    block, both within 1e-5."""
    xq, xkv, qm, km, W, want = pallas_blocks[(d, heads)]
    Wq, Wk, Wv, Wm, g1, b1, W1, W2, g2, b2 = W
    KV, ks = model_stats(xkv, km, Wk, Wv, heads, bf=False)
    KVp, ksp = attn_cuda.attn_stats_plain(t(xkv), t(km).float(), t(Wk), t(Wv),
                                          num_heads=heads)
    assert rel(KV, KVp.numpy()) <= BAR and rel(ks, ksp.numpy()) <= BAR
    assert (KV[1] == 0).all() and (ks[1] == 0).all()
    got = model_apply(xq, qm, KV, ks, Wq, Wm, g1, b1, W1, W2, g2, b2)
    assert rel(got, want, rows=qm) <= BAR


@pytest.mark.parametrize("d,heads", [(128, 128), (256, 1), (384, 16), (384, 128)])
def test_model_stats_bf16_meets_plain(d, heads):
    """bf16 inputs, three chunks: within the card's bar (5e-3 of the largest
    value) of the plain version; an all-masked batch gives exact zeros."""
    rng = np.random.default_rng(d + heads)
    B, S = 2, 1100
    x = bf16(rng.standard_normal((B, S, d)))
    Wk, Wv = (bf16(rng.standard_normal((d, d)) / np.sqrt(d)) for _ in range(2))
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    mask[-1] = 0.0
    KV, ks = model_stats(x, mask, Wk, Wv, heads, bf=True)
    assert (KV[-1] == 0).all() and (ks[-1] == 0).all()
    bf = torch.bfloat16
    KVp, ksp = attn_cuda.attn_stats_plain(t(x).to(bf), t(mask), t(Wk).to(bf), t(Wv).to(bf),
                                          num_heads=heads)
    for got, want in ((KV, KVp.numpy()), (ks, ksp.numpy())):
        assert np.abs(got - want).max() <= 5e-3 * np.abs(want).max()


# ---- work split and layouts, restated from csrc/attn_heads*.cu ----

def constant(name):
    with open(SOURCE) as f:
        found = re.findall(rf"constexpr int {name} = (\d+);", f.read())
    assert len(found) == 1, name
    return int(found[0])


def test_wrapper_constants_are_the_sources():
    """The chunk the wrappers and the model above sum in is the kernel's;
    the workspace groups are the 64 columns the packs lay out, the sum's
    wide blocks two of them; a sum stage's rows are whole tensor-core steps
    and divide the fp32 promotion chunk and the chunk; the apply's slice
    and band steps are the attend's."""
    assert attn_cuda.HEADS_CHUNK == constant("kChunk")
    assert constant("kGroup") == 64 and constant("kSumWide") == 128
    rows = constant("kSumRows")
    assert rows % 16 == 0 and attn_cuda.F32_PROMOTE_K % rows == 0
    assert attn_cuda.HEADS_CHUNK % rows == 0 and constant("kSumStages") >= 2
    # apply: the attend's slices and band steps (test_torch_port_heads_tc.py's model).
    assert attn_cuda.HEADS_SLICE == {torch.bfloat16: constant("kSliceBf16"),
                                     torch.float32: constant("kSliceF32")}
    assert attn_cuda.HEADS_BAND_STEP == {torch.bfloat16: constant("kStepBf16"),
                                         torch.float32: constant("kStepF32")}


def sum_block(f32, hd):
    """``attn_heads.cu:sum_block``: an item's block of K' (and V) columns."""
    wide = constant("kSumWide")
    return wide if not f32 and hd % wide == 0 else constant("kGroup")


def sum_pairs(nb, w, hd):
    """``attn_heads.cu:sum_pairs``: the pairs (a, c) of the nb blocks of w
    columns whose K' (a) and V (c) columns share a head, in item order."""
    return [(a, c) for a in range(nb) for c in range(nb)
            if a * w // hd <= (c * w + w - 1) // hd and c * w // hd <= (a * w + w - 1) // hd]


def staged_columns(w, esize):
    """``heads_sum_mma_kernel``'s fetch (one stage): for each cp.async piece
    i of 16 bytes, (half v, row r, staged element offset, block column):
    piece u of the K' (v 0) or V (v 1) half of group q of row r, at element
    (v kSumRows + r) (w + 8) + 64 q + u (16 / esize) of the stage."""
    rows, group = constant("kSumRows"), constant("kGroup")
    cpr, per = group * esize // 16, 16 // esize
    out = []
    for i in range(2 * rows * (w // group) * cpr):
        u, v, q = i % cpr, i // cpr % 2, i // (2 * cpr) % (w // group)
        r = i // (2 * cpr * (w // group))
        out.append((v, r, (v * rows + r) * (w + 8) + q * group + u * per, q * group + u * per))
    return out


@pytest.mark.parametrize("d,hd", GENERIC)
def test_sum_writes_each_output_once_from_staged_columns(d, hd):
    """``heads_sum_mma_kernel``, in bf16 and (d <= 256) fp32: the items of a
    (batch, chunk) are the pairs of blocks of ``sum_block`` columns whose K'
    and V columns share a head; warp w of an item takes its K' block's
    columns 16 w .. 16 w + 15 against the n8 tiles of its V block that share
    a head with them and writes the entries of those tiles whose K' and V
    columns lie in one head; every KV entry is written once, every K_sum
    column once (by the items with equal blocks), and an item writes only
    within the heads its K' block touches. A stage's cp.async pieces fill
    each staged element of its K' and V rows once (rows w + 8 elements
    apart, so that a fragment load's 8 rows fall in distinct banks), each
    from the block's own column."""
    for f32 in (False, True):
        if f32 and d > 256:
            continue
        w = sum_block(f32, hd)
        kv, ksum = np.zeros((d, hd), np.int64), np.zeros(d, np.int64)
        pairs = sum_pairs(d // w, w, hd)
        assert pairs and len(set(pairs)) == len(pairs)
        for a, c in pairs:
            k_heads = set(range(a * w // hd, (a * w + w - 1) // hd + 1))
            written = 0
            for warp in range(w // 16):
                cm = a * w + 16 * warp
                for j in range(w // 8):
                    cn = c * w + 8 * j
                    if not (cm // hd <= (cn + 7) // hd and cn // hd <= (cm + 15) // hd):
                        continue
                    for m in range(cm, cm + 16):
                        for n in range(cn, cn + 8):
                            if m // hd == n // hd:
                                assert m // hd in k_heads
                                kv[m, n - m // hd * hd] += 1
                                written += 1
                if a == c:
                    ksum[cm:cm + 16] += 1
            assert written > 0
        assert (kv == 1).all() and (ksum == 1).all(), (f32, d, hd)
        esize = 4 if f32 else 2
        staged = staged_columns(w, esize)
        rows = constant("kSumRows")
        cover = np.zeros(2 * rows * (w + 8), np.int64)
        for v, r, off, col in staged:
            cover[off:off + 16 // esize] += 1
            assert off == (v * rows + r) * (w + 8) + col and col + 16 // esize <= w
        pad = np.arange(cover.size) % (w + 8) >= w
        assert (cover[~pad] == 1).all() and (cover[pad] == 0).all()
        assert ((w + 8) * esize) % 16 == 0 and ((w + 8) * esize // 4) % 32 in (4, 8)


@pytest.mark.parametrize("d", [128, 256, 384])
def test_kernel_layouts_fit_shared_memory(d):
    """The sum block's ring (kSumStages stages of kSumRows K' and V rows of
    its block, w + 8 elements each) within the card's per-block limit, and
    the blocks an SM is meant to hold (256 / w, at most 128 registers a
    thread) within its 233,472 bytes with 1 KB each reserved; the bf16
    apply block (``tail::Layout<D, EXTRA>``: ring stages of 64 d bytes, the
    row tile, hidden chunks, the attend's band chunks (one of the two
    warpgroups' shared columns at d <= 256, d k-rows; one a warpgroup at d
    384, d / 2 k-rows: x 32 columns of bf16 hi and lo each, ``HeadsApply``),
    K_sum, row
    statistics, barriers) with at least 2 stages; in fp32 (d <= 256) the
    projection block (ring of 32 KB stages, the 64-row x tile, mask) and
    the apply block with each warpgroup's band chunk (64 k-rows x 64
    columns, fp32 hi and lo) inside its half of the hidden buffers."""
    sl, sl32 = constant("kSliceBf16"), constant("kSliceF32")
    stages, rows = constant("kSumStages"), constant("kSumRows")
    for esize, w in ((2, 64), (2, 128), (4, 64)):
        ring = stages * 2 * rows * (w + 8) * esize
        assert ring <= SMEM and (256 // w) * (ring + 1024) <= 233472
    cols = 2 if d > 256 else 1
    kc = attn_cuda.heads_band_chunk(d, torch.bfloat16)
    assert kc == (d if cols == 1 else d // 2) and kc % 32 == 0
    band = kc * sl * 4  # bytes of a bf16 chunk, hi then lo
    rest = (128 // cols) * d * 2 + 2 * 64 * 64 * cols * 2 + cols * band + d * 4 + 2 * 64 * 8
    nst = min(8, (SMEM - rest - 16 * 8) // (64 * d))
    assert nst >= 2 and nst * 64 * d + rest + 16 * nst <= SMEM
    assert (d // cols) % sl == 0  # a warpgroup's columns: whole slices
    if d <= 256:
        for rest in (64 * d * 4 + 64 * 4,  # projection
                     64 * d * 4 + 2 * 64 * 128 * 4 + d * 4 + 2 * 64 * 8 + 64 * 4):  # apply
            nst = min(8, (SMEM - rest - 16 * 8) // 32768)
            assert nst >= 2 and nst * 32768 + rest + 16 * nst <= SMEM
        kc32 = attn_cuda.heads_band_chunk(d, torch.float32)
        assert 2 * (kc32 * sl32 * 4 * 2) <= 2 * 64 * 128 * 4 and (d // 2) % sl32 == 0


def walk_stats_blob(blob, d, heads):
    """(Wk, Wv) read from the bf16 stats blob as the projection's consumers
    read it (``test_torch_port_heads.py``'s walk): stage s = g KP + p at s 2
    cols ks bytes, k16 step j at 32 cols j bytes on, element (k-row kk,
    column n) at (n // 8) 256 + (kk // 8) 128 + (n % 8) 16 + (kk % 8) 2;
    packed column g cols + n is k_h or v_h column c % (2 hd) of head c //
    (2 hd)."""
    flat = blob.float().numpy()
    cols, ks = attn_cuda.stats_stage(d, heads)
    kp, hd = d // ks, d // heads
    W = np.zeros((d, 2 * d), np.float32)
    j, kk, n = np.ix_(np.arange(ks // 16), np.arange(16), np.arange(cols))
    off = j * 32 * cols + (n // 8) * 256 + (kk // 8) * 128 + (n % 8) * 16 + (kk % 8) * 2
    for s in range(2 * d // cols * kp):
        g, p = divmod(s, kp)
        el = ((s * 2 * cols * ks + off) // 2).reshape(ks, cols)
        W[p * ks:(p + 1) * ks, g * cols:(g + 1) * cols] = flat[el]
    W = W.reshape(d, heads, 2, hd)
    return W[:, :, 0].reshape(d, d), W[:, :, 1].reshape(d, d)


@pytest.mark.parametrize("d,heads", [(128, 16), (256, 2), (384, 16), (384, 384)])
def test_generic_stats_blob_walks_back_to_wk_wv(d, heads):
    """At a head-generic cell the blob is that of d / 64 heads: [Wk|Wv] in
    64-column groups [k_g | v_g], whatever the model's head count; fp32 the
    same grouping, split hi / lo."""
    rng = np.random.default_rng(d * heads)
    Wk, Wv = (t(rng.standard_normal((d, d)).astype(np.float32)) for _ in range(2))
    assert attn_cuda.stats_layout_heads(d, heads, torch.bfloat16) == d // 64
    blob = attn_cuda.pack_stats_weights(Wk, Wv, num_heads=heads)
    assert blob.dtype == torch.bfloat16 and blob.shape == (2 * d * d,)
    got_k, got_v = walk_stats_blob(blob, d, d // 64)
    np.testing.assert_array_equal(got_k, bf16(Wk))
    np.testing.assert_array_equal(got_v, bf16(Wv))
    if d <= 256:
        f32 = attn_cuda.pack_stats_weights_f32(Wk, Wv, num_heads=heads)
        assert torch.equal(f32, attn_cuda.pack_stats_weights_f32(Wk, Wv, num_heads=d // 64))


# ---- models at the new head counts from JAX parameters ----

@pytest.mark.parametrize("d,heads", [(384, 16), (256, 2)])
def test_point_transformer_matches_jax(d, heads):
    cfg = dict(d_model=d, num_heads=heads, self_layers=1, cross_layers=1, dtype="float32")
    rng = np.random.default_rng(d + heads)
    B, N, M = 2, 40, 48
    args = (rng.uniform(-1, 1, (B, N, 3)).astype(np.float32),
            rng.uniform(-1, 1, (B, M, 3)).astype(np.float32),
            rng.random((B, N)) > 0.1, rng.random((B, M)) > 0.1,
            rng.uniform(-0.2, 0.2, (B, 1, 3)).astype(np.float32))
    jmodel = JPointTransformer(JModelConfig(**cfg))
    params = jmodel.init(jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"]
    want = jmodel.apply({"params": params}, *map(jnp.asarray, args))
    model = PointTransformer(ModelConfig(fused_attention=True, **cfg), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    with torch.no_grad():
        got = model(*map(t, args))
    assert got.dtype == torch.float32 and got.shape == (B, N, 3)
    assert rel(got.numpy(), want, rows=args[2]) <= BAR
