"""The head-generic apply kernels' attend on the tensor cores
(``csrc/attn_heads.cuh``: ``band``, ``stage_band_bf16``, ``stage_band_tf32``,
``attend_bf16``, ``attend_tf32``; ``csrc/attn_heads_apply.cu`` and
``_apply_f32.cu``). On the CPU, where the kernels cannot run:

* a torch model of the attend, ``att = Q' . blockdiag(KV)`` as the kernels
  form it: each warpgroup's output columns in ``HEADS_SLICE`` slices (bf16
  32 columns, fp32 64), each
  over its band of KV rows (``attn_cuda.heads_band``) with the entries off
  the diagonal blocks zero, the band in the kernels' chunks; bf16 as KV hi =
  bf16(KV) and lo = bf16(KV - hi), the hi then the lo pass of each k16 step
  added into one fp32 accumulator; fp32 as split-TF32, per k8 step the
  passes lo hi, hi lo, hi hi into a chunk accumulator promoted into the fp32
  master every ``F32_PROMOTE_K`` k-rows of the band;
* the fp32 model (every product 3xTF32, with round-to-nearest and with
  truncating adds) held to the JAX package's fused block through the Pallas
  kernels in interpret mode at HIGHEST within 1e-5, and to the plain apply
  within a quarter of the fp32 apply bar (5e-6); the bf16 model within
  5e-3 of the plain apply in bf16 (the JAX CPU backend runs no bf16 dot);
  at head dims that divide 64 (d 128 hd 8, d 256 hd 8), that straddle a
  slice edge (d 384 hd 3, 12, 24, 96) and from 128 up (d 256 hd 128, d 384
  hd 384);
* a model of the fp32 head-generic stats (``csrc/attn_heads.cu``: the
  projection on the 3xTF32 model, then ``heads_sum_mma_kernel``'s K'^T V and
  K_sum per chunk of ``HEADS_CHUNK`` rows as split-TF32 on mma.sync, per k8
  step the passes lo hi, hi lo, hi hi, promoted every ``F32_PROMOTE_K``
  rows, the chunks added in order) held to the JAX package's Pallas stats
  kernel in interpret mode at HIGHEST within a quarter of the fp32 stats
  bar (2.5e-6), with round-to-nearest and with truncating adds, at the fp32
  cells below over three chunks;
* the staging restated from the source at every cell of
  ``attn_cuda.KERNEL_CELLS`` in both dtypes: each chunk written as the
  kernels' items write it and read back through the wgmma B layout holds
  blockdiag(KV) at its rows and columns, so the staged band covers each
  output column's head rows exactly once and is zero elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scream_tpu.ops import attn_pallas as jattn
from scream_tpu_torch.ops import attn_cuda
from scream_tpu_torch.ops.ffn import tail_plain
from test_torch_port_fp32 import jax_stats
from test_torch_port_tf32x3 import mm3, model_tail, round32

BF, F32 = torch.bfloat16, torch.float32
PALLAS_BAR, F32_APPLY_BAR, BF16_BAR, BF16_APPLY_BAR = 1e-5, 2e-5 / 4, 5e-3, 1e-2
F32_STATS_BAR = 1e-5 / 4
# (d_model, heads): head dim 8 at d 128 and 256, 3 / 12 / 24 / 96 at d 384,
# 128 at d 256 and 384 at d 384.
CELLS = [(128, 16), (256, 32), (384, 128), (384, 32), (384, 16), (384, 4), (256, 2), (384, 1)]


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


# ---- the kernels' geometry ----

def warpgroup_columns(d, dtype):
    """The consumer warpgroups' output columns: bf16 both own all d (their
    64-row halves of the tile) at d <= 256, each d / 2 at d 384; fp32 each
    d / 2 of the same 64 rows."""
    nw = d if dtype == BF and d <= 256 else d // 2
    return [(cp * nw, nw) for cp in range(d // nw)]


def chunks(d, hd, dtype):
    """(columns c0, k-rows kc, rows nk) of every band chunk in the kernels'
    order, per warpgroup: its slices in order, each band in chunks of
    ``heads_band_chunk`` rows from its start."""
    cap = attn_cuda.heads_band_chunk(d, dtype)
    out = []
    for n0, nw in warpgroup_columns(d, dtype):
        for c0 in range(n0, n0 + nw, attn_cuda.HEADS_SLICE[dtype]):
            k0, k1 = attn_cuda.heads_band(d, hd, c0, dtype)
            out += [(c0, kc, min(cap, k1 - kc)) for kc in range(k0, k1, cap)]
    return out


def blockdiag(KV):
    """``(B, H, hd, hd)`` -> the ``(B, d, d)`` KV whose cross-head blocks are
    zero (``attn_pallas.py``'s ``KVf``)."""
    B, H, hd = KV.shape[:3]
    out = KV.new_zeros((B, H * hd, H * hd))
    for h in range(H):
        out[:, h * hd:(h + 1) * hd, h * hd:(h + 1) * hd] = KV[:, h]
    return out


# ---- a torch model of the attend ----

def split_tf32_64(v):
    hi, lo = attn_cuda.split_tf32(v.float())
    return hi.double(), lo.double()


def model_attend(qp, KV, dtype, mode="rn"):
    """``att = Q' . blockdiag(KV)`` as the kernels form it, fp32 ``(B, L,
    d)``: ``qp`` ``(B, L, d)`` (bf16 values in bf16), per chunk of
    :func:`chunks` the staged band; bf16 per k16 step ``acc += Q' hi`` then
    ``acc += Q' lo``, each an exact sum rounded once to fp32, one
    accumulator over the band's chunks; fp32 per k8 step the three split
    passes into a fresh chunk accumulator (``mode``: adds to nearest, or
    truncated), added into the master at the chunk's end."""
    B, L, d = qp.shape
    hd = KV.shape[2]
    full = blockdiag(KV.float())
    q = qp.double().reshape(B, L, d)
    att = torch.zeros((B, L, d), dtype=F32)
    sl = attn_cuda.HEADS_SLICE[dtype]
    for c0, kc, nk in chunks(d, hd, dtype):
        cols = slice(c0, c0 + sl)
        band = full[:, kc:kc + nk, cols]
        if dtype == BF:
            hi = band.to(BF)
            lo = (band - hi.float()).to(BF)
            acc = att[..., cols]
            for k in range(0, nk, 16):
                for part in (hi, lo):
                    acc = round32(acc.double()
                                  + q[..., kc + k:kc + k + 16] @ part[:, k:k + 16].double(), "rn")
            att[..., cols] = acc
        else:
            (ah, al), (bh, bl) = split_tf32_64(q[..., kc:kc + nk]), split_tf32_64(band)
            chunk = torch.zeros((B, L, sl), dtype=F32)
            for k in range(0, nk, 8):
                ks = slice(k, k + 8)
                for a, b in ((al, bh), (ah, bl), (ah, bh)):
                    chunk = round32(chunk.double() + a[..., ks] @ b[:, ks], mode)
            att[..., cols] = att[..., cols] + chunk
    return att


def normalize(att, qp, ksum, heads, eps=1e-6):
    """``att (1 / (z + eps))``, ``z`` the fp32 sum over a head's columns of
    ``Q' K_sum`` (``attn_heads.cuh:normalize``)."""
    B, L, d = att.shape
    hd = d // heads
    z = (qp.float().reshape(B, L, heads, hd) * ksum.reshape(B, 1, heads, hd)).sum(-1)
    return (att.reshape(B, L, heads, hd) * (1.0 / (z + eps))[..., None]).reshape(B, L, d)


def model_apply(x, mask, KV, ksum, Wq, Wm, g1, b1, W1, W2, g2, b2, dtype, mode="rn"):
    """The head-generic apply: bf16, the Q projection and the tail as the
    plain version computes them around the model's attend; fp32, every
    product on ``test_torch_port_tf32x3.py``'s 3xTF32 model (the tail in
    ``tf32_tail.cuh``'s passes and hidden chunks) and the attend on this
    one."""
    B, L, d = x.shape
    heads = KV.shape[1]
    if dtype == BF:
        qp = attn_cuda._elu1(x @ Wq) * mask.to(BF)[..., None]
        msg = normalize(model_attend(qp, KV, BF), qp, ksum, heads).to(BF)
        return tail_plain(msg, x, Wm, g1, b1, W1, W2, g2, b2, cd=BF, nd=F32, eps=1e-5)
    qp = (attn_cuda._elu1(mm3(x.reshape(B * L, d), Wq, mode)) * mask.reshape(-1, 1))
    qp = qp.reshape(B, L, d)
    msg = normalize(model_attend(qp, KV, F32, mode), qp, ksum, heads).reshape(B * L, d)
    return model_tail(msg, x.reshape(B * L, d), Wm, g1, b1, W1, W2, g2, b2,
                      mode).reshape(B, L, d)


def cell_inputs(d, heads, seed):
    """Self-attention rows (2 x 80, ragged against the tiles; the second
    batch's tail masked) and block weights at hidden 4 d."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 80, d)).astype(np.float32)
    mask = rng.random((2, 80)) > 0.2
    mask[1, 50:] = False
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
    g1, g2 = (rng.uniform(0.5, 1.5, d).astype(np.float32) for _ in range(2))
    b1, b2 = ((rng.standard_normal(d) * 0.1).astype(np.float32) for _ in range(2))
    return x, mask, (w(d, d), w(d, d), w(d, d), w(d, d), g1, b1, w(d, 4 * d), w(4 * d, d),
                     g2, b2)


@pytest.mark.parametrize("d,heads", CELLS)
def test_fp32_model_meets_pallas_and_plain(d, heads):
    """fp32: the model against the JAX package's fused block through the
    Pallas kernels (interpret mode, HIGHEST) within 1e-5, and against the
    plain apply on the same stats within a quarter of the fp32 apply bar,
    with round-to-nearest and with truncating adds."""
    x, mask, W = cell_inputs(d, heads, d + heads)
    Wq, Wk, Wv, Wm, g1, b1, W1, W2, g2, b2 = map(t, W)
    j = jnp.asarray
    want = np.asarray(jattn.attention_block(
        j(x), j(x), j(mask), j(mask), *map(j, W), num_heads=heads, dtype=jnp.float32,
        norm_dtype=jnp.float32, use_pallas=True, interpret=True))
    m = t(mask).float()
    KV, ks = attn_cuda.attn_stats_plain(t(x), m, Wk, Wv, num_heads=heads)
    plain = attn_cuda.attn_apply_plain(t(x), m, KV, ks, Wq, Wm, g1, b1, W1, W2, g2, b2,
                                       attn_eps=1e-6, ln_eps=1e-5, norm_dtype=F32)
    for mode in ("rn", "rz"):
        got = model_apply(t(x), m, KV, ks, Wq, Wm, g1, b1, W1, W2, g2, b2, F32, mode)
        assert rel(got.numpy(), want, rows=mask) <= PALLAS_BAR, mode
        assert rel(got.numpy(), plain.numpy(), rows=mask) <= F32_APPLY_BAR, mode


@pytest.mark.parametrize("d,heads", CELLS)
def test_bf16_model_meets_plain(d, heads):
    """bf16, on the plain stats: the model's message (fp32, before its bf16
    rounding) within 5e-3 of the largest value of the plain version's, and
    its attend within 2^-15 of the largest entry of ``Q' KV`` in fp64 (KV
    carried as hi + lo leaves a residual of at most 2^-17 of an entry; one
    bf16 pass would leave up to 2^-9); the whole apply within the card's
    bf16 apply bar, 1e-2 of the largest value: a bf16 output a rounding
    flip moves by one ulp, 2^-8..2^-7 of the largest value."""
    x, mask, W = cell_inputs(d, heads, 7 * d + heads)
    Wq, Wk, Wv, Wm, g1, b1, W1, W2, g2, b2 = (w.to(BF) if w.dim() == 2 else w
                                                 for w in map(t, W))
    xb, m = t(x).to(BF), t(mask).float()
    B, L = m.shape
    KV, ks = attn_cuda.attn_stats_plain(xb, m, Wk, Wv, num_heads=heads)
    qp = attn_cuda._elu1(xb @ Wq) * m.to(BF)[..., None]
    att = model_attend(qp, KV, BF)
    # attn_apply_plain's attention, before its bf16 rounding.
    qh = qp.float().reshape(B, L, heads, d // heads)
    want_att = torch.einsum("blhd,bhdv->blhv", qh, KV).reshape(B, L, d)
    assert rel(normalize(att, qp, ks, heads).numpy(),
               normalize(want_att, qp, ks, heads).numpy(), rows=mask) <= BF16_BAR
    exact = qp.double() @ blockdiag(KV).double()
    assert rel(att.numpy(), exact.numpy()) <= 2.0 ** -15
    plain = attn_cuda.attn_apply_plain(xb, m, KV, ks, Wq, Wm, g1, b1, W1, W2, g2, b2,
                                       attn_eps=1e-6, ln_eps=1e-5, norm_dtype=F32)
    got = model_apply(xb, m, KV, ks, Wq, Wm, g1, b1, W1, W2, g2, b2, BF)
    assert rel(got.float().numpy(), plain.float().numpy(), rows=mask) <= BF16_APPLY_BAR


# ---- the fp32 stats' K'^T V on the tensor cores ----

def mm3_batched(A, B, mode):
    """``test_torch_port_tf32x3.py``'s ``mm3`` over leading batch dims: ``A``
    ``(..., M, K)``, ``B`` ``(..., K, N)``, K a multiple of 8; per k8 step
    the passes lo(A) hi(B), hi(A) lo(B), hi(A) hi(B), each an exact sum of 8
    products added into the fp32 chunk accumulator with one rounding
    (``mode``), the chunk added into the fp32 master every
    ``F32_PROMOTE_K`` k values and at the end."""
    K = A.shape[-1]
    (Ah, Al), (Bh, Bl) = (tuple(p.double() for p in attn_cuda.split_tf32(M)) for M in (A, B))
    master = torch.zeros(A.shape[:-1] + B.shape[-1:])
    chunk = torch.zeros_like(master)
    for k0 in range(0, K, 8):
        ks = slice(k0, k0 + 8)
        for a, b in ((Al, Bh), (Ah, Bl), (Ah, Bh)):
            chunk = round32(chunk.double() + a[..., ks] @ b[..., ks, :], mode)
        if (k0 + 8) % attn_cuda.F32_PROMOTE_K == 0 or k0 + 8 == K:
            master, chunk = master + chunk, torch.zeros_like(master)
    return master


def model_stats_f32(x, mask, Wk, Wv, heads, mode):
    """The fp32 head-generic stats as the kernels form them: ``[k|v]`` on
    the 3xTF32 model (``heads_proj_f32_kernel``, ``tf32_tile.cuh:project_kv``),
    ``K' = elu1(k) m``, ``V = v m``; per chunk of ``HEADS_CHUNK`` rows each
    head's K'^T V and K_sum (K' times a column of ones) on
    :func:`mm3_batched` over the chunk's rows in order (``heads_sum_mma_kernel``:
    rows past S are the workspace's zeros); the chunks added in chunk order
    (the slot reduce)."""
    B, S, d = x.shape
    hd = d // heads
    kv = mm3(x.reshape(B * S, d), torch.cat([Wk, Wv], 1), mode).reshape(B, S, 2 * d)
    m = mask[..., None]
    kp, vm = attn_cuda._elu1(kv[..., :d]) * m, kv[..., d:] * m
    KV, ks = torch.zeros((B, heads, hd, hd)), torch.zeros((B, d))
    for c0 in range(0, S, attn_cuda.HEADS_CHUNK):
        c1 = min(S, c0 + attn_cuda.HEADS_CHUNK)
        n = c1 - c0 + (-(c1 - c0) % 8)
        kc, vc = (torch.nn.functional.pad(a[:, c0:c1], (0, 0, 0, n - (c1 - c0)))
                  for a in (kp, vm))
        A = kc.reshape(B, n, heads, hd).permute(0, 2, 3, 1)
        KV = KV + mm3_batched(A, vc.reshape(B, n, heads, hd).permute(0, 2, 1, 3), mode)
        ks = ks + mm3_batched(kc.transpose(1, 2), torch.ones((n, 1)), mode)[..., 0]
    return KV, ks


@pytest.mark.parametrize("d,heads", [(d, h) for d, h in CELLS if d <= 256])
def test_fp32_stats_model_meets_pallas(d, heads):
    """fp32, 2 x 1,100 rows (three chunks; the second batch's tail masked):
    the model's KV (the diagonal blocks) and K_sum against the Pallas stats
    kernel at HIGHEST within a quarter of the fp32 stats bar, with
    round-to-nearest and with truncating adds."""
    rng = np.random.default_rng(3 * d + heads)
    B, S = 2, 1100
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    mask = rng.random((B, S)) > 0.2
    mask[1, 700:] = False
    Wk, Wv = ((rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32) for _ in range(2))
    full, ks_want = jax_stats(x, mask, Wk, Wv)
    hd = d // heads
    want = np.stack([full[:, h * hd:(h + 1) * hd, h * hd:(h + 1) * hd] for h in range(heads)], 1)
    for mode in ("rn", "rz"):
        KV, ks = model_stats_f32(t(x), t(mask).float(), t(Wk), t(Wv), heads, mode)
        assert rel(KV.numpy(), want) <= F32_STATS_BAR, mode
        assert rel(ks.numpy(), ks_want) <= F32_STATS_BAR, mode


# ---- the staging, restated from csrc/attn_heads.cuh ----

def stage(kvb, hd, c0, k0, nk, kcap, nthr, dtype):
    """``stage_band_bf16`` / ``stage_band_tf32`` on one batch's KV ``(H, hd,
    hd)``, ``sl`` the dtype's slice: thread ``tid`` of ``nthr`` stages
    column n = tid % sl and the items kg = tid // sl, tid // sl + nthr //
    sl, ... of ``per`` k-rows (bf16 8, at byte ``(n / 8) 256 + (n % 8) 16 +
    (kg / 2) 32 sl + (kg % 2) 128`` of the hi block; tf32 4, at float ``(n /
    8) 64 + (n % 8) 4 + (kg / 2) 8 sl + (kg % 2) 32``), the lo block ``kcap
    sl`` elements on. Returns the buffer's elements (fp32 values) and how
    often each was written."""
    sl = attn_cuda.HEADS_SLICE[dtype]
    per = 8 if dtype == BF else 4
    n, kg = np.array([(tid % sl, kg) for tid in range(nthr)
                      for kg in range(tid // sl, nk // per, nthr // sl)]).T
    i = np.arange(per)
    c = c0 + n[:, None]
    kh0 = c // hd * hd
    r = k0 + per * kg[:, None] + i - kh0  # the row within the column's head
    inside = (r >= 0) & (r < hd)
    src = (kh0 + np.clip(r, 0, hd - 1)) * hd + c - kh0
    v = torch.where(t(inside), kvb.reshape(-1)[t(src)], torch.zeros(()))
    if dtype == BF:
        hi = v.to(BF).float()
        lo = (v - hi).to(BF).float()
        off = (((n >> 3) << 8) + ((n & 7) << 4) + (kg >> 1) * 32 * sl + ((kg & 1) << 7)) // 2
    else:
        hi, lo = attn_cuda.split_tf32(v)
        off = ((n >> 3) << 6) + ((n & 7) << 2) + (kg >> 1) * 8 * sl + ((kg & 1) << 5)
    buf = torch.zeros(2 * kcap * sl, dtype=F32)
    writes = np.zeros(2 * kcap * sl, np.int64)
    for block, part in ((0, hi), (kcap * sl, lo)):
        e = block + off[:, None] + i
        buf[t(e.reshape(-1))] = part.reshape(-1)
        np.add.at(writes, e.reshape(-1), 1)
    return buf, writes


def read_b(buf, dtype, kcap, nk):
    """The chunk's hi and lo blocks ``(nk, sl)`` as the wgmma descriptors
    read them: K-major, no swizzle, LBO 128 and SBO 256 bytes; bf16 k16 step
    s at 32 sl s bytes, core (n / 8, k half) at ((n / 8) 2 + half) 128, row
    n % 8 16 bytes, k % 8 2 bytes; tf32 k8 step s at 32 sl s, k % 4 4
    bytes."""
    sl = attn_cuda.HEADS_SLICE[dtype]
    k, n = np.meshgrid(np.arange(nk), np.arange(sl), indexing="ij")
    if dtype == BF:
        byte = (k // 16) * 32 * sl + ((n // 8) * 2 + (k % 16) // 8) * 128 + (n % 8) * 16 \
            + (k % 8) * 2
        return [buf[t(b + byte // 2)] for b in (0, kcap * sl)]
    byte = (k // 8) * 32 * sl + ((n // 8) * 2 + (k % 8) // 4) * 128 + (n % 8) * 16 + (k % 4) * 4
    return [buf[t(b + byte // 4)] for b in (0, kcap * sl)]


@pytest.mark.parametrize("dtype", [BF, F32], ids=["bf16", "fp32"])
def test_staged_band_covers_each_head_once(dtype):
    """At every (d, head dim) of ``KERNEL_CELLS``: each chunk is whole band
    steps within the buffer and within d; written as the kernels' threads
    write it (256 threads at bf16 d <= 256, else a warpgroup's 128), every
    element of its rows is written once, and read back through the B layout
    its hi and lo are blockdiag(KV)'s split at its rows and columns. Over a
    warpgroup's chunks each output column reads each row of its head
    exactly once and no row twice; every other row it reads is zero."""
    sl = attn_cuda.HEADS_SLICE[dtype]
    step = attn_cuda.HEADS_BAND_STEP[dtype]
    nthr_of = lambda d: 256 if dtype == BF and d <= 256 else 128
    for d, hds in attn_cuda.KERNEL_CELLS[dtype].items():
        kcap = attn_cuda.heads_band_chunk(d, dtype)
        assert kcap % step == 0
        for hd in hds:
            rng = np.random.default_rng(d + hd)
            KV = t(rng.uniform(0.5, 1.5, (d // hd, hd, hd)).astype(np.float32))  # no zeros
            full = blockdiag(KV[None])[0]
            for n0, nw in warpgroup_columns(d, dtype):
                reads = np.zeros((d, nw), np.int64)
                for c0, kc, nk in chunks(d, hd, dtype):
                    if not n0 <= c0 < n0 + nw:
                        continue
                    assert kc % step == 0 and nk % step == 0 and 0 < nk <= kcap
                    assert kc + nk <= d
                    buf, writes = stage(KV, hd, c0, kc, nk, kcap, nthr_of(d), dtype)
                    for b0 in (0, kcap * sl):
                        assert (writes[b0:b0 + nk * sl] == 1).all()
                        assert (writes[b0 + nk * sl:b0 + kcap * sl] == 0).all()
                    hi, lo = read_b(buf, dtype, kcap, nk)
                    want = full[kc:kc + nk, c0:c0 + sl]
                    if dtype == BF:
                        want_hi = want.to(BF).float()
                        want_lo = (want - want_hi).to(BF).float()
                    else:
                        want_hi, want_lo = attn_cuda.split_tf32(want)
                    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
                    reads[kc:kc + nk, c0 - n0:c0 - n0 + sl] += 1
                head_k = np.arange(d)[:, None] // hd
                head_n = np.arange(n0, n0 + nw)[None, :] // hd
                assert (reads[head_k == head_n] == 1).all() and (reads <= 1).all(), (d, hd)
