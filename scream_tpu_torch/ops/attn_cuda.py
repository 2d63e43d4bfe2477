"""Fused attention block: projections + linear attention + block tail in two
hand-written kernels (``csrc/attn.cu``), port of ``scream_tpu/ops/attn_pallas.py``.

* :func:`attn_stats` (kernels ``attn_stats_kernel`` and
  ``attn_stats_reduce_kernel``, replace the TPU's ``_stats_kernel``): per
  (batch, head), ``K'^T V`` and ``K_sum`` over the key/value rows, where
  ``[k|v] = x_kv @ [Wk|Wv]`` rounds to the compute dtype,
  ``K' = (elu(k)+1) * mask`` and ``V = v * mask``. The projection splits
  the sequence into 128-row tiles over the blocks and writes ``K'`` and
  ``V`` per head to a bf16 workspace; the second kernel sums each head's
  rows in row order, so the result depends on neither the card nor the
  batch, and two launches on one input agree bit for bit. ``[Wk|Wv]``
  streams through the projection's shared-memory ring, packed once per
  call by :func:`pack_stats_weights` (one launch of ``stats_pack_kernel``).
* :func:`attn_apply` (kernel ``attn_apply_kernel``, replaces ``_apply_kernel``):
  per row tile, ``q = x @ Wq``, ``Q' = (elu(q)+1) * mask``, the per-head
  contraction with the fp32 KV, the fp32 normalizer ``1/(Q'.K_sum + eps)``,
  then ``LN2(x + FFN(LN1(msg @ Wm + x)))`` through the tail kernel's code
  (``csrc/tail_tile.cuh``); its weights stream through a shared-memory ring,
  packed by ``ops/tail_cuda.py:pack_weights``.

The kernels take every head count dividing d_model at the widths of
``HEADS_WIDTHS`` (:func:`kernels_take`, ``KERNEL_CELLS``): bf16 at d_model
128, 256 and 384, fp32 at 128 and 256. The head-specific kernels take the
cells of ``HEAD_CELLS`` (templates on (d, head dim)): in bf16, d_model 128
and 256 with head dim 16, 32 or 64 and d_model 384 with head dim 16, 32, 48
or 64 (8 heads of 48 at ``--d-model 384``); in fp32, d_model 128 and 256
with head dim 16, 32 or 64. The fp32 configuration has its own pair,
``csrc/attn_f32.cu`` (``attn_stats_f32_kernel`` with
``attn_stats_f32_reduce_kernel``, and ``attn_apply_f32_kernel``): every
product on the tensor cores as split-TF32 ("3xTF32") wgmma, each operand
``hi + lo`` (:func:`split_tf32`) and each product ``lo hi + hi lo + hi hi``
into an accumulator promoted into an fp32 master sum every
``F32_PROMOTE_K`` k values; the weights split and packed once per call
(:func:`pack_stats_weights_f32`, :func:`pack_block_weights_f32`, the
latter the fp32 tail kernel's too, without ``Wq``), the stats summed per
64-row tile and then over the tiles in tile order. Every other head count
(head dim 1-12, 24, 96-384) goes to the head-generic pair, templated on
d_model only (:func:`attn_stats_heads`, ``csrc/attn_heads.cu``;
:func:`attn_apply_heads`, ``csrc/attn_heads_apply.cu`` and
``csrc/attn_heads_apply_f32.cu``): the stats project ``[k|v]`` on the
head-specific kernels' wgmma pipelines in 64-column groups, whatever the
head count, and sum ``K'^T V`` on the tensor cores (``mma.sync``; fp32 as
split-TF32) per pair of column blocks that share a head (64 columns, 128 in
bf16 from head dim 128) and chunk of ``HEADS_CHUNK`` rows, the rows in
order, then the chunks in chunk order (CPU models of that order are
``tests/test_torch_port_heads_any.py``'s and, for fp32,
``tests/test_torch_port_heads_tc.py``'s); apply forms the attend as
``Q' . blockdiag(KV)`` on the tensor cores, as the TPU
kernel does: each ``HEADS_SLICE`` output columns against the band of KV
rows of their heads (:func:`heads_band`), KV split bf16 hi + lo in bf16
and split-TF32 in fp32, then runs the head-specific kernels' tail (a CPU
model is ``tests/test_torch_port_heads_tc.py``'s).
Each wrapper dispatches on the compute dtype and the cell, launches its
kernel for CUDA tensors (raising on what no kernel takes) and runs its
plain PyTorch version, defined beside it, only for CPU tensors. Its
``launches`` counts its own kernel's launches alone: a cell that
:func:`attn_stats` hands to :func:`attn_stats_heads` counts there. The stats
are kept per head, ``(B, H, hd, hd)``: the TPU kernel's full ``d x d`` KV
has zeros outside those diagonal blocks.

The backward of :func:`attention_block_fused` recomputes the plain unfused
block (:func:`block_plain`) and differentiates it, as the JAX package's
``custom_vjp`` does.
"""

from __future__ import annotations

import torch

from scream_tpu_torch.ops import _build
from scream_tpu_torch.ops.ffn import _TILE_R, _VMEM_BUDGET, tail_plain
from scream_tpu_torch.ops.tail_cuda import KERNEL_WIDTHS_F32, pack_weights

# The head-specific kernels' cells: per compute dtype, d_model -> the head
# dims (d_model / heads) of their instantiations (csrc/attn.cu ATTN_CELLS,
# csrc/attn_f32.cu ATTN_F32_CELLS); their bits are the ones path 2's GT-free
# gate was set on (PERF.md).
HEAD_CELLS = {
    torch.bfloat16: {128: (16, 32, 64), 256: (16, 32, 64), 384: (16, 32, 48, 64)},
    torch.float32: {128: (16, 32, 64), 256: (16, 32, 64)},
}
# The widths of the head-generic pair (csrc/attn_heads.cu), which takes every
# head count; with a hidden width in 128-column chunks. KERNEL_CELLS: every
# (d_model, head dim) the CUDA kernels take. The widths the JAX rule admits
# beyond them are still to port (ROADMAP.md).
HEADS_WIDTHS = {torch.bfloat16: (128, 256, 384), torch.float32: (128, 256)}
KERNEL_CELLS = {dt: {d: tuple(hd for hd in range(1, d + 1) if d % hd == 0) for d in widths}
                for dt, widths in HEADS_WIDTHS.items()}
# The head-generic stats' chunk of rows (csrc/attn_heads.cuh kChunk): each
# chunk's partial sums in row order, then the chunks in chunk order.
HEADS_CHUNK = 512
# The head-generic apply's attend (csrc/attn_heads.cuh kSliceBf16,
# kSliceF32, kStepBf16, kStepF32): output columns a product, and the step
# its band of KV rows is rounded out to, by compute dtype. A bf16 band goes
# through shared memory whole at d <= 256 (in chunks of d / 2 rows at d 384,
# one a warpgroup), an fp32 band in chunks of F32_PROMOTE_K rows, one a
# promotion.
HEADS_SLICE = {torch.bfloat16: 32, torch.float32: 64}
HEADS_BAND_STEP = {torch.bfloat16: 32, torch.float32: 16}
KERNEL_HID_CHUNK = 128
# The stats projection's row tile (csrc/attn.cu TM): the blocks walk the
# (batch, tile) items, and the workspace holds S rounded up to it.
STATS_TILE = 128
# The fp32 kernels' row tile (csrc/attn_f32.cu TM): in the stats, one
# workspace slot of partial sums per (batch, tile), added in tile order.
STATS_F32_TILE = 64
# The fp32 kernels' promotion chunk, csrc/tf32_tile.cuh:kPromoteK (a
# compile-time constant there; tests/test_torch_port_tf32x3.py checks that
# the two agree): every F32_PROMOTE_K k values of a product the tensor
# cores' accumulator is added into an fp32 master sum and started afresh
# (tf32_tile.cuh:ring_mma3). The split arithmetic's CPU model in that test
# keeps the fp32 bars at this chunk even if every k8 step's add truncates.
F32_PROMOTE_K = 64
# A ring stage of the fp32 kernels: 4,096 floats of hi, then 4,096 of lo
# (csrc/tf32_tile.cuh kHalfFloats); a stats stage is 32 k-rows of a 128-column
# group, an apply or tail stage as f32_block_geometry says.
F32_STAGE_HALF = 4096
F32_GROUP = 128


def jax_fusable_block(d: int, hid: int, num_heads: int, dtype: torch.dtype) -> bool:
    """The JAX package's rule for the fused block (``attn_pallas.fusable_block``):
    aligned dims, clean head split, working set inside its VMEM budget. Where
    it holds, the TPU runs the Pallas stats/apply kernels."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    vmem = (3 * d * d + 2 * d * hid) * itemsize + _TILE_R * hid * 4 \
        + 10 * _TILE_R * d * 4
    return (d % 128 == 0 and hid % 128 == 0 and d % num_heads == 0
            and vmem < _VMEM_BUDGET)


def kernels_take(d: int, hid: int, num_heads: int, dtype: torch.dtype) -> bool:
    """Whether the CUDA kernels are written for this shape."""
    return (num_heads > 0 and d % num_heads == 0
            and d // num_heads in KERNEL_CELLS.get(dtype, {}).get(d, ())
            and hid % KERNEL_HID_CHUNK == 0)


def head_cell(d: int, num_heads: int, dtype: torch.dtype) -> bool:
    """Whether a head-specific kernel (``HEAD_CELLS``) takes this cell; the
    head-generic pair takes the rest of ``KERNEL_CELLS``."""
    return num_heads > 0 and d % num_heads == 0 and \
        d // num_heads in HEAD_CELLS.get(dtype, {}).get(d, ())


def heads_band(d: int, hd: int, c0: int, dtype: torch.dtype) -> tuple:
    """``(k0, k1)``: the rows of ``blockdiag(KV)`` that the head-generic
    apply's product for output columns ``[c0, c0 + HEADS_SLICE[dtype])``
    reads (``csrc/attn_heads.cuh:band``): every head those columns touch,
    clipped to ``d``, rounded out to the dtype's step; entries off the
    diagonal blocks are staged as zeros."""
    step = HEADS_BAND_STEP[dtype]
    k0 = c0 // hd * hd // step * step
    k1 = min(d, -(-(c0 + HEADS_SLICE[dtype]) // hd) * hd)
    return k0, -(-k1 // step) * step


def heads_band_chunk(d: int, dtype: torch.dtype) -> int:
    """Rows of a band chunk in shared memory: bf16 ``d`` at d <= 256 (any
    band), ``d / 2`` at d 384 (where each warpgroup stages its own columns'
    band); fp32 ``F32_PROMOTE_K`` (``HeadsApply::KC``,
    ``HeadsApplyF32::KC``)."""
    if dtype == torch.float32:
        return F32_PROMOTE_K
    return d if d <= 256 else d // 2


def _require_cell(name, d, num_heads, dtype):
    if not kernels_take(d, KERNEL_HID_CHUNK, num_heads, dtype):
        raise ValueError(f"{name} kernel takes d_model in {HEADS_WIDTHS.get(dtype, ())} for "
                         f"{dtype}, any head count dividing it; got d={d}, heads={num_heads} "
                         f"(head dim {d / num_heads if num_heads else None})")


def _elu1(x):
    """``elu(x) + 1`` as ``where(x > 0, x + 1, exp(x))`` in fp32, returned in
    ``x``'s dtype (``attn_pallas._elu1``)."""
    xf = x.float()
    return torch.where(xf > 0, xf + 1.0, torch.exp(xf)).to(x.dtype)


def block_plain(xq, xkv, qm, km, Wq, Wk, Wv, Wm, g1, b1, W1, W2, g2, b2, *,
                num_heads, cd, nd, attn_eps, ln_eps):
    """The unfused block, the literal AttentionBlock composition: separate
    projections, head split, ``linear_attention``, then the plain tail
    (``attn_pallas._block_xla``). The backward of the fused block."""
    from scream_tpu_torch.models.attention import linear_attention

    B, L = xq.shape[0], xq.shape[1]
    S = xkv.shape[1]
    hd = Wq.shape[1] // num_heads
    mm = lambda x, W: x.to(cd) @ W.to(cd)
    q = mm(xq, Wq).reshape(B, L, num_heads, hd)
    k = mm(xkv, Wk).reshape(B, S, num_heads, hd)
    v = mm(xkv, Wv).reshape(B, S, num_heads, hd)
    message = linear_attention(q, k, v, qm, km, eps=attn_eps)
    return tail_plain(message.reshape(B, L, Wq.shape[1]), xq, Wm, g1, b1,
                      W1, W2, g2, b2, cd=cd, nd=nd, eps=ln_eps)


def attn_stats_plain(x, mask, Wk, Wv, *, num_heads):
    """Plain version of the stats kernel. ``x`` ``(B, S, d)`` in the compute
    dtype, ``mask`` ``(B, S)`` fp32, ``Wk``/``Wv`` ``(d, d)`` in the compute
    dtype -> ``KV`` ``(B, H, hd, hd)`` fp32 and ``K_sum`` ``(B, d)`` fp32."""
    B, S, d = x.shape
    hd = d // num_heads
    mc = mask.to(x.dtype)[..., None]
    k = x @ Wk
    v = x @ Wv
    kp = (_elu1(k) * mc).reshape(B, S, num_heads, hd).float()
    vm = (v * mc).reshape(B, S, num_heads, hd).float()
    KV = torch.einsum("bshd,bshv->bhdv", kp, vm)
    return KV, kp.sum(1).reshape(B, d)


def attn_apply_plain(x, mask, KV, ksum, Wq, Wm, g1, b1, W1, W2, g2, b2, *,
                     attn_eps, ln_eps, norm_dtype):
    """Plain version of the apply kernel: ``x`` ``(B, L, d)`` in the compute
    dtype (query source and both residuals), ``mask`` ``(B, L)`` fp32, the
    stats of :func:`attn_stats_plain`, weights in the compute dtype, LayerNorm
    params fp32 -> ``(B, L, d)`` in the compute dtype."""
    B, L, d = x.shape
    H, hd = KV.shape[1], KV.shape[2]
    cd = x.dtype
    qp = _elu1(x @ Wq) * mask.to(cd)[..., None]
    qh = qp.float().reshape(B, L, H, hd)
    att = torch.einsum("blhd,bhdv->blhv", qh, KV)
    z = (qh * ksum.reshape(B, 1, H, hd)).sum(-1)
    msg = (att * (1.0 / (z + attn_eps))[..., None]).reshape(B, L, d).to(cd)
    return tail_plain(msg, x, Wm, g1, b1, W1, W2, g2, b2, cd=cd,
                      nd=norm_dtype, eps=ln_eps)


def _check(t, name, dtype, shape):
    # 32-byte alignment: the kernels load rows and stats in 16-byte vectors.
    _build.check_tensor(t, name, dtype, shape, align=32)


def stats_tiles(S: int) -> int:
    """Row tiles of one batch in the stats projection: ``ceil(S / 128)``.
    The shape alone sets the items, never the card; the rows of head ``h``
    then add in row order, in 16-row steps of the ``K'^T V`` product."""
    return -(-S // STATS_TILE)


def stats_stage(d: int, num_heads: int) -> tuple:
    """(columns, k-rows) of a stats ring stage (``csrc/attn.cu``
    ``stats_cols``, ``stats_krows``): whole ``[k_h | v_h]`` groups, at least
    64 columns; all ``d`` k-rows where the stage stays within 32 KB, else
    128, a column group's product then chaining over ``d / 128`` stages."""
    hd = d // num_heads
    cols = max(64, 2 * hd)
    return cols, (d if cols * d * 2 <= 32768 else 128)


def stats_layout_heads(d: int, num_heads: int, dtype: torch.dtype) -> int:
    """The head count whose ``[k_h | v_h]`` grouping the stats kernel of this
    cell reads its packed ``[Wk|Wv]`` in: the cell's own at a head-specific
    cell, ``d / 64`` (64-column groups) at the head-generic stats'."""
    return num_heads if head_cell(d, num_heads, dtype) else d // 64


def pack_stats_weights(Wk, Wv, *, num_heads) -> torch.Tensor:
    """``Wk``, ``Wv`` ``(d, d)`` (``(in, out)``) as the stats kernel's ring
    blob, flat bf16 of ``2 d^2``: ``[Wk|Wv]`` with its columns regrouped per
    head as ``[k_h | v_h]``, then cut into stages (:func:`stats_stage`):
    column group ``g``'s k-row parts in order, stage ``g * (d / ks) + p``,
    each in the wgmma operand layout of ``csrc/hopper_tile.cuh``. At a cell
    of the head-generic stats the blob of ``d / 64`` heads
    (:func:`stats_layout_heads`): ``[Wk|Wv]`` in 64-column groups ``[k_g |
    v_g]``, which that kernel projects whatever the head count. On the
    card one launch of ``stats_pack_kernel`` (bf16 weights); for CPU
    weights the permuted copy below, which defines the layout."""
    if Wk.dim() != 2 or tuple(Wk.shape) != tuple(Wv.shape) or Wk.shape[0] != Wk.shape[1]:
        raise ValueError(f"pack_stats_weights: Wk {tuple(Wk.shape)} and Wv "
                         f"{tuple(Wv.shape)} must be one square shape")
    d = Wk.shape[0]
    _require_cell("pack_stats_weights: the stats", d, num_heads, torch.bfloat16)
    num_heads = stats_layout_heads(d, num_heads, torch.bfloat16)
    if _build.route(Wk):
        for name, w in (("Wk", Wk), ("Wv", Wv)):
            _check(w, name, torch.bfloat16, (d, d))
        blob = torch.empty(2 * d * d, dtype=torch.bfloat16, device=Wk.device)
        err = _build.kernels().scream_pack_stats(Wk.data_ptr(), Wv.data_ptr(),
                                                 blob.data_ptr(), d, num_heads,
                                                 _build.stream_ptr(Wk))
        _build.check(err, "pack_stats_weights")
        return blob
    hd = d // num_heads
    cols, ks = stats_stage(d, num_heads)
    with torch.no_grad():
        W = torch.cat([Wk.reshape(d, num_heads, hd), Wv.reshape(d, num_heads, hd)],
                      -1).reshape(d, 2 * d).to(torch.bfloat16)
        # (column group, k part, k16 step, column group of 8, k half, column
        # in group, k in half)
        W = W.reshape(d // ks, ks // 16, 2, 8, 2 * d // cols, cols // 8, 8)
        return W.permute(4, 0, 1, 5, 2, 6, 3).contiguous().reshape(-1)


def attn_stats(x, mask, Wk, Wv, *, num_heads):
    """Linear-attention statistics of the key/value source (kernel 1)."""
    if not _build.route(x):
        return attn_stats_plain(x, mask, Wk, Wv, num_heads=num_heads)
    B, S, d = x.shape
    _require_cell("attn_stats", d, num_heads, x.dtype)
    if not head_cell(d, num_heads, x.dtype):
        return attn_stats_heads(x, mask, Wk, Wv, num_heads=num_heads)
    if x.dtype == torch.float32:
        return _attn_stats_f32(x, mask, Wk, Wv, num_heads=num_heads)
    _check(x, "x", torch.bfloat16, (B, S, d))
    _check(mask, "mask", torch.float32, (B, S))
    hd = d // num_heads
    nkv, per = num_heads * hd * hd, num_heads * hd * hd + d
    sp = stats_tiles(S) * STATS_TILE
    wpack = pack_stats_weights(Wk, Wv, num_heads=num_heads)
    # One allocation: KV, K_sum, then the bf16 K'/V workspace (B, H, sp, 2 hd).
    buf = torch.empty(B * per + B * sp * d, device=x.device, dtype=torch.float32)
    KV = buf[:B * nkv].view(B, num_heads, hd, hd)
    ksum = buf[B * nkv:B * per].view(B, d)
    err = _build.kernels().scream_attn_stats(
        x.data_ptr(), mask.data_ptr(), wpack.data_ptr(), buf[B * per:].data_ptr(),
        KV.data_ptr(), ksum.data_ptr(), B, S, d, num_heads, _build.stream_ptr(x))
    _build.check(err, "attn_stats")
    attn_stats.launches += 1
    return KV, ksum


attn_stats.launches = 0


def attn_stats_heads(x, mask, Wk, Wv, *, num_heads):
    """The head-generic stats kernel (``csrc/attn_heads.cu``) at any head
    count of ``HEADS_WIDTHS``; :func:`attn_stats` sends it the cells no
    head-specific kernel takes. Three or four launches in one C call: bf16
    ``[Wk|Wv]`` packed at ``d / 64`` heads (:func:`pack_stats_weights`, its
    own call), ``csrc/attn.cu``'s projection into a bf16 ``K' | V``
    workspace; fp32 the pack and ``heads_proj_f32_kernel`` into an fp32 one;
    then ``heads_sum_mma_kernel``, the partial ``K'^T V`` and ``K_sum`` on
    the tensor cores per (pair of column blocks sharing a head, chunk of
    ``HEADS_CHUNK`` rows, batch), and the reduce of the chunks in order.
    ``(KV (B, H, hd, hd), K_sum (B, d))`` fp32."""
    if not _build.route(x):
        return attn_stats_plain(x, mask, Wk, Wv, num_heads=num_heads)
    B, S, d = x.shape
    _require_cell("attn_stats_heads", d, num_heads, x.dtype)
    hd = d // num_heads
    nkv, per, nch = d * hd, d * hd + d, -(-S // HEADS_CHUNK)
    _check(mask, "mask", torch.float32, (B, S))
    lib, stream = _build.kernels(), _build.stream_ptr(x)
    if x.dtype == torch.float32:
        for name, t, shape in (("x", x, (B, S, d)), ("Wk", Wk, (d, d)), ("Wv", Wv, (d, d))):
            _check(t, name, torch.float32, shape)
        sp = -(-S // STATS_F32_TILE) * STATS_F32_TILE
        # One allocation: KV, K_sum, the chunk partials, the packed weights,
        # the K' | V workspace (B, d / 64, sp, 128).
        buf = x.new_empty(B * per * (1 + nch) + 4 * d * d + B * sp * 2 * d)
        p, wpack = buf.data_ptr(), B * per * (1 + nch)
        err = lib.scream_attn_stats_heads_f32(
            x.data_ptr(), mask.data_ptr(), Wk.data_ptr(), Wv.data_ptr(), p + 4 * wpack,
            p + 4 * (wpack + 4 * d * d), p + 4 * B * per, p, p + 4 * B * nkv, B, S, d,
            num_heads, stream)
    else:
        _check(x, "x", torch.bfloat16, (B, S, d))
        wpack = pack_stats_weights(Wk, Wv, num_heads=d // 64)
        sp = stats_tiles(S) * STATS_TILE
        # KV, K_sum, the chunk partials, the bf16 workspace (B sp 2 d bf16).
        buf = torch.empty(B * per * (1 + nch) + B * sp * d, device=x.device,
                          dtype=torch.float32)
        p = buf.data_ptr()
        err = lib.scream_attn_stats_heads(
            x.data_ptr(), mask.data_ptr(), wpack.data_ptr(), p + 4 * B * per * (1 + nch),
            p + 4 * B * per, p, p + 4 * B * nkv, B, S, d, num_heads, stream)
    _build.check(err, "attn_stats_heads")
    attn_stats_heads.launches += 1
    return buf[:B * nkv].view(B, num_heads, hd, hd), buf[B * nkv:B * per].view(B, d)


attn_stats_heads.launches = 0


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, as fp32 (``cvt.rna.tf32.f32`` with the 13 low bits
    cleared): half an ulp of TF32 added to the magnitude's bits, then
    truncated."""
    bits = x.contiguous().float().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """``(hi, lo)``: ``hi = tf32_rna(x)``, ``lo = tf32_rna(x - hi)`` (the
    subtraction is exact), the kernels' split of every fp32 operand."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def f32_stage_layout(W: torch.Tensor, ks: int) -> torch.Tensor:
    """``W`` ``(K, N)`` fp32 as ``K / ks`` ring stages of ``ks`` k-rows, each
    its hi block then its lo block, flat: within a block the wgmma operand
    layout of ``csrc/tf32_tile.cuh`` (k8 step, column group of 8, k half,
    column in group, k in half; each core-matrix row 4 k values)."""
    K, N = W.shape
    parts = []
    for half in split_tf32(W):
        # (stage, k8 step, k half, k in half, column group, column in group)
        v = half.reshape(K // ks, ks // 8, 2, 4, N // 8, 8).permute(0, 1, 4, 2, 5, 3)
        parts.append(v.reshape(K // ks, 1, ks * N))
    return torch.cat(parts, 1).reshape(-1)


def pack_stats_weights_f32(Wk, Wv, *, num_heads) -> torch.Tensor:
    """``Wk``, ``Wv`` ``(d, d)`` fp32 (``(in, out)``) as the fp32 stats
    kernel's ring blob, flat fp32 of ``4 d^2``: ``[Wk|Wv]`` with its columns
    regrouped per head as ``[k_h | v_h]``, cut into 128-column groups of 32
    k-row stages (stage ``g (d / 32) + p``), each split hi then lo
    (:func:`f32_stage_layout`); at a cell of the head-generic stats the
    blob of ``d / 64`` heads (:func:`stats_layout_heads`). On the card one
    launch of
    ``pack_stats_f32_kernel`` (which the fp32 stats also launch, in their own
    C call); for CPU weights the permuted copies below, which define the
    layout."""
    d = Wk.shape[0]
    if Wk.dim() != 2 or tuple(Wk.shape) != (d, d) or tuple(Wv.shape) != (d, d):
        raise ValueError(f"pack_stats_weights_f32: Wk {tuple(Wk.shape)} and Wv "
                         f"{tuple(Wv.shape)} must be one square shape")
    _require_cell("pack_stats_weights_f32: the fp32 stats", d, num_heads, torch.float32)
    num_heads = stats_layout_heads(d, num_heads, torch.float32)
    f32 = torch.float32
    if _build.route(Wk):
        _check(Wk, "Wk", f32, (d, d))
        _check(Wv, "Wv", f32, (d, d))
        blob = torch.empty(4 * d * d, dtype=f32, device=Wk.device)
        err = _build.kernels().scream_pack_stats_f32(Wk.data_ptr(), Wv.data_ptr(),
                                                     blob.data_ptr(), d, num_heads,
                                                     _build.stream_ptr(Wk))
        _build.check(err, "pack_stats_weights_f32")
        return blob
    hd = d // num_heads
    with torch.no_grad():
        W = torch.cat([Wk.reshape(d, num_heads, hd), Wv.reshape(d, num_heads, hd)],
                      -1).reshape(d, 2 * d).to(f32)
        return torch.cat([f32_stage_layout(W[:, g:g + F32_GROUP], 32)
                          for g in range(0, 2 * d, F32_GROUP)])


def f32_block_geometry(d: int) -> tuple:
    """``csrc/tf32_tail.cuh:Block<d>``, the ring stages of the fp32 apply
    and tail kernels: (``nd``, ``passes``, ``ksd``, ``hc``, ``ksh``). Each
    of the two consumer warpgroups owns ``d / 2`` output columns and makes
    them in ``passes`` passes of ``nd``; a d-wide weight (``Wq``, ``Wm``, a
    hidden chunk's ``W2`` rows) streams in stages of ``ksd`` k-rows x ``2
    nd`` columns (pass ``p``: columns ``p nd ..`` of warpgroup 0, then the
    same of warpgroup 1); the hidden goes in chunks of ``hc`` columns, their
    ``W1`` columns in stages of ``ksh`` k-rows. At d 128 / 256 one pass of
    ``d / 2`` and 128-column chunks; at d 384, where a 192-column pass would
    not fit a thread's registers, three passes of 64 and 64-column chunks."""
    pass64 = d > 256
    nd = 64 if pass64 else d // 2
    hc = 64 if pass64 else F32_GROUP
    return nd, d // 2 // nd, F32_STAGE_HALF // (2 * nd), hc, F32_STAGE_HALF // hc


def pack_block_f32_plain(Wq, Wm, W1, W2) -> torch.Tensor:
    """Plain version of ``pack_block_f32_kernel`` (``csrc/attn_f32.cu``), on
    any device: ``[Wq]`` (optional) and ``Wm``, then per hidden chunk its
    ``W1`` columns and its ``W2`` rows, in :func:`f32_block_geometry`'s
    stages, each split hi then lo (:func:`f32_stage_layout`), in the order
    the kernels consume them; flat fp32 of ``2 ((2 or 1) d^2 + 2 d hid)``."""
    d, hid = W1.shape
    nd, passes, ksd, hc, ksh = f32_block_geometry(d)
    f32, h = torch.float32, d // 2

    def wide(W):
        W = W.to(f32)
        return [f32_stage_layout(torch.cat([W[:, p * nd:(p + 1) * nd],
                                            W[:, h + p * nd:h + (p + 1) * nd]], 1), ksd)
                for p in range(passes)]

    with torch.no_grad():
        parts = (wide(Wq) if Wq is not None else []) + wide(Wm)
        for c in range(0, hid, hc):
            parts.append(f32_stage_layout(W1[:, c:c + hc].to(f32), ksh))
            parts += wide(W2[c:c + hc])
        return torch.cat(parts)


def pack_block_weights_f32(Wm, W1, W2, Wq=None) -> torch.Tensor:
    """The ring blob of the fp32 tail kernel (``csrc/tail_f32.cu``, d 128,
    256, 384) or, with ``Wq``, of the fp32 apply kernel (d 128, 256), flat
    fp32 of ``2 ((1 or 2) d^2 + 2 d hid)`` (:func:`pack_block_f32_plain`):
    the fp32 counterpart of ``tail_cuda.pack_weights``. On the card one
    launch of ``pack_block_f32_kernel``, which each of the two kernels also
    launches in its own C call; for CPU weights the plain version."""
    d, hid = W1.shape
    widths = KERNEL_CELLS[torch.float32] if Wq is not None else KERNEL_WIDTHS_F32
    if d not in widths or hid <= 0 or hid % KERNEL_HID_CHUNK \
            or (Wq is not None and tuple(Wq.shape) != (d, d)) or tuple(Wm.shape) != (d, d) \
            or tuple(W2.shape) != (hid, d):
        raise ValueError(f"pack_block_weights_f32: d in {tuple(widths)} and a hidden multiple "
                         f"of {KERNEL_HID_CHUNK}; got Wq {None if Wq is None else tuple(Wq.shape)}, "
                         f"Wm {tuple(Wm.shape)}, W1 {tuple(W1.shape)}, W2 {tuple(W2.shape)}")
    if not _build.route(W1):
        return pack_block_f32_plain(Wq, Wm, W1, W2)
    f32 = torch.float32
    ws = (("Wq", Wq, (d, d)),) if Wq is not None else ()
    for name, w, shape in ws + (("Wm", Wm, (d, d)), ("W1", W1, (d, hid)), ("W2", W2, (hid, d))):
        _check(w, name, f32, shape)
    blob = torch.empty(2 * ((2 if Wq is not None else 1) * d * d + 2 * d * hid), dtype=f32,
                       device=W1.device)
    err = _build.kernels().scream_pack_block_f32(
        Wq.data_ptr() if Wq is not None else None, Wm.data_ptr(), W1.data_ptr(), W2.data_ptr(),
        blob.data_ptr(), d, hid, _build.stream_ptr(W1))
    _build.check(err, "pack_block_weights_f32")
    return blob


def _attn_stats_f32(x, mask, Wk, Wv, *, num_heads):
    """The fp32 stats kernel (``csrc/attn_f32.cu``), one C call: ``[Wk|Wv]``
    split and packed (``pack_stats_f32_kernel``, as
    :func:`pack_stats_weights_f32` lays it out), partials per 64-row tile
    into a workspace, added in tile order by the third launch. One C call,
    not the bf16 wrappers' pack call and then kernel call: at the serving
    shapes the host's time bounds the call, and :func:`pack_stats_weights_f32`
    alone costs about half of it (``scripts/torch_port_f32_probe.py``)."""
    B, S, d = x.shape
    f32 = torch.float32
    for name, t, shape in (("x", x, (B, S, d)), ("mask", mask, (B, S)), ("Wk", Wk, (d, d)),
                           ("Wv", Wv, (d, d))):
        _check(t, name, f32, shape)
    hd = d // num_heads
    nkv, per, nblob = num_heads * hd * hd, num_heads * hd * hd + d, 4 * d * d
    nt = -(-S // STATS_F32_TILE)
    # One allocation: the packed weights, KV, K_sum, then the partials (B, nt,
    # per); the parts addressed by offset, since at the serving shapes the
    # host's time bounds the call and a slice costs more than an offset.
    buf = x.new_empty(nblob + B * per * (1 + nt))
    KV = buf.as_strided((B, num_heads, hd, hd), (nkv, hd * hd, hd, 1), nblob)
    ksum = buf.as_strided((B, d), (d, 1), nblob + B * nkv)
    p = buf.data_ptr()
    err = _build.kernels().scream_attn_stats_f32(
        x.data_ptr(), mask.data_ptr(), Wk.data_ptr(), Wv.data_ptr(), p,
        p + 4 * (nblob + B * per), p + 4 * nblob, p + 4 * (nblob + B * nkv), B, S, d, num_heads,
        _build.stream_ptr(x))
    _build.check(err, "attn_stats")
    attn_stats.launches += 1
    return KV, ksum


def attn_apply(x, mask, KV, ksum, Wq, Wm, g1, b1, W1, W2, g2, b2, *,
               attn_eps, ln_eps, norm_dtype):
    """Query projection, attention, merge, LayerNorms and FFN (kernel 2)."""
    if not _build.route(x):
        return attn_apply_plain(x, mask, KV, ksum, Wq, Wm, g1, b1, W1, W2, g2,
                                b2, attn_eps=attn_eps, ln_eps=ln_eps,
                                norm_dtype=norm_dtype)
    B, L, d = x.shape
    hid = W1.shape[1]
    H = KV.shape[1]
    _require_cell("attn_apply", d, H, x.dtype)
    if hid % KERNEL_HID_CHUNK:
        raise ValueError(f"attn_apply kernel takes a hidden multiple of "
                         f"{KERNEL_HID_CHUNK}; got {hid}")
    if norm_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attn_apply kernel: norm dtype {norm_dtype} unsupported")
    if not head_cell(d, H, x.dtype):
        return attn_apply_heads(x, mask, KV, ksum, Wq, Wm, g1, b1, W1, W2, g2, b2,
                                attn_eps=attn_eps, ln_eps=ln_eps, norm_dtype=norm_dtype)
    if x.dtype == torch.float32:
        return _attn_apply_f32(x, mask, KV, ksum, Wq, Wm, g1, b1, W1, W2, g2, b2,
                               attn_eps=attn_eps, ln_eps=ln_eps, norm_dtype=norm_dtype)
    bf, f32 = torch.bfloat16, torch.float32
    _check(x, "x", bf, (B, L, d))
    _check(mask, "mask", f32, (B, L))
    _check(KV, "KV", f32, (B, H, d // H, d // H))
    _check(ksum, "ksum", f32, (B, d))
    _check(Wq, "Wq", bf, (d, d))
    _check(Wm, "Wm", bf, (d, d))
    _check(W1, "W1", bf, (d, hid))
    _check(W2, "W2", bf, (hid, d))
    for name, p in (("g1", g1), ("b1", b1), ("g2", g2), ("b2", b2)):
        _check(p, name, f32, (d,))
    out = torch.empty((B, L, d), device=x.device, dtype=bf)
    if B * L == 0:
        return out
    # Wq, Wm, W1, W2 packed once per call for the kernel's weight ring
    # (ops/tail_cuda.py:pack_weights).
    wpack = pack_weights(Wm, W1, W2, Wq=Wq)
    _check(wpack, "packed weights", bf, (2 * d * d + 2 * d * hid,))
    err = _build.kernels().scream_attn_apply(
        x.data_ptr(), mask.data_ptr(), wpack.data_ptr(), KV.data_ptr(),
        ksum.data_ptr(), g1.data_ptr(), b1.data_ptr(), g2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), B, L, d, H, hid, float(attn_eps), float(ln_eps),
        _build.stream_ptr(x))
    _build.check(err, "attn_apply")
    attn_apply.launches += 1
    return out


attn_apply.launches = 0


def attn_apply_heads(x, mask, KV, ksum, Wq, Wm, g1, b1, W1, W2, g2, b2, *,
                     attn_eps, ln_eps, norm_dtype):
    """The head-generic apply kernel (``csrc/attn_heads_apply.cu``, fp32
    ``csrc/attn_heads_apply_f32.cu``) at any head count of
    ``HEADS_WIDTHS``; :func:`attn_apply` sends it the cells no
    head-specific kernel takes. The attend runs on the tensor cores as
    ``Q' . blockdiag(KV)`` over each slice's band (:func:`heads_band`).
    bf16: ``Wq, Wm, W1, W2`` packed by ``tail_cuda.pack_weights`` (its own
    call), then one launch; fp32: one C call, the pack
    (``pack_block_f32_kernel``) and the block."""
    if not _build.route(x):
        return attn_apply_plain(x, mask, KV, ksum, Wq, Wm, g1, b1, W1, W2, g2, b2,
                                attn_eps=attn_eps, ln_eps=ln_eps, norm_dtype=norm_dtype)
    B, L, d = x.shape
    hid, H = W1.shape[1], KV.shape[1]
    _require_cell("attn_apply_heads", d, H, x.dtype)
    if hid % KERNEL_HID_CHUNK:
        raise ValueError(f"attn_apply_heads kernel takes a hidden multiple of "
                         f"{KERNEL_HID_CHUNK}; got {hid}")
    if norm_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attn_apply_heads kernel: norm dtype {norm_dtype} unsupported")
    cd, f32, hd = x.dtype, torch.float32, d // H
    for name, t, shape, dt in (("x", x, (B, L, d), cd), ("mask", mask, (B, L), f32),
                               ("KV", KV, (B, H, hd, hd), f32), ("ksum", ksum, (B, d), f32),
                               ("Wq", Wq, (d, d), cd), ("Wm", Wm, (d, d), cd),
                               ("W1", W1, (d, hid), cd), ("W2", W2, (hid, d), cd),
                               ("g1", g1, (d,), f32), ("b1", b1, (d,), f32),
                               ("g2", g2, (d,), f32), ("b2", b2, (d,), f32)):
        _check(t, name, dt, shape)
    out = x.new_empty((B, L, d))
    if B * L == 0:
        return out
    lib, stream = _build.kernels(), _build.stream_ptr(x)
    if cd == f32:
        wpack = x.new_empty(2 * (2 * d * d + 2 * d * hid))
        err = lib.scream_attn_apply_heads_f32(
            x.data_ptr(), mask.data_ptr(), Wq.data_ptr(), Wm.data_ptr(), W1.data_ptr(),
            W2.data_ptr(), wpack.data_ptr(), KV.data_ptr(), ksum.data_ptr(), g1.data_ptr(),
            b1.data_ptr(), g2.data_ptr(), b2.data_ptr(), out.data_ptr(), B, L, d, H, hid,
            float(attn_eps), float(ln_eps), int(norm_dtype == torch.bfloat16), stream)
    else:
        wpack = pack_weights(Wm, W1, W2, Wq=Wq)
        _check(wpack, "packed weights", torch.bfloat16, (2 * d * d + 2 * d * hid,))
        err = lib.scream_attn_apply_heads(
            x.data_ptr(), mask.data_ptr(), wpack.data_ptr(), KV.data_ptr(), ksum.data_ptr(),
            g1.data_ptr(), b1.data_ptr(), g2.data_ptr(), b2.data_ptr(), out.data_ptr(), B, L,
            d, H, hid, float(attn_eps), float(ln_eps), stream)
    _build.check(err, "attn_apply_heads")
    attn_apply_heads.launches += 1
    return out


attn_apply_heads.launches = 0


def _attn_apply_f32(x, mask, KV, ksum, Wq, Wm, g1, b1, W1, W2, g2, b2, *,
                    attn_eps, ln_eps, norm_dtype):
    """The fp32 apply kernel (``csrc/attn_f32.cu``), one C call: every tensor
    fp32, the weights split and packed (``pack_block_f32_kernel``, as
    :func:`pack_block_weights_f32` lays them out), then the block."""
    B, L, d = x.shape
    hid, H = W1.shape[1], KV.shape[1]
    f32 = torch.float32
    for name, t, shape in (("x", x, (B, L, d)), ("mask", mask, (B, L)),
                           ("KV", KV, (B, H, d // H, d // H)), ("ksum", ksum, (B, d)),
                           ("Wq", Wq, (d, d)), ("Wm", Wm, (d, d)), ("W1", W1, (d, hid)),
                           ("W2", W2, (hid, d)), ("g1", g1, (d,)), ("b1", b1, (d,)),
                           ("g2", g2, (d,)), ("b2", b2, (d,))):
        _check(t, name, f32, shape)
    out = x.new_empty((B, L, d))
    if B * L == 0:
        return out
    wpack = x.new_empty(2 * (2 * d * d + 2 * d * hid))
    err = _build.kernels().scream_attn_apply_f32(
        x.data_ptr(), mask.data_ptr(), Wq.data_ptr(), Wm.data_ptr(), W1.data_ptr(),
        W2.data_ptr(), wpack.data_ptr(), KV.data_ptr(), ksum.data_ptr(), g1.data_ptr(),
        b1.data_ptr(), g2.data_ptr(), b2.data_ptr(), out.data_ptr(), B, L, d, H, hid,
        float(attn_eps), float(ln_eps), int(norm_dtype == torch.bfloat16),
        _build.stream_ptr(x))
    _build.check(err, "attn_apply")
    attn_apply.launches += 1
    return out


def _fused_forward(xq, xkv, qm, km, Wq, Wk, Wv, Wm, g1, b1, W1, W2, g2, b2,
                   kw):
    cd = kw["cd"]
    c = lambda t: t.to(cd).contiguous()
    p = lambda t: t.float().contiguous()
    KV, ksum = attn_stats(c(xkv), p(km), c(Wk), c(Wv),
                          num_heads=kw["num_heads"])
    return attn_apply(c(xq), p(qm), KV, ksum, c(Wq), c(Wm), p(g1), p(b1),
                      c(W1), c(W2), p(g2), p(b2), attn_eps=kw["attn_eps"],
                      ln_eps=kw["ln_eps"], norm_dtype=kw["nd"])


class _FusedBlock(torch.autograd.Function):
    """Kernels forward; the backward recomputes :func:`block_plain` from the
    saved inputs and differentiates it (rematerialization, as the JAX
    package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, xq, xkv, qm, km, Wq, Wk, Wv, Wm, g1, b1, W1, W2, g2, b2,
                kw):
        ctx.kw = kw
        ctx.save_for_backward(xq, xkv, qm, km, Wq, Wk, Wv, Wm, g1, b1, W1, W2,
                              g2, b2)
        return _fused_forward(xq, xkv, qm, km, Wq, Wk, Wv, Wm, g1, b1, W1, W2,
                              g2, b2, kw)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need) if t.is_floating_point() else t
                  for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = block_plain(*inputs, **ctx.kw)
            got = iter(torch.autograd.grad(out, wanted, grad.to(out.dtype)))
        return tuple(next(got) if t.requires_grad else None for t in inputs) \
            + (None,)


def attention_block_fused(xq, xkv, q_mask, kv_mask, Wq, Wk, Wv, Wm, g1, b1,
                          W1, W2, g2, b2, *, num_heads, dtype, norm_dtype,
                          attn_eps: float = 1e-6, ln_eps: float = 1e-5):
    """``LN2(x + FFN(LN1(attn(x_q, x_kv) @ Wm + x)))`` through the two kernels
    (their plain versions for CPU tensors). ``xq`` is the query source and
    both residuals; ``xkv`` the key/value source; masks are ``(B, L)`` /
    ``(B, S)`` bool. Returns ``(B, L, d)`` in ``dtype``."""
    if q_mask is None:
        q_mask = torch.ones(xq.shape[:2], dtype=torch.bool, device=xq.device)
    if kv_mask is None:
        kv_mask = torch.ones(xkv.shape[:2], dtype=torch.bool, device=xkv.device)
    kw = dict(num_heads=num_heads, cd=dtype, nd=norm_dtype,
              attn_eps=float(attn_eps), ln_eps=float(ln_eps))
    return _FusedBlock.apply(xq, xkv, q_mask, kv_mask, Wq, Wk, Wv, Wm, g1, b1,
                             W1, W2, g2, b2, kw)
