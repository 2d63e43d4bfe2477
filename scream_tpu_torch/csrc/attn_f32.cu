// Fused linear-attention block in float32 for Hopper (sm_90a): the
// float32 instantiation of the two kernels of attn.cu.
//
// Replaces the TPU kernels scream_tpu/ops/attn_pallas.py:_stats_kernel and
// scream_tpu/ops/attn_pallas.py:_apply_kernel as attention_block runs them
// for the float32 configuration (prec = HIGHEST, the KV carried whole in
// fp32, never split hi/lo). Same function as attn.cu, with no rounding to
// bf16 anywhere:
//
//   stats:  [k|v] = x_kv @ [Wk|Wv], K' = (elu(k)+1)*mask, V = v*mask, then
//           per (batch, head): KV = K'^T V (hd x hd) and K_sum = sum_rows K'.
//   apply:  q = x @ Wq, Q' = (elu(q)+1)*mask, att = Q' KV per head,
//           z = Q'.K_sum per head, msg = att / (z + eps) (as att * (1/(z+eps))),
//           then LN2(x + relu(LN1(msg @ Wm + x) @ W1) @ W2) (f32_tile.cuh).
//
// What bounds them on the H100: fp32 FMA on the CUDA cores (67 TFLOP/s;
// see f32_tile.cuh for why no tensor-core route keeps the fp32 bars). At
// the main path's shape (16 x 4096 rows, d 256, hidden 1024) apply does
// ~94 GFLOP against ~134 MB of activations in and out (~700 FLOP a byte)
// and stats ~18 GFLOP against 67 MB, both far above the card's fp32
// ridge of 20 FLOP a byte: operations bound them. What the design does
// about it: every product is register-tiled fp32 FMA (f32_tile.cuh:gemm,
// 8 x 4 G outputs a thread, weights streamed through a two-chunk
// cp.async ring), the activations stay in shared memory or registers
// between the products, and the small per-head work (K'^T V, the
// contraction with KV, the normalizer) runs from shared memory beside them.
//
//   * stats, in two launches. attn_stats_f32_kernel: one block per (tile
//     of 64 rows, batch); the tile of x is loaded once, then [Wk|Wv] is
//     projected 128 columns at a time, a column group holding [k_h | v_h]
//     of 128 / (2 hd) heads (1, 2 or 4), read straight from Wk and Wv (no
//     pack). The group's K' and V go to a shared tile, and the tile's
//     partial K'^T V and K_sum of those heads are summed over its 64 rows
//     in row order and written to a workspace, one slot per (batch, tile).
//     attn_stats_f32_reduce_kernel adds the slots of a batch in tile
//     order. No float atomics: two launches on one input agree bit for
//     bit, and a batch whose mask is all zero gives exact zeros.
//   * apply: one block per (tile of 64 query rows, batch): q = x @ Wq into
//     registers, Q' into the weight buffer (idle between products), then
//     per row and head the contraction with the batch's KV and K_sum (both
//     staged in shared memory), the head's hd products added in a fixed
//     order, and the message into the row tile for the tail body. No
//     register tile is live across that loop (one was, and spilled).
//
// Widths: d_model 128 and 256 with head dim 16, 32 or 64 (ATTN_F32_CELLS;
// 8 heads at both widths is the shipped models' split); a template on
// (D, H), the C entry points dispatch on (d, heads). Rows past the
// sequence's end are zero in the tiles and never stored.
//
// Layout contract (checked by the Python wrapper, ops/attn_cuda.py): all
// tensors fp32, contiguous, 16-byte aligned; weights (in, out) row-major;
// masks (B, S) / (B, L) fp32; KV (B, H, hd, hd), K_sum (B, d).

#include "f32_tile.cuh"

namespace {

using namespace scream::f32;

// The (d, heads) cells the kernels are instantiated for: head dim 16, 32, 64.
#define ATTN_F32_CELLS(X) X(128, 8) X(128, 4) X(128, 2) X(256, 16) X(256, 8) X(256, 4)

constexpr int TS = 64;  // rows of a stats tile (and of an apply tile)
constexpr int RM = 8;   // rows a warp

// Shared memory of a stats block: the x tile (TS x D), the group's K'|V
// tile (TS x 128), two weight chunks (KC x 128) and the tile's mask.
template <int D>
constexpr int stats_smem() {
  return (TS * D + TS * 128 + 2 * KC * 128 + TS) * 4;
}

template <int D, int H>
__global__ void __launch_bounds__(kThreads, 1)
attn_stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                      const float* __restrict__ wk, const float* __restrict__ wv,
                      float* __restrict__ ws, int S) {
  constexpr int HD = D / H, HPG = 128 / (2 * HD), PER = H * HD * HD + D;
  constexpr int JT = HPG * HD * HD / kThreads;  // KV outputs a thread, per group: 4, 8, 16
  static_assert(HPG * 2 * HD == 128 && JT % 4 == 0 && HD % JT == 0,
                "stats: whole heads a group, a thread's KV outputs in one row");
  extern __shared__ __align__(16) float smem[];
  float* X = smem;
  float* P = X + TS * D;
  float* wbuf = P + TS * 128;
  float* ms = wbuf + 2 * KC * 128;
  const int b = blockIdx.y, tile = blockIdx.x, row0 = tile * TS;
  const int nvalid = min(TS, S - row0);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  load_rows<RM, D / 128, D>(x + ((size_t)b * S + row0) * D, X, nvalid);
  if (threadIdx.x < TS)
    ms[threadIdx.x] = (int)threadIdx.x < nvalid ? mask[(size_t)b * S + row0 + threadIdx.x] : 0.f;
  float* slot = ws + ((size_t)b * gridDim.x + tile) * PER;
  // This thread's K'^T V outputs of a group: head hl, row i, columns j0 .. j0+JT-1.
  const int o = threadIdx.x * JT;
  const int hl = o / (HD * HD), ki = (o / HD) % HD, j0 = o % HD;
  // Its columns of the projection: the k half of a head or the v half.
  const bool is_k = (4 * lane) % (2 * HD) < HD;
#pragma unroll 1
  for (int grp = 0; grp < 2 * D / 128; ++grp) {
    float acc[RM][4];
    zero(acc);
    // Column c of the group: head grp HPG + c / (2 HD); its k column, then its v column.
    gemm<RM, 1, D, D>(acc, X, wbuf, [=](int k, int c) {
      const int head = grp * HPG + c / (2 * HD), e = c % (2 * HD);
      return (e < HD ? wk + (size_t)k * D + head * HD + e
                     : wv + (size_t)k * D + head * HD + e - HD);
    });
    // gemm's closing barrier follows every thread's reads of P for the
    // last group, so P may be rewritten.
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float m = ms[w * RM + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = (is_k ? elu1(acc[i][j]) : acc[i][j]) * m;
    }
    store_rows<RM, 1, 128>(acc, P);
    __syncthreads();
    // The tile's partial sums over its rows, in row order.
    {
      float kv[JT];
#pragma unroll
      for (int j = 0; j < JT; ++j) kv[j] = 0.f;
      const float* kcol = P + hl * 2 * HD + ki;
      const float* vcol = P + hl * 2 * HD + HD + j0;
#pragma unroll 4
      for (int r = 0; r < TS; ++r) {
        const float kr = kcol[r * 128];
#pragma unroll
        for (int j = 0; j < JT; j += 4) {
          const float4 vr = *reinterpret_cast<const float4*>(vcol + r * 128 + j);
          kv[j + 0] = fmaf(kr, vr.x, kv[j + 0]);
          kv[j + 1] = fmaf(kr, vr.y, kv[j + 1]);
          kv[j + 2] = fmaf(kr, vr.z, kv[j + 2]);
          kv[j + 3] = fmaf(kr, vr.w, kv[j + 3]);
        }
      }
      float* dst = slot + (grp * HPG + hl) * HD * HD + ki * HD + j0;
#pragma unroll
      for (int j = 0; j < JT; j += 4)
        *reinterpret_cast<float4*>(dst + j) = make_float4(kv[j], kv[j + 1], kv[j + 2], kv[j + 3]);
    }
    if (threadIdx.x < HPG * HD) {
      const int sh = threadIdx.x / HD, si = threadIdx.x % HD;
      const float* kcol = P + sh * 2 * HD + si;
      float s = 0.f;
#pragma unroll 4
      for (int r = 0; r < TS; ++r) s += kcol[r * 128];
      slot[H * HD * HD + (grp * HPG + sh) * HD + si] = s;
    }
  }
}

// out[b][e] = sum over the tiles t = 0, 1, ... of ws[b][t][e], in tile order.
__global__ void attn_stats_f32_reduce_kernel(const float* __restrict__ ws, float* __restrict__ kv,
                                             float* __restrict__ ksum, int B, int nt, int per,
                                             int nkv) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * per) return;
  const int b = idx / per, e = idx % per;
  const float* p = ws + (size_t)b * nt * per + e;
  float s = 0.f;
  for (int t = 0; t < nt; ++t) s += p[(size_t)t * per];
  if (e < nkv)
    kv[(size_t)b * nkv + e] = s;
  else
    ksum[(size_t)b * (per - nkv) + e - nkv] = s;
}

// Shared memory of an apply block: the row tile (TS x D), one hidden chunk
// (TS x 128), the weight chunks (tail_wbuf: two of KC x D), the batch's KV
// (H x hd x hd = D hd) and K_sum, the tile's mask. At d 256, head dim 64:
// 229,456 bytes of the 232,448.
template <int D, int H>
__host__ __device__ constexpr int apply_smem() {
  return (TS * D + TS * 128 + tail_wbuf<D>() + D * (D / H) + D + TS) * 4;
}

template <int D, int H>
__global__ void __launch_bounds__(kThreads, 1)
attn_apply_f32_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                      const float* __restrict__ wq, const float* __restrict__ kv,
                      const float* __restrict__ ksum, const float* __restrict__ wm,
                      const float* __restrict__ g1, const float* __restrict__ b1,
                      const float* __restrict__ w1, const float* __restrict__ w2,
                      const float* __restrict__ g2, const float* __restrict__ b2,
                      float* __restrict__ out, int L, int hid, float attn_eps, float ln_eps,
                      int norm_bf16) {
  constexpr int G = D / 128, HD = D / H;
  static_assert(tail_wbuf<D>() >= TS * D && HD % 4 == 0 && apply_smem<D, H>() <= 232448,
                "apply: Q' fits the weight buffer, a lane's 4 columns in one head");
  extern __shared__ __align__(16) float smem[];
  float* A = smem;
  float* Hs = A + TS * D;
  float* wbuf = Hs + TS * 128;
  float* kvs = wbuf + tail_wbuf<D>();
  float* kss = kvs + H * HD * HD;
  float* ms = kss + D;
  const int b = blockIdx.y, row0 = blockIdx.x * TS;
  const int nvalid = min(TS, L - row0);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float* xb = x + ((size_t)b * L + row0) * D;
  load_rows<RM, G, D>(xb, A, nvalid);
  for (int e = threadIdx.x; e < H * HD * HD / 4; e += kThreads)
    reinterpret_cast<float4*>(kvs)[e] =
        __ldg(reinterpret_cast<const float4*>(kv + (size_t)b * H * HD * HD) + e);
  for (int e = threadIdx.x; e < D; e += kThreads) kss[e] = ksum[(size_t)b * D + e];
  if (threadIdx.x < TS)
    ms[threadIdx.x] = (int)threadIdx.x < nvalid ? mask[(size_t)b * L + row0 + threadIdx.x] : 0.f;
  // (gemm's barriers order these stores before any read of kvs, kss, ms.)
  float acc[RM][4 * G];
  zero(acc);
  gemm<RM, G, D, D>(acc, A, wbuf, [=](int k, int c) { return wq + (size_t)k * D + c; });
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float m = ms[w * RM + i];
#pragma unroll
    for (int e = 0; e < 4 * G; ++e) acc[i][e] = elu1(acc[i][e]) * m;
  }
  // Q' into the weight buffer, idle between products (TS rows of D fit),
  // then the message into the row tile, so no register tile lives across
  // the per-head loop.
  float* Qs = wbuf;
  store_rows<RM, G, D>(acc, Qs);
  // Per row and head: att_j = sum_e Q'_e KV[e][j], z = sum_e Q'_e K_sum_e,
  // e = 0 .. HD-1 in order; this lane's 4 columns lie in one head.
#pragma unroll 1
  for (int i = 0; i < RM; ++i) {
    const int r = w * RM + i;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = 128 * g + 4 * lane, h = c / HD, jc = c % HD;
      const float* qrow = Qs + r * D + h * HD;
      const float* kvh = kvs + h * HD * HD + jc;
      const float* ksh = kss + h * HD;
      float at[4] = {0.f, 0.f, 0.f, 0.f}, z = 0.f;
#pragma unroll 4
      for (int e = 0; e < HD; e += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + e);
        const float4 kse = *reinterpret_cast<const float4*>(ksh + e);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float qe = comp(qv, u);
          z = fmaf(qe, comp(kse, u), z);
          const float4 kr = *reinterpret_cast<const float4*>(kvh + (e + u) * HD);
          at[0] = fmaf(qe, kr.x, at[0]);
          at[1] = fmaf(qe, kr.y, at[1]);
          at[2] = fmaf(qe, kr.z, at[2]);
          at[3] = fmaf(qe, kr.w, at[3]);
        }
      }
      const float inv = 1.f / (z + attn_eps);
      *reinterpret_cast<float4*>(A + r * D + c) =
          make_float4(at[0] * inv, at[1] * inv, at[2] * inv, at[3] * inv);
    }
  }
  __syncthreads();  // every warp's reads of Q' before the tail's first product refills wbuf
  tail_body<RM, G, D>(A, Hs, wbuf, wm, g1, b1, w1, w2, g2, b2, xb,
                      out + ((size_t)b * L + row0) * D, nvalid, hid, ln_eps, norm_bf16 != 0);
}

template <int D, int H>
int launch_stats(const void* x, const void* mask, const void* wk, const void* wv, void* ws,
                 void* kv, void* ksum, int B, int S, cudaStream_t stream) {
  constexpr int HD = D / H, PER = H * HD * HD + D;
  const int nt = (S + TS - 1) / TS;
  if (nt > 0) {
    constexpr int smem = stats_smem<D>();
    cudaError_t err = cudaFuncSetAttribute(
        attn_stats_f32_kernel<D, H>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attn_stats_f32_kernel<D, H><<<dim3(nt, B), kThreads, smem, stream>>>(
        (const float*)x, (const float*)mask, (const float*)wk, (const float*)wv, (float*)ws, S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int n = B * PER;
  attn_stats_f32_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      (const float*)ws, (float*)kv, (float*)ksum, B, nt, PER, H * HD * HD);
  return (int)cudaGetLastError();
}

template <int D, int H>
int launch_apply(const void* x, const void* mask, const void* wq, const void* kv,
                 const void* ksum, const void* wm, const void* g1, const void* b1,
                 const void* w1, const void* w2, const void* g2, const void* b2, void* out,
                 int B, int L, int hid, float attn_eps, float ln_eps, int norm_bf16,
                 cudaStream_t stream) {
  constexpr int smem = apply_smem<D, H>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_apply_f32_kernel<D, H>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attn_apply_f32_kernel<D, H><<<dim3((L + TS - 1) / TS, B), kThreads, smem, stream>>>(
      (const float*)x, (const float*)mask, (const float*)wq, (const float*)kv,
      (const float*)ksum, (const float*)wm, (const float*)g1, (const float*)b1,
      (const float*)w1, (const float*)w2, (const float*)g2, (const float*)b2, (float*)out, L,
      hid, attn_eps, ln_eps, norm_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, S, d) fp32, mask (B, S) fp32, Wk, Wv (d, d) fp32, (d, heads) a cell
// of ATTN_F32_CELLS -> KV (B, H, hd, hd) and K_sum (B, d) fp32; ws a
// workspace of B ceil(S/64) (H hd^2 + d) floats.
int scream_attn_stats_f32(const void* x, const void* mask, const void* wk, const void* wv,
                          void* ws, void* kv, void* ksum, int B, int S, int d, int heads,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || S < 0) return (int)cudaErrorInvalidValue;
#define ATTN_F32_STATS(D, H) \
  if (d == D && heads == H) return launch_stats<D, H>(x, mask, wk, wv, ws, kv, ksum, B, S, s);
  ATTN_F32_CELLS(ATTN_F32_STATS)
#undef ATTN_F32_STATS
  return (int)cudaErrorInvalidValue;
}

// x (B, L, d) fp32 (query source and both residuals), mask (B, L) fp32, the
// stats of scream_attn_stats_f32, weights (in, out) fp32, LayerNorm params
// (d,) fp32 -> out (B, L, d) fp32. (d, heads) a cell of ATTN_F32_CELLS,
// hidden a multiple of 128; norm_bf16 rounds the LayerNorm outputs through
// bf16 (norm dtype bf16).
int scream_attn_apply_f32(const void* x, const void* mask, const void* wq, const void* kv,
                          const void* ksum, const void* wm, const void* g1, const void* b1,
                          const void* w1, const void* w2, const void* g2, const void* b2,
                          void* out, int B, int L, int d, int heads, int hid, float attn_eps,
                          float ln_eps, int norm_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || L <= 0 || hid <= 0 || hid % 128) return (int)cudaErrorInvalidValue;
#define ATTN_F32_APPLY(D, H)                                                                  \
  if (d == D && heads == H)                                                                   \
    return launch_apply<D, H>(x, mask, wq, kv, ksum, wm, g1, b1, w1, w2, g2, b2, out, B, L,  \
                              hid, attn_eps, ln_eps, norm_bf16, s);
  ATTN_F32_CELLS(ATTN_F32_APPLY)
#undef ATTN_F32_APPLY
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
