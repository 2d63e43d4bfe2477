// Fused linear-attention block for Hopper (sm_90a): two kernels, stats and apply.
//
// Replaces the TPU kernels scream_tpu/ops/attn_pallas.py:_stats_kernel and
// scream_tpu/ops/attn_pallas.py:_apply_kernel (both called from
// attention_block). Same function, bf16 operands with fp32 accumulation:
//
//   stats:  [k|v] = x_kv @ [Wk|Wv] (rounded to bf16), K' = (elu(k)+1)*mask,
//           V = v*mask, then per (batch, head): KV = K'^T V (fp32, hd x hd)
//           and K_sum = sum_rows K' (fp32).
//   apply:  q = x @ Wq (bf16), Q' = (elu(q)+1)*mask, att = Q' KV per head
//           (fp32 KV), z = 1/(Q'.K_sum + eps) per head (fp32),
//           msg = bf16(att*z), then LN2(x + relu(LN1(msg @ Wm + x) @ W1) @ W2)
//           with fp32 LayerNorm statistics, var = max(0, E[x^2] - mu^2).
//
// What bounds it on the H100: at the main path's shape (16 x 4096 rows,
// d = 256, hidden 1024) the apply kernel does ~86 GFLOP per call against
// ~67 MB of activations in and out, ~1,300 FLOP per byte, so it is bound by
// tensor-core operations, not by HBM. The stats kernel does ~17 GFLOP over a
// 33 MB input and is bound the same way. At the GT-free serving shapes
// (d = 128, hidden 512, 8 x 512 rows) a call is ~1.3 GFLOP, a few
// microseconds of tensor-core time, so launch latency and the few blocks
// (8 B for stats, 8 x ceil(L / 64) B for apply) bound it instead. What the
// design does about it:
//   * The projections, the FFN and the merge run on the tensor cores
//     (WMMA bf16 16x16x16 fragments, fp32 accumulators), not on CUDA cores.
//   * Nothing intermediate goes to device memory: projected K/V, Q, the
//     message and the rows x 1024 FFN hidden stay in shared memory; the
//     hidden is produced and consumed in 128-column chunks whose second
//     product accumulates in registers.
//   * Each warp owns whole column groups of every product, so each weight
//     fragment is read from L2 once per block.
//   * The TPU kernel builds the full d x d KV and zeroes the cross-head
//     blocks; here one block per (batch, head) builds only its hd x hd
//     diagonal block, looping over the sequence: 8 B blocks (128 at
//     B = 16), no atomics, deterministic. The TPU's bf16 hi/lo split of KV is a Mosaic
//     workaround; the apply kernel reads the fp32 KV directly.
// This is the first, simple version (WMMA, no TMA/wgmma pipeline).
//
// Widths: one source serves d_model 256 (head_dim 32, the full model) and
// d_model 128 (head_dim 16, the hint-free GT-free checkpoint), both with 8
// heads; every kernel is a template on D and the C entry points dispatch on
// d. At head_dim 16 two heads share a warp in the apply kernel, so the
// normalizer is a half-warp sum, and the stats kernel's per-(batch, head)
// KV is a single 16 x 16 fragment.
//
// Layout contract (checked by the Python wrapper, ops/attn_cuda.py):
// d_model 128 or 256, 8 heads, hidden a multiple of 128, all tensors
// contiguous, bf16 activations and weights ((in, out) row-major), fp32
// masks, LayerNorm params and statistics.

#include "wmma_tile.cuh"

namespace {

using namespace scream;

constexpr int H = 8;          // heads (both widths)
constexpr int NT = 256;       // threads per block (8 warps)
constexpr int NW = NT / 32;   // warps per block
constexpr int TS = 64;        // stats: sequence rows per tile
constexpr int TA = 64;        // apply: query rows per block
constexpr int HC = 128;       // apply: FFN hidden columns per chunk

// elu(x) + 1 as where(x > 0, x + 1, exp(x)), in fp32 (attn_pallas._elu1).
__device__ __forceinline__ float elu1(float v) {
  return v > 0.f ? v + 1.f : expf(v);
}

// Stats tiling at width D (head dim HD = D / 8). The projection of a TS-row
// tile onto [k_h | v_h] (2 HD columns) is split into CFS column fragments
// of 16 and RGS row groups of RPG rows, one warp each; KV_W warps hold the
// KV block (KVF x KVF fragments), and warp KV_W sums K'.
template <int D>
struct Stats {
  static constexpr int HD = D / H;
  static constexpr int W2 = 2 * HD;
  static constexpr int CFS = W2 / 16;       // 4 at HD 32, 2 at HD 16
  static constexpr int RGS = NW / CFS;      // 2, 4
  static constexpr int RPG = TS / RGS;      // 32, 16
  static constexpr int RF = RPG / 16;       // 2, 1
  static constexpr int KVF = HD / 16;       // 2, 1
  static constexpr int KV_W = KVF * KVF;    // 4, 1
  static constexpr size_t SMEM =
      (size_t)TS * D * 2 + (size_t)TS * W2 * 4 + (size_t)TS * W2 * 2;
  static_assert(NW % CFS == 0 && TS % (16 * RGS) == 0 && KV_W < NW, "tiling");
};

// Stats: grid (H, B), one block per (head, batch), looping over S.
template <int D>
__global__ void __launch_bounds__(NT)
attn_stats_kernel(const bf16* __restrict__ x, const float* __restrict__ mask,
                  const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                  float* __restrict__ kv, float* __restrict__ ksum, int S) {
  using C = Stats<D>;
  constexpr int HD = C::HD, W2 = C::W2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);                          // TS x D
  float* st = reinterpret_cast<float*>(smem + (size_t)TS * D * 2);   // TS x W2
  bf16* kvb = reinterpret_cast<bf16*>(smem + (size_t)TS * D * 2 +
                                      (size_t)TS * W2 * 4);          // TS x W2

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* xb = x + (size_t)b * S * D;
  const float* mb = mask + (size_t)b * S;

  // Projection ownership: column fragment cf of [k_h | v_h] (the first
  // CFS / 2 are k) and rows rg * RPG .. + RPG of the tile.
  const int cf = warp % C::CFS, rg = warp / C::CFS;
  const bf16* wcol = (cf < C::CFS / 2 ? wk + h * HD + cf * 16
                                      : wv + h * HD + (cf - C::CFS / 2) * 16);

  FragC kvacc;  // warps 0 .. KV_W-1: KV sub-block (warp / KVF, warp % KVF)
  wmma::fill_fragment(kvacc, 0.f);
  float ks = 0.f;  // warp KV_W: K_sum column `lane` (lane < HD)

  for (int s0 = 0; s0 < S; s0 += TS) {
    load_rows<D, NT>(xs, xb, s0, TS, S);
    __syncthreads();

    FragC pacc[C::RF][1];
    warp_zero(pacc);
    warp_mma(pacc, xs + (size_t)rg * C::RPG * D, D, wcol, D, D);
    warp_store(pacc, st + (size_t)rg * C::RPG * W2 + cf * 16, W2);
    __syncthreads();

    // Round to bf16 (the projection's output dtype), feature map on k, mask.
    for (int i = threadIdx.x; i < TS * W2; i += NT) {
      const int r = i / W2, c = i % W2;
      const float m = (s0 + r < S) ? mb[s0 + r] : 0.f;
      float v = round_bf16(st[i]);
      if (c < HD) v = round_bf16(elu1(v));
      kvb[i] = __float2bfloat16(v * m);
    }
    __syncthreads();

    if (warp < C::KV_W) {
      const int bi = warp / C::KVF, bj = warp % C::KVF;
#pragma unroll
      for (int k = 0; k < TS; k += 16) {
        FragAT fa;  // K'^T: column-major view of the K' rows
        FragB fb;
        wmma::load_matrix_sync(fa, kvb + k * W2 + bi * 16, W2);
        wmma::load_matrix_sync(fb, kvb + k * W2 + HD + bj * 16, W2);
        wmma::mma_sync(kvacc, fa, fb, kvacc);
      }
    } else if (warp == C::KV_W && lane < HD) {
      for (int r = 0; r < TS; ++r) ks += __bfloat162float(kvb[r * W2 + lane]);
    }
    __syncthreads();
  }

  if (warp < C::KV_W) {
    const int bi = warp / C::KVF, bj = warp % C::KVF;
    float* out = kv + ((size_t)(b * H + h) * HD + bi * 16) * HD + bj * 16;
    wmma::store_matrix_sync(out, kvacc, HD, wmma::mem_row_major);
  } else if (warp == C::KV_W && lane < HD) {
    ksum[(size_t)b * D + h * HD + lane] = ks;
  }
}

// Apply tiling at width D: each warp owns WC = D / 8 output columns (CF
// fragments) of every D-wide product; the per-head contraction gives each
// thread one column and every RP-th row.
template <int D>
struct Apply {
  static constexpr int HD = D / H;
  static constexpr int WC = D / NW;         // 32, 16
  static constexpr int CF = WC / 16;        // 2, 1
  static constexpr int RP = NT / D;         // 1, 2
  static constexpr size_t SMEM = (size_t)TA * D * 2     // xs: block input
                                 + (size_t)TA * D * 2   // as: Q' / msg / LN1 out
                                 + (size_t)TA * D * 4   // st: fp32 staging
                                 + (size_t)TA * HC * 2  // hs: FFN hidden chunk
                                 + (size_t)H * HD * HD * 4  // KV
                                 + (size_t)D * 4        // K_sum
                                 + (size_t)TA * 4;      // row mask
  // st also stages the TA x HC hidden chunk; a head's columns lie in one warp.
  static_assert(D >= HC && NT % D == 0 && 32 % HD == 0 && TA % RP == 0, "tiling");
};

// Apply: grid (ceil(L / TA), B), one block per TA query rows.
template <int D>
__global__ void __launch_bounds__(NT)
attn_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ mask,
                  const bf16* __restrict__ wq, const float* __restrict__ kv,
                  const float* __restrict__ ksum, const bf16* __restrict__ wm,
                  const float* __restrict__ g1, const float* __restrict__ b1,
                  const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                  const float* __restrict__ g2, const float* __restrict__ b2,
                  bf16* __restrict__ out, int L, int hid, float attn_eps,
                  float ln_eps) {
  using C = Apply<D>;
  constexpr int HD = C::HD, WC = C::WC, CF = C::CF;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  bf16* xs = reinterpret_cast<bf16*>(p);  p += (size_t)TA * D * 2;
  bf16* as = reinterpret_cast<bf16*>(p);  p += (size_t)TA * D * 2;
  float* st = reinterpret_cast<float*>(p); p += (size_t)TA * D * 4;
  bf16* hs = reinterpret_cast<bf16*>(p);  p += (size_t)TA * HC * 2;
  float* kvs = reinterpret_cast<float*>(p); p += (size_t)H * HD * HD * 4;
  float* kss = reinterpret_cast<float*>(p); p += (size_t)D * 4;
  float* ms = reinterpret_cast<float*>(p);

  const int b = blockIdx.y, r0 = blockIdx.x * TA;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  load_rows<D, NT>(xs, x + (size_t)b * L * D, r0, TA, L);
  for (int i = tid; i < H * HD * HD; i += NT) kvs[i] = kv[(size_t)b * H * HD * HD + i];
  for (int i = tid; i < D; i += NT) kss[i] = ksum[(size_t)b * D + i];
  for (int i = tid; i < TA; i += NT) ms[i] = (r0 + i < L) ? mask[(size_t)b * L + r0 + i] : 0.f;
  __syncthreads();

  // q = x @ Wq; warp owns columns warp*WC .. +WC over all TA rows.
  {
    FragC acc[TA / 16][CF];
    warp_zero(acc);
    warp_mma(acc, xs, D, wq + warp * WC, D, D);
    warp_store(acc, st + warp * WC, D);
  }
  __syncthreads();
  for (int i = tid; i < TA * D; i += NT) {
    const float q = round_bf16(st[i]);
    as[i] = __float2bfloat16(round_bf16(elu1(q)) * ms[i / D]);
  }
  __syncthreads();

  // Per-head contraction and normalizer. Thread tid owns column tid % D of
  // rows tid / D, + RP, ...; the HD lanes of one head are an aligned group
  // inside one warp (a whole warp at HD 32, a half-warp at HD 16), and all
  // lanes of a warp walk the same rows, so the normalizer is a group sum.
  {
    const int col = tid % D, h = col / HD, cc = col % HD;
    float kvc[HD];
#pragma unroll
    for (int j = 0; j < HD; ++j) kvc[j] = kvs[h * HD * HD + j * HD + cc];
    const float ksc = kss[col];
    for (int r = tid / D; r < TA; r += C::RP) {
      const bf16* qrow = as + (size_t)r * D + h * HD;
      float att = 0.f;
#pragma unroll
      for (int j = 0; j < HD; ++j) att += __bfloat162float(qrow[j]) * kvc[j];
      const float z = group_sum<HD>(__bfloat162float(as[(size_t)r * D + col]) * ksc);
      __syncwarp();
      as[(size_t)r * D + col] = __float2bfloat16(att * (1.f / (z + attn_eps)));
    }
  }
  __syncthreads();

  // Merge, + x, LN1 -> as (bf16).
  {
    FragC acc[TA / 16][CF];
    warp_zero(acc);
    warp_mma(acc, as, D, wm + warp * WC, D, D);
    warp_store(acc, st + warp * WC, D);
  }
  __syncthreads();
  for (int r = warp; r < TA; r += NW) {
    float v[D / 32];
#pragma unroll
    for (int k = 0; k < D / 32; ++k) {
      const int c = lane + 32 * k;
      v[k] = round_bf16(round_bf16(st[(size_t)r * D + c]) +
                        __bfloat162float(xs[(size_t)r * D + c]));
    }
    ln_row<D>(v, g1, b1, ln_eps, lane);
#pragma unroll
    for (int k = 0; k < D / 32; ++k)
      as[(size_t)r * D + lane + 32 * k] = __float2bfloat16(v[k]);
  }
  __syncthreads();

  // FFN in hidden chunks: f += relu(bf16(y @ W1[:, chunk])) @ W2[chunk, :].
  // Each warp produces 16 of a chunk's HC columns.
  FragC facc[TA / 16][CF];
  warp_zero(facc);
  for (int h0 = 0; h0 < hid; h0 += HC) {
    {
      FragC hacc[TA / 16][1];
      warp_zero(hacc);
      warp_mma(hacc, as, D, w1 + h0 + warp * (HC / NW), hid, D);
      warp_store(hacc, st + warp * (HC / NW), HC);
    }
    __syncthreads();
    for (int i = tid; i < TA * HC; i += NT)
      hs[i] = __float2bfloat16(fmaxf(round_bf16(st[i]), 0.f));
    __syncthreads();
    warp_mma(facc, hs, HC, w2 + (size_t)h0 * D + warp * WC, D, HC);
    __syncthreads();
  }
  warp_store(facc, st + warp * WC, D);
  __syncthreads();

  // + x, LN2 -> out.
  for (int r = warp; r < TA; r += NW) {
    float v[D / 32];
#pragma unroll
    for (int k = 0; k < D / 32; ++k) {
      const int c = lane + 32 * k;
      v[k] = round_bf16(__bfloat162float(xs[(size_t)r * D + c]) +
                        round_bf16(st[(size_t)r * D + c]));
    }
    ln_row<D>(v, g2, b2, ln_eps, lane);
    if (r0 + r < L) {
      bf16* orow = out + ((size_t)b * L + r0 + r) * D;
#pragma unroll
      for (int k = 0; k < D / 32; ++k) orow[lane + 32 * k] = __float2bfloat16(v[k]);
    }
  }
}

template <int D>
int launch_stats(const void* x, const void* mask, const void* wk,
                 const void* wv, void* kv, void* ksum, int B, int S,
                 cudaStream_t stream) {
  constexpr size_t smem = Stats<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      attn_stats_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_stats_kernel<D><<<dim3(H, B), NT, smem, stream>>>(
      (const bf16*)x, (const float*)mask, (const bf16*)wk, (const bf16*)wv,
      (float*)kv, (float*)ksum, S);
  return (int)cudaGetLastError();
}

template <int D>
int launch_apply(const void* x, const void* mask, const void* wq,
                 const void* kv, const void* ksum, const void* wm,
                 const void* g1, const void* b1, const void* w1,
                 const void* w2, const void* g2, const void* b2, void* out,
                 int B, int L, int hid, float attn_eps, float ln_eps,
                 cudaStream_t stream) {
  constexpr size_t smem = Apply<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      attn_apply_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_apply_kernel<D><<<dim3((L + TA - 1) / TA, B), NT, smem, stream>>>(
      (const bf16*)x, (const float*)mask, (const bf16*)wq, (const float*)kv,
      (const float*)ksum, (const bf16*)wm, (const float*)g1, (const float*)b1,
      (const bf16*)w1, (const bf16*)w2, (const float*)g2, (const float*)b2,
      (bf16*)out, L, hid, attn_eps, ln_eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, S, d) bf16, d in {128, 256} -> KV (B, 8, d/8, d/8) fp32,
// ksum (B, d) fp32.
int scream_attn_stats(const void* x, const void* mask, const void* wk,
                      const void* wv, void* kv, void* ksum, int B, int S,
                      int d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 256) return launch_stats<256>(x, mask, wk, wv, kv, ksum, B, S, s);
  if (d == 128) return launch_stats<128>(x, mask, wk, wv, kv, ksum, B, S, s);
  return (int)cudaErrorInvalidValue;
}

// x (B, L, d) bf16, d in {128, 256}, hidden a multiple of 128 -> out
// (B, L, d) bf16.
int scream_attn_apply(const void* x, const void* mask, const void* wq,
                      const void* kv, const void* ksum, const void* wm,
                      const void* g1, const void* b1, const void* w1,
                      const void* w2, const void* g2, const void* b2, void* out,
                      int B, int L, int d, int hid, float attn_eps,
                      float ln_eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 256)
    return launch_apply<256>(x, mask, wq, kv, ksum, wm, g1, b1, w1, w2, g2, b2,
                             out, B, L, hid, attn_eps, ln_eps, s);
  if (d == 128)
    return launch_apply<128>(x, mask, wq, kv, ksum, wm, g1, b1, w1, w2, g2, b2,
                             out, B, L, hid, attn_eps, ln_eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
