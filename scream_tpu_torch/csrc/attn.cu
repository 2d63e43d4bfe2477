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
// tensor-core operations, not by HBM; short of that, by how many rows each
// weight byte read from L2 feeds. The stats kernel does ~17 GFLOP over a
// 33 MB input and is bound the same way. At the GT-free serving shapes
// (d = 128, hidden 512, 8 x 512 rows) a call is ~1.3 GFLOP, a few
// microseconds of tensor-core time, so launch latency and the few blocks
// bound it instead. What the design does about it:
//   * apply (the Hopper pipeline of hopper_tile.cuh): the query
//     projection, the merge and the FFN run on wgmma with the 128-row tile
//     as A in shared memory and the weights streamed through a ring of
//     shared-memory stages by bulk copies that complete on mbarriers (one
//     producer warpgroup, two consumer warpgroups of 64 rows each). After the
//     projection, the per-head contraction with the fp32 KV and the
//     normalizer run on CUDA cores in fp32 (2 R H hd^2 operations, a few
//     percent of the products'); the message overwrites the tile, and the
//     merge, LayerNorms and FFN are tail_tile.cuh's, the code tail.cu runs.
//   * stats (the first, simple version: WMMA bf16 16x16x16 fragments, fp32
//     accumulators, weights read from global memory): the projections run
//     on the tensor cores; the TPU kernel builds the full d x d KV and
//     zeroes the cross-head blocks, here one block per (batch, head) builds
//     only its hd x hd diagonal block, looping over the sequence: 8 B
//     blocks (128 at B = 16), no atomics, deterministic. The TPU's bf16
//     hi/lo split of KV is a Mosaic workaround; the apply kernel reads the
//     fp32 KV directly.
//   * Nothing intermediate goes to device memory: projected K/V, Q, the
//     message and the FFN hidden stay in shared memory or registers.
//
// Widths: one source serves d_model 256 (head_dim 32, the full model) and
// d_model 128 (head_dim 16, the hint-free GT-free checkpoint), both with 8
// heads; every kernel is a template on D and the C entry points dispatch on
// d. In the apply kernel a row's head dims lie in one quad of lanes at both
// widths; the stats kernel's per-(batch, head) KV is a single 16 x 16
// fragment at head_dim 16.
//
// Layout contract (checked by the Python wrapper, ops/attn_cuda.py):
// d_model 128 or 256, 8 heads, hidden a multiple of 128, all tensors
// contiguous, bf16 activations and weights ((in, out) row-major for stats;
// packed by ops/tail_cuda.py:pack_weights for apply), fp32 masks,
// LayerNorm params and statistics.

#include "tail_tile.cuh"
#include "wmma_tile.cuh"

namespace {

using namespace scream;

constexpr int H = 8;          // heads (both widths)
constexpr int NT = 256;       // threads per block (8 warps)
constexpr int NW = NT / 32;   // warps per block
constexpr int TS = 64;        // stats: sequence rows per tile

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

// Apply: the query projection on the ring, the attention on CUDA cores, then
// the tail of tail_tile.cuh on the message. Extra shared memory: the
// batch's KV (8 x HD x HD fp32) and K_sum (D fp32).
template <int D>
struct Apply {
  using C = tail::Cfg<D>;
  static constexpr int HD = D / H;
  static constexpr int EXTRA = H * HD * HD * 4 + D * 4;
  using L = tail::Layout<D, EXTRA>;
  static_assert(C::COLS == 1 && HD % 8 == 0, "apply: one warpgroup owns whole rows");
};

// Q' = (elu(bf16(q)) + 1) * mask in bf16 from the projection's accumulators,
// then per head msg = bf16(Q' KV / (Q'.K_sum + eps)) in fp32, written into the
// tile as the merge input. A row's head dims lie in the 4 lanes of a quad;
// each lane takes the row's Q' values from its quad by shuffles and makes
// the message for its own columns.
template <int D, class Consumer>
__device__ __forceinline__ void attend(const Consumer& c, float (&acc)[D / 2],
                                       const float* __restrict__ mrow, int nvalid,
                                       const float* kvs, const float* kss, float eps) {
  constexpr int HD = D / H, HJ = HD / 8;
  float m[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) m[hh] = c.row(hh) < nvalid ? mrow[c.row(hh)] : 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i)
    acc[i] = hopper::round_bf16(elu1(hopper::round_bf16(acc[i]))) * m[(i >> 1) & 1];
  const int base = c.lane & ~3, q4 = c.lane & 3;
  unsigned char* t = reinterpret_cast<unsigned char*>(c.tile);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    float att[2][HJ][2], z[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int jj = 0; jj < HJ; ++jj) att[hh][jj][0] = att[hh][jj][1] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      // Q'[row][h HD + d] is register 4 (h HJ + d/8) + 2 hh + d%2 of lane
      // base + (d%8)/2.
      const int i = 4 * (h * HJ + d / 8) + (d & 1);
      const int src = base | ((d & 7) >> 1);
      const float q0 = __shfl_sync(0xffffffffu, acc[i], src);
      const float q1 = __shfl_sync(0xffffffffu, acc[i + 2], src);
      const float ks = kss[h * HD + d];
      z[0] += q0 * ks;
      z[1] += q1 * ks;
#pragma unroll
      for (int jj = 0; jj < HJ; ++jj) {
        const float2 kv = *reinterpret_cast<const float2*>(kvs + (h * HD + d) * HD + 8 * jj +
                                                           2 * q4);
        att[0][jj][0] += q0 * kv.x;
        att[0][jj][1] += q0 * kv.y;
        att[1][jj][0] += q1 * kv.x;
        att[1][jj][1] += q1 * kv.y;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float inv = 1.f / (z[hh] + eps);
#pragma unroll
      for (int jj = 0; jj < HJ; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(
            t + hopper::core_off(c.row(hh), h * HD + 8 * jj + 2 * q4, D)) =
            __floats2bfloat162_rn(att[hh][jj][0] * inv, att[hh][jj][1] * inv);
    }
  }
}

// Apply: persistent grid over (batch, 128-row tile) pairs; a tile never
// spans two batches, whose KV differ.
template <int D>
__global__ void __launch_bounds__(tail::kThreads, 1)
attn_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ mask,
                  const unsigned char* __restrict__ wpack, const float* __restrict__ kv,
                  const float* __restrict__ ksum, const float* __restrict__ g1,
                  const float* __restrict__ b1, const float* __restrict__ g2,
                  const float* __restrict__ b2, bf16* __restrict__ out, int B, int L,
                  int hid, float attn_eps, float ln_eps) {
  using A = Apply<D>;
  using C = typename A::C;
  using Lay = typename A::L;
  constexpr int HD = A::HD;
  extern __shared__ __align__(128) unsigned char smem[];
  const typename Lay::Ring ring = Lay::ring(smem);
  const int tpb = (L + C::TM - 1) / C::TM, ntiles = B * tpb;
  if (threadIdx.x == 0) ring.init(tail::kConsumers);
  __syncthreads();

  if (threadIdx.x >= 128 * tail::kConsumers) {
    hopper::setmaxnreg_dec<tail::kProducerRegs>();
    if (threadIdx.x == 128 * tail::kConsumers)
      tail::produce(ring, wpack, C::stages(2, hid), C::STAGE, ntiles);
  } else {
    hopper::setmaxnreg_inc<tail::kConsumerRegs>();
    tail::Consumer<D, typename Lay::Ring> c(smem, ring, Lay::TILE, Lay::HID, Lay::STATS);
    float* kvs = reinterpret_cast<float*>(smem + Lay::EXTRA_OFF);
    float* kss = kvs + H * HD * HD;
    constexpr int NC = 128 * tail::kConsumers;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int b = t / tpb, l0 = (t % tpb) * C::TM + 64 * c.rg;
      const int nvalid = L - l0;
      const size_t row0 = (size_t)b * L + l0;
      hopper::named_sync(3, NC);  // both warpgroups are done with the last KV
      for (int i = threadIdx.x; i < H * HD * HD / 4; i += NC)
        reinterpret_cast<float4*>(kvs)[i] =
            reinterpret_cast<const float4*>(kv + (size_t)b * H * HD * HD)[i];
      for (int i = threadIdx.x; i < D / 4; i += NC)
        reinterpret_cast<float4*>(kss)[i] =
            reinterpret_cast<const float4*>(ksum + (size_t)b * D)[i];
      c.load_rows(x + row0 * D, nvalid);
      hopper::fence_proxy_async();
      hopper::named_sync(3, NC);

      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      hopper::ring_mma<D, 2>(acc, c.ring, C::S_D, hopper::smem_u32(c.tile), 16 * D, 0,
                             32 * D, c.wt);
      c.sync();  // every warp's wgmma on the tile has completed
      attend<D>(c, acc, mask + row0, nvalid, kvs, kss, attn_eps);
      hopper::fence_proxy_async();
      c.sync();
      c.run(x + row0 * D, out + row0 * D, nvalid, g1, b1, g2, b2, hid, ln_eps);
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
int launch_apply(const void* x, const void* mask, const void* wpack, const void* kv,
                 const void* ksum, const void* g1, const void* b1, const void* g2,
                 const void* b2, void* out, int B, int L, int hid, float attn_eps,
                 float ln_eps, cudaStream_t stream) {
  using C = tail::Cfg<D>;
  constexpr int smem = Apply<D>::L::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      attn_apply_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = B * ((L + C::TM - 1) / C::TM);
  const int grid = ntiles < tail::num_sms() ? ntiles : tail::num_sms();
  attn_apply_kernel<D><<<grid, tail::kThreads, smem, stream>>>(
      (const bf16*)x, (const float*)mask, (const unsigned char*)wpack, (const float*)kv,
      (const float*)ksum, (const float*)g1, (const float*)b1, (const float*)g2,
      (const float*)b2, (bf16*)out, B, L, hid, attn_eps, ln_eps);
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

// x (B, L, d) bf16, d in {128, 256}, hidden a multiple of 128, wpack the
// packed Wq, Wm, W1, W2 (pack_weights) -> out (B, L, d) bf16.
int scream_attn_apply(const void* x, const void* mask, const void* wpack, const void* kv,
                      const void* ksum, const void* g1, const void* b1, const void* g2,
                      const void* b2, void* out, int B, int L, int d, int hid,
                      float attn_eps, float ln_eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || L <= 0 || hid <= 0 || hid % 128) return (int)cudaErrorInvalidValue;
  if (d == 256)
    return launch_apply<256>(x, mask, wpack, kv, ksum, g1, b1, g2, b2, out, B, L, hid,
                             attn_eps, ln_eps, s);
  if (d == 128)
    return launch_apply<128>(x, mask, wpack, kv, ksum, g1, b1, g2, b2, out, B, L, hid,
                             attn_eps, ln_eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
