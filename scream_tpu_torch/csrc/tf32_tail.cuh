// The block tail in float32 on a resident row tile, shared by attn_f32.cu
// (attn_apply_f32_kernel, after its attention) and tail_f32.cu
// (tail_f32_kernel), every product split-TF32 ("3xTF32") wgmma on the
// ring of tf32_tile.cuh. With the tail's input in the row tile's shared
// memory and the ring at Wm's first stage, per row:
//
//   t = a @ Wm + res; y = LN1(t); h = relu(y @ W1); u = res + h @ W2;
//   out = LN2(u),
//
// LayerNorm with fp32 statistics, var = max(0, E[x^2] - mu^2) (flax),
// rounded through bf16 when the norm dtype is bf16. res is the block input
// (x in apply, q in the tail), read from global memory.
//
// Block: one producer warpgroup (one thread fills the ring) and two
// consumer warpgroups that take the same 64 rows and split every product's
// output columns, NW = D / 2 each (Block<D>):
//   * D 128 and 256: a D-wide weight (Wq, Wm, a hidden chunk's W2 rows)
//     streams in stages of 4096 / D k-rows x D columns, a warpgroup's
//     product N = NW; the hidden goes in chunks of 128 columns, their W1
//     columns in stages of 32 k-rows x 128, N = 64 a warpgroup.
//   * D 384: N = 192 would need a 96-register chunk accumulator beside the
//     96-register master, and ptxas holds a thread of these 384-thread
//     blocks to 168 registers. So a D-wide product goes in 3 passes of 64
//     columns a warpgroup (a 32-register chunk added into a third of the
//     master), each over all of its k, re-reading and re-splitting its A
//     operand, from stages of 32 k-rows x 128 columns: pass p's stage holds
//     columns 64 p .. 64 p + 63 (warpgroup 0) then 192 + 64 p .. 192 + 64 p
//     + 63 (warpgroup 1). The hidden goes in chunks of 64 columns, their W1
//     columns in stages of 64 k-rows x 64, N = 32 a warpgroup, so h's chunk
//     and master take 32 registers beside the output's 96.
// Every stage is 32 KB (hi, then lo); a product's accumulator is promoted
// every kPromoteK k values (ring_mma3), which each geometry's stages and
// hidden chunks divide. ops/attn_cuda.py:f32_block_geometry mirrors Block<D>
// and lays out the weights (pack_block_f32_kernel, attn_f32.cu).

#pragma once

#include <atomic>

#include "tail_tile.cuh"  // the block geometry: tail::kThreads, kSmemMax, num_sms, ...
#include "tf32_tile.cuh"

namespace scream {
namespace tf32 {

constexpr int TM = 64;  // rows of a tile

// Shared memory of a block: NST ring stages first, then the kernel's own
// REST bytes, then the barriers; as many stages as fit, at most 8.
template <int REST>
struct Smem {
  static constexpr int FIT = (tail::kSmemMax - REST - 16 * 8) / kStage;
  static constexpr int NST = FIT < 8 ? FIT : 8;
  static constexpr int BARS = NST * kStage + REST;
  static constexpr int BYTES = BARS + 16 * NST;
  static_assert(NST >= 2 && BYTES <= tail::kSmemMax, "shared memory");
  using Ring = hopper::Ring<NST, kStage, BARS>;
};

// The tail's geometry at width D (above).
template <int D>
struct Block {
  static constexpr bool PASS64 = D > 256;
  static constexpr int NW = D / 2;                   // output columns a warpgroup
  static constexpr int ND = PASS64 ? 64 : NW;        // of them in one D-wide pass
  static constexpr int PASSES = NW / ND;
  static constexpr int NS_D = 2 * ND;                // columns of a D-wide stage
  static constexpr int KS_D = kHalfFloats / NS_D;    // its k-rows
  static constexpr int HC = PASS64 ? 64 : 128;       // hidden columns a chunk
  static constexpr int NH = HC / 2;                  // W1 columns a warpgroup
  static constexpr int KS_H = kHalfFloats / HC;      // k-rows of a W1 stage
  // k8 steps a wgmma window (tf32_tile.cuh:stage3), each window's A
  // fragments 8 registers a step: 2 where a 64-register master and chunk
  // leave no more (d 256); at d 384 4 in the d-wide passes (96 + 32 + 32;
  // 2 cost 3-5 % more time, scripts/torch_port_f32_probe.py) and 2 in W1's
  // (4 spill there).
  static constexpr int WK_D = PASS64 ? 4 : KS_D / 8;
  static constexpr int WK_H = NW >= 128 ? 2 : KS_H / 8;
  static constexpr int CN = PASS64 ? 32 : 64;        // the chunk array
  static constexpr int S_D = PASSES * (D / KS_D);    // stages of a D x D weight
  static constexpr int S_W1 = D / KS_H, S_W2 = PASSES * (HC / KS_D);  // of a hidden chunk
  // Promotion falls on stage boundaries (ring_mma3 promotes after a
  // stage); that HC, and so every W2 product, ends on one too is
  // tests/test_torch_port_tf32x3.py's check.
  static_assert(KS_D % 8 == 0 && KS_H % 8 == 0 && kPromoteK % KS_D == 0 &&
                    kPromoteK % KS_H == 0 && NH <= CN && ND / 2 <= CN,
                "tail geometry: promotion on stage boundaries, the chunk array holds h");
  // Ring stages of one tile: dd D x D weights (Wm; Wq first in apply),
  // then per hidden chunk its W1 stages and its W2 stages.
  static __host__ __device__ constexpr int stages(int dd, int hid) {
    return dd * S_D + hid / HC * (S_W1 + S_W2);
  }
};

// One consumer thread's rows (r0, r0 + 8 of the tile), quad lane t, column
// half cp (its NW columns start at n0 = cp NW).
struct Rows {
  int r0, t, cp, lane;
};

// acc[AO .. AO + NW/2) (this warpgroup's NW columns, accumulator layout)
// into the tile of K columns.
template <int NW, int K, int AO = 0, int AN>
__device__ __forceinline__ void store_tile(const float (&acc)[AN], float* tile, const Rows& w,
                                           bool relu) {
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = acc[AO + 4 * j + 2 * hh + e];
        tile[tile_idx(w.r0 + 8 * hh, w.cp * NW + 8 * j + 2 * w.t + e, K)] =
            relu ? fmaxf(v, 0.f) : v;
      }
}

// acc <- LN(acc + res) over whole rows (both warpgroups' columns), fp32
// statistics, var = max(0, E[x^2] - mu^2), y = (x - mu) (rsqrt(var + eps) g)
// + b, rounded through bf16 when the norm dtype is bf16. res: the tile's
// first row in global memory (stride D); rows at or past nvalid add 0.
// Ends past a barrier of both warpgroups, after which neither reads the
// row tile for the product before it.
template <int D>
__device__ __forceinline__ void add_ln(float (&acc)[D / 4], const float* __restrict__ res,
                                       int nvalid, const float* __restrict__ g,
                                       const float* __restrict__ b, float eps, bool nbf,
                                       float2* stats, const Rows& w) {
  constexpr int NW = D / 2;
  const int c0 = w.cp * NW + 2 * w.t;
  float s[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = w.r0 + 8 * hh;
    const float* rp = res + (size_t)row * D + c0;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const float2 q = row < nvalid ? __ldg(reinterpret_cast<const float2*>(rp + 8 * j))
                                    : make_float2(0.f, 0.f);
      float& a0 = acc[4 * j + 2 * hh];
      float& a1 = acc[4 * j + 2 * hh + 1];
      a0 += q.x;
      a1 += q.y;
      s[hh] += a0 + a1;
      s2[hh] = fmaf(a1, a1, fmaf(a0, a0, s2[hh]));
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], o);
      s2[hh] += __shfl_xor_sync(0xffffffffu, s2[hh], o);
    }
  if (w.t == 0)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) stats[w.cp * TM + w.r0 + 8 * hh] = make_float2(s[hh], s2[hh]);
  hopper::named_sync(1, 256);
  float mu[2], rs[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float2 p0 = stats[w.r0 + 8 * hh], p1 = stats[TM + w.r0 + 8 * hh];
    mu[hh] = (p0.x + p1.x) / D;
    rs[hh] = rsqrtf(fmaxf(0.f, (p0.y + p1.y) / D - mu[hh] * mu[hh]) + eps);
  }
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const float2 gg = __ldg(reinterpret_cast<const float2*>(g + c0 + 8 * j));
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b + c0 + 8 * j));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float& a0 = acc[4 * j + 2 * hh];
      float& a1 = acc[4 * j + 2 * hh + 1];
      a0 = (a0 - mu[hh]) * (rs[hh] * gg.x) + bb.x;
      a1 = (a1 - mu[hh]) * (rs[hh] * gg.y) + bb.y;
      if (nbf) {
        a0 = hopper::round_bf16(a0);
        a1 = hopper::round_bf16(a1);
      }
    }
  }
}

// m += A @ W for a D-wide weight W over the next ring stages: A the tile a
// (K columns), the warpgroup's NW output columns in m's accumulator layout,
// pass P (and the passes before it) of Block<D>.
template <class G, int K, int P = G::PASSES - 1, int MN, int CN, class RingT>
__device__ __forceinline__ void wide_mma(float (&m)[MN], float (&c)[CN], RingT& ring,
                                         const float* a, int cp, int wt) {
  if constexpr (P > 0) wide_mma<G, K, P - 1>(m, c, ring, a, cp, wt);
  ring_mma3<G::ND, G::KS_D, K, G::NS_D, P * G::ND / 2, G::WK_D>(m, c, ring, K / G::KS_D, a,
                                                                32 * G::ND * cp, wt);
}

// The tail on the row tile At (64 x D, the tile layout of tf32_tile.cuh)
// with the ring at Wm's first stage: y = LN1(At @ Wm + res) into At, then
// the FFN over hid / HC hidden chunks (double-buffered in Hs: h written by
// both warpgroups, then read whole), out = LN2(res + f). res and out: the
// tile's first row in global memory (stride D); rows at or past nvalid are
// not stored. acc (the output's master) and c (the wgmma chunk) are the
// caller's registers.
template <int D, int MN, int CN, class RingT>
__device__ __forceinline__ void tail_rows(float (&acc)[MN], float (&c)[CN], RingT& ring,
                                          float* At, float* Hs, float2* stats,
                                          const float* __restrict__ res,
                                          float* __restrict__ out, int nvalid, int hid,
                                          const float* __restrict__ g1,
                                          const float* __restrict__ b1,
                                          const float* __restrict__ g2,
                                          const float* __restrict__ b2, float eps, bool nbf,
                                          const Rows& w, int wt) {
  using G = Block<D>;
  constexpr int NW = G::NW, NH = G::NH, HC = G::HC;
  static_assert(MN == NW / 2 && CN == G::CN, "tail registers");

  // t = a @ Wm + res; y = LN1(t) into the tile.
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  wide_mma<G, D>(acc, c, ring, At, w.cp, wt);
  add_ln<D>(acc, res, nvalid, g1, b1, eps, nbf, stats, w);
  store_tile<NW, D>(acc, At, w, false);
  hopper::named_sync(1, 256);

  // f = sum over hidden chunks of relu(y @ W1[:, ch]) @ W2[ch, :].
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int ch = 0; ch < hid / HC; ++ch) {
    // h into c[NH/2 .. NH), its master; the chunk in c[0 .. NH/2).
#pragma unroll
    for (int i = NH / 2; i < NH; ++i) c[i] = 0.f;
    ring_mma3<NH, G::KS_H, D, HC, NH / 2, G::WK_H>(c, c, ring, G::S_W1, At, 32 * NH * w.cp,
                                                   wt);
    float* hb = Hs + (ch & 1) * TM * HC;
    store_tile<NH, HC, NH / 2>(c, hb, w, true);
    hopper::named_sync(1, 256);  // the chunk's HC columns are in
    wide_mma<G, HC>(acc, c, ring, hb, w.cp, wt);
  }
  add_ln<D>(acc, res, nvalid, g2, b2, eps, nbf, stats, w);
  float* ob = out + w.cp * NW + 2 * w.t;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = w.r0 + 8 * hh;
    if (row >= nvalid) continue;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
      *reinterpret_cast<float2*>(ob + (size_t)row * D + 8 * j) =
          make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

// Wq (optional), Wm (d, d), W1 (d, hid), W2 (hid, d) fp32 -> the blob of
// Block<d>'s ring stages in the order they are consumed, hi then lo in
// every stage: [Wq], Wm, then per hidden chunk its W1 and W2 stages. One
// launch of pack_block_f32_kernel (attn_f32.cu) on `stream`.
int launch_pack_block(const void* wq, const void* wm, const void* w1, const void* w2, void* out,
                      int d, int hid, cudaStream_t stream);

// The kernel's dynamic shared memory limit raised to bytes, once per device
// (the bits of `devices`): cudaFuncSetAttribute on every launch would add to
// the host time of a small call, which bounds the serving shapes.
template <class K>
int set_smem(K kernel, int bytes, std::atomic<unsigned>& devices) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (devices.load(std::memory_order_acquire) & bit) return 0;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (!err) devices.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace tf32
}  // namespace scream
