// Shared by the head-generic attention kernels (attn_heads.cu: stats;
// attn_heads_apply.cu: bf16 apply; attn_heads_apply_f32.cu: fp32 apply):
// their constants and the apply kernels' attend, which takes the head dim
// at run time. attn_heads.cu's header says what the kernels replace, what
// bounds them and how.

#pragma once

#include "tf32_tail.cuh"

namespace scream {
namespace heads {

constexpr int kChunk = 512;       // stats: rows of a partial sum (ops/attn_cuda.py HEADS_CHUNK)
constexpr int kSub = 32;          // stats: rows of a shared-memory stage of the sum
constexpr int kSumThreads = 256;  // stats: threads of a sum block, one KV block each
constexpr int kGroup = 64;        // stats workspace: columns of K' (and of V) a group
constexpr int kIC = 32;           // apply: KV rows a pass of the attend

// The widths of the pair: bf16 d 128, 256, 384; fp32 d 128, 256; heads
// dividing d.
inline bool cell_ok(int d, int heads, bool f32) {
  return (d == 128 || d == 256 || (d == 384 && !f32)) && heads > 0 && d % heads == 0;
}

// KV rows i0 .. i0 + n of every head of one batch's KV (d / hd heads of hd
// x hd fp32) into kvs, head h's at kvs + h n hd; thread tid of nthr.
__device__ __forceinline__ void stage_kv(float* kvs, const float* __restrict__ kvb, int d,
                                         int hd, int i0, int n, int tid, int nthr) {
  const int per = n * hd, H = d / hd;
  for (int e = tid; e < H * per; e += nthr) {
    const int h = e / per;
    kvs[e] = __ldg(kvb + ((size_t)h * hd + i0) * hd + (e - h * per));
  }
}

// att (+)= Q' KV over the staged KV rows i0 .. i0 + n of each head, for
// the thread's column pairs j = J0 .. J0 + NJ - 1: acc[4 j + 2 hh + e] is
// row hh (of the thread's two), column col(j) + e (the wgmma accumulator
// layout); Q'(hh, c) reads the row tile; kvs holds the rows as stage_kv
// lays them out. Each output column is one fmaf chain over its head's rows
// in order. Where hd is even both columns of a pair lie in one head: one KV
// float2 a step. col(j) is made opaque (asm volatile) before the head
// arithmetic, so that the compiler does not hoist NJ columns' heads and
// offsets out of the loop over passes and hold them beside the
// accumulators.
template <int J0, int NJ, int NA, class ColF, class QF>
__device__ __forceinline__ void attend_pass(float (&acc)[NA], ColF col, QF q, const float* kvs,
                                            int i0, int n, int hd) {
  static_assert(4 * (J0 + NJ) <= NA, "column pairs");
  const bool pair = (hd & 1) == 0;
#pragma unroll
  for (int j = J0; j < J0 + NJ; ++j) {
    int cj = col(j);
    asm volatile("" : "+r"(cj));
    if (pair) {
      const int h = cj / hd, base = h * hd + i0;
      const float* kp = kvs + (size_t)h * n * hd + (cj - h * hd);
#pragma unroll 1
      for (int ii = 0; ii < n; ++ii) {
        const float q0 = q(0, base + ii), q1 = q(1, base + ii);
        const float2 kv = *reinterpret_cast<const float2*>(kp + ii * hd);
        acc[4 * j] = fmaf(q0, kv.x, acc[4 * j]);
        acc[4 * j + 1] = fmaf(q0, kv.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(q1, kv.x, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(q1, kv.y, acc[4 * j + 3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = cj + e, h = c / hd, base = h * hd + i0;
        const float* kp = kvs + (size_t)h * n * hd + (c - h * hd);
#pragma unroll 1
        for (int ii = 0; ii < n; ++ii) {
          const float kv = kp[ii * hd];
          acc[4 * j + e] = fmaf(q(0, base + ii), kv, acc[4 * j + e]);
          acc[4 * j + 2 + e] = fmaf(q(1, base + ii), kv, acc[4 * j + 2 + e]);
        }
      }
    }
  }
}

// acc *= 1 / (z + eps) for the column pairs j = J0 .. J0 + NJ - 1, z = sum
// over the column's head of Q'(hh, c) K_sum[c] (one fmaf chain over the
// head's columns in order), made once for each run of columns in one head.
template <int J0, int NJ, int NA, class ColF, class QF>
__device__ __forceinline__ void normalize(float (&acc)[NA], ColF col, QF q, const float* kss,
                                          int hd, float eps) {
  int zh = -1;
  float inv[2] = {0.f, 0.f};
#pragma unroll
  for (int j = J0; j < J0 + NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int c = col(j) + e;
      asm volatile("" : "+r"(c));
      const int h = c / hd;
      if (h != zh) {
        float z[2] = {0.f, 0.f};
#pragma unroll 1
        for (int i = h * hd; i < h * hd + hd; ++i) {
          const float k = kss[i];
          z[0] = fmaf(q(0, i), k, z[0]);
          z[1] = fmaf(q(1, i), k, z[1]);
        }
        inv[0] = 1.f / (z[0] + eps);
        inv[1] = 1.f / (z[1] + eps);
        zh = h;
      }
      acc[4 * j + e] *= inv[0];
      acc[4 * j + 2 + e] *= inv[1];
    }
}

}  // namespace heads
}  // namespace scream
