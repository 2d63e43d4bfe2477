// Shared by the head-generic attention kernels (attn_heads.cu: stats;
// attn_heads_apply.cu: bf16 apply; attn_heads_apply_f32.cu: fp32 apply):
// their constants and the apply kernels' attend, which takes the head dim
// at run time. attn_heads.cu's header says what the kernels replace, what
// bounds them and how.
//
// The attend is Q' . blockdiag(KV) on wgmma, as the TPU kernel forms it
// (scream_tpu/ops/attn_pallas.py:_apply_kernel: one product against the
// full d x d KV whose cross-head blocks the wrapper zeroes). A consumer
// warpgroup makes its output columns in slices of SL columns (bf16
// kSliceBf16, m64n32; fp32 kSliceF32, m64n64): slice [c0, c0 + SL) reads
// only the band of KV rows of the heads those columns touch, [hd floor(c0 /
// hd), hd ceil((c0 + SL) / hd)) clipped to d and rounded out to the band
// step (band below); inside the band the entries off the diagonal blocks
// are staged as zeros. A band goes through shared memory in chunks of
// k-rows, staged from the fp32 (B, H, hd, hd) KV by the consumer threads
// (stage_band_bf16, stage_band_tf32) in wgmma's B layout; a slice's
// accumulator is its wgmma fragment. The bf16 slice is 32 columns: the
// kernel holds its finished slices' messages in registers, and at d 256 a
// 64-column slice's 32 accumulators beside them leave too few of a
// thread's 168.

#pragma once

#include "tf32_tail.cuh"

namespace scream {
namespace heads {

constexpr int kChunk = 512;       // stats: rows of a partial sum (ops/attn_cuda.py HEADS_CHUNK)
constexpr int kSumRows = 32;      // stats: rows of a shared-memory stage of the sum
constexpr int kSumStages = 3;     // stats: the sum's stages in flight
constexpr int kSumWide = 128;     // stats: a bf16 sum block's columns at head dims of 128 up
constexpr int kGroup = 64;        // stats workspace: columns of K' (and of V) a group
constexpr int kSliceBf16 = 32;    // apply: columns of a bf16 attend product (attn_cuda.HEADS_SLICE)
constexpr int kSliceF32 = 64;     // apply: columns of an fp32 attend product
constexpr int kStepBf16 = 32;     // apply: band step in bf16, two k16 steps
constexpr int kStepF32 = 16;      // apply: band step in fp32, a window of two k8 steps

// The widths of the pair: bf16 d 128, 256, 384; fp32 d 128, 256; heads
// dividing d.
inline bool cell_ok(int d, int heads, bool f32) {
  return (d == 128 || d == 256 || (d == 384 && !f32)) && heads > 0 && d % heads == 0;
}

// The band [k0, k1) of blockdiag(KV) rows that output columns [c0, c0 +
// SL) read: every head they touch, clipped to d, rounded out to `step`
// (ops/attn_cuda.py:heads_band).
template <int SL>
__device__ __forceinline__ void band(int c0, int hd, int d, int step, int& k0, int& k1) {
  k0 = c0 / hd * hd / step * step;
  const int e = (c0 + SL + hd - 1) / hd * hd;
  k1 = ((e < d ? e : d) + step - 1) / step * step;
}

// f(Slice<S>{}) for S = 0 .. N - 1 in order, S a compile-time constant:
// each slice's accumulator registers are named at compile time.
template <int S>
struct Slice {
  static constexpr int value = S;
};

template <int S, int N, class F>
__device__ __forceinline__ void for_slices(F&& f) {
  if constexpr (S < N) {
    f(Slice<S>{});
    for_slices<S + 1, N>(f);
  }
}

// Rows k0 .. k0 + nk (a multiple of 8) of blockdiag(KV) at columns c0 ..
// c0 + kSliceBf16, from one batch's KV (kvb: H x hd x hd fp32), as bf16 hi
// = bf16(v) and lo = bf16(v - hi) (attn_pallas.py's KVm and KVlo) into buf:
// the hi block, then the lo block kcap kSliceBf16 2 bytes on, each in the
// K-major wgmma B layout of hopper_tile.cuh (k16 step t, column group n /
// 8, k half c: core ((t kSliceBf16 / 8 + n / 8) 2 + c) 128 bytes). Entries
// whose row lies outside the column's head are 0. Thread tid of nthr (a
// multiple of kSliceBf16): column n = tid % kSliceBf16, 8 k-rows (one
// core-matrix row, 16 bytes a block) an item.
__device__ __forceinline__ void stage_band_bf16(unsigned char* buf, int kcap,
                                                const float* __restrict__ kvb, int hd,
                                                int c0, int k0, int nk, int tid, int nthr) {
  constexpr int SL = kSliceBf16;
  const int n = tid % SL, c = c0 + n, kh0 = c / hd * hd;
  const float* kvc = kvb + (size_t)kh0 * hd + (c - kh0);  // KV[h][0][c - kh0]
  unsigned char* hp = buf + ((n >> 3) << 8) + ((n & 7) << 4);
#pragma unroll 1
  for (int kg = tid / SL; kg < nk / 8; kg += nthr / SL) {
    const int r0 = k0 + 8 * kg - kh0;  // the item's first row, within the head
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[e] = (unsigned)(r0 + i + e) < (unsigned)hd ? __ldg(kvc + (size_t)(r0 + i + e) * hd)
                                                     : 0.f;
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(v[0], v[1]);
      const float2 hf = __bfloat1622float2(h2);
      const __nv_bfloat162 l2 = __floats2bfloat162_rn(v[0] - hf.x, v[1] - hf.y);
      hi[i / 2] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[i / 2] = *reinterpret_cast<const uint32_t*>(&l2);
    }
    // k16 step kg / 2, k half kg % 2.
    unsigned char* p = hp + (kg >> 1) * (32 * SL) + ((kg & 1) << 7);
    *reinterpret_cast<uint4*>(p) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(p + kcap * SL * 2) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// The same in fp32 for the split-TF32 products, at columns c0 .. c0 +
// kSliceF32: hi = tf32(v), lo = tf32(v - hi) (tf32_tile.cuh:split) into
// buf, the hi block then the lo block kcap kSliceF32 floats on, each in
// tf32_tile.cuh's B layout (k8 step t, column group n / 8, k half c: core
// ((t kSliceF32 / 8 + n / 8) 2 + c) 128 bytes, a column's 4 k values 16
// bytes); nk a multiple of 4, 4 k-rows an item.
__device__ __forceinline__ void stage_band_tf32(float* buf, int kcap,
                                                const float* __restrict__ kvb, int hd,
                                                int c0, int k0, int nk, int tid, int nthr) {
  constexpr int SL = kSliceF32;
  const int n = tid % SL, c = c0 + n, kh0 = c / hd * hd;
  const float* kvc = kvb + (size_t)kh0 * hd + (c - kh0);
  float* hp = buf + ((n >> 3) << 6) + ((n & 7) << 2);
#pragma unroll 1
  for (int kq = tid / SL; kq < nk / 4; kq += nthr / SL) {
    const int r0 = k0 + 4 * kq - kh0;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v =
          (unsigned)(r0 + i) < (unsigned)hd ? __ldg(kvc + (size_t)(r0 + i) * hd) : 0.f;
      tf32::split(v, hi[i], lo[i]);
    }
    // k8 step kq / 2, k half kq % 2.
    float* p = hp + (kq >> 1) * (8 * SL) + ((kq & 1) << 5);
    *reinterpret_cast<uint4*>(p) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(p + kcap * SL) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// D += A @ B for one k16 step, m64n32k16, bf16 inputs, fp32 accumulators,
// A and B K-major in shared memory (hopper_tile.cuh's Wgmma at N = 32).
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d (one slice of the warpgroup's columns, the m64n32 fragment) (+)= Q' B
// over nk (a multiple of 32) k-rows, bf16: A the warpgroup's 64 rows of
// the row tile from the chunk's first k-row (shared address a, 8-row stride
// a_sbo), B the staged chunk at shared address b (hi block, the lo block
// kcap kSliceBf16 2 bytes on); per k16 step the hi pass, then the lo pass,
// into the fp32 accumulator. FRESH (the band's first chunk): d is zeroed
// first, here after the chunk's barrier, as attend_tf32 zeroes its chunk,
// so that no code in a divergent path writes a register a wgmma then reads.
// On return every wgmma has completed.
template <bool FRESH>
__device__ __forceinline__ void attend_bf16(float (&d)[kSliceBf16 / 2], uint32_t a,
                                            uint32_t a_sbo, uint32_t b, int kcap, int nk) {
  constexpr int SL = kSliceBf16;
  if constexpr (FRESH) {
#pragma unroll
    for (int i = 0; i < SL / 2; ++i) d[i] = 0.f;
  }
  uint64_t da = hopper::desc(a, 128, a_sbo), dh = hopper::desc(b, 128, 256);
  uint64_t dl = hopper::desc(b + kcap * SL * 2, 128, 256);
#pragma unroll 1
  for (int k = 0; k < nk; k += 32) {
    hopper::wgmma_fence();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      wgmma_n32(d, da, dh);
      wgmma_n32(d, da, dl);
      // The next k16 step: A 256 bytes on, B 32 SL bytes on.
      asm volatile("add.s64 %0, %0, 16;\n" : "+l"(da));
      asm volatile("add.s64 %0, %0, %1;\n" : "+l"(dh) : "n"(2 * SL));
      asm volatile("add.s64 %0, %0, %1;\n" : "+l"(dl) : "n"(2 * SL));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(d);
  }
}

// m[S kSliceF32 / 2 ..] += Q' B over nk (a multiple of 16, at most
// tf32::kPromoteK) k-rows as split-TF32: the chunk c[0 .. kSliceF32 / 2)
// afresh, per k8 step the passes lo(A) hi(B), hi(A) lo(B), hi(A) hi(B)
// (tf32_tile.cuh:stage3's order), A the fp32 row tile At (K = D columns)
// from k-row k0, split in registers, two k8 steps a window; then the chunk
// added into the master m (a promotion). B the staged chunk at shared
// address b (hi, the lo block kcap kSliceF32 4 bytes on).
template <int D, int S, int MN, int CN>
__device__ __forceinline__ void attend_tf32(float (&m)[MN], float (&c)[CN], const float* At,
                                            int k0, int nk, uint32_t b, int kcap, int r0,
                                            int t) {
  constexpr int SL = kSliceF32;
  static_assert((S + 1) * SL / 2 <= MN && SL / 2 <= CN, "slice, chunk");
#pragma unroll
  for (int i = 0; i < SL / 2; ++i) c[i] = 0.f;
#pragma unroll 1
  for (int k = 0; k < nk; k += 16) {
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) tf32::load_a<D>(At, (k0 + k) / 8 + i, r0, t, hi[i], lo[i]);
    const uint32_t bk = b + (k / 8) * (32 * SL);
    uint64_t bh = hopper::desc(bk, 128, 256), bl = hopper::desc(bk + kcap * SL * 4, 128, 256);
    hopper::wgmma_fence();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tf32::Wgmma<SL>::mma(c, lo[i], bh, 1);
      tf32::Wgmma<SL>::mma(c, hi[i], bl, 1);
      tf32::Wgmma<SL>::mma(c, hi[i], bh, 1);
      if (i == 0) {  // the next k8 step: 32 SL bytes on in both blocks
        asm volatile("add.s64 %0, %0, %1;\n" : "+l"(bh) : "n"(2 * SL));
        asm volatile("add.s64 %0, %0, %1;\n" : "+l"(bl) : "n"(2 * SL));
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(c, 0, SL / 2);
  }
#pragma unroll
  for (int i = 0; i < SL / 2; ++i) m[S * SL / 2 + i] += c[i];
}

// acc *= 1 / (z + eps) for the column pairs j = J0 .. J0 + NJ - 1 (col(j):
// the pair's first column, 8 j' + 2 t for the thread's quad lane t), z =
// sum over the column's head of Q'(hh, c) K_sum[c] in fp32, made once for
// each run of columns in one head: zh and inv carry the last head's across
// calls. Where hd is a multiple of 8 the 8 columns of a group lie in one
// head, shared by the 4 lanes of a quad: each lane sums a quarter of the
// head's columns (one fmaf chain) and the quad adds the quarters by
// shuffles, the same bits in every lane (the branch is warp-uniform: a
// group's head does not depend on the row). Otherwise each lane makes its
// own columns' heads, one fmaf chain over the head.
template <int J0, int NJ, int NA, class ColF, class QF>
__device__ __forceinline__ void normalize(float (&acc)[NA], ColF col, QF q, const float* kss,
                                          int hd, float eps, int& zh, float (&inv)[2]) {
  if (hd % 8 == 0) {
    const int t = (col(J0) >> 1) & 3, q4 = hd >> 2;
#pragma unroll
    for (int j = J0; j < J0 + NJ; ++j) {
      int c = col(j) & ~7;
      asm volatile("" : "+r"(c));
      const int h = c / hd;
      if (h != zh) {
        float z[2] = {0.f, 0.f};
        const int i0 = h * hd + t * q4;
#pragma unroll 1
        for (int i = i0; i < i0 + q4; ++i) {
          const float k = kss[i];
          z[0] = fmaf(q(0, i), k, z[0]);
          z[1] = fmaf(q(1, i), k, z[1]);
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          z[0] += __shfl_xor_sync(0xffffffffu, z[0], o);
          z[1] += __shfl_xor_sync(0xffffffffu, z[1], o);
        }
        inv[0] = 1.f / (z[0] + eps);
        inv[1] = 1.f / (z[1] + eps);
        zh = h;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[4 * j + e] *= inv[0];
        acc[4 * j + 2 + e] *= inv[1];
      }
    }
    return;
  }
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
