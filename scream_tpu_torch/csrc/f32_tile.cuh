// fp32 building blocks of the float32 block-tail kernel for Hopper
// (sm_90a, tail_f32.cu): a register-tiled fp32 FMA product over a row tile
// in shared memory, the row LayerNorm, and the block tail.
//
// tail_f32.cu replaces scream_tpu/ops/ffn_pallas.py:_tail_kernel for the
// float32 configuration (prec = HIGHEST). What bounds it on the H100: fp32
// FMA on the CUDA cores (67 TFLOP/s): at d 384, 8 x 4,096 rows, hidden
// 1,536 it does ~87 GFLOP, 1.30 ms at that rate, far above the fp32 ridge
// of 20 FLOP a byte. Every product here is fp32 FMA, each output one fmaf
// chain over k in ascending order, so a launch's result depends on neither
// the card nor the grid, and two launches agree bit for bit. (The fp32
// attention kernels, attn_f32.cu, run on the tensor cores as split-TF32
// wgmma, tf32_tile.cuh, which keeps the fp32 bars at three TF32 passes a
// product; the tail has not been redesigned that way.)
//
// Geometry: 256 threads, 8 warps. Warp w owns the RM rows w RM .. w RM +
// RM - 1 of a TM = 8 RM row tile; lane l owns the columns 128 g + 4 l ..
// 128 g + 4 l + 3 of each 128-column group g < G. So a warp holds whole
// rows in registers: the LayerNorms reduce across its lanes by shuffles,
// and the tiles in shared memory (the activations A, the hidden chunk Hs)
// are written and read by their own warp only. The weights are the one
// operand the warps share: a product streams W(k, .) through two
// shared-memory buffers of CK (32 or 16) k-rows each by cp.async, the next
// chunk in flight while the current one feeds the FMAs. Per 4 k a thread loads RM
// float4 of A (one address per warp: a broadcast) and 4 G float4 of W
// (512 contiguous bytes per warp: no bank conflict) for 16 RM G FMAs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace scream {
namespace f32 {

constexpr int kThreads = 256;  // 8 warps
constexpr int KC = 32;         // k-rows of a staged weight chunk (the default)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int RM, int N>
__device__ __forceinline__ void zero(float (&acc)[RM][N]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[i][e] = 0.f;
}

// acc[i][4 g + j] += sum_k A[(w RM + i) LDA + k] W(k, 128 g + 4 lane + j) for
// k = 0 .. K-1 in order, one fmaf chain per output. A is this warp's rows of
// a tile in shared memory; wsrc(k, c) points at the 16 bytes W(k, c .. c+3)
// in global memory (c a multiple of 4). W goes through wbuf in chunks of CK
// k-rows (2 CK 128 G floats); a smaller CK holds fewer copy addresses in
// registers. Every thread of the block calls it; it ends on a barrier, so
// wbuf may be refilled by the next call at once.
template <int RM, int G, int K, int LDA, int CK = KC, class Src>
__device__ __forceinline__ void gemm(float (&acc)[RM][4 * G], const float* A, float* wbuf,
                                     Src wsrc) {
  constexpr int N = 128 * G, NCH = K / CK, VEC = CK * N / 4;
  static_assert(K % CK == 0 && CK % 4 == 0 && VEC % kThreads == 0, "gemm: chunking");
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  auto stage = [&](int ch, float* buf) {
#pragma unroll
    for (int it = 0; it < VEC / kThreads; ++it) {
      const int v = threadIdx.x + it * kThreads;
      const int k = v / (N / 4), c = (v % (N / 4)) * 4;
      cp_async16(buf + k * N + c, wsrc(ch * CK + k, c));
    }
    cp_commit();
  };
  stage(0, wbuf);
  const float* arow = A + w * RM * LDA;
#pragma unroll 1
  for (int ch = 0; ch < NCH; ++ch) {
    const float* cur = wbuf + (ch & 1) * CK * N;
    if (ch + 1 < NCH) {
      stage(ch + 1, wbuf + ((ch + 1) & 1) * CK * N);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < CK; kk += 4) {
      float4 a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        a[i] = *reinterpret_cast<const float4*>(arow + i * LDA + ch * CK + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 b[G];
#pragma unroll
        for (int g = 0; g < G; ++g)
          b[g] = *reinterpret_cast<const float4*>(cur + (kk + u) * N + 128 * g + 4 * lane);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float av = comp(a[i], u);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            acc[i][4 * g + 0] = fmaf(av, b[g].x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(av, b[g].y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(av, b[g].z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(av, b[g].w, acc[i][4 * g + 3]);
          }
        }
      }
    }
    __syncthreads();
  }
}

// This warp's rows of acc into the tile T (row stride LD).
template <int RM, int G, int LD>
__device__ __forceinline__ void store_rows(const float (&acc)[RM][4 * G], float* T) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g)
      *reinterpret_cast<float4*>(T + (w * RM + i) * LD + 128 * g + 4 * lane) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
  __syncwarp();
}

// Rows of src (global, row stride D) below nvalid into this warp's rows of
// the tile T; rows at or past nvalid are zero.
template <int RM, int G, int D>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, float* T, int nvalid) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = w * RM + i;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = 128 * g + 4 * lane;
      *reinterpret_cast<float4*>(T + r * D + c) =
          r < nvalid ? __ldg(reinterpret_cast<const float4*>(src + (size_t)r * D + c))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncwarp();
}

// acc += res (global rows, stride D; rows at or past nvalid add nothing).
template <int RM, int G, int D>
__device__ __forceinline__ void add_rows(float (&acc)[RM][4 * G], const float* __restrict__ res,
                                         int nvalid) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = w * RM + i;
    if (r >= nvalid) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(res + (size_t)r * D + 128 * g +
                                                              4 * lane));
      acc[i][4 * g + 0] += v.x;
      acc[i][4 * g + 1] += v.y;
      acc[i][4 * g + 2] += v.z;
      acc[i][4 * g + 3] += v.w;
    }
  }
}

// LayerNorm of each row in registers, flax's math: fp32 statistics,
// var = max(0, E[x^2] - mu^2), y = (x - mu) (rsqrt(var + eps) g) + b,
// rounded through bf16 when the norm dtype is bf16 (nbf).
template <int RM, int G, int D>
__device__ __forceinline__ void layer_norm(float (&acc)[RM][4 * G], const float* __restrict__ gm,
                                           const float* __restrict__ bt, float eps, bool nbf) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * G; ++e) {
      s += acc[i][e];
      s2 = fmaf(acc[i][e], acc[i][e], s2);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mu = s / D;
    const float rs = rsqrtf(fmaxf(0.f, s2 / D - mu * mu) + eps);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = 128 * g + 4 * lane;
      const float4 gg = __ldg(reinterpret_cast<const float4*>(gm + c));
      const float4 bb = __ldg(reinterpret_cast<const float4*>(bt + c));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float y = (acc[i][4 * g + j] - mu) * (rs * comp(gg, j)) + comp(bb, j);
        acc[i][4 * g + j] = nbf ? round_bf16(y) : y;
      }
    }
  }
}

// The block tail on a row tile whose merge input (the attention output)
// is in this warp's rows of A, res the block input rows in global memory:
//
//   t = A @ Wm + res; y = LN1(t); f = sum over 128-column hidden chunks c
//   of relu(y @ W1[:, c]) @ W2[c, :]; out = LN2(res + f),
//
// rows below nvalid stored to out (global, stride D). Hs holds one hidden
// chunk (TM x 128); wbuf the weight chunks (tail_wbuf<D>() floats).
//
// At D 384 a thread holds 8 x 12 accumulators of f through the hidden
// loop; there the D-wide products (Wm, W2) stage 16 k-rows a chunk: with
// 32, 255 registers did not hold the kernel (8 bytes spilled).
template <int D>
__host__ __device__ constexpr int tail_ck() {
  return D > 256 ? 16 : KC;
}
template <int D>
__host__ __device__ constexpr int tail_wbuf() {
  return 2 * tail_ck<D>() * D > 2 * KC * 128 ? 2 * tail_ck<D>() * D : 2 * KC * 128;
}
template <int RM, int G, int D>
__device__ __forceinline__ void tail_body(float* A, float* Hs, float* wbuf,
                                          const float* __restrict__ wm,
                                          const float* __restrict__ g1,
                                          const float* __restrict__ b1,
                                          const float* __restrict__ w1,
                                          const float* __restrict__ w2,
                                          const float* __restrict__ g2,
                                          const float* __restrict__ b2,
                                          const float* __restrict__ res, float* __restrict__ out,
                                          int nvalid, int hid, float eps, bool nbf) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  constexpr int CK = tail_ck<D>();
  float acc[RM][4 * G];
  zero(acc);
  gemm<RM, G, D, D, CK>(acc, A, wbuf, [=](int k, int c) { return wm + (size_t)k * D + c; });
  add_rows<RM, G, D>(acc, res, nvalid);
  layer_norm<RM, G, D>(acc, g1, b1, eps, nbf);
  store_rows<RM, G, D>(acc, A);
  zero(acc);  // now f
#pragma unroll 1
  for (int c0 = 0; c0 < hid; c0 += 128) {
    float h[RM][4];
    zero(h);
    gemm<RM, 1, D, D>(h, A, wbuf,
                      [=](int k, int c) { return w1 + (size_t)k * hid + c0 + c; });
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[i][j] = h[i][j] > 0.f ? h[i][j] : 0.f;
    store_rows<RM, 1, 128>(h, Hs);
    gemm<RM, G, 128, 128, CK>(acc, Hs, wbuf,
                              [=](int k, int c) { return w2 + (size_t)(c0 + k) * D + c; });
  }
  add_rows<RM, G, D>(acc, res, nvalid);
  layer_norm<RM, G, D>(acc, g2, b2, eps, nbf);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = w * RM + i;
    if (r >= nvalid) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
      *reinterpret_cast<float4*>(out + (size_t)r * D + 128 * g + 4 * lane) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
  }
}

}  // namespace f32
}  // namespace scream
