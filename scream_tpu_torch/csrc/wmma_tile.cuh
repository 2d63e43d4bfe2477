// Tile helpers of the WMMA kernel (attn.cu's stats kernel): bf16 16x16x16
// fragments with fp32 accumulators, a warp's share of a product with its A
// operand in shared memory and its B operand (a weight) in global memory,
// and row loads with a zero-filled ragged edge. The apply and tail kernels
// run on the Hopper pipeline of hopper_tile.cuh instead.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace scream {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// One warp's share of C (+)= A @ B: RF row fragments x CF column fragments.
// A: shared memory, row-major, lda (points at the warp's first row and k=0).
// B: global memory (L2-resident weights), row-major, ldb (points at k=0 and
// the warp's first column). K is a multiple of 16.
template <int RF, int CF>
__device__ __forceinline__ void warp_mma(FragC (&acc)[RF][CF], const bf16* A,
                                         int lda, const bf16* B, int ldb,
                                         int K) {
  for (int k = 0; k < K; k += 16) {
    FragB fb[CF];
#pragma unroll
    for (int j = 0; j < CF; ++j)
      wmma::load_matrix_sync(fb[j], B + (size_t)k * ldb + j * 16, ldb);
#pragma unroll
    for (int i = 0; i < RF; ++i) {
      FragA fa;
      wmma::load_matrix_sync(fa, A + (size_t)i * 16 * lda + k, lda);
#pragma unroll
      for (int j = 0; j < CF; ++j) wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
    }
  }
}

template <int RF, int CF>
__device__ __forceinline__ void warp_zero(FragC (&acc)[RF][CF]) {
#pragma unroll
  for (int i = 0; i < RF; ++i)
#pragma unroll
    for (int j = 0; j < CF; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

template <int RF, int CF>
__device__ __forceinline__ void warp_store(FragC (&acc)[RF][CF], float* C,
                                           int ldc) {
#pragma unroll
  for (int i = 0; i < RF; ++i)
#pragma unroll
    for (int j = 0; j < CF; ++j)
      wmma::store_matrix_sync(C + (size_t)i * 16 * ldc + j * 16, acc[i][j], ldc,
                              wmma::mem_row_major);
}

// Copy `rows` x D bf16 rows from global (row r0 on) into shared memory with
// the block's NT threads, zero-filling rows at or beyond `limit`.
template <int D, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int rows, int limit) {
  constexpr int per_row = D / 8;  // uint4 = 8 bf16
  for (int i = threadIdx.x; i < rows * per_row; i += NT) {
    const int r = i / per_row, c = i % per_row;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      v = reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D)[c];
    reinterpret_cast<uint4*>(dst)[i] = v;
  }
}

}  // namespace scream
