// Nearest-neighbour search for Hopper (sm_90a): exact and threshold-bounded.
//
// nn_exact replaces scream_tpu/ops/nn_pallas.py:_nn_kernel
// (nearest_neighbor_pallas, the pose solve's NN): for every src point, the
// minimum over dst of d2 = (|d|^2 + |s|^2) - 2 (d . s) and the first dst
// index attaining it; masked dst rows were moved to FAR = 2e17 by the
// wrapper, so they never win.
//
// nn_bounded replaces scream_tpu/ops/nn_pallas.py:_nn_bounded_batched_fine_kernel
// (_bounded_batched, the batched ICP's NN) and, launched at B = 1,
// scream_tpu/ops/nn_pallas.py:_nn_bounded_kernel (_bounded_impl, the
// single-pair ICP's NN); the TPU's coarse (_nn_bounded_batched_kernel) and
// grouped (_nn_bounded_batched_fine4_kernel) tilings compute the same
// function. Contract: exact for every src point whose true NN lies within
// the threshold; a (128-point src sub-slab, 256-row dst tile) pair whose
// bounding boxes are farther apart than the threshold (gap^2 > thresh^2,
// strict) is skipped, a dead lane skips every tile, and a point with no
// live tile keeps (3e38, (0, 0, 0)). The winner's xyz is written by the
// kernel, never gathered after it.
//
// Both use the distance expression of the TPU kernels, evaluated in this
// order with round-to-nearest intrinsics so nvcc contracts nothing into
// FMAs: d_sq = (dx*dx + dy*dy) + dz*dz, cross = (dx*sx + dy*sy) + dz*sz,
// d2 = (d_sq + s_sq) - 2*cross. The plain PyTorch versions
// (ops/nn_cuda.py) compute the same expression elementwise, so kernel and
// plain agree bit for bit, and ties break to the lowest index as argmin does
// (a sequential scan over dst with strict <).
//
// What bounds them on the H100: with K = 3 the distance is ~10 issued
// fp32 instructions per (src, dst) pair (five products and adds for the
// cross term, which no FMA may contract, |d|^2 + |s|^2, one fmaf, a compare
// and two selects) against 12 bytes per point, so both are bound by the
// CUDA cores' instruction rate (132 SMs x 128 lanes x 1.98 GHz; TF32
// tensor cores would change distances and ties). The exact NN does 16 x 4096 x 4096
// pairs at the main path's shape (~0.08 ms at that rate); the bounded NN
// does only the pairs of live tiles, which at ICP's shapes is microseconds
// of work, so its call is bound by the launch path instead. The designs:
//   * exact: each thread keeps EX_R = 4 src points and their running (min,
//     index) in registers, so one staged dst row serves four pairs; dst
//     streams through shared memory in ascending order as float4 (x, y, z,
//     |d|^2, computed once per staged row), one 16-byte broadcast load a
//     row; the d2 expression's last step is fmaf(-2, cross, |d|^2 + |s|^2),
//     the rounding of (|d|^2 + |s|^2) - 2 cross since 2 cross is exact.
//     Where B x src slabs would leave SMs idle, dst is split over the blocks
//     of a thread-block cluster (ops/nn_cuda.py:exact_splits: 8 at 16 x
//     4,096 and at path 2's B = 1, 7, 8), so that ~4 blocks of 4 warps
//     share an SM;
//   * bounded: one thread owns one src point and keeps its running (min,
//     xyz) in registers; the box test is uniform across its block, so a
//     pruned tile costs one 6-float read and no shared-memory traffic;
//   * one launch per ICP step: the dst tile boxes come from
//     tile_boxes_kernel once per ICP call (ICP's dst does not change across
//     its iterations) and are passed in; the dead flags are read as the bool
//     tensor's bytes;
//   * the bounded kernel's grid is (dst splits, src sub-slabs, B). Where
//     B x sub-slabs would leave the card idle (B = 1) the dst tiles are
//     split over up to 8 blocks, a number set by the shape
//     (ops/nn_cuda.py:bounded_splits);
//   * in both, each split scans its run of dst in ascending order with a
//     strict < and keeps a partial winner per src point in shared memory.
//     The splits of one (b, src slab) form a thread-block cluster: after a
//     cluster barrier, rank 0 reads the partials through distributed shared
//     memory and merges them in ascending split order with a strict <
//     (merge_splits), so ties keep the lowest dst index, as one scan would.
//     One launch, no workspace, no counters, no atomics: deterministic.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_launch.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int EX_THREADS = 128;   // exact: threads per block
constexpr int EX_R = 4;           // exact: src points per thread, in registers
constexpr int EX_SLAB = EX_THREADS * EX_R;  // exact: src points per block
constexpr int EX_TILE = 512;      // exact: dst rows staged per step
constexpr int BD_THREADS = 128;   // bounded: src sub-slab (one point each)
constexpr int BD_TILE = 256;      // bounded: dst rows per tile (box granularity)
constexpr int MAX_SPLITS = 8;    // dst splits per cluster: the portable cluster size
constexpr float NO_HIT = 3.0e38f;
constexpr float FAR_HALF = 1.0e17f;  // half the wrapper's FAR = 2e17

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ float dist2(float dsq, float ssq, float dx, float dy,
                                       float dz, float sx, float sy, float sz) {
  const float cross =
      __fadd_rn(__fadd_rn(__fmul_rn(dx, sx), __fmul_rn(dy, sy)), __fmul_rn(dz, sz));
  return __fsub_rn(__fadd_rn(dsq, ssq), __fmul_rn(2.0f, cross));
}

// Rank 0's merge of the splits' partial winners of slot k: `part` holds a
// split's winner per slot, its distance in .x; ascending split order with a
// strict <. Between two cluster barriers (the partials written, then read).
template <typename T>
__device__ __forceinline__ T merge_splits(cg::cluster_group& cluster, T* part, int k) {
  T w = part[k];
  for (int r = 1; r < (int)cluster.num_blocks(); ++r) {
    const T q = cluster.map_shared_rank(part, r)[k];
    if (q.x < w.x) w = q;
  }
  return w;
}

// Grid (splits, src slabs, B), clusters of `splits` blocks along x; split s
// scans dst rows s rps .. s rps + rps - 1. Src point r of thread t in a
// slab is slab * EX_SLAB + r * EX_THREADS + t.
__global__ void __launch_bounds__(EX_THREADS)
nn_exact_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                float* __restrict__ min_out, int64_t* __restrict__ idx_out,
                int N, int M, int rps) {
  __shared__ float4 rows[EX_TILE];
  __shared__ float2 part[EX_SLAB];  // this split's (min, index bits) per src point
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * EX_SLAB + threadIdx.x;
  float sx[EX_R], sy[EX_R], sz[EX_R], ssq[EX_R], best[EX_R];
  int bi[EX_R];
#pragma unroll
  for (int r = 0; r < EX_R; ++r) {
    const int i = i0 + r * EX_THREADS;
    const float* sp = src + ((size_t)b * N + (i < N ? i : 0)) * 3;
    sx[r] = sp[0]; sy[r] = sp[1]; sz[r] = sp[2];
    ssq[r] = sq3(sx[r], sy[r], sz[r]);
    best[r] = INFINITY;
    bi[r] = 0;
  }
  const float* db = dst + (size_t)b * M * 3;
  const int m_end = min(M, (split + 1) * rps);
  for (int m0 = split * rps; m0 < m_end; m0 += EX_TILE) {
    const int cnt = min(EX_TILE, m_end - m0);
    for (int j = threadIdx.x; j < cnt; j += EX_THREADS) {
      const float* dp = db + (size_t)(m0 + j) * 3;
      const float x = dp[0], y = dp[1], z = dp[2];
      rows[j] = make_float4(x, y, z, sq3(x, y, z));
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < cnt; ++j) {
      const float4 d = rows[j];
#pragma unroll
      for (int r = 0; r < EX_R; ++r) {
        const float cross = __fadd_rn(
            __fadd_rn(__fmul_rn(d.x, sx[r]), __fmul_rn(d.y, sy[r])), __fmul_rn(d.z, sz[r]));
        const float d2 = __fmaf_rn(-2.0f, cross, __fadd_rn(d.w, ssq[r]));
        if (d2 < best[r]) { best[r] = d2; bi[r] = m0 + j; }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < EX_R; ++r)
    part[r * EX_THREADS + threadIdx.x] = make_float2(best[r], __int_as_float(bi[r]));
  cluster.sync();  // every split's partials are in its shared memory
  if (split == 0) {
#pragma unroll
    for (int r = 0; r < EX_R; ++r) {
      const int i = i0 + r * EX_THREADS;
      const float2 w = merge_splits(cluster, part, r * EX_THREADS + threadIdx.x);
      if (i < N) {
        min_out[(size_t)b * N + i] = fmaxf(w.x, 0.f);
        idx_out[(size_t)b * N + i] = __float_as_int(w.y);
      }
    }
  }
  cluster.sync();  // rank 0 has read every partial before any block exits
}

// Min or max of v over a block of NWARPS warps; every thread gets the result.
template <int NWARPS>
__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : fminf(v, w);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int k = 1; k < NWARPS; ++k) v = is_max ? fmaxf(v, red[k]) : fminf(v, red[k]);
  return v;
}

// Per-tile boxes of dst for the bounded kernel: grid (mt, B), one thread per
// row. Rows at FAR (masked) and rows past M are left out, so an all-masked
// tile gets the empty box (+inf, -inf), which never passes the gap test.
__global__ void __launch_bounds__(BD_TILE)
tile_boxes_kernel(const float* __restrict__ dst, float* __restrict__ boxes,
                  int M, int mt) {
  __shared__ float red[BD_TILE / 32];
  const int t = blockIdx.x, b = blockIdx.y;
  const int j = t * BD_TILE + threadIdx.x;
  float x = 0.f, y = 0.f, z = 0.f;
  bool valid = false;
  if (j < M) {
    const float* dp = dst + ((size_t)b * M + j) * 3;
    x = dp[0]; y = dp[1]; z = dp[2];
    valid = x < FAR_HALF;
  }
  float out[6];
  out[0] = block_reduce<BD_TILE / 32>(valid ? x : INFINITY, false, red);
  out[1] = block_reduce<BD_TILE / 32>(valid ? y : INFINITY, false, red);
  out[2] = block_reduce<BD_TILE / 32>(valid ? z : INFINITY, false, red);
  out[3] = block_reduce<BD_TILE / 32>(valid ? x : -INFINITY, true, red);
  out[4] = block_reduce<BD_TILE / 32>(valid ? y : -INFINITY, true, red);
  out[5] = block_reduce<BD_TILE / 32>(valid ? z : -INFINITY, true, red);
  if (threadIdx.x < 6) boxes[((size_t)b * mt + t) * 6 + threadIdx.x] = out[threadIdx.x];
}

// boxes: (B, mt, 6) fp32 per dst tile (tile_boxes_kernel): lo xyz, hi xyz.
// Grid (splits, sub-slabs, B), clusters of `splits` blocks along x; split
// s scans tiles s tps .. s tps + tps - 1. dead: (B,) bytes, 0 = live, or
// null for none.
__global__ void __launch_bounds__(BD_THREADS)
nn_bounded_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                  const float* __restrict__ boxes,
                  const uint8_t* __restrict__ dead, float thresh_sq,
                  float* __restrict__ min_out, float* __restrict__ xyz_out,
                  int N, int M, int mt, int tps) {
  __shared__ float tx[BD_TILE], ty[BD_TILE], tz[BD_TILE], tq[BD_TILE];
  __shared__ float red[BD_THREADS / 32];
  __shared__ float4 part[BD_THREADS];  // this split's (min, x, y, z) per point
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int b = blockIdx.z;
  const int i = blockIdx.y * BD_THREADS + threadIdx.x;
  const bool valid = i < N;
  const float* sp = src + ((size_t)b * N + (valid ? i : 0)) * 3;
  const float sx = sp[0], sy = sp[1], sz = sp[2];

  float best = NO_HIT, bx = 0.f, by = 0.f, bz = 0.f;
  if (!(dead && dead[b])) {  // uniform across the block
    const float ssq = sq3(sx, sy, sz);
    // The sub-slab's box over its in-range points.
    const float lox = block_reduce<BD_THREADS / 32>(valid ? sx : INFINITY, false, red);
    const float loy = block_reduce<BD_THREADS / 32>(valid ? sy : INFINITY, false, red);
    const float loz = block_reduce<BD_THREADS / 32>(valid ? sz : INFINITY, false, red);
    const float hix = block_reduce<BD_THREADS / 32>(valid ? sx : -INFINITY, true, red);
    const float hiy = block_reduce<BD_THREADS / 32>(valid ? sy : -INFINITY, true, red);
    const float hiz = block_reduce<BD_THREADS / 32>(valid ? sz : -INFINITY, true, red);
    const float* db = dst + (size_t)b * M * 3;
    const float* bb = boxes + (size_t)b * mt * 6;
    const int t1 = min(mt, (split + 1) * tps);
    for (int t = split * tps; t < t1; ++t) {
      const float* bt = bb + (size_t)t * 6;
      const float gx = fmaxf(fmaxf(lox - bt[3], bt[0] - hix), 0.f);
      const float gy = fmaxf(fmaxf(loy - bt[4], bt[1] - hiy), 0.f);
      const float gz = fmaxf(fmaxf(loz - bt[5], bt[2] - hiz), 0.f);
      const float gap2 = sq3(gx, gy, gz);
      if (!(gap2 <= thresh_sq)) continue;  // prune: gap^2 > thresh^2 (or NaN box)
      const int m0 = t * BD_TILE;
      const int cnt = min(BD_TILE, M - m0);
      for (int j = threadIdx.x; j < cnt; j += BD_THREADS) {
        const float* dp = db + (size_t)(m0 + j) * 3;
        const float x = dp[0], y = dp[1], z = dp[2];
        tx[j] = x; ty[j] = y; tz[j] = z;
        tq[j] = sq3(x, y, z);
      }
      __syncthreads();
      int win = -1;
      for (int j = 0; j < cnt; ++j) {
        const float d2 = dist2(tq[j], ssq, tx[j], ty[j], tz[j], sx, sy, sz);
        if (d2 < best) { best = d2; win = j; }
      }
      if (win >= 0) { bx = tx[win]; by = ty[win]; bz = tz[win]; }
      __syncthreads();
    }
  }
  part[threadIdx.x] = make_float4(best, bx, by, bz);
  cluster.sync();  // every split's partial is in its shared memory
  if (split == 0) {
    const float4 w = merge_splits(cluster, part, threadIdx.x);
    if (valid) {
      const size_t o = (size_t)b * N + i;
      min_out[o] = fmaxf(w.x, 0.f);
      xyz_out[o * 3 + 0] = w.y;
      xyz_out[o * 3 + 1] = w.z;
      xyz_out[o * 3 + 2] = w.w;
    }
  }
  cluster.sync();  // rank 0 has read every partial before any block exits
}

}  // namespace

extern "C" {

// src (B, N, 3), dst (B, M, 3) fp32 with masked rows at FAR ->
// min_d2 (B, N) fp32 clamped at 0, idx (B, N) int64. dst splits over
// `splits` blocks (1..8) per src slab. One launch.
int scream_nn_exact(const void* src, const void* dst, void* min_d2, void* idx,
                    int B, int N, int M, int splits, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  return (int)launch_clusters(nn_exact_kernel, dim3(splits, (N + EX_SLAB - 1) / EX_SLAB, B),
                              EX_THREADS, splits, stream, (const float*)src, (const float*)dst,
                              (float*)min_d2, (int64_t*)idx, N, M, (M + splits - 1) / splits);
}

// dst (B, M, 3) fp32 with masked rows at FAR -> boxes (B, ceil(M/256), 6)
// fp32: lo xyz, hi xyz of each tile's valid rows. One launch.
int scream_nn_tile_boxes(const void* dst, void* boxes, int B, int M, void* stream) {
  if (B <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const int mt = (M + BD_TILE - 1) / BD_TILE;
  tile_boxes_kernel<<<dim3(mt, B), BD_TILE, 0, (cudaStream_t)stream>>>(
      (const float*)dst, (float*)boxes, M, mt);
  return (int)cudaGetLastError();
}

// src (B, N, 3), dst (B, M, 3) fp32 with masked rows at FAR, boxes from
// scream_nn_tile_boxes, dead (B,) bytes or null -> min_d2 (B, N),
// xyz (B, N, 3). The dst tiles split over `splits` blocks (1..8) per
// sub-slab. One launch.
int scream_nn_bounded(const void* src, const void* dst, const void* boxes,
                      const void* dead, float thresh_sq, void* min_d2, void* xyz,
                      int B, int N, int M, int splits, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int mt = (M + BD_TILE - 1) / BD_TILE;
  return (int)launch_clusters(nn_bounded_kernel,
                              dim3(splits, (N + BD_THREADS - 1) / BD_THREADS, B), BD_THREADS,
                              splits, stream, (const float*)src, (const float*)dst,
                              (const float*)boxes, (const uint8_t*)dead, thresh_sq,
                              (float*)min_d2, (float*)xyz, N, M, mt, (mt + splits - 1) / splits);
}

}  // extern "C"
