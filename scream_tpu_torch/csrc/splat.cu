// Two-channel Gaussian max-splat for Hopper (sm_90a): the depth renderer's
// hot op.
//
// max_splat_kernel replaces scream_tpu/ops/splat_pallas.py:_splat_kernel
// (_splat_forward, reached through max_splat from
// scream_tpu/ops/render.py:render_depth_images). For every image i, pixel p
// and channel c (src, tgt):
//   img[i, c, p] = max over points n of vals[i, n, c] * exp(-d2 * rho^2 / 2)
//   arg[i, c, p] = the lowest n attaining that max,
// with d2 = max((|xy_n|^2 + |pix_p|^2) - 2 (x_n px + y_n py), 0).
//
// Arithmetic: d2 is evaluated in that order with round-to-nearest
// intrinsics, so nvcc contracts nothing into FMAs, then w = expf(d2 * c)
// (c = -rho^2/2 rounded to fp32, full-precision expf) and the channel
// contributions vals * w. The plain PyTorch version (ops/splat_cuda.py)
// computes the same expression elementwise in the same order, so the two
// agree bit for bit. Ties: the TPU kernel takes the first index >= max
// within a 1,024-point tile and a later tile only if strictly greater, which
// is the lowest index attaining the max; here one ascending scan over the
// points with a strict > gives the same winner. No rows are padded, so a
// pixel where every contribution is 0 (exp underflows far from all points
// at rho 24) is won by point 0, as on the TPU, whose padded rows come last.
//
// Pixel centres: pixel p is (col p % w, row p / w), mapped to
// ((col, row) - w/2 + 0.5) / (w/2) with round-to-nearest fp32 sub, add and
// div in ops/splat_cuda.py:pixel_grid's order, so no grid is read. (On
// CUDA tensors torch divides by a scalar as a product with its reciprocal,
// the same value wherever w/2 is a power of two, as at every shipped width.)
//
// What bounds it on the H100: each (point, pixel) pair costs ~12 fp32
// operations plus one expf against 16 bytes a point, so it
// is bound by fp32 CUDA-core operations: at the training shape (48 images,
// 8,192 points, 64 x 64 pixels) 1.61e9 pairs, ~0.3 ms at 67 TFLOP/s, while
// the ~9 MB of points and images take ~3 us of HBM time. The design, the
// first simple one: one block per (image, 256-pixel tile), one thread per
// pixel holding both channels' running (max, argmax) in registers; the
// image's points stream through shared memory in tiles of 1,024 (x, y,
// v_src, v_tgt as one 16-byte float4, |xy|^2 computed once per staged
// point) and every thread reads the same point at once (a broadcast). At
// the training shape the grid is 16 x 48 = 768 blocks, all resident at once
// on 132 SMs. The TPU kernel's 1,024 x 1,024 VMEM tiles are not copied.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SP_THREADS = 256;  // pixels per block, one per thread
constexpr int SP_TILE = 1024;    // points staged in shared memory per step

__global__ void __launch_bounds__(SP_THREADS)
max_splat_kernel(const float2* __restrict__ xy, const float2* __restrict__ vals,
                 float* __restrict__ img, int32_t* __restrict__ arg, int N, int w,
                 float neg_half_rho_sq) {
  __shared__ float4 pts[SP_TILE];
  __shared__ float psq[SP_TILE];
  const int P = w * w;
  const int im = blockIdx.y;
  const int p = blockIdx.x * SP_THREADS + threadIdx.x;
  const bool valid = p < P;
  const float half = (float)(w / 2);
  float2 px;
  px.x = __fdiv_rn(__fadd_rn(__fsub_rn((float)(p % w), half), 0.5f), half);
  px.y = __fdiv_rn(__fadd_rn(__fsub_rn((float)(p / w), half), 0.5f), half);
  const float xsq = __fadd_rn(__fmul_rn(px.x, px.x), __fmul_rn(px.y, px.y));
  const float2* xyb = xy + (size_t)im * N;
  const float2* vb = vals + (size_t)im * N;

  float best0 = -INFINITY, best1 = -INFINITY;
  int32_t arg0 = 0, arg1 = 0;
  for (int n0 = 0; n0 < N; n0 += SP_TILE) {
    const int cnt = min(SP_TILE, N - n0);
    for (int j = threadIdx.x; j < cnt; j += SP_THREADS) {
      const float2 q = xyb[n0 + j];
      const float2 v = vb[n0 + j];
      pts[j] = make_float4(q.x, q.y, v.x, v.y);
      psq[j] = __fadd_rn(__fmul_rn(q.x, q.x), __fmul_rn(q.y, q.y));
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float4 q = pts[j];
      const float cross = __fadd_rn(__fmul_rn(q.x, px.x), __fmul_rn(q.y, px.y));
      const float d2 =
          fmaxf(__fsub_rn(__fadd_rn(psq[j], xsq), __fmul_rn(2.0f, cross)), 0.0f);
      const float w = expf(__fmul_rn(d2, neg_half_rho_sq));
      const float c0 = __fmul_rn(q.z, w);
      const float c1 = __fmul_rn(q.w, w);
      if (c0 > best0) { best0 = c0; arg0 = n0 + j; }
      if (c1 > best1) { best1 = c1; arg1 = n0 + j; }
    }
    __syncthreads();
  }
  if (valid) {
    const size_t o = (size_t)im * 2 * P + p;
    img[o] = best0;
    img[o + P] = best1;
    arg[o] = arg0;
    arg[o + P] = arg1;
  }
}

}  // namespace

extern "C" {

// xy (I, N, 2), vals (I, N, 2) fp32 -> img (I, 2, w*w) fp32 and
// arg (I, 2, w*w) int32; neg_half_rho_sq = -rho^2 / 2. One launch.
int scream_max_splat(const void* xy, const void* vals, void* img, void* arg, int I,
                     int N, int w, float neg_half_rho_sq, void* stream) {
  dim3 grid((w * w + SP_THREADS - 1) / SP_THREADS, I);
  max_splat_kernel<<<grid, SP_THREADS, 0, (cudaStream_t)stream>>>(
      (const float2*)xy, (const float2*)vals, (float*)img, (int32_t*)arg, N, w,
      neg_half_rho_sq);
  return (int)cudaGetLastError();
}

}  // extern "C"
