// Fused attention-block tail in float32 for Hopper (sm_90a): the float32
// instantiation of tail.cu.
//
// tail_f32_kernel replaces scream_tpu/ops/ffn_pallas.py:_tail_kernel as
// _tail_pallas runs it for the float32 configuration (prec = HIGHEST,
// weights fp32), where the fused attention block does not apply: at
// d_model 384 (the fused block is over the JAX package's VMEM budget
// there, the tail is not) and at d 128 / 256 under fused_attention=False.
// Per row, with x the attention output and q the block input:
//
//   t = x @ Wm + q; y = LN1(t); h = relu(y @ W1); u = q + h @ W2;
//   out = LN2(u),
//
// all in fp32 (f32_tile.cuh:tail_body), LayerNorm with fp32 statistics,
// var = max(0, E[x^2] - mu^2), as flax computes it.
//
// What bounds it on the H100: 2 R d (d + 2 hid) fp32 operations against
// 3 R d + d (d + 2 hid) fp32 words, ~1,000 operations a byte at d 384,
// hidden 1536, so fp32 FMA (67 TFLOP/s) bounds it, not HBM. What the
// design does about it: the three products are register-tiled fp32 FMA
// (f32_tile.cuh:gemm) with the weights streamed through a two-chunk
// cp.async ring in shared memory, the hidden in chunks of 128 columns
// whose W2 products add into the output's registers, and nothing
// intermediate goes to device memory. Row tiles of 64 rows, one block
// each, so each weight byte streamed from L2 feeds 64 rows (32-row tiles at
// d 384, the first version, streamed twice the bytes and were slower than
// the plain version, PERF.md); the ragged last tile is zero-filled and not
// stored. At d 384 the tile, a hidden chunk and 16-row weight chunks take
// 176 KB of shared memory.
//
// Widths: a template on D, instantiated at every fp32 width where the JAX
// package's tail rule (ffn_pallas.fusable) holds at hidden 4d: d in
// {128, 256, 384}; the hidden may be any multiple of 128.
//
// Layout contract (checked by the Python wrapper, ops/tail_cuda.py): x, q
// and out (R, d) fp32; Wm (d, d), W1 (d, hid), W2 (hid, d) fp32 (in, out)
// row-major, read as they are (no pack); g1, b1, g2, b2 (d,) fp32; all
// contiguous and 16-byte aligned.

#include "f32_tile.cuh"

namespace {

using namespace scream::f32;

template <int D>
struct TailCfg {
  static constexpr int TM = 64, RM = TM / 8, G = D / 128;
  // The row tile, one hidden chunk, the weight chunks.
  static constexpr int SMEM = (TM * D + TM * 128 + tail_wbuf<D>()) * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
tail_f32_kernel(const float* __restrict__ x, const float* __restrict__ q,
                const float* __restrict__ wm, const float* __restrict__ g1,
                const float* __restrict__ b1, const float* __restrict__ w1,
                const float* __restrict__ w2, const float* __restrict__ g2,
                const float* __restrict__ b2, float* __restrict__ out, int R, int hid, float eps,
                int norm_bf16) {
  using C = TailCfg<D>;
  extern __shared__ __align__(16) float smem[];
  float* A = smem;
  float* Hs = A + C::TM * D;
  float* wbuf = Hs + C::TM * 128;
  const int row0 = blockIdx.x * C::TM;
  const int nvalid = min(C::TM, R - row0);
  load_rows<C::RM, C::G, D>(x + (size_t)row0 * D, A, nvalid);
  tail_body<C::RM, C::G, D>(A, Hs, wbuf, wm, g1, b1, w1, w2, g2, b2, q + (size_t)row0 * D,
                            out + (size_t)row0 * D, nvalid, hid, eps, norm_bf16 != 0);
}

template <int D>
int launch_tail(const void* x, const void* q, const void* wm, const void* g1, const void* b1,
                const void* w1, const void* w2, const void* g2, const void* b2, void* out,
                int R, int hid, float eps, int norm_bf16, cudaStream_t stream) {
  using C = TailCfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      tail_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  tail_f32_kernel<D><<<(R + C::TM - 1) / C::TM, kThreads, C::SMEM, stream>>>(
      (const float*)x, (const float*)q, (const float*)wm, (const float*)g1, (const float*)b1,
      (const float*)w1, (const float*)w2, (const float*)g2, (const float*)b2, (float*)out, R,
      hid, eps, norm_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, q (R, d) fp32, d in {128, 256, 384}, hidden a multiple of 128, weights
// (in, out) fp32 -> out (R, d) fp32; norm_bf16 rounds the LayerNorm outputs
// through bf16 (norm dtype bf16).
int scream_block_tail_f32(const void* x, const void* q, const void* wm, const void* g1,
                          const void* b1, const void* w1, const void* w2, const void* g2,
                          const void* b2, void* out, int R, int d, int hid, float eps,
                          int norm_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R <= 0 || hid <= 0 || hid % 128) return (int)cudaErrorInvalidValue;
#define SCREAM_TAIL_F32(D)                                                                 \
  if (d == D)                                                                              \
    return launch_tail<D>(x, q, wm, g1, b1, w1, w2, g2, b2, out, R, hid, eps, norm_bf16, s);
  SCREAM_TAIL_F32(128)
  SCREAM_TAIL_F32(256)
  SCREAM_TAIL_F32(384)
#undef SCREAM_TAIL_F32
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
