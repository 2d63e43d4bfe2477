// Fused attention-block tail for Hopper (sm_90a).
//
// tail_kernel replaces scream_tpu/ops/ffn_pallas.py:_tail_kernel (reached
// through _tail_pallas and block_tail, where the fused attention block does
// not apply). Per row, with x the attention output and q the block input:
//
//   m = bf16(x @ Wm); t = bf16(m + q); y = bf16(LN1(t));
//   h = relu(bf16(y @ W1)); f = bf16(h @ W2); u = bf16(q + f);
//   out = bf16(LN2(u)),
//
// bf16 operands with fp32 accumulation, rounding to bf16 where the plain
// version (ops/ffn.py:tail_plain) rounds; LayerNorm with fp32 statistics,
// var = max(0, E[x^2] - mu^2), as flax computes it.
//
// What bounds it on the H100: 18 R d^2 operations at hidden 4d against
// (3 R d + 9 d^2) bf16 bytes, ~1,800 operations per byte at d = 512 and
// R = 65,536, so tensor-core operations bound it, not HBM. What the design
// does about it, the first simple version (WMMA, no TMA/wgmma pipeline):
//   * All three products run on the tensor cores (WMMA bf16 16x16x16, fp32
//     accumulators in registers).
//   * Nothing intermediate goes to device memory: the x tile, then the LN1
//     output in its place, a fp32 staging tile and one 128-column chunk of
//     the hidden stay in shared memory; the hidden is made and consumed
//     chunk by chunk, the second product accumulating in registers.
//   * Each warp owns D / 8 output columns over all of the block's rows, so
//     each weight fragment is read from L2 once per block.
//   * A block takes 64 rows at d <= 256 and 32 at d 384 and 512, so a warp
//     holds at most 8 accumulator fragments (64 floats a thread) and
//     nothing spills; shared memory is 64-112 KB (above 48 KB by
//     cudaFuncSetAttribute). The residual q is read from global memory
//     where it is added, never staged.
//   * The ragged last tile is zero-filled on load and not stored.
//
// Widths: a template on D, instantiated at every bf16 width where the JAX
// package's tail rule (ffn_pallas.fusable) holds at hidden 4d: d in
// {128, 256, 384, 512}; the hidden may be any multiple of 128. The C entry
// point dispatches on d.
//
// Layout contract (checked by the Python wrapper, ops/tail_cuda.py): x, q
// and out (R, d) bf16; Wm (d, d), W1 (d, hid), W2 (hid, d) bf16 row-major
// ((in, out)); g1, b1, g2, b2 (d,) fp32; all contiguous and 32-byte aligned.

#include "wmma_tile.cuh"

namespace {

using namespace scream;

constexpr int NT = 256;      // threads per block (8 warps)
constexpr int NW = NT / 32;  // warps per block
constexpr int HC = 128;      // FFN hidden columns per chunk

template <int D>
struct Tail {
  static constexpr int TR = D <= 256 ? 64 : 32;  // rows per block
  static constexpr int RF = TR / 16;             // row fragments: 4, 2
  static constexpr int WC = D / NW;              // columns per warp
  static constexpr int CF = WC / 16;             // 1, 2, 3, 4
  static constexpr size_t SMEM = (size_t)TR * D * 2    // xs: x tile, then LN1 out
                                 + (size_t)TR * D * 4  // st: fp32 staging
                                 + (size_t)TR * HC * 2;  // hs: hidden chunk
  static_assert(D % HC == 0 && WC % 16 == 0 && RF * CF <= 8, "tiling");
};

// The residual q at (row, c), 0 past the last row.
__device__ __forceinline__ float q_at(const bf16* __restrict__ q, int row,
                                      int R, int D, int c) {
  return row < R ? __bfloat162float(q[(size_t)row * D + c]) : 0.f;
}

// grid (ceil(R / TR)), one block per TR rows.
template <int D>
__global__ void __launch_bounds__(NT)
tail_kernel(const bf16* __restrict__ x, const bf16* __restrict__ q,
            const bf16* __restrict__ wm, const float* __restrict__ g1,
            const float* __restrict__ b1, const bf16* __restrict__ w1,
            const bf16* __restrict__ w2, const float* __restrict__ g2,
            const float* __restrict__ b2, bf16* __restrict__ out, int R,
            int hid, float eps) {
  using C = Tail<D>;
  constexpr int TR = C::TR, RF = C::RF, WC = C::WC, CF = C::CF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* st = reinterpret_cast<float*>(smem + (size_t)TR * D * 2);
  bf16* hs = reinterpret_cast<bf16*>(smem + (size_t)TR * D * 2 + (size_t)TR * D * 4);

  const int r0 = blockIdx.x * TR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  load_rows<D, NT>(xs, x, r0, TR, R);
  __syncthreads();

  // m = x @ Wm; the warp owns columns warp * WC .. + WC over all TR rows.
  {
    FragC acc[RF][CF];
    warp_zero(acc);
    warp_mma(acc, xs, D, wm + warp * WC, D, D);
    warp_store(acc, st + warp * WC, D);
  }
  __syncthreads();

  // t = bf16(m) + q, LN1 -> xs (bf16); one warp per row.
  for (int r = warp; r < TR; r += NW) {
    float v[D / 32];
#pragma unroll
    for (int k = 0; k < D / 32; ++k) {
      const int c = lane + 32 * k;
      v[k] = round_bf16(round_bf16(st[(size_t)r * D + c]) + q_at(q, r0 + r, R, D, c));
    }
    ln_row<D>(v, g1, b1, eps, lane);
#pragma unroll
    for (int k = 0; k < D / 32; ++k)
      xs[(size_t)r * D + lane + 32 * k] = __float2bfloat16(v[k]);
  }
  __syncthreads();

  // FFN in hidden chunks: f += relu(bf16(y @ W1[:, chunk])) @ W2[chunk, :].
  // Each warp makes 16 of a chunk's HC columns.
  FragC facc[RF][CF];
  warp_zero(facc);
  for (int h0 = 0; h0 < hid; h0 += HC) {
    {
      FragC hacc[RF][1];
      warp_zero(hacc);
      warp_mma(hacc, xs, D, w1 + h0 + warp * (HC / NW), hid, D);
      warp_store(hacc, st + warp * (HC / NW), HC);
    }
    __syncthreads();
    for (int i = tid; i < TR * HC; i += NT)
      hs[i] = __float2bfloat16(fmaxf(round_bf16(st[i]), 0.f));
    __syncthreads();
    warp_mma(facc, hs, HC, w2 + (size_t)h0 * D + warp * WC, D, HC);
    __syncthreads();
  }
  warp_store(facc, st + warp * WC, D);
  __syncthreads();

  // u = q + bf16(f), LN2 -> out.
  for (int r = warp; r < TR; r += NW) {
    if (r0 + r >= R) break;  // rows ascend with r: the rest are past the end
    float v[D / 32];
#pragma unroll
    for (int k = 0; k < D / 32; ++k) {
      const int c = lane + 32 * k;
      v[k] = round_bf16(q_at(q, r0 + r, R, D, c) + round_bf16(st[(size_t)r * D + c]));
    }
    ln_row<D>(v, g2, b2, eps, lane);
    bf16* orow = out + (size_t)(r0 + r) * D;
#pragma unroll
    for (int k = 0; k < D / 32; ++k) orow[lane + 32 * k] = __float2bfloat16(v[k]);
  }
}

template <int D>
int launch_tail(const void* x, const void* q, const void* wm, const void* g1,
                const void* b1, const void* w1, const void* w2, const void* g2,
                const void* b2, void* out, int R, int hid, float eps,
                cudaStream_t stream) {
  constexpr size_t smem = Tail<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      tail_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tail_kernel<D><<<(R + Tail<D>::TR - 1) / Tail<D>::TR, NT, smem, stream>>>(
      (const bf16*)x, (const bf16*)q, (const bf16*)wm, (const float*)g1,
      (const float*)b1, (const bf16*)w1, (const bf16*)w2, (const float*)g2,
      (const float*)b2, (bf16*)out, R, hid, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, q (R, d) bf16, d in {128, 256, 384, 512}, hidden a multiple of 128 ->
// out (R, d) bf16.
int scream_block_tail(const void* x, const void* q, const void* wm,
                      const void* g1, const void* b1, const void* w1,
                      const void* w2, const void* g2, const void* b2, void* out,
                      int R, int d, int hid, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R <= 0 || hid <= 0 || hid % HC) return (int)cudaErrorInvalidValue;
#define SCREAM_TAIL(D)                                                        \
  if (d == D)                                                                 \
    return launch_tail<D>(x, q, wm, g1, b1, w1, w2, g2, b2, out, R, hid, eps, s);
  SCREAM_TAIL(128)
  SCREAM_TAIL(256)
  SCREAM_TAIL(384)
  SCREAM_TAIL(512)
#undef SCREAM_TAIL
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
