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
// R = 65,536, so tensor-core operations bound it, not HBM. Short of that,
// every block reads all of the weights (4.7 MB at d 512) through L2 once
// per row tile, and the tile height sets how many operations each of those
// bytes feeds. What the design does about it (tail_tile.cuh,
// hopper_tile.cuh):
//   * All three products run on wgmma (bf16 -> fp32, m64nNk16), the only
//     path to the card's tensor-core rate, with the row tile (x, then the
//     LN1 output, then each hidden chunk) as A in shared memory.
//   * The weights stream through a ring of 2-8 stages in shared memory,
//     filled by one producer thread with 1-D bulk copies (cp.async.bulk)
//     that complete on mbarriers; the wrapper packs the weights once per
//     call into the stages' byte order (pack_kernel below, launched by
//     ops/tail_cuda.py:pack_weights), so a stage is one contiguous copy. No weight fragment is loaded from
//     global memory by a consumer, and the copies run ahead of the
//     products by up to the ring's depth.
//   * Tiles of 64 rows (d 384, 512; the two consumer warpgroups split the
//     columns) or 128 rows (d 128, 256; one warpgroup per 64 rows): each
//     weight byte from L2 feeds 64 or 128 rows.
//   * A persistent grid (one block an SM) walks the row tiles, so the
//     producer fetches a tile's first stages while the consumers finish
//     the previous tile's LayerNorm.
//   * Nothing intermediate goes to device memory; the ragged last tile is
//     zero-filled on load and not stored. The residual q is read from
//     global memory where it is added.
//
// Widths: a template on D, instantiated at every bf16 width where the JAX
// package's tail rule (ffn_pallas.fusable) holds at hidden 4d: d in
// {128, 256, 384, 512}; the hidden may be any multiple of 128. The C entry
// point dispatches on d.
//
// Layout contract (checked by the Python wrapper, ops/tail_cuda.py): x, q
// and out (R, d) bf16, 16-byte aligned; wpack the packed Wm, W1, W2 (bf16,
// scream_pack_weights); g1, b1, g2, b2 (d,) fp32; all contiguous.

#include "tail_tile.cuh"

namespace {

using namespace scream;
using hopper::bf16;

// Persistent grid: block b takes row tiles b, b + grid, ...
template <int D>
__global__ void __launch_bounds__(tail::kThreads, 1)
tail_kernel(const bf16* __restrict__ x, const bf16* __restrict__ q,
            const unsigned char* __restrict__ wpack, const float* __restrict__ g1,
            const float* __restrict__ b1, const float* __restrict__ g2,
            const float* __restrict__ b2, bf16* __restrict__ out, int R, int hid,
            float eps) {
  using C = tail::Cfg<D>;
  using L = tail::Layout<D, 0>;
  extern __shared__ __align__(128) unsigned char smem[];
  const typename L::Ring ring = L::ring(smem);
  const int ntiles = (R + C::TM - 1) / C::TM;
  if (threadIdx.x == 0) ring.init(tail::kConsumers);
  __syncthreads();

  if (threadIdx.x >= 128 * tail::kConsumers) {
    hopper::setmaxnreg_dec<tail::kProducerRegs>();
    if (threadIdx.x == 128 * tail::kConsumers)
      tail::produce(ring, wpack, C::stages(1, hid), C::STAGE, ntiles);
  } else {
    hopper::setmaxnreg_inc<tail::kConsumerRegs>();
    tail::Consumer<D, typename L::Ring> c(smem, ring, L::TILE, L::HID, L::STATS);
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int row0 = t * C::TM + 64 * c.rg;
      const int nvalid = R - row0;
      c.load_rows(x + (size_t)row0 * D, nvalid);
      hopper::fence_proxy_async();
      c.sync();
      c.run(q + (size_t)row0 * D, out + (size_t)row0 * D, nvalid, g1, b1, g2, b2, hid,
            eps);
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// The blob of ops/tail_cuda.py:pack_weights, one output element a thread:
// [Wq], Wm in stages of 32 k-rows, then per hidden chunk of hc columns its
// W1 columns in stages of ks_h k-rows and its W2 rows in stages of 32.
// Weights (in, out) row-major in T, cast to bf16 as .to(torch.bfloat16).
template <typename T>
__global__ void pack_kernel(const T* __restrict__ wq, const T* __restrict__ wm,
                            const T* __restrict__ w1, const T* __restrict__ w2,
                            bf16* __restrict__ out, unsigned d, unsigned hid,
                            unsigned hc, unsigned ks_h, unsigned n) {
  const unsigned sq = d * d, nsq = wq ? 2 : 1, per = 2 * d * hc;
  for (unsigned o = blockIdx.x * blockDim.x + threadIdx.x; o < n;
       o += gridDim.x * blockDim.x) {
    unsigned k, c;
    float v;
    if (o < nsq * sq) {
      hopper::kmajor_src(o % sq, d, 32, k, c);
      v = to_f32((wq && o < sq ? wq : wm)[k * d + c]);
    } else {
      const unsigned ch = (o - nsq * sq) / per, t = (o - nsq * sq) % per;
      if (t < d * hc) {
        hopper::kmajor_src(t, hc, ks_h, k, c);
        v = to_f32(w1[k * hid + ch * hc + c]);
      } else {
        hopper::kmajor_src(t - d * hc, d, 32, k, c);
        v = to_f32(w2[(ch * hc + k) * d + c]);
      }
    }
    out[o] = __float2bfloat16(v);
  }
}

template <int D>
int launch_tail(const void* x, const void* q, const void* wpack, const void* g1,
                const void* b1, const void* g2, const void* b2, void* out, int R,
                int hid, float eps, cudaStream_t stream) {
  using C = tail::Cfg<D>;
  constexpr int smem = tail::Layout<D, 0>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      tail_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (R + C::TM - 1) / C::TM;
  const int grid = ntiles < tail::num_sms() ? ntiles : tail::num_sms();
  tail_kernel<D><<<grid, tail::kThreads, smem, stream>>>(
      (const bf16*)x, (const bf16*)q, (const unsigned char*)wpack, (const float*)g1,
      (const float*)b1, (const float*)g2, (const float*)b2, (bf16*)out, R, hid, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, q (R, d) bf16, d in {128, 256, 384, 512}, hidden a multiple of 128,
// wpack from pack_weights -> out (R, d) bf16.
int scream_block_tail(const void* x, const void* q, const void* wpack, const void* g1,
                      const void* b1, const void* g2, const void* b2, void* out, int R,
                      int d, int hid, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R <= 0 || hid <= 0 || hid % 128) return (int)cudaErrorInvalidValue;
#define SCREAM_TAIL(D)                                                           \
  if (d == D) return launch_tail<D>(x, q, wpack, g1, b1, g2, b2, out, R, hid, eps, s);
  SCREAM_TAIL(128)
  SCREAM_TAIL(256)
  SCREAM_TAIL(384)
  SCREAM_TAIL(512)
#undef SCREAM_TAIL
  return (int)cudaErrorInvalidValue;
}

// The weights of the tail ([Wq] of the apply kernel, may be null, at d <=
// 384; Wm, W1, W2 as (in, out), all fp32 if fp32 else all bf16) -> the
// packed blob out, (d + 2 hid) d elements, (2 d + 2 hid) d with Wq. The
// ring's geometry is tail_tile.cuh:Cfg's: at d > 256 a hidden chunk is 128
// columns, else 64; Wq's stages are Wm's at every width.
int scream_pack_weights(const void* wq, const void* wm, const void* w1, const void* w2,
                        int fp32, void* out, int d, int hid, void* stream) {
  if (!(d == 128 || d == 256 || d == 384 || d == 512) || hid <= 0 || hid % 128 ||
      (wq && d > 384))
    return (int)cudaErrorInvalidValue;
  const unsigned cols = d > 256 ? 2 : 1, hc = 64 * cols, ks_h = d / (2 * cols);
  const unsigned n = (unsigned)((wq ? 2 : 1) * d + 2 * hid) * d;
  const int grid = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  cudaStream_t s = (cudaStream_t)stream;
  if (fp32)
    pack_kernel<float><<<grid, 256, 0, s>>>((const float*)wq, (const float*)wm,
                                             (const float*)w1, (const float*)w2,
                                             (bf16*)out, d, hid, hc, ks_h, n);
  else
    pack_kernel<bf16><<<grid, 256, 0, s>>>((const bf16*)wq, (const bf16*)wm,
                                            (const bf16*)w1, (const bf16*)w2,
                                            (bf16*)out, d, hid, hc, ks_h, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
