// Fused attention-block tail in float32 for Hopper (sm_90a): the float32
// counterpart of tail.cu, its products on the tensor cores as split-TF32
// ("3xTF32") wgmma (tf32_tile.cuh).
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
// LayerNorm with fp32 statistics, var = max(0, E[x^2] - mu^2), as flax
// computes it.
//
// What bounds it on the H100: operations, 2 R d (d + 2 hid) of them against
// 3 R d + d (d + 2 hid) fp32 words, ~1,000 operations a byte at d 384,
// hidden 1,536. On the CUDA cores' fp32 FMA (67 TFLOP/s) that is 1.30 ms at
// d 384, 8 x 4,096 rows; one pass of TF32 on the tensor cores (495
// TFLOP/s) keeps ~11 bits of each operand, short of the fp32 bar (2e-5).
// The split keeps it (attn_f32.cu's header): each operand hi + lo, each
// product lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B) into one fp32 accumulator,
// promoted into an fp32 master every tf32_tile.cuh:kPromoteK k values;
// three passes at 495 TFLOP/s, a bound of 0.53 ms at that shape.
//
// What the design does about it: the fp32 apply kernel's pipeline and its
// tail half, shared (tf32_tail.cuh:tail_rows): one producer thread streams
// the pre-split weights through a ring of 32 KB shared-memory stages (bulk
// copies on mbarriers), two consumer warpgroups take a 64-row tile each
// and split the output columns, over a persistent grid of tiles; the row
// tile stays fp32 in shared memory and is split in registers. At d 384
// (tf32_tail.cuh:Block) each warpgroup's 192 columns go in three passes of
// 64 and the hidden in chunks of 64, within the 168 registers a thread of
// a 384-thread block gets. The weights are split and packed once per call
// by pack_block_f32_kernel (attn_f32.cu), launched by this kernel's own C
// entry point: at small shapes the host's time bounds a call, and a pack
// call of its own would add about half again. Nothing intermediate goes to
// device memory; rows past R are zero in the tile and never stored. No
// float atomics: two launches on one input agree bit for bit.
//
// Widths: a template on D, instantiated at every fp32 width where the JAX
// package's tail rule (ffn_pallas.fusable) holds at hidden 4d: d in
// {128, 256, 384}; the hidden may be any multiple of 128.
//
// Layout contract (checked by the Python wrapper, ops/tail_cuda.py): x, q
// and out (R, d) fp32; Wm (d, d), W1 (d, hid), W2 (hid, d) fp32 (in, out)
// row-major; wpack 2 (d^2 + 2 d hid) floats of scratch for the packed
// weights; g1, b1, g2, b2 (d,) fp32; all contiguous and 16-byte aligned.

#include "tf32_tail.cuh"

namespace {

using namespace scream;
using tf32::kStage;
using tf32::TM;

template <int D>
struct TailF32 {
  using G = tf32::Block<D>;
  static constexpr int A = 0, HID = A + TM * D * 4, ST = HID + 2 * TM * G::HC * 4;
  using S = tf32::Smem<ST + 2 * TM * 8>;
};

template <int D>
__global__ void __launch_bounds__(tail::kThreads, 1)
tail_f32_kernel(const float* __restrict__ x, const float* __restrict__ q,
                const float* __restrict__ wpack, const float* __restrict__ g1,
                const float* __restrict__ b1, const float* __restrict__ g2,
                const float* __restrict__ b2, float* __restrict__ out, int R, int hid,
                float eps, int norm_bf16) {
  using C = TailF32<D>;
  constexpr int NW = C::G::NW;
  extern __shared__ __align__(128) unsigned char smem[];
  const typename C::S::Ring ring0(hopper::smem_u32(smem));
  const int ntiles = (R + TM - 1) / TM;
  if (threadIdx.x == 0) ring0.init(tail::kConsumers);
  __syncthreads();

  if (threadIdx.x >= 128 * tail::kConsumers) {
    hopper::setmaxnreg_dec<tail::kProducerRegs>();
    if (threadIdx.x == 128 * tail::kConsumers) {
      typename C::S::Ring ring = ring0;
      const int per = C::G::stages(1, hid);
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x)
        for (int s = 0; s < per; ++s) {
          ring.fill(wpack + (size_t)s * (kStage / 4));
          ring.advance();
        }
    }
    return;
  }
  hopper::setmaxnreg_inc<tail::kConsumerRegs>();
  typename C::S::Ring ring = ring0;
  const int tid = threadIdx.x, wt = tid & 127;
  tf32::Rows w;
  w.lane = tid & 31;
  w.r0 = 16 * (wt >> 5) + (w.lane >> 2);
  w.t = w.lane & 3;
  w.cp = tid >> 7;
  unsigned char* base = smem + C::S::NST * kStage;
  float* At = reinterpret_cast<float*>(base + C::A);
  float* Hs = reinterpret_cast<float*>(base + C::HID);
  float2* stats = reinterpret_cast<float2*>(base + C::ST);
  const bool nbf = norm_bf16 != 0;
  // The output's master sum and the wgmma chunk (tf32_tail.cuh:Block).
  float acc[NW / 2], c[C::G::CN];

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * TM;
    const int nvalid = R - (int)row0 < TM ? R - (int)row0 : TM;
    hopper::named_sync(1, 256);  // the last tile's reads of the buffers are done
    tf32::load_tile<D>(At, x + row0 * D, nvalid, tid, 256);
    hopper::named_sync(1, 256);
    tf32::tail_rows<D>(acc, c, ring, At, Hs, stats, q + row0 * D, out + row0 * D, nvalid, hid,
                       g1, b1, g2, b2, eps, nbf, w, wt);
  }
}

template <int D>
int launch_tail(const void* x, const void* q, const void* wpack, const void* g1, const void* b1,
                const void* g2, const void* b2, void* out, int R, int hid, float eps,
                int norm_bf16, cudaStream_t stream) {
  using C = TailF32<D>;
  static std::atomic<unsigned> smem_set{0};
  int err = tf32::set_smem(tail_f32_kernel<D>, C::S::BYTES, smem_set);
  if (err) return err;
  const int ntiles = (R + TM - 1) / TM;
  const int grid = ntiles < tail::num_sms() ? ntiles : tail::num_sms();
  tail_f32_kernel<D><<<grid, tail::kThreads, C::S::BYTES, stream>>>(
      (const float*)x, (const float*)q, (const float*)wpack, (const float*)g1,
      (const float*)b1, (const float*)g2, (const float*)b2, (float*)out, R, hid, eps,
      norm_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, q (R, d) fp32, d in {128, 256, 384}, hidden a multiple of 128, weights
// (in, out) fp32 -> out (R, d) fp32; norm_bf16 rounds the LayerNorm outputs
// through bf16 (norm dtype bf16). Two launches: the weight pack into wpack
// (2 (d^2 + 2 d hid) floats, pack_block_f32_kernel without Wq), then the
// tail.
int scream_block_tail_f32(const void* x, const void* q, const void* wm, const void* g1,
                          const void* b1, const void* w1, const void* w2, const void* g2,
                          const void* b2, void* wpack, void* out, int R, int d, int hid,
                          float eps, int norm_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R <= 0 || (d != 128 && d != 256 && d != 384) || hid <= 0 || hid % 128)
    return (int)cudaErrorInvalidValue;
  const int err = tf32::launch_pack_block(nullptr, wm, w1, w2, wpack, d, hid, s);
  if (err) return err;
#define SCREAM_TAIL_F32(D)                                                                 \
  if (d == D) return launch_tail<D>(x, q, wpack, g1, b1, g2, b2, out, R, hid, eps, norm_bf16, s);
  SCREAM_TAIL_F32(128)
  SCREAM_TAIL_F32(256)
  SCREAM_TAIL_F32(384)
#undef SCREAM_TAIL_F32
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
