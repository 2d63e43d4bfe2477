// The head-generic apply kernel in fp32 (d 128, 256, any head count):
// attn_f32.cu's attn_apply_f32_kernel (every product split-TF32 wgmma, the
// tail of tf32_tail.cuh) with the attend of attn_heads.cuh, which takes the
// head dim at run time. Replaces scream_tpu/ops/attn_pallas.py:_apply_kernel
// in the float32 configuration at the head counts attn_f32.cu is not
// instantiated for; attn_heads.cu's header says what bounds it and how the
// design answers.
//
// Per 64-row tile: q = x @ Wq (the two consumer warpgroups split its
// columns); Q' = elu1(q) * mask into the fp32 row tile; then att = Q' .
// blockdiag(KV) as split-TF32 wgmma, the products' arithmetic
// (tf32_tile.cuh): each warpgroup makes its NW columns in m64n64 slices,
// each over its band of KV rows (attn_heads.cuh:band) in chunks of
// kPromoteK k-rows, a chunk's three passes a k8 step into a fresh
// accumulator then added into the fp32 master (a promotion); the band is
// split hi / lo and staged by the warpgroup into its half of the hidden
// buffers (idle until the FFN). z = Q'.K_sum per head on fp32 FMA
// (attn_heads.cuh:normalize); the message att / (z + eps) overwrites the
// tile and the tail runs on it.
//
// Layout contract (ops/attn_cuda.py:attn_apply_heads): every tensor fp32;
// Wq, Wm (d, d), W1 (d, hid), W2 (hid, d) (in, out), split and packed by
// attn_f32.cu's pack_block_f32_kernel in this kernel's C call; KV (B, H,
// hd, hd), K_sum (B, d); hidden a multiple of 128.

#include "attn_heads.cuh"

namespace {

using namespace scream;
using namespace scream::heads;

template <int D>
struct HeadsApplyF32 {
  using G = tf32::Block<D>;
  static constexpr int TM = tf32::TM, NW = G::NW;
  static constexpr int KC = tf32::kPromoteK;  // k-rows of a band chunk
  static constexpr int A = 0, HID = A + TM * D * 4, KSUM = HID + 2 * TM * G::HC * 4,
                       ST = KSUM + D * 4, MS = ST + 2 * TM * 8;
  using S = tf32::Smem<MS + TM * 4>;
  static_assert(G::PASSES == 1 && NW % kSliceF32 == 0 && KC % kStepF32 == 0 &&
                    2 * KC * kSliceF32 * 8 <= 2 * TM * G::HC * 4,
                "apply: one pass, slices, a band chunk of each warpgroup in the hidden buffers");
  static __host__ __device__ constexpr int stages(int hid) { return G::stages(2, hid); }
};

template <int D>
__global__ void __launch_bounds__(tail::kThreads, 1)
attn_apply_heads_f32_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                            const float* __restrict__ wpack, const float* __restrict__ kv,
                            const float* __restrict__ ksum, const float* __restrict__ g1,
                            const float* __restrict__ b1, const float* __restrict__ g2,
                            const float* __restrict__ b2, float* __restrict__ out, int B, int L,
                            int hid, int hd, float attn_eps, float ln_eps, int norm_bf16) {
  using C = HeadsApplyF32<D>;
  constexpr int NW = C::NW, NJ = NW / 8, TM = C::TM, KC = C::KC;
  extern __shared__ __align__(128) unsigned char smem[];
  const typename C::S::Ring ring0(hopper::smem_u32(smem));
  const int tpb = (L + TM - 1) / TM, ntiles = B * tpb;
  if (threadIdx.x == 0) ring0.init(tail::kConsumers);
  __syncthreads();

  if (threadIdx.x >= 128 * tail::kConsumers) {
    hopper::setmaxnreg_dec<tail::kProducerRegs>();
    if (threadIdx.x == 128 * tail::kConsumers) {
      typename C::S::Ring ring = ring0;
      const int per = C::stages(hid);
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x)
        for (int s = 0; s < per; ++s) {
          ring.fill(wpack + (size_t)s * (tf32::kStage / 4));
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
  unsigned char* base = smem + C::S::NST * tf32::kStage;
  float* At = reinterpret_cast<float*>(base + C::A);
  float* Hs = reinterpret_cast<float*>(base + C::HID);
  float* kss = reinterpret_cast<float*>(base + C::KSUM);
  float2* stats = reinterpret_cast<float2*>(base + C::ST);
  float* ms = reinterpret_cast<float*>(base + C::MS);
  // The warpgroup's band chunk: its half of the hidden buffers.
  float* buf = Hs + w.cp * (2 * KC * kSliceF32);
  const uint32_t bs = hopper::smem_u32(buf);
  const bool nbf = norm_bf16 != 0;
  // Q'(hh, col): row r0 + 8 hh of the tile (tf32_tile.cuh layout; rows r0
  // and r0 + 8 share r0 & 3).
  auto q = [At, &w](int hh, int col) {
    return At[tf32::tile_idx(w.r0, col, D) + hh * 8 * D];
  };
  auto col = [&w](int j) { return w.cp * NW + 8 * j + 2 * w.t; };

  float acc[NW / 2], c[C::G::CN];
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / tpb, l0 = (tile % tpb) * TM;
    const int nvalid = L - l0 < TM ? L - l0 : TM;
    const size_t row0 = (size_t)b * L + l0;
    const float* xb = x + row0 * D;
    hopper::named_sync(1, 256);  // the last tile's reads of the buffers are done
    tf32::load_tile<D>(At, xb, nvalid, tid, 256);
    for (int i = tid; i < D / 4; i += 256)
      reinterpret_cast<float4*>(kss)[i] =
          __ldg(reinterpret_cast<const float4*>(ksum + (size_t)b * D) + i);
    if (tid < TM) ms[tid] = tid < nvalid ? mask[row0 + tid] : 0.f;
    hopper::named_sync(1, 256);

#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    tf32::wide_mma<typename C::G, D>(acc, c, ring, At, w.cp, wt);
    const float m[2] = {ms[w.r0], ms[w.r0 + 8]};
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = tf32::elu1(acc[i]) * m[(i >> 1) & 1];
    hopper::named_sync(1, 256);  // both warpgroups' reads of x in the tile are done
    tf32::store_tile<NW, D>(acc, At, w, false);  // Q'
    hopper::named_sync(1, 256);  // Q' is in: the attend's A
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    const float* kvb = kv + (size_t)b * D * hd;
    for_slices<0, NW / kSliceF32>([&](auto sl) {
      constexpr int s = decltype(sl)::value;
      const int c0 = w.cp * NW + s * kSliceF32;
      int k0, k1;
      band<kSliceF32>(c0, hd, D, kStepF32, k0, k1);
#pragma unroll 1
      for (int kc = k0; kc < k1; kc += KC) {
        const int nk = k1 - kc < KC ? k1 - kc : KC;
        hopper::named_sync(2 + w.cp, 128);  // every wgmma on the last chunk has completed
        stage_band_tf32(buf, KC, kvb, hd, c0, kc, nk, wt, 128);
        hopper::fence_proxy_async();
        hopper::named_sync(2 + w.cp, 128);
        attend_tf32<D, s>(acc, c, At, kc, nk, bs, KC, w.r0, w.t);
      }
    });
    int zh = -1;
    float inv[2];
    normalize<0, NJ>(acc, col, q, kss, hd, attn_eps, zh, inv);
    hopper::named_sync(1, 256);  // every read of Q' in the tile is done
    tf32::store_tile<NW, D>(acc, At, w, false);  // the message
    hopper::named_sync(1, 256);

    tf32::tail_rows<D>(acc, c, ring, At, Hs, stats, xb, out + row0 * D, nvalid, hid, g1, b1,
                       g2, b2, ln_eps, nbf, w, wt);
  }
}

template <int D>
int launch_apply(const void* x, const void* mask, const void* wpack, const void* kv,
                 const void* ksum, const void* g1, const void* b1, const void* g2,
                 const void* b2, void* out, int B, int L, int hid, int hd, float attn_eps,
                 float ln_eps, int norm_bf16, cudaStream_t stream) {
  using C = HeadsApplyF32<D>;
  static std::atomic<unsigned> smem_set{0};
  int err = tf32::set_smem(attn_apply_heads_f32_kernel<D>, C::S::BYTES, smem_set);
  if (err) return err;
  const int ntiles = B * ((L + C::TM - 1) / C::TM);
  const int grid = ntiles < tail::num_sms() ? ntiles : tail::num_sms();
  attn_apply_heads_f32_kernel<D><<<grid, tail::kThreads, C::S::BYTES, stream>>>(
      (const float*)x, (const float*)mask, (const float*)wpack, (const float*)kv,
      (const float*)ksum, (const float*)g1, (const float*)b1, (const float*)g2,
      (const float*)b2, (float*)out, B, L, hid, hd, attn_eps, ln_eps, norm_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The fp32 apply: every tensor fp32, Wq, Wm (d, d), W1 (d, hid), W2 (hid,
// d) (in, out), d 128 or 256, heads dividing d, hidden a multiple of 128;
// norm_bf16 rounds the LayerNorm outputs through bf16. Two launches: the
// weight pack into wpack (2 (2 d^2 + 2 d hid) floats, attn_f32.cu's
// pack_block_f32_kernel), then the block.
int scream_attn_apply_heads_f32(const void* x, const void* mask, const void* wq, const void* wm,
                                const void* w1, const void* w2, void* wpack, const void* kv,
                                const void* ksum, const void* g1, const void* b1, const void* g2,
                                const void* b2, void* out, int B, int L, int d, int heads,
                                int hid, float attn_eps, float ln_eps, int norm_bf16,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || L <= 0 || hid <= 0 || hid % 128 || !cell_ok(d, heads, true))
    return (int)cudaErrorInvalidValue;
  const int err = tf32::launch_pack_block(wq, wm, w1, w2, wpack, d, hid, s);
  if (err) return err;
  const int hd = d / heads;
  if (d == 128)
    return launch_apply<128>(x, mask, wpack, kv, ksum, g1, b1, g2, b2, out, B, L, hid, hd,
                             attn_eps, ln_eps, norm_bf16, s);
  return launch_apply<256>(x, mask, wpack, kv, ksum, g1, b1, g2, b2, out, B, L, hid, hd,
                           attn_eps, ln_eps, norm_bf16, s);
}

}  // extern "C"
