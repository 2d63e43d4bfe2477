// The head-generic apply kernel in bf16 (d 128, 256, 384, any head count):
// attn.cu's attn_apply_kernel (the Q projection on wgmma, then the tail of
// tail_tile.cuh) with the attend of attn_heads.cuh, which takes the head dim
// at run time. Replaces scream_tpu/ops/attn_pallas.py:_apply_kernel at the
// head counts attn.cu is not instantiated for; attn_heads.cu's header says
// what bounds it and how the design answers.
//
// Per row tile: q = x @ Wq; Q' = bf16(elu1(bf16(q))) * mask into the row
// tile (bf16 K-major, exact); then att = Q' . blockdiag(KV) on wgmma, the
// TPU kernel's split_kv arithmetic (attn_pallas.py:_apply_kernel): KV as
// bf16 hi + bf16 lo, two passes into one fp32 accumulator, the A operand
// the row tile itself. Each consumer warpgroup makes its NW columns in
// m64n32 slices, each over its band of KV rows (attn_heads.cuh:band), the
// band staged from the fp32 KV in chunks of KC k-rows by the threads that
// share the columns (both warpgroups at d <= 256, whose 64-row halves of
// the tile share them; each warpgroup its own at d 384); z = Q'.K_sum per
// head on fp32 FMA; the message bf16(att / (z + eps)) overwrites the tile
// and the tail runs on it. A slice's fp32 accumulator is normalized and
// rounded to the bf16 message as soon as the slice's band is done, so a
// thread holds one slice's 16 fp32 accumulators beside the finished
// slices' bf16 pairs (NW / 4 registers), within the 168 registers a thread
// of the 384-thread block has.
//
// Layout contract (ops/attn_cuda.py:attn_apply_heads): x (B, L, d) bf16,
// mask (B, L) fp32, wpack from tail.cu's pack (Wq, Wm, W1, W2), KV (B, H,
// hd, hd) and K_sum (B, d) fp32, LayerNorm params fp32, out (B, L, d)
// bf16; hidden a multiple of 128.

#include <type_traits>

#include "attn_heads.cuh"

namespace {

using namespace scream;
using namespace scream::heads;
using hopper::bf16;

// Extra shared memory of the tile: a band chunk for each group of threads
// that shares columns (COLS of them: KC k-rows x SL columns, bf16 hi then
// lo), then K_sum (d fp32). At d <= 256 a chunk holds any band (d rows),
// so no slice's accumulator is live while a chunk is staged; at d 384 each
// warpgroup's chunk is d / 2 rows.
template <int D>
struct HeadsApply {
  using C = tail::Cfg<D>;
  static constexpr int NC = 128 * tail::kConsumers, SL = kSliceBf16;
  static constexpr int KC = C::COLS == 1 ? D : D / 2;  // k-rows of a band chunk
  static constexpr int BAND = KC * SL * 4, KSUM = C::COLS * BAND, EXTRA = KSUM + D * 4;
  static_assert(KC % kStepBf16 == 0 && C::NW % SL == 0, "chunks of whole steps, slices");
  using L = tail::Layout<D, EXTRA>;

  // The threads that stage one band chunk: both warpgroups (barrier 3) where
  // they share columns, else the warpgroup alone (barrier 4 + cp).
  static __device__ __forceinline__ void band_sync(int cp) {
    if (C::COLS == 1)
      hopper::named_sync(3, NC);
    else
      hopper::named_sync(4 + cp, 128);
  }
};

template <int D>
__global__ void __launch_bounds__(tail::kThreads, 1)
attn_apply_heads_kernel(const bf16* __restrict__ x, const float* __restrict__ mask,
                        const unsigned char* __restrict__ wpack, const float* __restrict__ kv,
                        const float* __restrict__ ksum, const float* __restrict__ g1,
                        const float* __restrict__ b1, const float* __restrict__ g2,
                        const float* __restrict__ b2, bf16* __restrict__ out, int B, int L,
                        int hid, int hd, float attn_eps, float ln_eps) {
  using A = HeadsApply<D>;
  using C = typename A::C;
  using Lay = typename A::L;
  constexpr int NW = C::NW, NJ = NW / 8, NC = A::NC;
  extern __shared__ __align__(128) unsigned char smem[];
  const typename Lay::Ring ring = Lay::ring(smem);
  const int tpb = (L + C::TM - 1) / C::TM, ntiles = B * tpb;
  if (threadIdx.x == 0) ring.init(tail::kConsumers);
  __syncthreads();

  if (threadIdx.x >= NC) {
    hopper::setmaxnreg_dec<tail::kProducerRegs>();
    if (threadIdx.x == NC) tail::produce(ring, wpack, C::stages(2, hid), C::STAGE, ntiles);
    return;
  }
  hopper::setmaxnreg_inc<tail::kConsumerRegs>();
  tail::Consumer<D, typename Lay::Ring> c(smem, ring, Lay::TILE, Lay::HID, Lay::STATS);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int b = t / tpb, l0 = (t % tpb) * C::TM + 64 * c.rg;
    const int nvalid = L - l0;
    const size_t row0 = (size_t)b * L + l0;
    float* kss = reinterpret_cast<float*>(smem + Lay::EXTRA_OFF + A::KSUM);
    hopper::named_sync(3, NC);  // both warpgroups are done with the last K_sum
    for (int i = threadIdx.x; i < D / 4; i += NC)
      reinterpret_cast<float4*>(kss)[i] = reinterpret_cast<const float4*>(ksum + (size_t)b * D)[i];
    c.load_rows(x + row0 * D, nvalid);
    hopper::fence_proxy_async();
    hopper::named_sync(3, NC);

    float acc[NW / 2];  // q, the warpgroup's NW columns
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    hopper::ring_mma<NW, 2>(acc, c.ring, C::S_D, hopper::smem_u32(c.tile), 16 * D,
                            32 * c.cp * NW, 32 * D, c.wt);
    c.sync();  // every warp's wgmma on the tile has completed
    {
      float m[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) m[hh] = c.row(hh) < nvalid ? mask[row0 + c.row(hh)] : 0.f;
#pragma unroll
      for (int i = 0; i < NW / 2; ++i)
        acc[i] = hopper::round_bf16(tf32::elu1(hopper::round_bf16(acc[i]))) * m[(i >> 1) & 1];
    }
    c.store_tile(acc);  // Q' (bf16, exact): the attend's A
    hopper::fence_proxy_async();
    c.sync();  // the row group's Q' is in the tile
    // The message as bf16 pairs: elements (row(hh), col(j)), (.., col(j) + 1)
    // at msg[2 j + hh], each slice's made, normalized and rounded in turn.
    uint32_t msg[NW / 4];
    int zh = -1;  // the normalizer's last head, and its 1 / (z + eps) by row
    float inv[2];
    for_slices<0, NW / A::SL>([&](auto sl) {
      constexpr int s = decltype(sl)::value, SL = A::SL;
      const int c0 = c.cp * NW + s * SL;
      float att[SL / 2];
      int k0, k1;
      band<SL>(c0, hd, D, kStepBf16, k0, k1);
      // The band's chunks (the first makes att afresh): staged by the
      // threads that share the warpgroup's columns, then multiplied. The
      // addresses are made where they are used (opaque), so that none is
      // held beside the message across the slices.
      auto chunk = [&](int kc, auto fresh) {
        const int nk = k1 - kc < A::KC ? k1 - kc : A::KC;
        unsigned char* buf =
            hopper::opaque(smem) + Lay::EXTRA_OFF + (C::COLS == 1 ? 0 : c.cp * A::BAND);
        A::band_sync(c.cp);  // every wgmma on the last chunk has completed
        stage_band_bf16(buf, A::KC, hopper::opaque(kv) + (size_t)b * D * hd, hd, c0, kc, nk,
                        C::COLS == 1 ? (int)threadIdx.x : c.wt, C::COLS == 1 ? NC : 128);
        hopper::fence_proxy_async();
        A::band_sync(c.cp);
        attend_bf16<decltype(fresh)::value>(att, hopper::smem_u32(c.tile) + (kc / 16) * 256,
                                            16 * D, hopper::smem_u32(buf), A::KC, nk);
      };
      chunk(k0, std::true_type{});
      if constexpr (A::KC < D) {
#pragma unroll 1
        for (int kc = k0 + A::KC; kc < k1; kc += A::KC) chunk(kc, std::false_type{});
      }
      // Q'(hh, col): row row(hh) of the warpgroup's tile (bf16 K-major; row
      // row(1) = row(0) + 8 is 16 D bytes on).
      const unsigned char* tq = reinterpret_cast<const unsigned char*>(hopper::opaque(c.tile)) +
                                hopper::core_off(c.row(0), 0, D);
      auto q = [tq](int hh, int col) {
        return __bfloat162float(*reinterpret_cast<const bf16*>(
            tq + hh * 16 * D + (col >> 3) * 128 + (col & 7) * 2));
      };
      normalize<0, SL / 8>(att, [&c](int j) { return c.col(s * SL / 8 + j); }, q, kss, hd,
                           attn_eps, zh, inv);
#pragma unroll
      for (int j = 0; j < SL / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(att[4 * j + 2 * hh], att[4 * j + 2 * hh + 1]);
          msg[2 * (s * SL / 8 + j) + hh] = *reinterpret_cast<const uint32_t*>(&v);
        }
    });
    c.sync();  // every read of Q' in the tile is done
    {  // the message, the merge's input
      unsigned char* tt = reinterpret_cast<unsigned char*>(c.tile);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<uint32_t*>(tt + hopper::core_off(c.row(hh), c.col(j), D)) =
              msg[2 * j + hh];
    }
    hopper::fence_proxy_async();
    c.sync();
    c.run(x + row0 * D, out + row0 * D, nvalid, g1, b1, g2, b2, hid, ln_eps);
  }
}

template <int D>
int launch_apply(const void* x, const void* mask, const void* wpack, const void* kv,
                 const void* ksum, const void* g1, const void* b1, const void* g2,
                 const void* b2, void* out, int B, int L, int hid, int hd, float attn_eps,
                 float ln_eps, cudaStream_t stream) {
  using C = tail::Cfg<D>;
  constexpr int smem = HeadsApply<D>::L::BYTES;
  static std::atomic<unsigned> smem_set{0};
  int err = tf32::set_smem(attn_apply_heads_kernel<D>, smem, smem_set);
  if (err) return err;
  const int ntiles = B * ((L + C::TM - 1) / C::TM);
  const int grid = ntiles < tail::num_sms() ? ntiles : tail::num_sms();
  attn_apply_heads_kernel<D><<<grid, tail::kThreads, smem, stream>>>(
      (const bf16*)x, (const float*)mask, (const unsigned char*)wpack, (const float*)kv,
      (const float*)ksum, (const float*)g1, (const float*)b1, (const float*)g2,
      (const float*)b2, (bf16*)out, B, L, hid, hd, attn_eps, ln_eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, L, d) bf16, d 128, 256 or 384, heads dividing d, hidden a multiple
// of 128, wpack the packed Wq, Wm, W1, W2 (pack_weights), KV (B, H, hd, hd)
// and K_sum (B, d) fp32 -> out (B, L, d) bf16. One launch.
int scream_attn_apply_heads(const void* x, const void* mask, const void* wpack, const void* kv,
                            const void* ksum, const void* g1, const void* b1, const void* g2,
                            const void* b2, void* out, int B, int L, int d, int heads, int hid,
                            float attn_eps, float ln_eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || L <= 0 || hid <= 0 || hid % 128 || !cell_ok(d, heads, false))
    return (int)cudaErrorInvalidValue;
  const int hd = d / heads;
  if (d == 128)
    return launch_apply<128>(x, mask, wpack, kv, ksum, g1, b1, g2, b2, out, B, L, hid, hd,
                             attn_eps, ln_eps, s);
  if (d == 256)
    return launch_apply<256>(x, mask, wpack, kv, ksum, g1, b1, g2, b2, out, B, L, hid, hd,
                             attn_eps, ln_eps, s);
  return launch_apply<384>(x, mask, wpack, kv, ksum, g1, b1, g2, b2, out, B, L, hid, hd,
                           attn_eps, ln_eps, s);
}

}  // extern "C"
