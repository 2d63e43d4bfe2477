// The head-generic apply kernel in bf16 (d 128, 256, 384, any head count):
// attn.cu's attn_apply_kernel (the Q projection on wgmma, then the tail of
// tail_tile.cuh) with the attend of attn_heads.cuh, which takes the head dim
// at run time. Replaces scream_tpu/ops/attn_pallas.py:_apply_kernel at the
// head counts attn.cu is not instantiated for; attn_heads.cu's header says
// what bounds it and how the design answers.
//
// Per row tile: q = x @ Wq; Q' = bf16(elu1(bf16(q))) * mask into the row tile
// (bf16 K-major, exact); then for each of the thread's output columns (the
// wgmma accumulator layout) att = sum over its head's rows i of Q'[row][base
// + i] KV[h][i][column] on fp32 FMA, the KV of all heads streamed through
// shared memory kIC rows i a pass (both consumer warpgroups share a tile's
// batch); z = Q'.K_sum per head; the message bf16(att / (z + eps))
// overwrites the tile and the tail runs on it. The attend makes the
// thread's columns in two halves, each over all of its head's KV rows, the
// first half's message parked in shared memory (bf16, as the tile will hold
// it) while the second is made: so at most half of the 64-128 accumulators
// a thread holds for its columns are live beside the attend's own values,
// within the 168 registers a thread of the 384-thread block has.
//
// Layout contract (ops/attn_cuda.py:attn_apply_heads): x (B, L, d) bf16,
// mask (B, L) fp32, wpack from tail.cu's pack (Wq, Wm, W1, W2), KV (B, H,
// hd, hd) and K_sum (B, d) fp32, LayerNorm params fp32, out (B, L, d)
// bf16; hidden a multiple of 128.

#include "attn_heads.cuh"

namespace {

using namespace scream;
using namespace scream::heads;
using hopper::bf16;

// Extra shared memory of the tile: a pass of KV rows (d kIC fp32), K_sum (d
// fp32), and the first half of each consumer thread's message (NW / 4 bf16
// a thread, as NW / 8 words; word k of thread i at k NC + i).
template <int D>
struct HeadsApply {
  using C = tail::Cfg<D>;
  static constexpr int NC = 128 * tail::kConsumers, HALF = C::NW / 8;  // words a thread
  static constexpr int KSS = D * kIC * 4, MSG = KSS + D * 4, EXTRA = MSG + HALF * NC * 4;
  using L = tail::Layout<D, EXTRA>;
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
    float* kss = reinterpret_cast<float*>(smem + Lay::EXTRA_OFF + A::KSS);
    hopper::named_sync(3, NC);  // both warpgroups are done with the last K_sum
    for (int i = threadIdx.x; i < D / 4; i += NC)
      reinterpret_cast<float4*>(kss)[i] = reinterpret_cast<const float4*>(ksum + (size_t)b * D)[i];
    c.load_rows(x + row0 * D, nvalid);
    hopper::fence_proxy_async();
    hopper::named_sync(3, NC);

    float acc[NW / 2];  // q, then the message: the warpgroup's NW columns
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
    c.store_tile(acc);  // Q' (bf16, exact)
    c.sync();  // the row group's Q' is in the tile
    {
      // Q'(hh, col): row row(hh) of the warpgroup's tile (bf16 K-major; row
      // row(1) = row(0) + 8 is 16 D bytes on).
      int r = c.row(0);
      asm volatile("" : "+r"(r));
      const unsigned char* tq =
          reinterpret_cast<const unsigned char*>(c.tile) + hopper::core_off(r, 0, D);
      auto q = [tq](int hh, int col) {
        return __bfloat162float(*reinterpret_cast<const bf16*>(
            tq + hh * 16 * D + (col >> 3) * 128 + (col & 7) * 2));
      };
      auto col = [&c](int j) { return c.col(j); };
      float* kvs = reinterpret_cast<float*>(smem + Lay::EXTRA_OFF);
      __nv_bfloat162* park =
          reinterpret_cast<__nv_bfloat162*>(smem + Lay::EXTRA_OFF + A::MSG) + threadIdx.x;
      // The first half of the columns, parked; then the second half.
#pragma unroll
      for (int i = 0; i < NW / 4; ++i) acc[i] = 0.f;
      for (int i0 = 0; i0 < hd; i0 += kIC) {
        const int n = hd - i0 < kIC ? hd - i0 : kIC;
        hopper::named_sync(3, NC);  // every read of the last pass's KV rows is done
        stage_kv(kvs, kv + (size_t)b * D * hd, D, hd, i0, n, threadIdx.x, NC);
        hopper::named_sync(3, NC);
        attend_pass<0, NJ / 2>(acc, col, q, kvs, i0, n, hd);
      }
      normalize<0, NJ / 2>(acc, col, q, kss, hd, attn_eps);
#pragma unroll
      for (int k = 0; k < A::HALF; ++k)
        park[k * NC] = __floats2bfloat162_rn(acc[2 * k], acc[2 * k + 1]);
#pragma unroll
      for (int i = NW / 4; i < NW / 2; ++i) acc[i] = 0.f;
      for (int i0 = 0; i0 < hd; i0 += kIC) {
        const int n = hd - i0 < kIC ? hd - i0 : kIC;
        hopper::named_sync(3, NC);
        stage_kv(kvs, kv + (size_t)b * D * hd, D, hd, i0, n, threadIdx.x, NC);
        hopper::named_sync(3, NC);
        attend_pass<NJ / 2, NJ / 2>(acc, col, q, kvs, i0, n, hd);
      }
      normalize<NJ / 2, NJ / 2>(acc, col, q, kss, hd, attn_eps);
#pragma unroll
      for (int k = 0; k < A::HALF; ++k) {
        const float2 v = __bfloat1622float2(park[k * NC]);
        acc[2 * k] = v.x;
        acc[2 * k + 1] = v.y;
      }
    }
    c.sync();  // every read of Q' in the tile is done
    c.store_tile(acc);  // the message, the merge's input
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
