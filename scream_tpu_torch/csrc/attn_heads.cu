// Fused linear-attention block for Hopper (sm_90a) at any head count: the
// head-generic stats and apply kernels, bf16 at d 128, 256 and 384 and fp32
// at d 128 and 256, templated on d only (the head dim is a runtime
// argument). This file holds the stats; attn_heads_apply.cu (bf16) and
// attn_heads_apply_f32.cu (fp32) the apply kernels, one source each so
// that the parallel build compiles them at once; attn_heads.cuh their
// constants and the attend.
//
// Replaces the TPU kernels scream_tpu/ops/attn_pallas.py:_stats_kernel and
// scream_tpu/ops/attn_pallas.py:_apply_kernel at the head counts the
// head-specific kernels of attn.cu (bf16) and attn_f32.cu (fp32) are not
// instantiated for: head dim 1-12, 24 and 96-384 (ops/attn_cuda.py sends
// the head dims 16, 32, 48 and 64 to those). The TPU kernels never split by
// head: stats accumulates the full d x d K'^T V, the wrapper zeroes the
// cross-head blocks, and apply forms Q' . blockdiag(KV) as one product with
// a per-head normalizer from thin selector matrices. These kernels keep
// that independence of the head count, in the port's (B, H, hd, hd)
// layout (the diagonal blocks of that full KV), so the plain versions, the
// backward and the weight converter stay as they are. Same function as
// attn.cu / attn_f32.cu:
//
//   stats:  [k|v] = x_kv @ [Wk|Wv], K' = (elu(k)+1)*mask, V = v*mask, per
//           (batch, head) KV = K'^T V (hd x hd, fp32) and K_sum = sum_rows K';
//   apply:  q = x @ Wq, Q' = (elu(q)+1)*mask, att = Q' KV per head,
//           z = Q'.K_sum per head, msg = att * (1 / (z + eps)), then the
//           block tail LN2(x + relu(LN1(msg @ Wm + x) @ W1) @ W2),
//
// with bf16 rounding where attn.cu rounds (bf16), none in fp32.
//
// What bounds them on the H100: the projections and the tail's products
// (2 R d (2 d + 2 d) operations a row in apply, 2 R d (2 d) in stats, on
// the tensor cores), plus the head-dependent part, 2 R d hd operations a
// row in each kernel (K'^T V in stats, Q' KV in apply), which at head dim
// 128-384 is 0.25-1.5x the projection of stats. What the design does:
//   * stats, in three launches. (1) The projection, whatever the head
//     count, on the wgmma pipelines of the head-specific kernels: bf16
//     through attn.cu's projection at head dim 64 (scream::attn::
//     launch_projection64: [Wk|Wv] packed in 64-column groups [k_g | v_g],
//     rows of K' | V written per group to a bf16 workspace), fp32 through
//     heads_proj_f32_kernel below (attn_f32.cu's projection at head dim 64,
//     tf32_tile.cuh:project_kv, into an fp32 workspace). (2) heads_sum_kernel: per
//     (batch, chunk of kChunk rows) the partial KV of every head and K_sum
//     on fp32 FMA, each thread an 8 x 8 block of one head's KV (head dims
//     that are multiples of 8) or one entry (the rest), the rows summed in
//     row order from a shared-memory stage of kSub rows. (3) attn_f32.cu's
//     slot reduce (tf32_tile.cuh:launch_reduce_slots) adds the chunks in
//     chunk order. The shape alone
//     sets the chunks, never the card: two launches on one input agree bit
//     for bit, and a batch whose mask is all zero gives exact zeros. No
//     float atomics. The workspace round trip (the bf16 K' | V, 2 R d x 2
//     bytes each way) and the chunk partials (d hd + d floats a chunk) are
//     the price of the head independence.
//   * apply: the head-specific kernels' pipeline unchanged (bf16: the Q
//     projection on wgmma and tail_tile.cuh's tail; fp32: tf32_tail.cuh's
//     products and tail), only the attend differs. Q' goes to the row tile
//     in shared memory, which is the attend's wgmma A operand as it is the
//     merge's; att = Q' . blockdiag(KV) on wgmma, each warpgroup's columns
//     in slices (bf16 32 columns, fp32 64) over the band of KV rows of the
//     heads a slice touches (the rows of its own heads, plus the
//     neighbours' where a head straddles a slice edge, staged as zeros off
//     the diagonal blocks), the band staged from the fp32 KV in chunks:
//     bf16 hi + lo in two passes (the TPU kernel's split_kv), fp32 as
//     split-TF32 promoted every 64 k. So the attend runs on the tensor
//     cores: 2 R d hd useful operations, issued as 2 R d x (band rows),
//     which is (slice / hd) times that at a head dim dividing the slice
//     (zeros off the diagonal blocks) and about 1x from the slice up. The
//     normalizer per head from Q' and K_sum on FMA, its chain split over a
//     quad of lanes where the head dim is a multiple of 8; the message
//     overwrites the tile (attn_heads.cuh).
//
// Layout contract (checked by the Python wrapper, ops/attn_cuda.py): d
// 128, 256, 384 (bf16) or 128, 256 (fp32), heads dividing d, hidden a
// multiple of 128; contiguous tensors, 16-byte aligned; weights (in, out)
// packed as the head-specific kernels' packs lay them out (stats at d / 64
// heads); workspaces as the C entry points below say.

#include "attn_heads.cuh"

namespace scream {
namespace attn {
// attn.cu: the bf16 stats projection at head dim 64 into (B, d/64, Sp, 128).
int launch_projection64(const void* x, const void* mask, const void* wpack, void* kvw, int B,
                        int S, int d, cudaStream_t stream);
}  // namespace attn
}  // namespace scream

// attn_f32.cu: the fp32 stats pack; at d / 64 heads, [Wk|Wv] in 64-column
// groups [k_g | v_g].
extern "C" int scream_pack_stats_f32(const void* wk, const void* wv, void* out, int d,
                                     int heads, void* stream);

namespace {

using namespace scream;
using namespace scream::heads;
using hopper::bf16;

// ---- stats ----------------------------------------------------------------

// Workspace element of K' (v 0) or V (v 1) at row s, column c of batch b:
// (B, G, Sp, 128), group c / 64 holding K' then V of its 64 columns.
template <class T>
__device__ __forceinline__ const T* ws_at(const T* ws, int b, int G, int Sp, int s, int c,
                                          int v) {
  return ws + (((size_t)b * G + c / kGroup) * Sp + s) * (2 * kGroup) + kGroup * v + c % kGroup;
}

// 8 workspace values from p (16-byte aligned) as floats into dst.
__device__ __forceinline__ void load8(const bf16* p, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  float4 a, c;
  float2 f = __bfloat1622float2(h[0]);
  a.x = f.x, a.y = f.y;
  f = __bfloat1622float2(h[1]);
  a.z = f.x, a.w = f.y;
  f = __bfloat1622float2(h[2]);
  c.x = f.x, c.y = f.y;
  f = __bfloat1622float2(h[3]);
  c.z = f.x, c.w = f.y;
  reinterpret_cast<float4*>(dst)[0] = a;
  reinterpret_cast<float4*>(dst)[1] = c;
}
__device__ __forceinline__ void load8(const float* p, float* dst) {
  reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(p)[0];
  reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(p)[1];
}

// Stats, pass 2: the partial KV and K_sum of chunk blockIdx.y of batch
// blockIdx.z (rows kChunk y .. up to S) into its slot of part, (B, nchunk,
// d hd + d) floats: KV[h][i][j] at (h hd + i) hd + j, K_sum[c] at d hd + c.
// Thread t of the batch's nt = (d / TT) (hd / TT) owns rows c0 .. c0 + TT -
// 1 (c = h hd + i, one head) and columns j0 .. j0 + TT - 1 of the KV, TT 8
// where hd is a multiple of 8, else 1; blockIdx.x takes threads
// kSumThreads x .. The block stages kSub rows at a time: the K' columns of
// its threads [ka, kb) and the V columns of their heads [va, vb) (TT 1: all
// d of each), as fp32, and every thread adds them in row order.
template <class T, int TT>
__global__ void __launch_bounds__(kSumThreads)
heads_sum_kernel(const T* __restrict__ ws, float* __restrict__ part, int S, int Sp, int d,
                 int hd, int nchunk) {
  extern __shared__ __align__(16) float stage[];
  const int b = blockIdx.z, chunk = blockIdx.y, G = d / kGroup;
  const int jt = hd / TT, nt = d / TT * jt;
  const int t_first = blockIdx.x * kSumThreads;
  const int t_last = (nt < t_first + kSumThreads ? nt : t_first + kSumThreads) - 1;
  int ka = 0, kb = d, va = 0, vb = d;
  if constexpr (TT > 1) {
    ka = t_first / jt * TT;
    kb = t_last / jt * TT + TT;
    va = ka / hd * hd;
    vb = (kb - 1) / hd * hd + hd;
  }
  const int kw = kb - ka, rw = kw + vb - va;  // floats of a staged row: K' part, V part
  const int t = t_first + (int)threadIdx.x;
  const bool active = t < nt;
  const int tc = active ? t : t_last;
  const int c0 = tc / jt * TT, j0 = tc % jt * TT;
  const int koff = c0 - ka, voff = kw + c0 / hd * hd + j0 - va;
  float acc[TT][TT], ks[TT];
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    ks[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TT; ++j) acc[i][j] = 0.f;
  }
  const int r_end = S < (chunk + 1) * kChunk ? S : (chunk + 1) * kChunk;
  const int units = rw / 8, ku = kw / 8;
  for (int r0 = chunk * kChunk; r0 < r_end; r0 += kSub) {
    const int nr = r_end - r0 < kSub ? r_end - r0 : kSub;
    __syncthreads();  // every read of the last stage is done
    for (int i = threadIdx.x; i < nr * units; i += kSumThreads) {
      const int r = i / units, u = i % units;
      const bool is_v = u >= ku;
      const int c = is_v ? va + 8 * (u - ku) : ka + 8 * u;
      load8(ws_at(ws, b, G, Sp, r0 + r, c, is_v), stage + r * rw + 8 * u);
    }
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      const float* row = stage + r * rw;
      float k[TT], v[TT];
      if constexpr (TT == 8) {
        const float4 k0 = reinterpret_cast<const float4*>(row + koff)[0];
        const float4 k1 = reinterpret_cast<const float4*>(row + koff)[1];
        const float4 v0 = reinterpret_cast<const float4*>(row + voff)[0];
        const float4 v1 = reinterpret_cast<const float4*>(row + voff)[1];
        const float kk[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
        const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < TT; ++i) k[i] = kk[i], v[i] = vv[i];
      } else {
#pragma unroll
        for (int i = 0; i < TT; ++i) k[i] = row[koff + i], v[i] = row[voff + i];
      }
#pragma unroll
      for (int i = 0; i < TT; ++i) {
        ks[i] += k[i];
#pragma unroll
        for (int j = 0; j < TT; ++j) acc[i][j] = fmaf(k[i], v[j], acc[i][j]);
      }
    }
  }
  if (!active) return;
  float* slot = part + ((size_t)b * nchunk + chunk) * ((size_t)d * hd + d);
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int j = 0; j < TT; ++j) slot[(size_t)(c0 + i) * hd + j0 + j] = acc[i][j];
  if (j0 == 0)
#pragma unroll
    for (int i = 0; i < TT; ++i) slot[(size_t)d * hd + c0 + i] = ks[i];
}

// The fp32 projection: per (batch, 64-row tile) item and 128-column group
// g of the blob (pack_stats_f32_kernel at d / 64 heads: [k_g | v_g], 64
// columns each), attn_stats_f32_kernel's projection at head dim 64
// (tf32_tile.cuh:project_kv: warpgroup cp 0 the group's K' half, cp 1 its
// V half), written to the workspace (B, G, Sp, 128) fp32, Sp = S rounded
// up to 64 (rows past S are zero: x's tile rows there are zero and the
// mask 0).
template <int D>
struct ProjF32 {
  static constexpr int G = D / kGroup, SP = D / 32, NS = G * SP;  // groups, stages
  static constexpr int X = 0, MS = X + tf32::TM * D * 4;
  using S = tf32::Smem<MS + tf32::TM * 4>;
  static_assert(kGroup == 64 && tf32::TM == 64, "project_kv's groups and tiles");
};

template <int D>
__global__ void __launch_bounds__(tail::kThreads, 1)
heads_proj_f32_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                      const float* __restrict__ wpack, float* __restrict__ ws, int S, int Sp,
                      int nitems) {
  using C = ProjF32<D>;
  constexpr int TM = tf32::TM;
  extern __shared__ __align__(128) unsigned char smem[];
  const typename C::S::Ring ring0(hopper::smem_u32(smem));
  const int nt = (S + TM - 1) / TM;
  if (threadIdx.x == 0) ring0.init(tail::kConsumers);
  __syncthreads();

  if (threadIdx.x >= 128 * tail::kConsumers) {
    hopper::setmaxnreg_dec<tail::kProducerRegs>();
    if (threadIdx.x == 128 * tail::kConsumers) tf32::fill_items(ring0, wpack, C::NS, nitems);
    return;
  }
  hopper::setmaxnreg_inc<tail::kConsumerRegs>();
  typename C::S::Ring ring = ring0;
  const int tid = threadIdx.x, cp = tid >> 7, wt = tid & 127, lane = tid & 31;
  const int r0 = 16 * (wt >> 5) + (lane >> 2), t = lane & 3;
  unsigned char* base = smem + C::S::NST * tf32::kStage;
  float* X = reinterpret_cast<float*>(base + C::X);
  float* ms = reinterpret_cast<float*>(base + C::MS);
  float acc[32], c[32];  // a group's half (master) and the wgmma chunk

  for (int it = blockIdx.x; it < nitems; it += gridDim.x) {
    const int b = it / nt, row0 = (it % nt) * TM;
    const int nvalid = S - row0 < TM ? S - row0 : TM;
    tf32::project_kv<D, kGroup>(
        acc, c, ring, X, ms, x + ((size_t)b * S + row0) * D, mask + (size_t)b * S + row0, nvalid,
        tid, [&](int grp, const float(&a)[32]) {
          // a[4 j + 2 hh + e]: row r0 + 8 hh, group column 64 cp + 8 j + 2 t + e.
          float* dst = ws + (((size_t)b * C::G + grp) * Sp + row0 + r0) * (2 * kGroup) +
                       kGroup * cp + 2 * t;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              *reinterpret_cast<float2*>(dst + 8 * hh * (2 * kGroup) + 8 * j) =
                  make_float2(a[4 * j + 2 * hh], a[4 * j + 2 * hh + 1]);
        });
  }
}

// ---- launchers ------------------------------------------------------------

template <class T>
int launch_sum_reduce(const T* ws, float* part, float* kv, float* ksum, int B, int S, int Sp,
                      int d, int hd, cudaStream_t stream) {
  const int nchunk = (S + kChunk - 1) / kChunk, per = d * hd + d;
  const int smem = kSub * 2 * d * 4;
  const bool t8 = hd % 8 == 0;
  const int nt = t8 ? d / 8 * (hd / 8) : d * hd;
  const dim3 grid((nt + kSumThreads - 1) / kSumThreads, nchunk, B);
  cudaError_t err;
  if (t8) {
    err = cudaFuncSetAttribute(heads_sum_kernel<T, 8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    heads_sum_kernel<T, 8><<<grid, kSumThreads, smem, stream>>>(ws, part, S, Sp, d, hd, nchunk);
  } else {
    err = cudaFuncSetAttribute(heads_sum_kernel<T, 1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    heads_sum_kernel<T, 1><<<grid, kSumThreads, smem, stream>>>(ws, part, S, Sp, d, hd, nchunk);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return tf32::launch_reduce_slots(part, kv, ksum, B, nchunk, per, d * hd, stream);
}

template <int D>
int launch_proj_f32(const void* x, const void* mask, const void* wpack, void* ws, int B, int S,
                    int Sp, cudaStream_t stream) {
  using C = ProjF32<D>;
  static std::atomic<unsigned> smem_set{0};
  const int nitems = B * ((S + tf32::TM - 1) / tf32::TM);
  int err = tf32::set_smem(heads_proj_f32_kernel<D>, C::S::BYTES, smem_set);
  if (err) return err;
  const int grid = nitems < tail::num_sms() ? nitems : tail::num_sms();
  heads_proj_f32_kernel<D><<<grid, tail::kThreads, C::S::BYTES, stream>>>(
      (const float*)x, (const float*)mask, (const float*)wpack, (float*)ws, S, Sp, nitems);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, S, d) bf16, mask (B, S) fp32, wpack from scream_pack_stats at d / 64
// heads, d 128, 256 or 384, heads dividing d -> KV (B, H, hd, hd) and K_sum
// (B, d) fp32. Workspaces: kvw B Sp 2 d bf16 (Sp = S rounded up to 128),
// part B ceil(S / 512) (d hd + d) fp32. Three launches: the projection
// (attn.cu), the chunk sums, their reduce.
int scream_attn_stats_heads(const void* x, const void* mask, const void* wpack, void* kvw,
                            void* part, void* kv, void* ksum, int B, int S, int d, int heads,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || S <= 0 || !cell_ok(d, heads, false)) return (int)cudaErrorInvalidValue;
  const int err = attn::launch_projection64(x, mask, wpack, kvw, B, S, d, s);
  if (err) return err;
  const int Sp = (S + 127) / 128 * 128;
  return launch_sum_reduce((const bf16*)kvw, (float*)part, (float*)kv, (float*)ksum, B, S, Sp,
                           d, d / heads, s);
}

// The fp32 stats: x (B, S, d), mask (B, S), Wk, Wv (d, d) fp32 (in, out), d
// 128 or 256, heads dividing d -> KV (B, H, hd, hd), K_sum (B, d) fp32.
// Workspaces: wpack 4 d^2 floats, ws B Sp 2 d floats (Sp = S rounded up to
// 64), part B ceil(S / 512) (d hd + d) floats. Four launches: the pack
// (attn_f32.cu, at d / 64 heads), the projection, the chunk sums, their
// reduce.
int scream_attn_stats_heads_f32(const void* x, const void* mask, const void* wk, const void* wv,
                                void* wpack, void* ws, void* part, void* kv, void* ksum, int B,
                                int S, int d, int heads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || S <= 0 || !cell_ok(d, heads, true)) return (int)cudaErrorInvalidValue;
  int err = scream_pack_stats_f32(wk, wv, wpack, d, d / kGroup, stream);
  if (err) return err;
  const int Sp = (S + tf32::TM - 1) / tf32::TM * tf32::TM;
  err = d == 128 ? launch_proj_f32<128>(x, mask, wpack, ws, B, S, Sp, s)
                 : launch_proj_f32<256>(x, mask, wpack, ws, B, S, Sp, s);
  if (err) return err;
  return launch_sum_reduce((const float*)ws, (float*)part, (float*)kv, (float*)ksum, B, S, Sp, d,
                           d / heads, s);
}

}  // extern "C"
