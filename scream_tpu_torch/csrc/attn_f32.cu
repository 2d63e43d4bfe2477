// Fused linear-attention block in float32 for Hopper (sm_90a): the stats
// and apply kernels of the float32 configuration, their products on the
// tensor cores as split-TF32 ("3xTF32") wgmma (tf32_tile.cuh).
//
// Replaces the TPU kernels scream_tpu/ops/attn_pallas.py:_stats_kernel and
// scream_tpu/ops/attn_pallas.py:_apply_kernel as attention_block runs them
// for the float32 configuration (prec = HIGHEST, the KV carried whole in
// fp32, never split hi/lo). Same function as attn.cu, with no rounding to
// bf16 anywhere:
//
//   stats:  [k|v] = x_kv @ [Wk|Wv], K' = (elu(k)+1)*mask, V = v*mask, then
//           per (batch, head): KV = K'^T V (hd x hd) and K_sum = sum_rows K'.
//   apply:  q = x @ Wq, Q' = (elu(q)+1)*mask, att = Q' KV per head,
//           z = Q'.K_sum per head, msg = att / (z + eps) (as att * (1/(z+eps))),
//           then LN2(x + relu(LN1(msg @ Wm + x) @ W1) @ W2).
//
// What bounds them on the H100: operations. At the main path's shape (16 x
// 4,096 rows, d 256, hidden 1,024) apply does ~86 GFLOP of products and
// stats ~17 GFLOP (+ ~1 GFLOP of K'^T V), ~700 FLOP a byte of activations.
// On the CUDA cores' fp32 FMA (67 TFLOP/s) that is 1.30 and 0.27 ms; one
// pass of TF32 on the tensor cores (495 TFLOP/s) keeps ~11 bits of each
// operand, short of the fp32 bars (1e-5 stats, 2e-5 apply). The split does:
// each operand is hi + lo, two TF32 values (tf32_tile.cuh:split), and each
// product is lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B) into one fp32
// accumulator: ~22 bits of each operand (the dropped lo lo term is 2^-22 of
// the product), three passes at 495 TFLOP/s, a bound of 0.53 ms (apply) and
// 0.11 ms (stats) at that shape. Each promotion chunk of
// tf32_tile.cuh:kPromoteK k values starts a fresh accumulator, added into a
// master sum with fp32 FADD (tf32_tile.cuh:ring_mma3). On the card
// (scripts/torch_port_f32_probe.py) the wgmma work costs about that bound,
// and the rest does not overlap it: loading and splitting each stage's A
// fragments, the ring's handshake, and per tile the attention, the
// LayerNorms and the tile loads (apply without its wgmmas still takes more
// than half its time). The L2 stream of the packed hi and lo weights (5.2
// MB apply, 1 MB stats a 64-row tile at d 256) costs a few percent.
//
//   * Both kernels: one producer warpgroup (one thread issues 1-D bulk
//     copies of 32 KB ring stages, hopper_tile.cuh's Ring) and two consumer
//     warpgroups, a persistent grid over 64-row tiles. The two consumer
//     warpgroups take the same 64 rows and split each product's output
//     columns (N 64 or 128 each, so a warpgroup's master and chunk
//     accumulators are at most 2 x 64 registers). The row tile (the A
//     operand) stays fp32 in shared memory and is split in registers, one
//     stage's fragments before its wgmma fence; the weights are transposed to
//     N x K and pre-split into the ring's hi and lo halves once per call by
//     pack_stats_f32_kernel / pack_block_f32_kernel (the latter the fp32
//     tail's too, without Wq), launched by the same C entry point as the
//     kernel (plain versions in ops/attn_cuda.py): at the serving shapes the
//     host's time bounds a call, and a pack call of its own, as the bf16
//     wrappers make, would add about half again
//     (scripts/torch_port_f32_probe.py). scream_pack_stats_f32 /
//     scream_pack_block_f32 launch the packs alone, for their check.
//   * stats, in two launches. attn_stats_f32_kernel walks the (batch, tile)
//     items; per 128-column group of the packed [k_h | v_h] columns (1, 2
//     or 4 heads) it projects the tile on wgmma, applies elu1 and the mask,
//     and writes the group's K' | V to a shared tile; the tile's partial
//     K'^T V and K_sum of those heads are then summed over its 64 rows in
//     row order on fp32 FMA from shared memory (6-12 % of the operations:
//     as a wgmma it would take M = head dim rows, less than the 64 it
//     needs at head dim 16 and 32, and its operands K-major, a transposed
//     copy of K' and V) and written to a workspace, one slot per (batch,
//     tile). attn_stats_f32_reduce_kernel adds the slots of a batch in tile
//     order. No float atomics: two launches on one input agree bit for
//     bit, and a batch whose mask is all zero gives exact zeros.
//   * apply: per tile, q = x @ Wq on wgmma, then per head of the
//     warpgroup's columns the contraction with the batch's KV and K_sum on
//     fp32 FMA from shared memory (a row's head dims lie in a quad of
//     lanes, whose Q' values it gathers by shuffles; the KV is staged in
//     the hidden buffers, idle until the FFN), the message into the row
//     tile, then the tail on it (tf32_tail.cuh:tail_rows, the fp32 tail
//     kernel's body too): the merge, LN1, the FFN in 128-column hidden
//     chunks (double-buffered in shared memory) and LN2, every product on
//     wgmma. LayerNorm statistics cross the two warpgroups through shared
//     memory.
//
// Widths: d_model 128 and 256 with head dim 16, 32 or 64 (ATTN_F32_CELLS;
// 8 heads at both widths is the shipped models' split); hidden any multiple
// of 128. Templates on (D, HD); the C entry points dispatch on (d, heads).
// Rows past the sequence's end are zero in the tiles and never stored.
//
// Layout contract (checked by the Python wrapper, ops/attn_cuda.py): all
// tensors fp32, contiguous, 16-byte aligned; weights (in, out) row-major,
// packed by the pack kernels below; masks (B, S) / (B, L) fp32; KV (B, H,
// hd, hd), K_sum (B, d).

#include "tf32_tail.cuh"

namespace {

using namespace scream;
using tf32::kStage;
using tf32::Rows;
using tf32::Smem;
using tf32::TM;

// The (d, heads) cells the kernels are instantiated for: head dim 16, 32, 64.
#define ATTN_F32_CELLS(X) X(128, 8) X(128, 4) X(128, 2) X(256, 16) X(256, 8) X(256, 4)

constexpr int GC = 128;      // columns of a stats column group, and of an FFN hidden chunk
constexpr int KS_G = 32;     // k-rows of a stats stage
constexpr int LDP = GC + 8;  // stats: row stride of the K' | V tile (bank-shifted)

// Stats at width D, head dim HD: per item the x tile, then G column groups
// of SP stages (KS_G k-rows x 128 columns) each.
template <int D, int HD>
struct Stats {
  static constexpr int H = D / HD, HPG = GC / (2 * HD), G = 2 * D / GC, SP = D / KS_G;
  static constexpr int NS = G * SP;                   // stages an item
  static constexpr int PER = H * HD * HD + D;         // floats of a workspace slot
  static constexpr int X = 0, P = X + TM * D * 4, MS = P + TM * LDP * 4;
  using S = Smem<MS + TM * 4>;
  static constexpr int JT = HPG * HD * HD / 256;      // KV outputs a thread, per group
  static_assert(HPG * 2 * HD == GC && JT % 4 == 0 && HD % JT == 0 && KS_G == 32 && GC == 128,
                "stats: whole heads a group, a thread's KV outputs in one row, "
                "tf32_tile.cuh:project_kv's stages");
};

// Apply at width D, head dim HD: the tail's geometry (tf32_tail.cuh:Block;
// at D 128 / 256 the warpgroups' NW = D / 2 columns each in one pass, ring
// stages of 4096 / D k-rows of a D-wide weight or 32 k-rows of a 128-column
// W1 chunk), with Wq's stages first.
template <int D, int HD>
struct Apply {
  using G = tf32::Block<D>;
  static constexpr int H = D / HD, NW = G::NW;
  static constexpr int A = 0, HID = A + TM * D * 4, KSUM = HID + 2 * TM * G::HC * 4,
                       ST = KSUM + D * 4, MS = ST + 2 * TM * 8;
  using S = Smem<MS + TM * 4>;
  static_assert(G::PASSES == 1 && NW % HD == 0 && HD % 8 == 0 &&
                    H * HD * HD * 4 <= 2 * TM * G::HC * 4,
                "apply: one pass, whole heads a warpgroup, the KV fits the hidden buffers");
  // Ring stages of one tile: Wq, then the tail's.
  static __host__ __device__ constexpr int stages(int hid) { return G::stages(2, hid); }
};

// Stats, pass 1: per (batch, 64-row tile) item the partial K'^T V and K_sum
// over the tile's rows into its workspace slot.
template <int D, int HD>
__global__ void __launch_bounds__(tail::kThreads, 1)
attn_stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                      const float* __restrict__ wpack, float* __restrict__ ws, int S,
                      int nitems) {
  using C = Stats<D, HD>;
  constexpr int H = C::H, HPG = C::HPG, JT = C::JT, PER = C::PER;
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
  unsigned char* base = smem + C::S::NST * kStage;
  float* X = reinterpret_cast<float*>(base + C::X);
  float* P = reinterpret_cast<float*>(base + C::P);
  float* ms = reinterpret_cast<float*>(base + C::MS);
  // This thread's K'^T V outputs of a group: head hl, row ki, columns j0 .. j0+JT-1.
  const int o = tid * JT;
  const int hl = o / (HD * HD), ki = (o / HD) % HD, j0 = o % HD;
  float acc[32], c[32];  // a group's [k|v] (master) and the wgmma chunk

  for (int it = blockIdx.x; it < nitems; it += gridDim.x) {
    const int b = it / nt, tile = it % nt, row0 = tile * TM;
    const int nvalid = S - row0 < TM ? S - row0 : TM;
    float* slot = ws + ((size_t)b * nt + tile) * PER;
    // Per group the tile's K' | V (tf32_tile.cuh:project_kv), then its
    // partial sums over the tile's rows.
    tf32::project_kv<D, HD>(acc, c, ring, X, ms, x + ((size_t)b * S + row0) * D,
                            mask + (size_t)b * S + row0, nvalid, tid,
                            [&](int grp, const float(&a)[32]) {
      hopper::named_sync(1, 256);  // every read of P for the last group is done
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(P + (r0 + 8 * hh) * LDP + 64 * cp + 8 * j + 2 * t) =
              make_float2(a[4 * j + 2 * hh], a[4 * j + 2 * hh + 1]);
      hopper::named_sync(1, 256);
      // The tile's partial sums over its rows, in row order.
      {
        float kv[JT];
#pragma unroll
        for (int j = 0; j < JT; ++j) kv[j] = 0.f;
        const float* kcol = P + hl * 2 * HD + ki;
        const float* vcol = P + hl * 2 * HD + HD + j0;
#pragma unroll 4
        for (int r = 0; r < TM; ++r) {
          const float kr = kcol[r * LDP];
#pragma unroll
          for (int j = 0; j < JT; j += 4) {
            const float4 vr = *reinterpret_cast<const float4*>(vcol + r * LDP + j);
            kv[j + 0] = fmaf(kr, vr.x, kv[j + 0]);
            kv[j + 1] = fmaf(kr, vr.y, kv[j + 1]);
            kv[j + 2] = fmaf(kr, vr.z, kv[j + 2]);
            kv[j + 3] = fmaf(kr, vr.w, kv[j + 3]);
          }
        }
        float* dst = slot + (grp * HPG + hl) * HD * HD + ki * HD + j0;
#pragma unroll
        for (int j = 0; j < JT; j += 4)
          *reinterpret_cast<float4*>(dst + j) =
              make_float4(kv[j], kv[j + 1], kv[j + 2], kv[j + 3]);
      }
      if (tid < HPG * HD) {
        const int sh = tid / HD, si = tid % HD;
        const float* kcol = P + sh * 2 * HD + si;
        float s = 0.f;
#pragma unroll 4
        for (int r = 0; r < TM; ++r) s += kcol[r * LDP];
        slot[H * HD * HD + (grp * HPG + sh) * HD + si] = s;
      }
    });
  }
}

// out[b][e] = sum over the slots t = 0, 1, ... of ws[b][t][e], in slot order
// (tf32_tile.cuh:launch_reduce_slots).
__global__ void attn_stats_f32_reduce_kernel(const float* __restrict__ ws, float* __restrict__ kv,
                                             float* __restrict__ ksum, int B, int nt, int per,
                                             int nkv) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * per) return;
  const int b = idx / per, e = idx % per;
  const float* p = ws + (size_t)b * nt * per + e;
  float s = 0.f;
  for (int t = 0; t < nt; ++t) s += p[(size_t)t * per];
  if (e < nkv)
    kv[(size_t)b * nkv + e] = s;
  else
    ksum[(size_t)b * (per - nkv) + e - nkv] = s;
}

// Q' = (elu(q) + 1) * mask in registers, then per head of the warpgroup
// msg = Q' KV / (Q'.K_sum + eps), each sum one fmaf chain over the head's
// dims in order, written over that head's Q' registers. A row's head dims
// lie in the 4 lanes of a quad; each lane gathers the row's Q' values from
// its quad by shuffles and makes the message for its own columns.
template <int NW, int HD>
__device__ __forceinline__ void attend(float (&acc)[NW / 2], const float* ms, const Rows& w,
                                       const float* kvs, const float* kss, float eps) {
  constexpr int HJ = HD / 8, NH = NW / HD;
  const float m[2] = {ms[w.r0], ms[w.r0 + 8]};
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = tf32::elu1(acc[i]) * m[(i >> 1) & 1];
  const int base = w.lane & ~3;
#pragma unroll
  for (int hl = 0; hl < NH; ++hl) {
    const int h = w.cp * NH + hl;
    float att[2][HJ][2], z[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int jj = 0; jj < HJ; ++jj) att[hh][jj][0] = att[hh][jj][1] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      // Q'[row][h HD + d] is register 4 (hl HJ + d/8) + 2 hh + d%2 of lane
      // base + (d%8)/2.
      const int i = 4 * (hl * HJ + d / 8) + (d & 1);
      const int src = base | ((d & 7) >> 1);
      const float q0 = __shfl_sync(0xffffffffu, acc[i], src);
      const float q1 = __shfl_sync(0xffffffffu, acc[i + 2], src);
      const float ks = kss[h * HD + d];
      z[0] = fmaf(q0, ks, z[0]);
      z[1] = fmaf(q1, ks, z[1]);
#pragma unroll
      for (int jj = 0; jj < HJ; ++jj) {
        const float2 kv =
            *reinterpret_cast<const float2*>(kvs + (h * HD + d) * HD + 8 * jj + 2 * w.t);
        att[0][jj][0] = fmaf(q0, kv.x, att[0][jj][0]);
        att[0][jj][1] = fmaf(q0, kv.y, att[0][jj][1]);
        att[1][jj][0] = fmaf(q1, kv.x, att[1][jj][0]);
        att[1][jj][1] = fmaf(q1, kv.y, att[1][jj][1]);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float inv = 1.f / (z[hh] + eps);
#pragma unroll
      for (int jj = 0; jj < HJ; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[4 * (hl * HJ + jj) + 2 * hh + e] = att[hh][jj][e] * inv;
    }
  }
}

template <int D, int HD>
__global__ void __launch_bounds__(tail::kThreads, 1)
attn_apply_f32_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                      const float* __restrict__ wpack, const float* __restrict__ kv,
                      const float* __restrict__ ksum, const float* __restrict__ g1,
                      const float* __restrict__ b1, const float* __restrict__ g2,
                      const float* __restrict__ b2, float* __restrict__ out, int B, int L,
                      int hid, float attn_eps, float ln_eps, int norm_bf16) {
  using C = Apply<D, HD>;
  constexpr int NW = C::NW, H = C::H;
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
          ring.fill(wpack + (size_t)s * (kStage / 4));
          ring.advance();
        }
    }
    return;
  }
  hopper::setmaxnreg_inc<tail::kConsumerRegs>();
  typename C::S::Ring ring = ring0;
  const int tid = threadIdx.x, wt = tid & 127;
  Rows w;
  w.lane = tid & 31;
  w.r0 = 16 * (wt >> 5) + (w.lane >> 2);
  w.t = w.lane & 3;
  w.cp = tid >> 7;
  unsigned char* base = smem + C::S::NST * kStage;
  float* At = reinterpret_cast<float*>(base + C::A);
  float* Hs = reinterpret_cast<float*>(base + C::HID);
  float* kvs = Hs;  // the batch's KV, in the hidden buffers (idle until the FFN)
  float* kss = reinterpret_cast<float*>(base + C::KSUM);
  float2* stats = reinterpret_cast<float2*>(base + C::ST);
  float* ms = reinterpret_cast<float*>(base + C::MS);
  const bool nbf = norm_bf16 != 0;

  // A product's master sum and the wgmma chunk; the W1 product (64 columns
  // a warpgroup) keeps its master in c[32 .. 64): ptxas holds a thread to
  // 168 registers, and at d 256 f, c, a separate master and a stage's A
  // fragments would need 192.
  float acc[NW / 2], c[C::G::CN];

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / tpb, l0 = (tile % tpb) * TM;
    const int nvalid = L - l0 < TM ? L - l0 : TM;
    const size_t row0 = (size_t)b * L + l0;
    const float* xb = x + row0 * D;
    hopper::named_sync(1, 256);  // the last tile's reads of the buffers are done
    tf32::load_tile<D>(At, xb, nvalid, tid, 256);
    for (int i = tid; i < H * HD * HD / 4; i += 256)
      reinterpret_cast<float4*>(kvs)[i] =
          __ldg(reinterpret_cast<const float4*>(kv + (size_t)b * H * HD * HD) + i);
    for (int i = tid; i < D / 4; i += 256)
      reinterpret_cast<float4*>(kss)[i] =
          __ldg(reinterpret_cast<const float4*>(ksum + (size_t)b * D) + i);
    if (tid < TM) ms[tid] = tid < nvalid ? mask[row0 + tid] : 0.f;
    hopper::named_sync(1, 256);

    // q, then the message in its place.
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    tf32::wide_mma<typename C::G, D>(acc, c, ring, At, w.cp, wt);
    attend<NW, HD>(acc, ms, w, kvs, kss, attn_eps);
    hopper::named_sync(1, 256);  // both warpgroups' reads of x in the tile are done
    tf32::store_tile<NW, D>(acc, At, w, false);
    hopper::named_sync(1, 256);

    // The tail on the message, x the residual.
    tf32::tail_rows<D>(acc, c, ring, At, Hs, stats, xb, out + row0 * D, nvalid, hid, g1, b1,
                       g2, b2, ln_eps, nbf, w, wt);
  }
}

// The split of a weight element: hi, or lo for the second half of a stage.
__device__ __forceinline__ float split_half(float v, unsigned lo) {
  const uint32_t hi = tf32::rna(v);
  return __uint_as_float(lo ? tf32::rna(v - __uint_as_float(hi)) : hi);
}

// [Wk|Wv] (d, d) each -> the stats blob: stage s = g (d / 32) + p holds
// packed columns 128 g .. 128 g + 127 by k-rows 32 p .. 32 p + 31, hi then
// lo, where packed column c is column w of k_h (w < hd) or column w - hd of
// v_h, h = c / (2 hd), w = c % (2 hd). One output float a thread.
__global__ void pack_stats_f32_kernel(const float* __restrict__ wk, const float* __restrict__ wv,
                                      float* __restrict__ out, unsigned d, unsigned hd) {
  const unsigned n = 4 * d * d, sp = d / KS_G;
  for (unsigned o = blockIdx.x * blockDim.x + threadIdx.x; o < n;
       o += gridDim.x * blockDim.x) {
    const unsigned s = o / (2 * tf32::kHalfFloats);
    unsigned k, col;
    tf32::stage_src(o % tf32::kHalfFloats, GC, k, col);
    k += KS_G * (s % sp);
    col += GC * (s / sp);
    const unsigned h = col / (2 * hd), w = col % (2 * hd);
    const float v = w < hd ? wk[k * d + h * hd + w] : wv[k * d + h * hd + w - hd];
    out[o] = split_half(v, (o / tf32::kHalfFloats) & 1);
  }
}

// The block blob of tf32_tail.cuh:Block (its geometry in g): [Wq], Wm,
// then per hidden chunk of g.hc columns its W1 columns in stages of g.ksh
// k-rows and its W2 rows in stages of g.ksd; each D-wide weight in g.passes
// passes of stages of g.ksd k-rows x 2 g.nd columns, pass p's packed column
// c being column (c / nd) (d / 2) + p nd + c % nd. Hi then lo in every
// stage. One output float a thread.
struct PackGeo {
  unsigned nd, passes, ksd, hc, ksh;
};

__global__ void pack_block_f32_kernel(const float* __restrict__ wq, const float* __restrict__ wm,
                                      const float* __restrict__ w1,
                                      const float* __restrict__ w2, float* __restrict__ out,
                                      unsigned d, unsigned hid, PackGeo g) {
  const unsigned kst = d / g.ksd, s_d = g.passes * kst, s_w1 = d / g.ksh,
                 per = g.hc / g.ksd, s_w2 = g.passes * per, sq = wq ? 2 : 1;
  const unsigned n = 2 * (sq * d * d + 2 * d * hid);
  for (unsigned o = blockIdx.x * blockDim.x + threadIdx.x; o < n;
       o += gridDim.x * blockDim.x) {
    const unsigned s = o / (2 * tf32::kHalfFloats);
    const float* src;
    unsigned ld = d, k0, n0 = 0, ns = 2 * g.nd, p = 0;
    bool wide = true;  // a D-wide weight: its stage's columns from pass p
    if (s < sq * s_d) {
      src = wq && s < s_d ? wq : wm;
      p = (s % s_d) / kst, k0 = (s % kst) * g.ksd;
    } else {
      const unsigned r = (s - sq * s_d) % (s_w1 + s_w2), ch = (s - sq * s_d) / (s_w1 + s_w2);
      if (r < s_w1) {
        src = w1, ld = hid, k0 = r * g.ksh, n0 = ch * g.hc, ns = g.hc, wide = false;
      } else {
        src = w2, p = (r - s_w1) / per, k0 = ch * g.hc + ((r - s_w1) % per) * g.ksd;
      }
    }
    unsigned k, col;
    tf32::stage_src(o % tf32::kHalfFloats, ns, k, col);
    if (wide) col = (col / g.nd) * (d / 2) + p * g.nd + col % g.nd;
    out[o] = split_half(src[(size_t)(k0 + k) * ld + n0 + col], (o / tf32::kHalfFloats) & 1);
  }
}

int pack_grid(unsigned n) { return (int)((n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048); }

int launch_pack_stats(const void* wk, const void* wv, void* out, int d, int heads,
                      cudaStream_t stream) {
  pack_stats_f32_kernel<<<pack_grid(4u * d * d), 256, 0, stream>>>(
      (const float*)wk, (const float*)wv, (float*)out, (unsigned)d, (unsigned)(d / heads));
  return (int)cudaGetLastError();
}

template <int D, int HD>
int launch_stats(const void* x, const void* mask, const void* wpack, void* ws, void* kv,
                 void* ksum, int B, int S, cudaStream_t stream) {
  using C = Stats<D, HD>;
  static std::atomic<unsigned> smem_set{0};
  const int nt = (S + TM - 1) / TM, nitems = B * nt;
  if (nitems > 0) {
    int err = tf32::set_smem(attn_stats_f32_kernel<D, HD>, C::S::BYTES, smem_set);
    if (err) return err;
    const int grid = nitems < tail::num_sms() ? nitems : tail::num_sms();
    attn_stats_f32_kernel<D, HD><<<grid, tail::kThreads, C::S::BYTES, stream>>>(
        (const float*)x, (const float*)mask, (const float*)wpack, (float*)ws, S, nitems);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return tf32::launch_reduce_slots((const float*)ws, (float*)kv, (float*)ksum, B, nt, C::PER,
                                   C::H * HD * HD, stream);
}

template <int D, int HD>
int launch_apply(const void* x, const void* mask, const void* wpack, const void* kv,
                 const void* ksum, const void* g1, const void* b1, const void* g2,
                 const void* b2, void* out, int B, int L, int hid, float attn_eps,
                 float ln_eps, int norm_bf16, cudaStream_t stream) {
  using C = Apply<D, HD>;
  static std::atomic<unsigned> smem_set{0};
  int err = tf32::set_smem(attn_apply_f32_kernel<D, HD>, C::S::BYTES, smem_set);
  if (err) return err;
  const int ntiles = B * ((L + TM - 1) / TM);
  const int grid = ntiles < tail::num_sms() ? ntiles : tail::num_sms();
  attn_apply_f32_kernel<D, HD><<<grid, tail::kThreads, C::S::BYTES, stream>>>(
      (const float*)x, (const float*)mask, (const float*)wpack, (const float*)kv,
      (const float*)ksum, (const float*)g1, (const float*)b1, (const float*)g2,
      (const float*)b2, (float*)out, B, L, hid, attn_eps, ln_eps, norm_bf16);
  return (int)cudaGetLastError();
}

// Whether (d, heads) is a cell of ATTN_F32_CELLS.
bool f32_cell(int d, int heads) {
#define ATTN_F32_IS_CELL(D, H) \
  if (d == D && heads == H) return true;
  ATTN_F32_CELLS(ATTN_F32_IS_CELL)
#undef ATTN_F32_IS_CELL
  return false;
}

template <int D>
PackGeo pack_geo() {
  using G = tf32::Block<D>;
  return PackGeo{G::ND, G::PASSES, G::KS_D, G::HC, G::KS_H};
}

}  // namespace

int scream::tf32::launch_pack_block(const void* wq, const void* wm, const void* w1,
                                    const void* w2, void* out, int d, int hid,
                                    cudaStream_t stream) {
  const PackGeo g = d == 128 ? pack_geo<128>() : d == 256 ? pack_geo<256>() : pack_geo<384>();
  const unsigned n = 2u * ((wq ? 2u : 1u) * d * d + 2u * d * hid);
  pack_block_f32_kernel<<<pack_grid(n), 256, 0, stream>>>(
      (const float*)wq, (const float*)wm, (const float*)w1, (const float*)w2, (float*)out,
      (unsigned)d, (unsigned)hid, g);
  return (int)cudaGetLastError();
}

namespace scream {
namespace tf32 {

int launch_reduce_slots(const float* part, float* kv, float* ksum, int B, int nslots, int per,
                        int nkv, cudaStream_t stream) {
  const int n = B * per;
  attn_stats_f32_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, kv, ksum, B, nslots,
                                                                     per, nkv);
  return (int)cudaGetLastError();
}

}  // namespace tf32
}  // namespace scream

extern "C" {

// x (B, S, d) fp32, mask (B, S) fp32, Wk, Wv (d, d) fp32 (in, out), (d,
// heads) a cell of ATTN_F32_CELLS -> KV (B, H, hd, hd) and K_sum (B, d)
// fp32. Three launches: the weight pack into wpack (4 d^2 floats,
// pack_stats_f32_kernel), the projection and per-tile sums into ws (B
// ceil(S/64) (H hd^2 + d) floats), the reduce.
int scream_attn_stats_f32(const void* x, const void* mask, const void* wk, const void* wv,
                          void* wpack, void* ws, void* kv, void* ksum, int B, int S, int d,
                          int heads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || S < 0 || !f32_cell(d, heads))
    return (int)cudaErrorInvalidValue;
  const int err = launch_pack_stats(wk, wv, wpack, d, heads, s);
  if (err) return err;
#define ATTN_F32_STATS(D, H)                                                             \
  if (d == D && heads == H)                                                              \
    return launch_stats<D, D / H>(x, mask, wpack, ws, kv, ksum, B, S, s);
  ATTN_F32_CELLS(ATTN_F32_STATS)
#undef ATTN_F32_STATS
  return (int)cudaErrorInvalidValue;
}

// Wk, Wv (d, d) fp32, (in, out), (d, heads) a cell -> the stats blob out,
// 4 d^2 floats (pack_stats_f32_kernel; scream_attn_stats_f32 launches it
// too). One launch.
int scream_pack_stats_f32(const void* wk, const void* wv, void* out, int d, int heads,
                          void* stream) {
  if (!f32_cell(d, heads)) return (int)cudaErrorInvalidValue;
  return launch_pack_stats(wk, wv, out, d, heads, (cudaStream_t)stream);
}

// Wq (d, d) or NULL, Wm (d, d), W1 (d, hid), W2 (hid, d) fp32, (in, out),
// d 128 or 256 with Wq (apply), 128, 256 or 384 without (the tail), hid a
// multiple of 128 -> the block blob out, 2 ((2 or 1) d^2 + 2 d hid) floats
// (pack_block_f32_kernel; scream_attn_apply_f32 and scream_block_tail_f32
// launch it too). One launch.
int scream_pack_block_f32(const void* wq, const void* wm, const void* w1, const void* w2,
                          void* out, int d, int hid, void* stream) {
  if ((d != 128 && d != 256 && (wq || d != 384)) || hid <= 0 || hid % GC)
    return (int)cudaErrorInvalidValue;
  return tf32::launch_pack_block(wq, wm, w1, w2, out, d, hid, (cudaStream_t)stream);
}

// x (B, L, d) fp32 (query source and both residuals), mask (B, L) fp32,
// Wq, Wm (d, d), W1 (d, hid), W2 (hid, d) fp32 (in, out), the stats of
// scream_attn_stats_f32, LayerNorm params (d,) fp32 -> out (B, L, d) fp32.
// (d, heads) a cell of ATTN_F32_CELLS, hidden a multiple of 128; norm_bf16
// rounds the LayerNorm outputs through bf16 (norm dtype bf16). Two
// launches: the weight pack into wpack (2 (2 d^2 + 2 d hid) floats,
// pack_block_f32_kernel), then the block.
int scream_attn_apply_f32(const void* x, const void* mask, const void* wq, const void* wm,
                          const void* w1, const void* w2, void* wpack, const void* kv,
                          const void* ksum, const void* g1, const void* b1, const void* g2,
                          const void* b2, void* out, int B, int L, int d, int heads, int hid,
                          float attn_eps, float ln_eps, int norm_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || L <= 0 || hid <= 0 || hid % GC || !f32_cell(d, heads))
    return (int)cudaErrorInvalidValue;
  const int err = tf32::launch_pack_block(wq, wm, w1, w2, wpack, d, hid, s);
  if (err) return err;
#define ATTN_F32_APPLY(D, H)                                                             \
  if (d == D && heads == H)                                                              \
    return launch_apply<D, D / H>(x, mask, wpack, kv, ksum, g1, b1, g2, b2, out, B, L,  \
                                  hid, attn_eps, ln_eps, norm_bf16, s);
  ATTN_F32_CELLS(ATTN_F32_APPLY)
#undef ATTN_F32_APPLY
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
