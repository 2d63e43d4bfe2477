// Fused linear-attention block for Hopper (sm_90a): two kernels, stats and apply.
//
// Replaces the TPU kernels scream_tpu/ops/attn_pallas.py:_stats_kernel and
// scream_tpu/ops/attn_pallas.py:_apply_kernel (both called from
// attention_block). Same function, bf16 operands with fp32 accumulation:
//
//   stats:  [k|v] = x_kv @ [Wk|Wv] (rounded to bf16), K' = (elu(k)+1)*mask,
//           V = v*mask, then per (batch, head): KV = K'^T V (fp32, hd x hd)
//           and K_sum = sum_rows K' (fp32).
//   apply:  q = x @ Wq (bf16), Q' = (elu(q)+1)*mask, att = Q' KV per head
//           (fp32 KV), z = 1/(Q'.K_sum + eps) per head (fp32),
//           msg = bf16(att*z), then LN2(x + relu(LN1(msg @ Wm + x) @ W1) @ W2)
//           with fp32 LayerNorm statistics, var = max(0, E[x^2] - mu^2).
//
// What bounds them on the H100: at the main path's shape (16 x 4096 rows,
// d = 256, hidden 1024) the apply kernel does ~86 GFLOP per call against
// ~67 MB of activations in and out, ~1,300 FLOP per byte, so it is bound by
// tensor-core operations, not by HBM; short of that, by how many rows each
// weight byte read from L2 feeds. The stats kernel does ~17 GFLOP (the
// projection; the per-head K'^T V is ~1 GFLOP) over a 33.5 MB input that
// takes 10 us of HBM, so it is bound by operations too; short of that, by
// how many blocks share the sequence, the epilogue and the K'/V workspace's
// round trip through HBM (~40 us at that shape). At
// the GT-free serving shapes (d = 128, hidden 512, 8 x 512 rows) a call is
// ~1.3 GFLOP, a few microseconds of tensor-core time, so launch latency and
// the few blocks bound it instead. What the design does about it:
//   * apply (the Hopper pipeline of hopper_tile.cuh): the query
//     projection, the merge and the FFN run on wgmma with the 128-row tile
//     as A in shared memory and the weights streamed through a ring of
//     shared-memory stages by bulk copies that complete on mbarriers (one
//     producer warpgroup, two consumer warpgroups of 64 rows each). After the
//     projection, the per-head contraction with the fp32 KV and the
//     normalizer run on CUDA cores in fp32 (2 R H hd^2 operations, a few
//     percent of the products'); the message overwrites the tile, and the
//     merge, LayerNorms and FFN are tail_tile.cuh's, the code tail.cu runs.
//   * stats, in two kernels. The projection runs on the same pipeline:
//     the sequence is cut into 128-row tiles and a persistent grid walks
//     the (batch, tile) items (the shape alone sets them, never the SM
//     count). Each block loads its tile of x once into shared memory (x is
//     read from HBM once per call, not once per head) and streams [Wk|Wv]
//     past it through the ring, packed once per call (stats_pack_kernel)
//     with its columns regrouped per head as [k_h | v_h]: a ring stage
//     holds whole [k_h | v_h] groups, at least 64 columns (two heads at
//     head dim 16, one at 32, 48 or 64: m64n64, m64n96 or m64n128, so
//     N = 32 is never needed), by all d k-rows where that stays within
//     32 KB (d 128, and d 256 at head dim <= 32), else by 128 k-rows, the
//     products of one column group then chaining over d / 128 stages (at
//     d 384 a 96-column stage by all 384 k-rows is 72 KB, and the 96 KB x
//     tile with two of them would not fit in 227 KB; a 64-row x tile would
//     halve the rows each weight byte feeds). Per column group each
//     consumer warpgroup projects its 64 rows on wgmma, rounds
//     to bf16, applies elu1 to the k half, masks, and writes K'_h and V_h
//     through a shared-memory tile to a bf16 workspace, one contiguous run
//     of rows per (batch, head): 67 MB at 16 x 4096, d 256, about 20 us of
//     HBM each way. The second kernel (one block per (head, batch))
//     streams those rows through a cp.async ring and sums them in row
//     order over the whole sequence: KV_h = K'_h^T V_h on mma.sync
//     (wmma m16n16k16, 16-row steps chained in one fp32 accumulator per
//     16 x 16 block of KV, ~6 % of the projection's operations at head dim
//     32) and K_sum row by row in fp32, one column a lane: the
//     order of one block walking the sequence, the same at every shape,
//     batch and grid. (Per-chunk partials added afterwards would change
//     the last bits of KV, and GT-free serving's bistable pairs follow
//     such bits: see PERF.md.) No float atomics:
//     two launches on the same input are bit identical. The TPU's bf16
//     hi/lo split of KV is a Mosaic workaround; the apply kernel reads the
//     fp32 KV directly.
//   * Nothing intermediate goes to device memory but the stats workspace
//     (K' and V): Q, the message and the FFN hidden stay in shared memory
//     or registers.
//
// Widths: every kernel is a template on (D, HD), the width and the head
// dim, and the C entry points dispatch on (d, heads) over ATTN_CELLS: d
// 128 and 256 with head dim 16, 32 or 64 (8 heads of 32 at d 256 is the
// full model, 8 of 16 at d 128 the hint-free GT-free checkpoint) and d 384
// with head dim 16, 32, 48 or 64 (8 heads of 48: `--d-model 384`). At
// d 384 the apply tile is 64 rows and each consumer warpgroup owns 192
// output columns (tail_tile.cuh, COLS 2): a whole number of heads at every
// head dim, so each attends its own heads with no exchange. In the apply
// kernel a row's head dims lie in one quad of lanes at every width.
//
// The other head counts go to the head-generic kernels (attn_heads.cu,
// attn_heads_apply.cu), whose stats run this file's projection at head dim
// 64 (launch_projection64): [Wk|Wv] in 64-column groups, whatever the head
// count.
//
// Layout contract (checked by the Python wrapper, ops/attn_cuda.py):
// (d, heads) a cell of ATTN_CELLS, hidden a multiple of 128, all tensors
// contiguous, bf16 activations and weights ((in, out) row-major, packed by
// stats_pack_kernel for stats and by ops/tail_cuda.py:pack_weights for
// apply), fp32 masks, LayerNorm params and statistics.

#include <mma.h>

#include "tail_tile.cuh"

namespace {

using namespace nvcuda;
using namespace scream;
using hopper::bf16;

constexpr int TM = 128;       // stats: rows a tile (two warpgroups of 64)

// The (d, head dim) cells the kernels are instantiated for.
#define ATTN_CELLS(X) \
  X(128, 16) X(128, 32) X(128, 64) X(256, 16) X(256, 32) X(256, 64) \
  X(384, 16) X(384, 32) X(384, 48) X(384, 64)

// A stats ring stage: whole [k_h | v_h] groups, at least 64 columns, by all
// d k-rows where the stage stays within 32 KB, else by 128 k-rows (the
// pack and the kernel both read these).
__host__ __device__ constexpr int stats_cols(int hd) { return 2 * hd > 64 ? 2 * hd : 64; }
__host__ __device__ constexpr int stats_krows(int d, int hd) {
  return stats_cols(hd) * d * 2 <= 32768 ? d : 128;
}
// Threads of the sum block: a warp per 16 x 16 block of KV, + the K_sum warp.
__host__ __device__ constexpr int stats_sum_threads(int hd) {
  return 32 * ((hd / 16) * (hd / 16) + 1);
}

// elu(x) + 1 as where(x > 0, x + 1, exp(x)), in fp32 (attn_pallas._elu1).
__device__ __forceinline__ float elu1(float v) {
  return v > 0.f ? v + 1.f : expf(v);
}

// Stats geometry at width D, head dim HD. A ring stage is NSC columns of
// the packed [Wk|Wv] (a column group: HPS heads' [k_h | v_h]) by KS
// k-rows; a column group's product chains over its KP stages.
template <int D, int HD>
struct Stats {
  static constexpr int H = D / HD;
  static constexpr int W2 = 2 * HD;           // a head's [K'_h | V_h] row
  static constexpr int NSC = stats_cols(HD);  // columns of a stage: 64, 96, 128
  static constexpr int HPS = NSC / W2;        // heads a stage: 2 at hd 16, else 1
  static constexpr int KS = stats_krows(D, HD);  // k-rows of a stage: D or 128
  static constexpr int KP = D / KS;           // stages of a column group
  static constexpr int NS = 2 * D / NSC * KP; // stages a tile
  static constexpr int STAGE = NSC * KS * 2;  // bytes a stage: 16-32 KB
  static constexpr int TILE_BYTES = TM * D * 2;
  static constexpr int OLD = NSC + 8;         // out tile row stride (bf16), bank-shifted
  static constexpr int OUT_BYTES = 64 * OLD * 2;  // per warpgroup
  static constexpr int REST = TILE_BYTES + 2 * OUT_BYTES + 16 * tail::kMaxStages;
  static constexpr int FIT = (tail::kSmemMax - REST) / STAGE;
  static constexpr int NST = FIT < tail::kMaxStages ? FIT : tail::kMaxStages;
  static constexpr int TILE = NST * STAGE;    // the x tile, after the ring
  static constexpr int OUTB = TILE + TILE_BYTES;
  static constexpr int BARS = OUTB + 2 * OUT_BYTES;
  static constexpr int BYTES = BARS + 16 * NST;
  // Pass 2: SUM_ROWS-row tiles of one head's [K'_h | V_h] rows, SUM_ST in
  // flight, rows SUM_LD bf16 apart in shared memory (bank-shifted).
  static constexpr int KVF = HD / 16;         // 16 x 16 KV fragments a side: 1-4
  static constexpr int KV_W = KVF * KVF;      // warps of the KV product: 1-16
  static constexpr int KSW = (HD + 31) / 32;  // K_sum columns a lane: 1, 2
  static constexpr int SUM_THREADS = stats_sum_threads(HD);  // KV_W + the K_sum warp
  static constexpr int SUM_ROWS = 128;
  static constexpr int SUM_ST = 4;
  static constexpr int SUM_LD = W2 + 8;
  static constexpr int SUM_TILE = SUM_ROWS * SUM_LD * 2;  // bytes: 10-34 KB
  static_assert(HD % 16 == 0 && NSC % W2 == 0 && KS % 16 == 0 && KP * KS == D &&
                NST >= 2 && BYTES <= tail::kSmemMax && TM % SUM_ROWS == 0,
                "stats layout");
  using Ring = hopper::Ring<NST, STAGE, BARS>;
};

// Stats, pass 1: the projection. A persistent grid walks the (batch, tile)
// items, item it = b * T + t; warpgroup w of the block takes rows
// 64 w .. 64 w + 63 of the tile. Per column group (KP ring stages, its
// k-rows in order) it projects its rows onto the group's heads on wgmma,
// rounds to bf16, applies elu1 to k (rounded again) and the mask, and
// writes K'_h and V_h row by row to kvw, laid out (B, H, Sp, 2 HD) bf16
// with Sp = 128 T (rows at or past S are zeros).
template <int D, int HD>
__global__ void __launch_bounds__(tail::kThreads, 1)
attn_stats_kernel(const bf16* __restrict__ x, const float* __restrict__ mask,
                  const unsigned char* __restrict__ wpack, bf16* __restrict__ kvw,
                  int S, int nitems) {
  using C = Stats<D, HD>;
  constexpr int H = C::H, W2 = C::W2, NSC = C::NSC;
  extern __shared__ __align__(128) unsigned char smem[];
  const typename C::Ring ring0(hopper::smem_u32(smem));
  const int T = (S + TM - 1) / TM, Sp = T * TM;
  if (threadIdx.x == 0) ring0.init(tail::kConsumers);
  __syncthreads();

  if (threadIdx.x >= 128 * tail::kConsumers) {
    hopper::setmaxnreg_dec<tail::kProducerRegs>();
    if (threadIdx.x == 128 * tail::kConsumers) {
      typename C::Ring ring = ring0;
      for (int it = blockIdx.x; it < nitems; it += gridDim.x)
        for (int st = 0; st < C::NS; ++st) {
          ring.fill(wpack + (size_t)st * C::STAGE);
          ring.advance();
        }
    }
    return;
  }
  hopper::setmaxnreg_inc<tail::kConsumerRegs>();
  typename C::Ring ring = ring0;
  const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
  const int warp = wt >> 5, lane = threadIdx.x & 31;
  const int bar = 1 + wg;                  // named barrier of the warpgroup
  const int r0 = 16 * warp + (lane >> 2);  // rows r0, r0 + 8 of the warpgroup's 64
  bf16* xt = reinterpret_cast<bf16*>(smem + C::TILE) + (size_t)wg * 64 * D;
  bf16* ot = reinterpret_cast<bf16*>(smem + C::OUTB + wg * C::OUT_BYTES);
  const uint32_t xa = hopper::smem_u32(xt);

  // The projection's accumulators. They are zeroed only where no wgmma is
  // in flight: a write to an accumulator register inside an open wgmma
  // window makes ptxas serialize every wgmma of the kernel.
  float acc[NSC / 2];
#pragma unroll
  for (int i = 0; i < NSC / 2; ++i) acc[i] = 0.f;
  hopper::fence_acc(acc);

  for (int it = blockIdx.x; it < nitems; it += gridDim.x) {
    const int b = it / T, row0 = (it % T) * TM + 64 * wg;
    const int nvalid = S - row0;
    hopper::named_sync(bar, 128);  // every read of the last tile is done
    hopper::load_tile64<D>(xt, x + ((size_t)b * S + row0) * D, nvalid, wt, 128);
    hopper::fence_proxy_async();
    hopper::named_sync(bar, 128);
    float m[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      m[hh] = r0 + 8 * hh < nvalid ? hopper::round_bf16(mask[(size_t)b * S + row0 + r0 + 8 * hh])
                                   : 0.f;

    for (int st = 0; st < C::NS; ++st) {
      // [k_h | v_h] of column group st / KP's heads for the warpgroup's 64
      // rows, over the k-rows of part st % KP.
      const int kp = st % C::KP;
      const uint32_t sa = ring.wait_full();
      uint64_t da = hopper::desc(xa + 16 * C::KS * kp, 128, 16 * D);
      uint64_t db = hopper::desc(sa, 128, 256);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < C::KS / 16; ++k) {
        hopper::Wgmma<NSC>::mma(acc, da, db);
        if (k + 1 < C::KS / 16) {  // A 256 bytes on, B one k16 step (32 NSC bytes) on
          asm volatile("add.s64 %0, %0, 16;\n" : "+l"(da));
          asm volatile("add.s64 %0, %0, %1;\n" : "+l"(db) : "n"(2 * NSC));
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(acc);
      if (wt == 0) ring.release(ring.slot);
      ring.advance();
      if (kp + 1 < C::KP) continue;  // the group's next k-rows add on
      // Round to bf16, elu1 on k (rounded again), mask, into the out tile
      // (row-major, NSC stage columns). acc[4j + 2hh + e] is row r0 + 8hh,
      // stage column 8j + 2(lane%4) + e.
#pragma unroll
      for (int j = 0; j < NSC / 8; ++j) {
        const bool is_k = (8 * j) % W2 < HD;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = hopper::round_bf16(acc[4 * j + 2 * hh + e]);
            if (is_k) v[e] = hopper::round_bf16(elu1(v[e]));
            v[e] *= m[hh];
          }
          *reinterpret_cast<__nv_bfloat162*>(ot + (r0 + 8 * hh) * C::OLD + 8 * j +
                                             2 * (lane & 3)) = __floats2bfloat162_rn(v[0], v[1]);
        }
      }
#pragma unroll
      for (int i = 0; i < NSC / 2; ++i) acc[i] = 0.f;  // for the next group
      hopper::fence_acc(acc);
      hopper::named_sync(bar, 128);  // the out tile is written
      // Out: 64 rows x HPS heads x W2 columns, 16 bytes a thread-step.
#pragma unroll
      for (int q = 0; q < 64 * NSC / 8 / 128; ++q) {
        const int i = wt + 128 * q, r = i / (NSC / 8), c = 8 * (i % (NSC / 8));
        const int h = st / C::KP * C::HPS + c / W2;
        *reinterpret_cast<uint4*>(kvw + (((size_t)b * H + h) * Sp + row0 + r) * W2 + c % W2) =
            *reinterpret_cast<const uint4*>(ot + r * C::OLD + c);
      }
      hopper::named_sync(bar, 128);  // the out tile is read
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src));
}

// Stats, pass 2: KV and K_sum of head h of batch b, one block each (grid
// (H, B)), in row order over the whole sequence. Warp w < KV_W chains its
// 16 x 16 block of K'_h^T V_h through wmma (mma.sync m16n16k16, fp32
// accumulator) over every 16-row step; the K_sum warp adds K'_h row by row
// in fp32, lane l columns l and l + 32. Rows stream through SUM_ST tiles of SUM_ROWS rows by cp.async
// (rows SUM_LD apart in shared memory, so the 8 rows of a fragment fall in
// 8 bank groups); rows past S read the workspace's zeros, which leave both
// sums as they are.
template <int D, int HD>
__global__ void __launch_bounds__(stats_sum_threads(HD))
attn_stats_reduce_kernel(const bf16* __restrict__ kvw, float* __restrict__ kv,
                         float* __restrict__ ksum, int S) {
  using C = Stats<D, HD>;
  constexpr int H = C::H, W2 = C::W2, LD = C::SUM_LD, CH = C::SUM_ROWS * W2 / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Sp = (S + TM - 1) / TM * TM, nt = (S + C::SUM_ROWS - 1) / C::SUM_ROWS;
  const bf16* src = kvw + ((size_t)b * H + h) * Sp * W2;
  auto fetch = [&](int t) {
    if (t < nt)
      for (int i = threadIdx.x; i < CH; i += C::SUM_THREADS)
        cp_async16(smem + (t % C::SUM_ST) * C::SUM_TILE + (i / (W2 / 8)) * LD * 2 +
                       16 * (i % (W2 / 8)),
                   src + (size_t)t * C::SUM_ROWS * W2 + 8 * i);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  for (int t = 0; t < C::SUM_ST - 1; ++t) fetch(t);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  float ks[C::KSW] = {};  // the K_sum warp: columns lane + 32 c (< HD)
  const int bi = warp / C::KVF, bj = warp % C::KVF;
  for (int t = 0; t < nt; ++t) {
    fetch(t + C::SUM_ST - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(C::SUM_ST - 1));
    __syncthreads();  // tile t is in
    const bf16* tile = reinterpret_cast<const bf16*>(smem + (t % C::SUM_ST) * C::SUM_TILE);
    if (warp < C::KV_W) {  // every operand of the tile first, then the chain
      constexpr int KS = C::SUM_ROWS / 16;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[KS];  // K'^T
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[KS];
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        wmma::load_matrix_sync(fa[k], tile + 16 * k * LD + bi * 16, LD);
        wmma::load_matrix_sync(fb[k], tile + 16 * k * LD + HD + bj * 16, LD);
      }
#pragma unroll
      for (int k = 0; k < KS; ++k) wmma::mma_sync(acc, fa[k], fb[k], acc);
    } else {
#pragma unroll
      for (int c = 0; c < C::KSW; ++c)
        if (lane + 32 * c < HD) {
#pragma unroll 16
          for (int r = 0; r < C::SUM_ROWS; ++r)
            ks[c] += __bfloat162float(tile[r * LD + lane + 32 * c]);
        }
    }
    __syncthreads();  // tile t is read before its slot is refilled
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  if (warp < C::KV_W)
    wmma::store_matrix_sync(kv + (((size_t)b * H + h) * HD + bi * 16) * HD + bj * 16, acc, HD,
                            wmma::mem_row_major);
  else
#pragma unroll
    for (int c = 0; c < C::KSW; ++c)
      if (lane + 32 * c < HD) ksum[(size_t)b * D + h * HD + lane + 32 * c] = ks[c];
}

// [Wk|Wv] (d, d) bf16 each -> the stats ring's blob: stage s holds packed
// columns nsc g .. nsc g + nsc - 1 by k-rows ks p .. ks p + ks - 1, g = s /
// (d / ks), p = s % (d / ks), in the stage layout of hopper_tile.cuh, where
// packed column c is column w of k_h (w < hd) or column w - hd of v_h,
// h = c / (2 hd), w = c % (2 hd). One output element a thread.
__global__ void stats_pack_kernel(const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                                  bf16* __restrict__ out, unsigned d, unsigned hd,
                                  unsigned nsc, unsigned ks) {
  const unsigned n = 2 * d * d, kp = d / ks;
  for (unsigned o = blockIdx.x * blockDim.x + threadIdx.x; o < n;
       o += gridDim.x * blockDim.x) {
    unsigned k, col;
    const unsigned s = o / (nsc * ks);
    hopper::kmajor_src(o % (nsc * ks), nsc, ks, k, col);
    k += ks * (s % kp);
    col += nsc * (s / kp);
    const unsigned h = col / (2 * hd), w = col % (2 * hd);
    out[o] = w < hd ? wk[k * d + h * hd + w] : wv[k * d + h * hd + w - hd];
  }
}

// Apply: the query projection on the ring, the attention on CUDA cores, then
// the tail of tail_tile.cuh on the message. Extra shared memory: the
// batch's KV (H x HD x HD fp32) and K_sum (D fp32). A warpgroup's NW output
// columns hold NH whole heads (all H at d <= 256; at d 384 half of them).
template <int D, int HD>
struct Apply {
  using C = tail::Cfg<D>;
  static constexpr int H = D / HD;
  static constexpr int EXTRA = H * HD * HD * 4 + D * 4;
  using L = tail::Layout<D, EXTRA>;
  static_assert(C::NW % HD == 0 && HD % 8 == 0, "apply: a warpgroup owns whole heads");
};

// Q' = (elu(bf16(q)) + 1) * mask in bf16 from the projection's accumulators
// (the warpgroup's NW columns), then per head of the warpgroup msg =
// bf16(Q' KV / (Q'.K_sum + eps)) in fp32, written into the tile as the merge
// input. A row's head dims lie in the 4 lanes of a quad; each lane takes the
// row's Q' values from its quad by shuffles and makes the message for its
// own columns.
template <int D, int HD, class Consumer>
__device__ __forceinline__ void attend(const Consumer& c, float (&acc)[Consumer::C::NW / 2],
                                       const float* __restrict__ mrow, int nvalid,
                                       const float* kvs, const float* kss, float eps) {
  constexpr int NW = Consumer::C::NW, HJ = HD / 8, NH = NW / HD;
  float m[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) m[hh] = c.row(hh) < nvalid ? mrow[c.row(hh)] : 0.f;
#pragma unroll
  for (int i = 0; i < NW / 2; ++i)
    acc[i] = hopper::round_bf16(elu1(hopper::round_bf16(acc[i]))) * m[(i >> 1) & 1];
  const int base = c.lane & ~3, q4 = c.lane & 3;
  unsigned char* t = reinterpret_cast<unsigned char*>(c.tile);
#pragma unroll
  for (int hl = 0; hl < NH; ++hl) {
    const int h = c.cp * NH + hl;  // the head, of H
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
      z[0] += q0 * ks;
      z[1] += q1 * ks;
#pragma unroll
      for (int jj = 0; jj < HJ; ++jj) {
        const float2 kv = *reinterpret_cast<const float2*>(kvs + (h * HD + d) * HD + 8 * jj +
                                                           2 * q4);
        att[0][jj][0] += q0 * kv.x;
        att[0][jj][1] += q0 * kv.y;
        att[1][jj][0] += q1 * kv.x;
        att[1][jj][1] += q1 * kv.y;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float inv = 1.f / (z[hh] + eps);
#pragma unroll
      for (int jj = 0; jj < HJ; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(
            t + hopper::core_off(c.row(hh), h * HD + 8 * jj + 2 * q4, D)) =
            __floats2bfloat162_rn(att[hh][jj][0] * inv, att[hh][jj][1] * inv);
    }
  }
}

// Apply: persistent grid over (batch, row tile) pairs (128 rows, 64 at
// d 384); a tile never spans two batches, whose KV differ.
template <int D, int HD>
__global__ void __launch_bounds__(tail::kThreads, 1)
attn_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ mask,
                  const unsigned char* __restrict__ wpack, const float* __restrict__ kv,
                  const float* __restrict__ ksum, const float* __restrict__ g1,
                  const float* __restrict__ b1, const float* __restrict__ g2,
                  const float* __restrict__ b2, bf16* __restrict__ out, int B, int L,
                  int hid, float attn_eps, float ln_eps) {
  using A = Apply<D, HD>;
  using C = typename A::C;
  using Lay = typename A::L;
  constexpr int H = A::H;
  extern __shared__ __align__(128) unsigned char smem[];
  const typename Lay::Ring ring = Lay::ring(smem);
  const int tpb = (L + C::TM - 1) / C::TM, ntiles = B * tpb;
  if (threadIdx.x == 0) ring.init(tail::kConsumers);
  __syncthreads();

  if (threadIdx.x >= 128 * tail::kConsumers) {
    hopper::setmaxnreg_dec<tail::kProducerRegs>();
    if (threadIdx.x == 128 * tail::kConsumers)
      tail::produce(ring, wpack, C::stages(2, hid), C::STAGE, ntiles);
  } else {
    hopper::setmaxnreg_inc<tail::kConsumerRegs>();
    tail::Consumer<D, typename Lay::Ring> c(smem, ring, Lay::TILE, Lay::HID, Lay::STATS);
    float* kvs = reinterpret_cast<float*>(smem + Lay::EXTRA_OFF);
    float* kss = kvs + H * HD * HD;
    constexpr int NC = 128 * tail::kConsumers;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int b = t / tpb, l0 = (t % tpb) * C::TM + 64 * c.rg;
      const int nvalid = L - l0;
      const size_t row0 = (size_t)b * L + l0;
      hopper::named_sync(3, NC);  // both warpgroups are done with the last KV
      for (int i = threadIdx.x; i < H * HD * HD / 4; i += NC)
        reinterpret_cast<float4*>(kvs)[i] =
            reinterpret_cast<const float4*>(kv + (size_t)b * H * HD * HD)[i];
      for (int i = threadIdx.x; i < D / 4; i += NC)
        reinterpret_cast<float4*>(kss)[i] =
            reinterpret_cast<const float4*>(ksum + (size_t)b * D)[i];
      c.load_rows(x + row0 * D, nvalid);
      hopper::fence_proxy_async();
      hopper::named_sync(3, NC);

      float acc[C::NW / 2];  // q, the warpgroup's NW columns
#pragma unroll
      for (int i = 0; i < C::NW / 2; ++i) acc[i] = 0.f;
      hopper::ring_mma<C::NW, 2>(acc, c.ring, C::S_D, hopper::smem_u32(c.tile), 16 * D,
                                 32 * c.cp * C::NW, 32 * D, c.wt);
      c.sync();  // every warp's wgmma on the tile has completed
      attend<D, HD>(c, acc, mask + row0, nvalid, kvs, kss, attn_eps);
      hopper::fence_proxy_async();
      c.sync();
      c.run(x + row0 * D, out + row0 * D, nvalid, g1, b1, g2, b2, hid, ln_eps);
    }
  }
}

// Stats, pass 1 alone: the projection into the workspace kvw.
template <int D, int HD>
int launch_projection(const void* x, const void* mask, const void* wpack, void* kvw, int B,
                      int S, cudaStream_t stream) {
  using C = Stats<D, HD>;
  const int nitems = B * ((S + TM - 1) / TM);
  cudaError_t err = cudaFuncSetAttribute(
      attn_stats_kernel<D, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = nitems < tail::num_sms() ? nitems : tail::num_sms();
  attn_stats_kernel<D, HD><<<grid, tail::kThreads, C::BYTES, stream>>>(
      (const bf16*)x, (const float*)mask, (const unsigned char*)wpack, (bf16*)kvw, S, nitems);
  return (int)cudaGetLastError();
}

template <int D, int HD>
int launch_stats(const void* x, const void* mask, const void* wpack, void* kvw, void* kv,
                 void* ksum, int B, int S, cudaStream_t stream) {
  using C = Stats<D, HD>;
  cudaError_t err = (cudaError_t)launch_projection<D, HD>(x, mask, wpack, kvw, B, S, stream);
  if (err != cudaSuccess) return (int)err;
  constexpr int smem = C::SUM_ST * C::SUM_TILE;
  err = cudaFuncSetAttribute(attn_stats_reduce_kernel<D, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attn_stats_reduce_kernel<D, HD><<<dim3(C::H, B), C::SUM_THREADS, smem, stream>>>(
      (const bf16*)kvw, (float*)kv, (float*)ksum, S);
  return (int)cudaGetLastError();
}

template <int D, int HD>
int launch_apply(const void* x, const void* mask, const void* wpack, const void* kv,
                 const void* ksum, const void* g1, const void* b1, const void* g2,
                 const void* b2, void* out, int B, int L, int hid, float attn_eps,
                 float ln_eps, cudaStream_t stream) {
  using C = tail::Cfg<D>;
  constexpr int smem = Apply<D, HD>::L::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      attn_apply_kernel<D, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = B * ((L + C::TM - 1) / C::TM);
  const int grid = ntiles < tail::num_sms() ? ntiles : tail::num_sms();
  attn_apply_kernel<D, HD><<<grid, tail::kThreads, smem, stream>>>(
      (const bf16*)x, (const float*)mask, (const unsigned char*)wpack, (const float*)kv,
      (const float*)ksum, (const float*)g1, (const float*)b1, (const float*)g2,
      (const float*)b2, (bf16*)out, B, L, hid, attn_eps, ln_eps);
  return (int)cudaGetLastError();
}

// Whether (d, d / heads) is a cell of ATTN_CELLS.
bool attn_cell(int d, int heads) {
  if (heads <= 0 || d % heads) return false;
  const int hd = d / heads;
#define ATTN_IS_CELL(D, HD) \
  if (d == D && hd == HD) return true;
  ATTN_CELLS(ATTN_IS_CELL)
#undef ATTN_IS_CELL
  return false;
}

}  // namespace

// The projection of the stats at head dim 64 alone, for the head-generic
// stats of attn_heads.cu: x (B, S, d) bf16, d 128, 256 or 384, wpack from
// scream_pack_stats at d / 64 heads ([Wk|Wv] in 64-column groups [k_g |
// v_g]) -> kvw (B, d / 64, Sp, 128) bf16, group g's rows K'[:, 64 g ..
// 64 g + 63] | V[:, 64 g .. 64 g + 63], Sp = S rounded up to 128, rows at
// or past S zero. Whatever the model's head count: the projection does not
// depend on it. One launch.
namespace scream {
namespace attn {
int launch_projection64(const void* x, const void* mask, const void* wpack, void* kvw, int B,
                        int S, int d, cudaStream_t stream) {
  if (B <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (d == 128) return launch_projection<128, 64>(x, mask, wpack, kvw, B, S, stream);
  if (d == 256) return launch_projection<256, 64>(x, mask, wpack, kvw, B, S, stream);
  if (d == 384) return launch_projection<384, 64>(x, mask, wpack, kvw, B, S, stream);
  return (int)cudaErrorInvalidValue;
}
}  // namespace attn
}  // namespace scream

extern "C" {

// x (B, S, d) bf16, (d, heads) a cell of ATTN_CELLS, wpack from
// scream_pack_stats, kvw a bf16 workspace of B * Sp * 2 d (Sp = S rounded up
// to 128) -> KV (B, H, hd, hd) fp32, ksum (B, d) fp32. Two launches: the
// projection into kvw, then the per-head sums in row order.
int scream_attn_stats(const void* x, const void* mask, const void* wpack, void* kvw,
                      void* kv, void* ksum, int B, int S, int d, int heads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || S <= 0 || !attn_cell(d, heads)) return (int)cudaErrorInvalidValue;
  const int hd = d / heads;
#define ATTN_STATS(D, HD) \
  if (d == D && hd == HD) return launch_stats<D, HD>(x, mask, wpack, kvw, kv, ksum, B, S, s);
  ATTN_CELLS(ATTN_STATS)
#undef ATTN_STATS
  return (int)cudaErrorInvalidValue;
}

// Wk, Wv (d, d) bf16, (in, out), (d, heads) a cell of ATTN_CELLS -> the
// stats blob out, 2 d^2 bf16 (stats_pack_kernel). One launch.
int scream_pack_stats(const void* wk, const void* wv, void* out, int d, int heads,
                      void* stream) {
  if (!attn_cell(d, heads)) return (int)cudaErrorInvalidValue;
  const int hd = d / heads;
  const unsigned n = 2u * d * d;
  const int grid = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  stats_pack_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)wk, (const bf16*)wv, (bf16*)out, (unsigned)d, (unsigned)hd,
      (unsigned)stats_cols(hd), (unsigned)stats_krows(d, hd));
  return (int)cudaGetLastError();
}

// x (B, L, d) bf16, (d, heads) a cell of ATTN_CELLS, hidden a multiple of
// 128, wpack the packed Wq, Wm, W1, W2 (pack_weights), KV (B, H, hd, hd)
// -> out (B, L, d) bf16.
int scream_attn_apply(const void* x, const void* mask, const void* wpack, const void* kv,
                      const void* ksum, const void* g1, const void* b1, const void* g2,
                      const void* b2, void* out, int B, int L, int d, int heads, int hid,
                      float attn_eps, float ln_eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || L <= 0 || hid <= 0 || hid % 128 || !attn_cell(d, heads))
    return (int)cudaErrorInvalidValue;
  const int hd = d / heads;
#define ATTN_APPLY(D, HD)                                                                  \
  if (d == D && hd == HD)                                                                  \
    return launch_apply<D, HD>(x, mask, wpack, kv, ksum, g1, b1, g2, b2, out, B, L, hid,  \
                               attn_eps, ln_eps, s);
  ATTN_CELLS(ATTN_APPLY)
#undef ATTN_APPLY
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
