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
// 128-384 is 0.25-1.5x the projection of stats; in stats also the K' | V
// workspace between its passes (2 R 2 d elements written and read back).
// What the design does:
//   * stats, in three launches. (1) The projection, whatever the head
//     count, on the wgmma pipelines of the head-specific kernels: bf16
//     through attn.cu's projection at head dim 64 (scream::attn::
//     launch_projection64: [Wk|Wv] packed in 64-column groups [k_g | v_g],
//     rows of K' | V written per group to a bf16 workspace), fp32 through
//     heads_proj_f32_kernel below (attn_f32.cu's projection at head dim 64,
//     tf32_tile.cuh:project_kv, into an fp32 workspace). (2)
//     heads_sum_mma_kernel: K'^T V on the tensor cores (mma.sync; bf16
//     operands, or fp32 as split-TF32 promoted every tf32::kPromoteK rows),
//     one item per (pair of column blocks whose K' and V columns share a
//     head, chunk of kChunk rows, batch). A block is 64 columns (a
//     workspace group), or 128 in bf16 at head dims of 128 and up, so that
//     each head's K' and V are read once: at 2 heads of 128, 16 x 4,096,
//     256 items of 8 warps; at 32 heads of 8 in fp32, 512 of 4. So the grid
//     grows with the heads and the rows, not with a thread's share of the
//     KV. Each item streams its blocks' halves through a cp.async ring and
//     keeps the entries of its diagonal blocks; the n8 tiles that share no
//     head with a warp's K' columns are skipped. (3) attn_f32.cu's slot
//     reduce (tf32_tile.cuh:launch_reduce_slots) adds the chunks in chunk
//     order. The shape alone sets the items and the order of every sum
//     (each accumulator chain walks its item's rows in order), never the
//     card: two launches on one input agree bit for bit, and a batch whose
//     mask is all zero gives exact zeros. No float atomics. The workspace
//     round trip (K' | V, 2 R d elements each way) and the chunk partials (d
//     hd + d floats a chunk) are the price of the head independence. On an
//     H100 the sum streams the workspace at 1.7-2.7 TB/s, and its products
//     add 5-40 % to that in bf16, 20 % in fp32 at head dim 8 and 2-3x from
//     head dim 128 up (3xTF32 on mma.sync). K'^T V is
//     on mma.sync, not wgmma: both operands are read row-major from padded
//     rows (ldmatrix.trans in bf16, the fragments by hand in fp32), where
//     tf32 wgmma takes only K-major operands, and the bf16 sum at 2 heads
//     of 128 takes about what streaming its rows alone takes
//     (scripts/torch_port_heads_probe.py --stats, PERF.md).
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

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// Four 8 x 8 b16 matrices, transposed: lane l gives the row address of
// matrix l / 8, row l % 8; register q holds matrix q's (row 2 (l % 4) and
// the next, column l / 4).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += A B on mma.sync, fp32 accumulators: m16n8k16 bf16 or m16n8k8 tf32.
// A fragment a (row g = lane / 4, t = lane % 4): a[0] row g, a[1] row g +
// 8, a[2] and a[3] the same rows at the upper k half; B fragment b0 (k the
// lower half, column g), b1 (the upper half); c[2 hh + e] is row g + 8 hh,
// column 2 t + e.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The K' (and V) columns of a sum item's block: kSumWide in bf16 at head
// dims that are multiples of it (each head's K' and V then read once), else
// kGroup.
__host__ __device__ inline int sum_block(bool f32, int hd) {
  return !f32 && hd % kSumWide == 0 ? kSumWide : kGroup;
}

// Whether column blocks a (its K' columns) and c (its V columns) of w
// columns each share a head at head dim hd; sum_pairs counts the pairs
// (a, c) of the nb blocks that do, in row-major order, and with p >= 0 sets
// (a, c) to the p-th: the sum's items of one (batch, chunk)
// (tests/test_torch_port_heads_any.py restates both).
__host__ __device__ inline bool blocks_share_head(int a, int c, int w, int hd) {
  return a * w / hd <= (c * w + w - 1) / hd && c * w / hd <= (a * w + w - 1) / hd;
}
__host__ __device__ inline int sum_pairs(int nb, int w, int hd, int p, int& a, int& c) {
  int n = 0;
  for (int i = 0; i < nb; ++i)
    for (int j = 0; j < nb; ++j)
      if (blocks_share_head(i, j, w, hd)) {
        if (n == p) a = i, c = j;
        ++n;
      }
  return n;
}

// Stats, pass 2. The sum's item (p, chunk, b) = (blockIdx.x, .y, .z) sums
// rows kChunk chunk .. up to S of batch b for its pair p of column blocks
// (bk, bv) of BW columns (sum_block: 128 or 64; sum_pairs:
// K' columns BW bk .. and V columns BW bv .. that share a head): K'_bk^T
// V_bv (BW x BW) on mma.sync with fp32 accumulators, into the chunk's slot
// of part, (B, nchunk, d hd + d) floats: KV[h][i][j] at (h hd + i) hd + j
// for the entries whose K' and V columns lie in one head, and at bk == bv
// K_sum[c] at d hd + c. A block's BW / 64 workspace groups' halves stream
// through kSumStages stages of kSumRows rows by cp.async, K' rows then V
// rows, BW + 8 elements apart (the 8 rows a fragment load reads fall in
// distinct banks); rows past S read the workspace's zeros. Warp w of BW / 16
// takes K' columns 16 w .. 16 w + 15 against the n8 tiles of V columns that
// share a head with them, one accumulator chain a tile over the item's rows
// in order:
//   bf16: per k16 step, A = K'^T and B = V by ldmatrix.trans (both stored
//     row-major, k the row), K_sum as A times a B of ones;
//   fp32: per k8 step the fragments read as floats and split (tf32::split),
//     the passes lo(A) hi(B), hi(A) lo(B), hi(A) hi(B) into a chunk
//     accumulator added into the fp32 master every tf32::kPromoteK rows
//     (K_sum: lo(A) 1, hi(A) 1).
template <class T, int W>
struct SumCfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int BW = W;                   // columns a block
  static constexpr int THREADS = 2 * BW;         // BW / 16 warps
  static constexpr int MIN_BLOCKS = 256 / BW;    // an SM's: at most 128 registers a thread
  static constexpr int NT = BW / 8;              // n8 tiles a warp
  static constexpr int LD = BW + 8;              // elements from one staged row to the next
  static constexpr int STAGE = 2 * kSumRows * LD;  // elements: K' rows, then V rows
  static constexpr int BYTES = kSumStages * STAGE * (int)sizeof(T);
  static_assert(tf32::kPromoteK % kSumRows == 0 && kSumRows % 16 == 0 && BW % kGroup == 0,
                "sum stages");
};

template <class T, int W>
__global__ void __launch_bounds__(SumCfg<T, W>::THREADS, SumCfg<T, W>::MIN_BLOCKS)
heads_sum_mma_kernel(const T* __restrict__ ws, float* __restrict__ part, int S, int Sp,
                     int d, int hd, int nchunk) {
  using C = SumCfg<T, W>;
  constexpr bool F32 = C::F32;
  constexpr int BW = C::BW, NT = C::NT, LD = C::LD;
  constexpr int CPR = kGroup * (int)sizeof(T) / 16;  // 16-byte pieces of a group's half row
  constexpr int KSTEP = F32 ? 8 : 16;                 // rows of an mma step
  constexpr uint32_t ALL = (1u << NT) - 1;           // every n8 tile
  extern __shared__ __align__(128) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);
  const int b = blockIdx.z, chunk = blockIdx.y, G = d / kGroup;
  int bk = 0, bv = 0;
  sum_pairs(d / BW, BW, hd, blockIdx.x, bk, bv);
  const int r0 = chunk * kChunk, r_end = S < r0 + kChunk ? S : r0 + kChunk;
  const int nst = (r_end - r0 + kSumRows - 1) / kSumRows;
  // Row r0 of the block's first group: its K' half, and its V half.
  const T* srck = ws + ((size_t)(b * G + bk * BW / kGroup) * Sp + r0) * (2 * kGroup);
  const T* srcv = ws + ((size_t)(b * G + bv * BW / kGroup) * Sp + r0) * (2 * kGroup) + kGroup;
  auto fetch = [&](int s) {
    if (s < nst) {
      const uint32_t dst = hopper::smem_u32(stage + (s % kSumStages) * C::STAGE);
#pragma unroll
      for (int i = threadIdx.x; i < 2 * kSumRows * (BW / kGroup) * CPR; i += C::THREADS) {
        // piece u of the K' (v 0) or V (v 1) half of group q of row r: a
        // warp's pieces run along the workspace rows where bk == bv
        const int u = i % CPR, v = i / CPR % 2, q = i / (2 * CPR) % (BW / kGroup);
        const int r = i / (2 * CPR * (BW / kGroup));
        cp_async16(dst + (((v * kSumRows + r) * LD + q * kGroup) * (int)sizeof(T)) + 16 * u,
                   (v ? srcv : srck) + ((size_t)q * Sp + s * kSumRows + r) * (2 * kGroup) +
                       u * (16 / sizeof(T)));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int cm = bk * BW + 16 * warp;  // the warp's first K' column
  uint32_t need = 0;                   // its n8 tiles: V columns of its heads
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int cn = bv * BW + 8 * j;
    if (cm / hd <= (cn + 7) / hd && cn / hd <= (cm + 15) / hd) need |= 1u << j;
  }
  const bool with_ks = bk == bv;
  float acc[NT][4], ks[4], cacc[F32 ? NT : 1][4], cks[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ks[e] = cks[e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < (F32 ? NT : 1); ++j) cacc[j][e] = 0.f;
  }

  for (int s = 0; s < kSumStages - 1; ++s) fetch(s);
  for (int s = 0; s < nst; ++s) {
    fetch(s + kSumStages - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kSumStages - 1) : "memory");
    __syncthreads();  // stage s is in
    const T* K = stage + (s % kSumStages) * C::STAGE;
    const T* V = K + kSumRows * LD;
#pragma unroll
    for (int k = 0; k < kSumRows; k += KSTEP) {
      if constexpr (!F32) {
        const int q = lane >> 3, r = lane & 7;
        uint32_t a[4];
        ldsm_x4_t(a, hopper::smem_u32(K + (k + (q >> 1) * 8 + r) * LD + 16 * warp + (q & 1) * 8));
        if (with_ks) mma_bf16(ks, a, 0x3F803F80u, 0x3F803F80u);  // B = ones
        // Tiles 2 jj and 2 jj + 1 (one ldmatrix); every tile in one branch
        // where all are needed, so that the chains interleave.
        auto pair = [&](int jj, uint32_t use) {
          uint32_t bv4[4];
          ldsm_x4_t(bv4, hopper::smem_u32(V + (k + (q & 1) * 8 + r) * LD + 16 * jj + (q >> 1) * 8));
          if (use & 1u) mma_bf16(acc[2 * jj], a, bv4[0], bv4[1]);
          if (use & 2u) mma_bf16(acc[2 * jj + 1], a, bv4[2], bv4[3]);
        };
        if (need == ALL) {
#pragma unroll
          for (int jj = 0; jj < NT / 2; ++jj) pair(jj, 3u);
        } else {
#pragma unroll
          for (int jj = 0; jj < NT / 2; ++jj)
            if (need >> (2 * jj) & 3u) pair(jj, need >> (2 * jj) & 3u);
        }
      } else {
        const float* Kf = reinterpret_cast<const float*>(K) + (k + t) * LD + 16 * warp + g;
        uint32_t ah[4], al[4];
        tf32::split(Kf[0], ah[0], al[0]);
        tf32::split(Kf[8], ah[1], al[1]);
        tf32::split(Kf[4 * LD], ah[2], al[2]);
        tf32::split(Kf[4 * LD + 8], ah[3], al[3]);
        constexpr uint32_t one = 0x3F800000u;
        if (with_ks) {
          mma_tf32(cks, al, one, one);
          mma_tf32(cks, ah, one, one);
        }
        auto tile = [&](int j) {
          const float* Vf = reinterpret_cast<const float*>(V) + (k + t) * LD + 8 * j + g;
          uint32_t bh[2], bl[2];
          tf32::split(Vf[0], bh[0], bl[0]);
          tf32::split(Vf[4 * LD], bh[1], bl[1]);
          mma_tf32(cacc[j], al, bh[0], bh[1]);
          mma_tf32(cacc[j], ah, bl[0], bl[1]);
          mma_tf32(cacc[j], ah, bh[0], bh[1]);
        };
        if (need == ALL) {
#pragma unroll
          for (int j = 0; j < NT; ++j) tile(j);
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j)
            if (need >> j & 1u) tile(j);
        }
      }
    }
    if constexpr (F32) {  // a promotion every kPromoteK rows of the item, and at its end
      if ((s + 1) % (tf32::kPromoteK / kSumRows) == 0 || s + 1 == nst) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ks[e] += cks[e];
          cks[e] = 0.f;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            acc[j][e] += cacc[j][e];
            cacc[j][e] = 0.f;
          }
        }
      }
    }
    __syncthreads();  // stage s is read before its slot is refilled
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  float* slot = part + ((size_t)b * nchunk + chunk) * ((size_t)d * hd + d);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (!(need >> j & 1u)) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = cm + g + 8 * (e >> 1), n = bv * BW + 8 * j + 2 * t + (e & 1);
      const int h = c / hd;
      if (n / hd == h) slot[(size_t)c * hd + n - h * hd] = acc[j][e];
    }
  }
  if (with_ks && t == 0) {
    slot[(size_t)d * hd + cm + g] = ks[0];
    slot[(size_t)d * hd + cm + g + 8] = ks[2];
  }
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

template <class T, int W>
int launch_sum(const T* ws, float* part, int B, int S, int Sp, int d, int hd, int nchunk,
               cudaStream_t stream) {
  using C = SumCfg<T, W>;
  static std::atomic<unsigned> smem_set{0};
  int bk, bv;
  const int npairs = sum_pairs(d / W, W, hd, -1, bk, bv);
  const int err = tf32::set_smem(heads_sum_mma_kernel<T, W>, C::BYTES, smem_set);
  if (err) return err;
  heads_sum_mma_kernel<T, W><<<dim3(npairs, nchunk, B), C::THREADS, C::BYTES, stream>>>(
      ws, part, S, Sp, d, hd, nchunk);
  return (int)cudaGetLastError();
}

template <class T>
int launch_sum_reduce(const T* ws, float* part, float* kv, float* ksum, int B, int S, int Sp,
                      int d, int hd, cudaStream_t stream) {
  const int nchunk = (S + kChunk - 1) / kChunk, per = d * hd + d;
  int err;
  if constexpr (sizeof(T) == 2)
    err = sum_block(false, hd) == kSumWide
              ? launch_sum<T, kSumWide>(ws, part, B, S, Sp, d, hd, nchunk, stream)
              : launch_sum<T, kGroup>(ws, part, B, S, Sp, d, hd, nchunk, stream);
  else
    err = launch_sum<T, kGroup>(ws, part, B, S, Sp, d, hd, nchunk, stream);
  if (err) return err;
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
