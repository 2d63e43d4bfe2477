// The block tail on a resident row tile, shared by tail.cu (tail_kernel) and
// attn.cu (attn_apply_kernel), built on the weight ring of hopper_tile.cuh.
// With the merge input already in the tile's shared memory and the ring at
// Wm's first stage, per row:
//
//   m = bf16(a @ Wm); t = bf16(m + res); y = bf16(LN1(t));
//   h = relu(bf16(y @ W1)); f = bf16(h @ W2); u = bf16(res + f);
//   out = bf16(LN2(u)),
//
// rounding to bf16 where the plain version (ops/ffn.py:tail_plain) rounds,
// LayerNorm statistics in fp32 with var = max(0, E[x^2] - mu^2) (flax).
//
// Block: two consumer warpgroups and one producer warpgroup, of which one
// thread issues the copies. Tiling at width D:
//   * d 384 and 512 (COLS 2): a tile is 64 rows; the two warpgroups split
//     the output columns, D/2 each, so an accumulator is 64 x 256 fp32 at
//     most, 128 registers a thread (a 64 x 512 one would be 256, more than
//     a thread may hold). LayerNorm then sums each row's statistics over
//     both warpgroups through shared memory. Each warpgroup makes half of
//     every 128-column hidden chunk; the chunk goes through shared memory
//     (double-buffered) because the second product needs all of it.
//   * d 128 and 256 (COLS 1): a tile is 128 rows, each warpgroup owns 64 of
//     them and all D columns; the hidden chunk is 64 columns, one buffer a
//     warpgroup. Each weight byte read from L2 then feeds 128 rows.
// Ring stages are 64 D bytes: 32 k-rows of Wm, Wq or W2, or D / (2 COLS)
// k-rows of a W1 chunk, so every stage is one bulk copy of the same size.
//
// Shared-memory budget at d 512 (227 KB a block, one block an SM): the
// tile 64 x 512 bf16 = 64 KB (the merge input, then the LN1 output in its
// place), two hidden chunks 2 x 64 x 128 bf16 = 32 KB, row statistics
// 1 KB, and a ring of 4 stages x 32 KB = 128 KB: 225 KB. Narrower widths
// take up to 8 stages. Registers at d 512: the output accumulator (128)
// plus a hidden-chunk accumulator (32) a consumer thread; setmaxnreg gives
// the consumers 240 and the producer warpgroup 24. LayerNorm works on 8
// column blocks at a time, so that what the compiler hoists does not push
// the accumulators out of registers.

#pragma once

#include "hopper_tile.cuh"

namespace scream {
namespace tail {

using hopper::bf16;

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
// setmaxnreg moves registers inside the block's own allocation: 384 threads
// launch with 168 each; the producer warpgroup's 128 threads give back 144
// each (to 24) and the consumers' 256 take 72 each (to 240).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kSmemMax = 232448;                  // H100: dynamic shared memory a block
constexpr int kMaxStages = 8;

template <int D>
struct Cfg {
  static constexpr int COLS = D > 256 ? 2 : 1;            // warpgroups a row group
  static constexpr int TM = 64 * kConsumers / COLS;       // rows a tile
  static constexpr int NW = D / COLS;                     // output columns a warpgroup
  static constexpr int HC = 64 * COLS;                    // hidden columns a chunk
  static constexpr int STAGE = 64 * D;                    // bytes a ring stage
  static constexpr int KS_H = D / (2 * COLS);             // k-rows of a W1 stage
  static constexpr int S_D = D / 32;                      // stages of a D x D weight
  static constexpr int S_CH = 2 * COLS;                   // stages of a W1 (or W2) chunk
  static constexpr int TILE_BYTES = TM * D * 2;
  static constexpr int HID_BYTES = 2 * 64 * HC * 2;
  static constexpr int STATS_BYTES = 2 * 64 * 8;
  static_assert(D % 128 == 0 && KS_H % 16 == 0 && NW % 64 == 0 && NW <= 256, "tiling");

  // Ring stages for one tile: `dd` D x D weights (Wm; Wq too in apply),
  // then per hidden chunk its W1 and W2 stages.
  static __host__ __device__ constexpr int stages(int dd, int hid) {
    return dd * S_D + (hid / HC) * 2 * S_CH;
  }
};

// Shared-memory layout with EXTRA kernel-specific bytes (a multiple of 16):
// the ring first, then the tile, the hidden buffers, EXTRA, the row
// statistics and the barriers. As many stages as fit, at most kMaxStages.
template <int D, int EXTRA>
struct Layout {
  using C = Cfg<D>;
  static constexpr int REST = C::TILE_BYTES + C::HID_BYTES + EXTRA + C::STATS_BYTES +
                              16 * kMaxStages;
  static constexpr int FIT = (kSmemMax - REST) / C::STAGE;
  static constexpr int NST = FIT < kMaxStages ? FIT : kMaxStages;
  static constexpr int TILE = NST * C::STAGE;
  static constexpr int HID = TILE + C::TILE_BYTES;
  static constexpr int EXTRA_OFF = HID + C::HID_BYTES;
  static constexpr int STATS = EXTRA_OFF + EXTRA;
  static constexpr int BARS = STATS + C::STATS_BYTES;
  static constexpr int BYTES = BARS + 16 * NST;
  static_assert(NST >= 2 && BYTES <= kSmemMax && EXTRA % 16 == 0, "shared memory");

  using Ring = hopper::Ring<NST, C::STAGE, BARS>;

  static __device__ __forceinline__ Ring ring(unsigned char* smem) {
    return Ring(hopper::smem_u32(smem));
  }
};

// Streaming multiprocessors of the current device: the persistent grid.
inline int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// The producer thread: the packed weight blob, `stages` stages of STAGE
// bytes, once for every tile this block takes.
template <class RingT>
__device__ __forceinline__ void produce(RingT ring, const unsigned char* blob, int stages,
                                        int stage_bytes, int ntiles) {
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x)
    for (int s = 0; s < stages; ++s) {
      ring.fill(blob + (size_t)s * stage_bytes);
      ring.advance();
    }
}

// One consumer thread's view: its warpgroup's rows and columns, the tile,
// the hidden buffers and its cursor in the ring.
template <int D, class RingT>
struct Consumer {
  using C = Cfg<D>;
  RingT ring;
  int wt, warp, lane;  // thread and warp in the warpgroup, lane
  int rg, cp;          // row group (64 rows) and column part of the warpgroup
  bf16* tile;          // the warpgroup's 64 rows of the tile (K-major, K = D)
  bf16* hid;           // the two hidden buffers (64 x HC each)
  float2* stats;       // row sums of each column part (2 x 64)

  __device__ __forceinline__ Consumer(unsigned char* smem, const RingT& r,
                                      int tile_off, int hid_off, int stats_off)
      : ring(r) {
    const int tid = threadIdx.x, wg = tid >> 7;
    wt = tid & 127;
    warp = wt >> 5;
    lane = tid & 31;
    rg = wg / C::COLS;
    cp = wg % C::COLS;
    tile = reinterpret_cast<bf16*>(smem + tile_off) + (size_t)rg * 64 * D;
    hid = reinterpret_cast<bf16*>(smem + hid_off);
    stats = reinterpret_cast<float2*>(smem + stats_off);
  }

  // The warpgroups that share this row group.
  __device__ __forceinline__ void sync() const {
    hopper::named_sync(1 + rg, 128 * C::COLS);
  }

  // Row (of the warpgroup's 64) of accumulator half hh; column (of D) of
  // the pair of n8 block j.
  __device__ __forceinline__ int row(int hh) const {
    return 16 * warp + (lane >> 2) + 8 * hh;
  }
  __device__ __forceinline__ int col(int j) const {
    return cp * C::NW + 8 * j + 2 * (lane & 3);
  }

  // The row group's 64 rows from global (row stride D) into the tile.
  __device__ __forceinline__ void load_rows(const bf16* src, int nvalid) const {
    hopper::load_tile64<D>(tile, src, nvalid, cp * 128 + wt, 128 * C::COLS);
  }

  // acc <- LN(bf16(bf16(acc) + res)) over whole rows, fp32 statistics. Both
  // passes go over the accumulators JG column blocks at a time (fence_acc),
  // and every load is a row pointer plus a constant, so that what the
  // compiler hoists stays within a group.
  static constexpr int JG = 8;

  __device__ __forceinline__ void add_ln(float (&acc)[C::NW / 2], const bf16* res,
                                         int nvalid, const float* g, const float* b,
                                         float eps) const {
    const int c0 = col(0);
    const __nv_bfloat162* rp[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      rp[hh] = row(hh) < nvalid ? reinterpret_cast<const __nv_bfloat162*>(
                                      hopper::opaque(res) + (size_t)row(hh) * D + c0)
                                : nullptr;
    float s[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < C::NW / 8; ++j) {
      if (j % JG == 0) hopper::fence_acc(acc, 4 * j, 4 * JG);  // opens a group
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 q = rp[hh] ? __bfloat1622float2(rp[hh][4 * j]) : make_float2(0.f, 0.f);
        float& a0 = acc[4 * j + 2 * hh];
        float& a1 = acc[4 * j + 2 * hh + 1];
        a0 = hopper::round_bf16(hopper::round_bf16(a0) + q.x);
        a1 = hopper::round_bf16(hopper::round_bf16(a1) + q.y);
        s[hh] += a0 + a1;
        s2[hh] += a0 * a0 + a1 * a1;
      }
      if (j % JG == JG - 1) hopper::fence_acc(acc, 4 * (j + 1 - JG), 4 * JG);  // closes it
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], o);
        s2[hh] += __shfl_xor_sync(0xffffffffu, s2[hh], o);
      }
    if (C::COLS == 2) {
      if ((lane & 3) == 0)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) stats[cp * 64 + row(hh)] = make_float2(s[hh], s2[hh]);
      sync();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 a = stats[row(hh)], c = stats[64 + row(hh)];
        s[hh] = a.x + c.x;
        s2[hh] = a.y + c.y;
      }
    } else {
      sync();  // the tile may be rewritten once every warp is past here
    }
    float mu[2], rs[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mu[hh] = s[hh] / D;
      rs[hh] = rsqrtf(fmaxf(0.f, s2[hh] / D - mu[hh] * mu[hh]) + eps);
    }
    const float2* gp = reinterpret_cast<const float2*>(hopper::opaque(g) + c0);
    const float2* bp = reinterpret_cast<const float2*>(hopper::opaque(b) + c0);
#pragma unroll
    for (int j = 0; j < C::NW / 8; ++j) {
      if (j % JG == 0) hopper::fence_acc(acc, 4 * j, 4 * JG);
      const float2 gg = gp[4 * j], bb = bp[4 * j];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float& a0 = acc[4 * j + 2 * hh];
        float& a1 = acc[4 * j + 2 * hh + 1];
        a0 = (a0 - mu[hh]) * (rs[hh] * gg.x) + bb.x;
        a1 = (a1 - mu[hh]) * (rs[hh] * gg.y) + bb.y;
      }
      if (j % JG == JG - 1) hopper::fence_acc(acc, 4 * (j + 1 - JG), 4 * JG);
    }
  }

  // bf16(acc) into the tile, where the next product reads it.
  __device__ __forceinline__ void store_tile(const float (&acc)[C::NW / 2]) const {
    unsigned char* t = reinterpret_cast<unsigned char*>(tile);
#pragma unroll
    for (int j = 0; j < C::NW / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<__nv_bfloat162*>(t + hopper::core_off(row(hh), col(j), D)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }

  // bf16(acc) to global rows below nvalid (row stride D).
  __device__ __forceinline__ void store_out(const float (&acc)[C::NW / 2], bf16* out,
                                            int nvalid) const {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (row(hh) >= nvalid) continue;
      __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(
          hopper::opaque(out) + (size_t)row(hh) * D + col(0));
#pragma unroll
      for (int j = 0; j < C::NW / 8; ++j)
        op[4 * j] = __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }

  // The tail of the row group, from the merge input in the tile and the
  // ring at Wm's first stage; `res` and `out` point at the row group's
  // first row (stride D), rows at or past nvalid are zero and not stored.
  __device__ __forceinline__ void run(const bf16* res, bf16* out, int nvalid,
                                      const float* g1, const float* b1, const float* g2,
                                      const float* b2, int hid_w, float eps) {
    const uint32_t a = hopper::smem_u32(tile);
    float acc[C::NW / 2];
#pragma unroll
    for (int i = 0; i < C::NW / 2; ++i) acc[i] = 0.f;
    hopper::ring_mma<C::NW, 2>(acc, ring, C::S_D, a, 16 * D, 32 * cp * C::NW, 32 * D, wt);
    add_ln(acc, res, nvalid, g1, b1, eps);
    store_tile(acc);
    hopper::fence_proxy_async();
    sync();

#pragma unroll
    for (int i = 0; i < C::NW / 2; ++i) acc[i] = 0.f;
    for (int ch = 0; ch < hid_w / C::HC; ++ch) {
      float h[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) h[i] = 0.f;
      hopper::ring_mma<64, C::KS_H / 16>(h, ring, C::S_CH, a, 16 * D, 32 * 64 * cp,
                                         32 * C::HC, wt);
      bf16* hb = hid + (size_t)(C::COLS == 2 ? (ch & 1) : rg) * 64 * C::HC;
      unsigned char* hp = reinterpret_cast<unsigned char*>(hb);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int c = cp * 64 + 8 * j + 2 * (lane & 3);
          *reinterpret_cast<__nv_bfloat162*>(hp + hopper::core_off(row(hh), c, C::HC)) =
              __floats2bfloat162_rn(fmaxf(hopper::round_bf16(h[4 * j + 2 * hh]), 0.f),
                                    fmaxf(hopper::round_bf16(h[4 * j + 2 * hh + 1]), 0.f));
        }
      hopper::fence_proxy_async();
      sync();
      hopper::ring_mma<C::NW, 2>(acc, ring, C::S_CH, hopper::smem_u32(hb), 16 * C::HC,
                                 32 * cp * C::NW, 32 * D, wt);
    }
    add_ln(acc, res, nvalid, g2, b2, eps);
    store_out(acc, out, nvalid);
  }
};

}  // namespace tail
}  // namespace scream
