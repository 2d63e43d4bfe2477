// Two-channel Gaussian max-splat for Hopper (sm_90a): the depth renderer's
// hot op.
//
// max_splat_kernel replaces scream_tpu/ops/splat_pallas.py:_splat_kernel
// (_splat_forward, reached through max_splat from
// scream_tpu/ops/render.py:render_depth_images). For every image i, pixel p
// and channel c (src, tgt):
//   img[i, c, p] = max over points n of vals[i, n, c] * exp(-d2 * rho^2 / 2)
//   arg[i, c, p] = the lowest n attaining that max,
// with d2 = max((|xy_n|^2 + |pix_p|^2) - 2 (x_n px + y_n py), 0).
//
// Arithmetic: every (point, pixel, channel) the kernel evaluates uses the
// expression of the plain PyTorch version (ops/splat_cuda.py) in its order
// with round-to-nearest intrinsics, so nvcc contracts nothing: cross =
// x px + y py (two rounded products, one rounded add), d2 = max((|xy|^2 +
// |pix|^2) - 2 cross, 0) (written fmaf(-2, cross, .), the same rounding since
// 2 cross is exact), w = expf(d2 * c) (c = -rho^2/2 rounded to fp32,
// full-precision expf), contribution v * w. Ties: one ascending scan over the
// points with a strict > keeps the lowest index, as the TPU kernel does
// within and across its 1,024-point tiles; a pixel where every contribution
// is 0 is won by point 0.
//
// Pixel centres: pixel p is (col p % w, row p / w), mapped to
// ((col, row) - w/2 + 0.5) / (w/2) with round-to-nearest fp32 sub, add and
// div in ops/splat_cuda.py:pixel_grid's order, so no grid is read.
//
// What bounds it on the H100. A dense sweep evaluates every (point, pixel)
// pair: 1.61e9 at the training shape (48 images, 8,192 points, 64 x 64), ~20
// issued fp32 instructions each (no FMA may contract the expression, and
// expf is a range reduction around one MUFU.EX2), so no dense kernel goes
// below ~1 ms at 132 SMs x 128 lanes x 1.98 GHz. This kernel evaluates only
// the pairs that could change a pixel's (max, argmax), and proves the rest
// cannot, so its result is the dense scan's, bit for bit.
//
// The skip rule and its proof, all in one place (u = 2^-24; the errors are
// the CUDA math API's: __logf 2^-21.41 absolute on [0.5, 2] and 3 ulp
// elsewhere, logf 1 ulp, expf 2 ulp; tests/test_torch_port_cull.py's
// TestCullMargins checks each step at its edge). A (point, pixel, channel)
// with value v is skipped when t = fl(e + lnv) < L, e = fl(d2 c) being the
// exponent the pair would use (c = -rho^2 / 2) and L the pixel's threshold.
//   P1. lnv >= ln v. v <= 0: -inf (skipped only where L > -inf, i.e. the
//       best b >= 0 >= v w). v > 2^20: +inf, never skipped. v < 2^-24:
//       -16 >= ln 2^-24 = -16.64 (the cut-off must stay <= e^-16: 2^-23
//       would leave ln v up to 0.058 above -16). Else __logf(v) + 2^-20 +
//       2^-20 |.|: 8u (1 + |l|) covers __logf's error (<= 3.01 u + 3 u |l|)
//       and the two rounded adds (<= u (1 + |l|)); the clamp to >= -16 only
//       raises it.
//   P2. b >= 2^-100: L = logf(b) - 2^-12. fl(e + lnv) < L gives e + ln v <
//       ln b - 2^-12 + 2^-16 (logf's ulp and L's rounding, |ln b| < 89), so
//       v exp(e) < b (1 - 2^-12.2); expf's 2 ulp, its subnormal spacing
//       (v <= 2^20: <= 2^-128, far below 2^-112 <= b 2^-12.2) and the
//       rounded product keep fl(v expf(e)) < b. Skipped pairs are below b,
//       and b only grows, so L = max of the thresholds seen stays valid.
//   P3. 0 <= b < 2^-100: L = L_ZERO = -120.625. By P1 lnv >= -16 for v > 0,
//       so e < -104.625 <= EXP_ZERO = -104.5, where expf(e) == 0
//       (chip_smoke.py checks every fp32 x <= EXP_ZERO on the card): the
//       contribution is 0 <= b. b < 0: L = -inf, nothing skipped.
//   P4. Since each scan ascends and takes a contribution only when it is
//       strictly above b, a skipped pair (contribution <= b) would not have
//       been taken: ties keep the lowest index.
//   P5. Boxes: d2lo = max(g2 (1 - 2^-20) - 2^-20 (|xy|^2 + max |pix|^2), 0),
//       g2 the squared gap from the point to a box of pixel centres, is at
//       most the rounded d2 of every pixel of the box: the plain expression
//       errs by <= 7u (|xy|^2 + |pix|^2), g2's own roundings by <= 6u g2.
//       As c < 0 and rounding is monotone, fl(fl(d2lo c) + lnv) >= every
//       pixel's t, so a point whose box t is below the smallest L over the
//       box's pixels is skipped by each of them.
//   P6. Another split's best o >= 2^-100 is a contribution some point
//       attains, so the pixel's max is >= o. By P2 a pair skipped against
//       logf(o) - 2^-12 is strictly below o, hence below the max whatever
//       its index; o < 2^-100 gives no threshold (a tie at 0 could be the
//       max with a lower index).
//
// The kernel:
//   * one block per (image, 16 x 16 pixel tile, point split), one pixel a
//     thread, both channels' (best, argmax, L) in registers; a warp owns an
//     8 x 4 patch. The points stream in chunks of 512: each thread tests
//     two points against the tile box and the tile's smallest L (a block
//     reduction once a chunk), and the kept (point, channel)s are compacted
//     into shared memory in ascending index with ballots and a prefix sum,
//     one list per channel. Each warp then walks a list 32 entries at a
//     time, tests them against its own box and its own smallest L (a warp
//     reduction every 32 entries, so the test tightens as its pixels'
//     bests grow), and takes the survivors two at a time, in order, through
//     the per-pixel test and expf (branches taken by the whole warp, on
//     votes);
//   * a tile's points are split over a thread-block cluster of up to 8
//     blocks (ops/splat_cuda.py:splat_splits: 4 at 8,192 points), since
//     the work of a tile follows the scene and one dense tile would
//     otherwise set the kernel's time. Each split scans its run of points
//     in ascending order; at each chunk it also reads the other splits'
//     bests through distributed shared memory and skips below them (P6).
//     Rank 0 merges the splits in ascending order with a strict >, so ties
//     keep the lowest index, as one scan would;
//   * the first chunk of a split is its seed: L is -inf until a pixel has
//     a best, so nothing is culled before the split's first point has been
//     evaluated everywhere.
// The work left depends on the scene: how many points lie within reach of
// a pixel's best. The counting build (kCount) reports it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_launch.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int SP_TW = 16;                    // pixel tile edge: 16 x 16 pixels a block
constexpr int SP_THREADS = SP_TW * SP_TW;    // one pixel a thread
constexpr int SP_WARPS = SP_THREADS / 32;    // each warp owns 8 columns x 4 rows
constexpr int SP_CHUNK = 2 * SP_THREADS;     // points tested and compacted per step
constexpr int SP_SLOTS = SP_CHUNK / 32;      // ballot words per chunk and channel
constexpr int SP_MAX_SPLITS = 8;             // point splits per cluster: the portable size
// The skip rule's constants; P1-P6 in the header say why each holds.
constexpr float SP_D2_REL = 0x1p-20f;        // P5: margin of the d2 lower bound
constexpr float SP_LOG_MARGIN = 0x1p-12f;    // P2, P6: margin of the threshold
constexpr float SP_BEST_NORMAL = 0x1p-100f;  // P2, P3: best >= this: L from logf(best)
constexpr float SP_V_MAX = 0x1p20f;          // P1: v above this is never skipped
constexpr float SP_V_LOG = 0x1p-24f;         // P1: v below this: ln v taken as LNV_MIN
constexpr float SP_LNV_MIN = -16.0f;         // P1: ln v clamped up to this
constexpr float SP_LOG_ERR_ABS = 0x1p-20f;   // P1: __logf's error bound, and the
constexpr float SP_LOG_ERR_REL = 0x1p-20f;   //     two rounded adds
constexpr float SP_L_ZERO = -120.625f;       // P3: L where 0 <= best < 2^-100
constexpr float SP_EXP_ZERO = -104.5f;       // P3: expf(x) == 0 for fp32 x <= this
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float pixel_coord(int k, float half) {
  return __fdiv_rn(__fadd_rn(__fsub_rn((float)k, half), 0.5f), half);
}

__device__ __forceinline__ float sq2(float x, float y) {
  return __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
}

// e = fl(d2 c) of one (point, pixel) pair, the plain version's expression:
// d2 = max((|xy|^2 + |pix|^2) - 2 (x px + y py), 0).
__device__ __forceinline__ float pair_exponent(float4 f, float pxx, float pxy, float xsq,
                                               float neg) {
  const float cross = __fadd_rn(__fmul_rn(f.x, pxx), __fmul_rn(f.y, pxy));
  return __fmul_rn(fmaxf(__fmaf_rn(-2.0f, cross, __fadd_rn(f.z, xsq)), 0.0f), neg);
}

// The log-domain threshold L of a pixel whose best is b (P2, P3).
__device__ __forceinline__ float threshold(float b) {
  if (b >= SP_BEST_NORMAL) return __fsub_rn(logf(b), SP_LOG_MARGIN);
  if (b >= 0.0f) return SP_L_ZERO;
  return -INFINITY;
}

// The threshold from another split's best b (P6): only where it proves a
// contribution strictly below b (b >= 2^-100), so that a point it skips is
// below the pixel's max whatever its index.
__device__ __forceinline__ float strict_threshold(float b) {
  return b >= SP_BEST_NORMAL ? __fsub_rn(logf(b), SP_LOG_MARGIN) : -INFINITY;
}

// ln v, rounded up: never below the true value (P1).
__device__ __forceinline__ float log_value(float v) {
  if (!(v > 0.0f)) return -INFINITY;
  if (v > SP_V_MAX) return INFINITY;
  if (v < SP_V_LOG) return SP_LNV_MIN;
  const float l = __logf(v);
  return fmaxf(l + SP_LOG_ERR_ABS + SP_LOG_ERR_REL * fabsf(l), SP_LNV_MIN);
}

// A box of pixel centres: x in [x0, x1], y in [y0, y1], and the largest
// |pix|^2 over it.
struct Box {
  float x0, x1, y0, y1, sq_max;
};

__device__ __forceinline__ Box make_box(int c0, int c1, int r0, int r1, float half) {
  Box b;
  b.x0 = pixel_coord(c0, half);
  b.x1 = pixel_coord(c1, half);
  b.y0 = pixel_coord(r0, half);
  b.y1 = pixel_coord(r1, half);
  const float mx = fmaxf(fabsf(b.x0), fabsf(b.x1));
  const float my = fmaxf(fabsf(b.y0), fabsf(b.y1));
  b.sq_max = mx * mx + my * my;
  return b;
}

// fl(fl(d2lo * c) + ln v) for a point against a box: at least the t of
// every (point, pixel) pair of the box (P5).
__device__ __forceinline__ float box_t(float qx, float qy, float psq, float lnv,
                                       const Box& b, float neg) {
  const float gx = fmaxf(fmaxf(b.x0 - qx, qx - b.x1), 0.0f);
  const float gy = fmaxf(fmaxf(b.y0 - qy, qy - b.y1), 0.0f);
  const float g2 = gx * gx + gy * gy;
  const float d2lo = fmaxf(g2 * (1.0f - SP_D2_REL) - (psq + b.sq_max) * SP_D2_REL, 0.0f);
  return __fadd_rn(__fmul_rn(d2lo, neg), lnv);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

struct SplatShared {
  float4 q[2][SP_CHUNK];  // kept (x, y, |xy|^2, ln v) per channel, ascending index
  float v[2][SP_CHUNK];
  int idx[2][SP_CHUNK];
  int cnt[2 * SP_SLOTS];  // kept per (channel, ballot word), in point order
  float red[2][SP_WARPS];
  float4 part[SP_THREADS];  // this split's (best0, best1, argmax0, argmax1 bits)
  float2 pub[SP_THREADS];   // this split's bests, read by the other splits
};

// With kCount (a diagnostic build; the path's launches compile the counts
// out), stats gets (atomically): [0] (point, channel)s kept by the tile
// test, [1] (point, channel, warp)s kept by the warp test, [2] (point,
// pixel, channel)s that reached expf.
// Grid (tiles x splits, I), clusters of `splits` blocks along x: split s
// of a tile scans points s nps .. s nps + nps - 1.
template <bool kCount>
__global__ void __launch_bounds__(SP_THREADS)
max_splat_kernel(const float2* __restrict__ xy, const float2* __restrict__ vals,
                 float* __restrict__ img, int32_t* __restrict__ arg, int N, int w,
                 float neg_half_rho_sq, int nps, unsigned long long* __restrict__ stats) {
  __shared__ SplatShared sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int tile = blockIdx.x / (int)cluster.num_blocks();
  const int n_begin = split * nps, n_end = min(N, n_begin + nps);
  const int tiles = (w + SP_TW - 1) / SP_TW;
  const int tx = tile % tiles, ty = tile / tiles, im = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wc = tx * SP_TW + (warp & 1) * 8, wr = ty * SP_TW + (warp >> 1) * 4;
  const int col = wc + (lane & 7), row = wr + (lane >> 3);
  const float half = (float)(w / 2);
  const float neg = neg_half_rho_sq;
  const float pxx = pixel_coord(col, half), pxy = pixel_coord(row, half);
  const float xsq = sq2(pxx, pxy);
  const Box tbox = make_box(tx * SP_TW, tx * SP_TW + SP_TW - 1, ty * SP_TW,
                            ty * SP_TW + SP_TW - 1, half);
  const Box wbox = make_box(wc, wc + 7, wr, wr + 3, half);
  const float2* xyb = xy + (size_t)im * N;
  const float2* vb = vals + (size_t)im * N;
  const unsigned lt_mask = (1u << lane) - 1u;

  float best[2] = {-INFINITY, -INFINITY}, lim[2] = {-INFINITY, -INFINITY};
  int32_t win[2] = {0, 0};
  unsigned kept_tile = 0, kept_warp = 0, reached = 0;

  // This chunk's two points a thread, loaded one chunk ahead.
  float2 p_next[2], v_next[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n_begin + r * SP_THREADS + threadIdx.x;
    p_next[r] = n < n_end ? xyb[n] : make_float2(0.0f, 0.0f);
    v_next[r] = n < n_end ? vb[n] : make_float2(0.0f, 0.0f);
  }
  const int nsplit = (int)cluster.num_blocks();
  sm.pub[threadIdx.x] = make_float2(-INFINITY, -INFINITY);
  cluster.sync();  // every split's bests are readable
  for (int n0 = n_begin; n0 < n_end; n0 += SP_CHUNK) {
    // The other splits' bests so far, each a value some point attains.
    if (nsplit > 1) {
      sm.pub[threadIdx.x] = make_float2(best[0], best[1]);
      float2 o = make_float2(-INFINITY, -INFINITY);
      for (int r = 0; r < nsplit; ++r) {
        if (r == split) continue;
        const float2 q = cluster.map_shared_rank(sm.pub, r)[threadIdx.x];
        o.x = fmaxf(o.x, q.x);
        o.y = fmaxf(o.y, q.y);
      }
      lim[0] = fmaxf(lim[0], strict_threshold(o.x));
      lim[1] = fmaxf(lim[1], strict_threshold(o.y));
    }
    // The tile's smallest threshold per channel.
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float m = warp_min(lim[c]);
      if (lane == 0) sm.red[c][warp] = m;
    }
    __syncthreads();
    float tile_lim[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float m = sm.red[c][0];
#pragma unroll
      for (int k = 1; k < SP_WARPS; ++k) m = fminf(m, sm.red[c][k]);
      tile_lim[c] = m;
    }
    // Test two points a thread against the tile box; ballot per channel.
    float4 e[2][2];  // (x, y, |xy|^2, ln v) per (point, channel)
    bool keep[2][2];
    int rank[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = n0 + r * SP_THREADS + threadIdx.x < n_end;
      const float2 p = p_next[r];
      const float psq = sq2(p.x, p.y);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float lnv = log_value(c == 0 ? v_next[r].x : v_next[r].y);
        e[r][c] = make_float4(p.x, p.y, psq, lnv);
        keep[r][c] = in && !(box_t(p.x, p.y, psq, lnv, tbox, neg) < tile_lim[c]);
        const unsigned b = __ballot_sync(FULL, keep[r][c]);
        rank[r][c] = __popc(b & lt_mask);
        if (lane == 0) sm.cnt[c * SP_SLOTS + r * SP_WARPS + warp] = __popc(b);
      }
    }
    __syncthreads();
    // Exclusive prefix of the counts in point order, per channel: each warp
    // scans the 2 x 16 words itself (16-lane segments).
    const int cv = sm.cnt[lane];
    int incl = cv;
#pragma unroll
    for (int o = 1; o < SP_SLOTS; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o, SP_SLOTS);
      if ((lane & (SP_SLOTS - 1)) >= o) incl += y;
    }
    const int excl = incl - cv;
    int total[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      total[c] = __shfl_sync(FULL, incl, c * SP_SLOTS + SP_SLOTS - 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int base = __shfl_sync(FULL, excl, c * SP_SLOTS + r * SP_WARPS + warp);
        if (keep[r][c]) {
          const int pos = base + rank[r][c];
          sm.q[c][pos] = e[r][c];
          sm.v[c][pos] = c == 0 ? v_next[r].x : v_next[r].y;
          sm.idx[c][pos] = n0 + r * SP_THREADS + threadIdx.x;
        }
      }
    }
    if constexpr (kCount) kept_tile += total[0] + total[1];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + SP_CHUNK + r * SP_THREADS + threadIdx.x;
      p_next[r] = n < n_end ? xyb[n] : make_float2(0.0f, 0.0f);
      v_next[r] = n < n_end ? vb[n] : make_float2(0.0f, 0.0f);
    }
    // Each warp walks each channel's list in ascending order, 32 entries
    // at a time through its box test, then the kept entries two at a time,
    // in order, through the per-pixel test and expf.
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      for (int g = 0; g < total[c]; g += 32) {
        const float warp_lim = warp_min(lim[c]);
        const int k = g + lane;
        bool keep_w = false;
        if (k < total[c]) {
          const float4 f = sm.q[c][k];
          keep_w = !(box_t(f.x, f.y, f.z, f.w, wbox, neg) < warp_lim);
        }
        unsigned m = __ballot_sync(FULL, keep_w);
        if constexpr (kCount) kept_warp += __popc(m);
        while (m) {
          const int j0 = g + __ffs(m) - 1;
          m &= m - 1;
          const bool has1 = m != 0;
          const int j1 = has1 ? g + __ffs(m) - 1 : j0;
          if (has1) m &= m - 1;
          const float4 f0 = sm.q[c][j0];
          const float4 f1 = sm.q[c][j1];
          const float ex0 = pair_exponent(f0, pxx, pxy, xsq, neg);
          const float ex1 = pair_exponent(f1, pxx, pxy, xsq, neg);
          const bool go0 = !(__fadd_rn(ex0, f0.w) < lim[c]);
          const bool go1 = has1 && !(__fadd_rn(ex1, f1.w) < lim[c]);
          if (!__any_sync(FULL, go0 || go1)) continue;
          if constexpr (kCount) reached += go0 + go1;
          const float c0 = __fmul_rn(sm.v[c][j0], expf(ex0));
          const float c1 = __fmul_rn(sm.v[c][j1], expf(ex1));
          const bool up0 = go0 && c0 > best[c];
          if (up0) { best[c] = c0; win[c] = sm.idx[c][j0]; }
          const bool up1 = go1 && c1 > best[c];
          if (up1) { best[c] = c1; win[c] = sm.idx[c][j1]; }
          if (!__any_sync(FULL, up0 || up1)) continue;
          if (up0 || up1) lim[c] = fmaxf(lim[c], threshold(best[c]));
        }
      }
    }
  }
  // Rank 0 merges the splits' winners in ascending split order with a
  // strict >, so a tie keeps the lowest point index, as one scan would.
  sm.part[threadIdx.x] =
      make_float4(best[0], best[1], __int_as_float(win[0]), __int_as_float(win[1]));
  cluster.sync();
  if (split == 0) {
    for (int r = 1; r < (int)cluster.num_blocks(); ++r) {
      const float4 q = cluster.map_shared_rank(sm.part, r)[threadIdx.x];
      if (q.x > best[0]) { best[0] = q.x; win[0] = __float_as_int(q.z); }
      if (q.y > best[1]) { best[1] = q.y; win[1] = __float_as_int(q.w); }
    }
    if (col < w && row < w) {
      const int P = w * w;
      const size_t o = (size_t)im * 2 * P + (size_t)row * w + col;
      img[o] = best[0];
      img[o + P] = best[1];
      arg[o] = win[0];
      arg[o + P] = win[1];
    }
  }
  cluster.sync();  // rank 0 has read every partial before any block exits
  if constexpr (kCount) {
    const unsigned r = warp_sum(reached);
    if (lane == 0) {
      atomicAdd(stats + 1, (unsigned long long)kept_warp);
      atomicAdd(stats + 2, (unsigned long long)r);
    }
    if (threadIdx.x == 0) atomicAdd(stats, (unsigned long long)kept_tile);
  }
}

// Counts, over every non-positive fp32 x (bit patterns 0x80000000 ..
// 0xff800000), the x where expf(x) > expf(next x below) (not monotone) and
// the x <= EXP_ZERO where expf(x) != 0. The splat's skip rule needs the
// second count to be 0.
__global__ void expf_check_kernel(unsigned long long* __restrict__ bad) {
  const uint32_t last = 0x7f800000u;  // magnitude bits of -inf
  const uint32_t stride = gridDim.x * blockDim.x;
  unsigned non_mono = 0, non_zero = 0;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < last; i += stride) {
    const float x = __uint_as_float(0x80000000u | i);
    const float ex = expf(x);
    if (expf(__uint_as_float(0x80000000u | (i + 1))) > ex) ++non_mono;
    if (x <= SP_EXP_ZERO && ex != 0.0f) ++non_zero;
  }
  non_mono = warp_sum(non_mono);
  non_zero = warp_sum(non_zero);
  if ((threadIdx.x & 31) == 0 && (non_mono | non_zero)) {
    atomicAdd(bad, (unsigned long long)non_mono);
    atomicAdd(bad + 1, (unsigned long long)non_zero);
  }
}

}  // namespace

extern "C" {

// xy (I, N, 2), vals (I, N, 2) fp32 -> img (I, 2, w*w) fp32 and
// arg (I, 2, w*w) int32; neg_half_rho_sq = -rho^2 / 2; the points split
// over `splits` blocks (1..8) per tile; stats null, or three zeroed
// uint64 counters for the counting build (see max_splat_kernel). One launch.
int scream_max_splat(const void* xy, const void* vals, void* img, void* arg, int I,
                     int N, int w, float neg_half_rho_sq, int splits, void* stats,
                     void* stream) {
  if (I <= 0 || N <= 0 || w <= 0 || splits < 1 || splits > SP_MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int tiles = (w + SP_TW - 1) / SP_TW;
  const dim3 grid(tiles * tiles * splits, I);
  const int nps = (N + splits - 1) / splits;
  auto* counts = (unsigned long long*)stats;
  if (counts)
    return (int)launch_clusters(max_splat_kernel<true>, grid, SP_THREADS, splits, stream,
                                (const float2*)xy, (const float2*)vals, (float*)img,
                                (int32_t*)arg, N, w, neg_half_rho_sq, nps, counts);
  return (int)launch_clusters(max_splat_kernel<false>, grid, SP_THREADS, splits, stream,
                              (const float2*)xy, (const float2*)vals, (float*)img,
                              (int32_t*)arg, N, w, neg_half_rho_sq, nps, counts);
}

// bad: two zeroed uint64 counters (see expf_check_kernel). One launch.
int scream_splat_expf_check(void* bad, void* stream) {
  expf_check_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>((unsigned long long*)bad);
  return (int)cudaGetLastError();
}

}  // extern "C"
