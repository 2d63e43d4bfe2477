// Split-TF32 ("3xTF32") building blocks for the float32 attention and tail
// kernels on Hopper (sm_90a), beside hopper_tile.cuh's bf16 ones
// (attn_f32.cu, tail_f32.cu, through tf32_tail.cuh):
//
//   * split: an fp32 value a as hi = tf32_rna(a) and lo = tf32_rna(a - hi),
//     both fp32 bit patterns with the 13 low mantissa bits zero
//     (cvt.rna.tf32.f32, then masked), so the tensor cores never truncate a
//     raw fp32 operand. a - hi is exact; hi + lo is a within 2^-22 of |a|.
//   * wgmma.mma_async m64nNk8 .f32.tf32.tf32, N 32, 64 or 128, A from registers
//     (the four values of the thread's fragment) and B from shared memory
//     through a K-major, no-swizzle descriptor, scale-d a runtime predicate.
//     The 3xTF32 product of one k8 step is three of them into one fp32
//     accumulator, small terms first: lo(A) hi(B), hi(A) lo(B), hi(A) hi(B).
//   * ring_mma3: one warpgroup's product over a run of ring stages (the Ring
//     of hopper_tile.cuh, one producer thread filling it with bulk copies of
//     a blob packed once per call), with promotion: every kPromoteK k values
//     the wgmma accumulator (fresh at the chunk's first step, scale-d 0) is
//     added into a master sum in registers with fp32 FADD. Published
//     measurements of NVIDIA tensor cores (V100 to A100) found fp32 partial
//     sums added with truncation and no guard bits; a chunk of 64 k values
//     bounds what that can cost (the CPU model of
//     tests/test_torch_port_tf32x3.py, which reads kPromoteK from here as
//     ops/attn_cuda.py:F32_PROMOTE_K).
//
// Row tiles (the A operand) are fp32 in shared memory, read into registers
// and split there, so no hi/lo copy of a tile is kept. A tile of K columns
// stores element (r, c), c = 8 j + u, at float r K + 8 (j ^ (r & 3)) + p(u),
// p(u) = 2 (u & 3) + (u >> 2): a thread's fragment values (r, 8 j + t) and
// (r, 8 j + t + 4) are one 8-byte load, and the 16 lanes of a half-warp
// (rows r0 .. r0 + 3) hit 16 distinct 8-byte bank pairs.
//
// The A fragment of m64nNk8 tf32 (thread of lane l in warp w of the
// warpgroup, g = l / 4, t = l % 4): a0 = A[16 w + g][t], a1 = A[16 w + g +
// 8][t], a2 = A[16 w + g][t + 4], a3 = A[16 w + g + 8][t + 4]. The
// accumulator fragment is hopper_tile.cuh's.
//
// A weight stage holds KS k-rows x NS columns twice, hi then lo, 16 KB each
// (kHalf bytes: KS NS = 4096): core matrices of 8 columns x 4 k (16 bytes a
// column), core (t, n/8, c) of k8 step t and k half c at ((t NS/8 + n/8) 2
// + c) 128 bytes, so LBO = 128, SBO = 256, step t starts at 32 NS t and
// column n0 at 32 n0 (stage_src below; attn_f32.cu's pack kernels write it,
// ops/attn_cuda.py:f32_stage_layout is their plain version).

#pragma once

#include "hopper_tile.cuh"

namespace scream {
namespace tf32 {

constexpr int kHalfFloats = 4096;           // a stage's hi (or lo) block
constexpr int kHalf = 4 * kHalfFloats;      // its bytes
constexpr int kStage = 2 * kHalf;           // bytes of a ring stage: hi, then lo
constexpr int kPromoteK = 64;               // k values of a promotion chunk

// fp32 -> tf32 rounded to nearest, ties away from zero, as an fp32 pattern.
__device__ __forceinline__ uint32_t rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = rna(a);
  lo = rna(a - __uint_as_float(hi));
}

// elu(x) + 1 as where(x > 0, x + 1, exp(x)) (attn_pallas._elu1).
__device__ __forceinline__ float elu1(float v) { return v > 0.f ? v + 1.f : expf(v); }

// Element i of a stage half with ns columns comes from k-row k, column n.
__host__ __device__ __forceinline__ void stage_src(unsigned i, unsigned ns, unsigned& k,
                                                   unsigned& n) {
  const unsigned kk = i % 4, nn = (i / 4) % 8, c = (i / 32) % 2, g = (i / 64) % (ns / 8);
  k = 8 * (i / (8 * ns)) + 4 * c + kk;
  n = 8 * g + nn;
}

// Float index of element (r, c) in a row tile of K columns.
__device__ __forceinline__ int tile_idx(int r, int c, int K) {
  const int u = c & 7;
  return r * K + 8 * ((c >> 3) ^ (r & 3)) + 2 * (u & 3) + (u >> 2);
}

// Rows of src (global, row stride K) below nvalid into the 64-row tile,
// rows at or past nvalid zero; thread tid of nthr.
template <int K>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ src,
                                          int nvalid, int tid, int nthr) {
  constexpr int GR = K / 8;
  for (int i = tid; i < 64 * GR; i += nthr) {
    const int r = i / GR, j = i % GR;
    float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
    if (r < nvalid) {
      const float4* p = reinterpret_cast<const float4*>(src + (size_t)r * K + 8 * j);
      v0 = __ldg(p);
      v1 = __ldg(p + 1);
    }
    float4* d = reinterpret_cast<float4*>(tile + r * K + 8 * (j ^ (r & 3)));
    d[0] = make_float4(v0.x, v1.x, v0.y, v1.y);  // columns 0 4 1 5
    d[1] = make_float4(v0.z, v1.z, v0.w, v1.w);  // columns 2 6 3 7
  }
}

// The A fragment of k8 step s (columns 8 s .. 8 s + 7) for rows r0, r0 + 8,
// split into hi and lo.
template <int K>
__device__ __forceinline__ void load_a(const float* tile, int s, int r0, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int off = 8 * (s ^ (r0 & 3)) + 2 * t;
  const float2 v0 = *reinterpret_cast<const float2*>(tile + r0 * K + off);
  const float2 v1 = *reinterpret_cast<const float2*>(tile + (r0 + 8) * K + off);
  split(v0.x, hi[0], lo[0]);
  split(v1.x, hi[1], lo[1]);
  split(v0.y, hi[2], lo[2]);
  split(v1.y, hi[3], lo[3]);
}

// D (+)= A @ B for one k8 step: scale_d 0 overwrites D; D is d[0 .. N/2).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  template <int R>
  __device__ static __forceinline__ void mma(float (&d)[R], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    static_assert(R >= 16, "accumulator");
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  template <int R>
  __device__ static __forceinline__ void mma(float (&d)[R], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    static_assert(R >= 32, "accumulator");
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  template <int R>
  __device__ static __forceinline__ void mma(float (&d)[R], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    static_assert(R >= 64, "accumulator");
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// The 3xTF32 product of one ring stage (KS k-rows, NS columns) for one
// warpgroup: A columns KS s .. KS s + KS - 1 of the tile (K columns), B the
// warpgroup's N columns at byte b_off of each half; fresh: the stage opens a
// promotion chunk, whose first wgmma overwrites c. The stage's k8 steps go
// in windows of WK: a window's A registers are all written before its wgmma
// fence and its group is waited for before the next window's are, so no
// register a wgmma reads changes under it (and a window holds 8 WK of them).
// The stage is released after its last window.
template <int N, int KS, int K, int NS, int CN, int WK, class RingT>
__device__ __forceinline__ void stage3(float (&c)[CN], RingT& ring, const float* a, int s,
                                       uint32_t b_off, int fresh, int r0, int t, int wt) {
  static_assert(KS % (8 * WK) == 0, "windows");
  uint32_t st = 0;
#pragma unroll
  for (int w0 = 0; w0 < KS / 8; w0 += WK) {
    uint32_t hi[WK][4], lo[WK][4];
#pragma unroll
    for (int i = 0; i < WK; ++i) load_a<K>(a, s * (KS / 8) + w0 + i, r0, t, hi[i], lo[i]);
    if (w0 == 0) st = ring.wait_full();
    uint64_t bh = hopper::desc(st + b_off + 32 * NS * w0, 128, 256);
    uint64_t bl = hopper::desc(st + kHalf + b_off + 32 * NS * w0, 128, 256);
    hopper::wgmma_fence();
#pragma unroll
    for (int i = 0; i < WK; ++i) {
      Wgmma<N>::mma(c, lo[i], bh, w0 + i == 0 ? !fresh : 1);
      Wgmma<N>::mma(c, hi[i], bl, 1);
      Wgmma<N>::mma(c, hi[i], bh, 1);
      if (i + 1 < WK) {  // the next k8 step: 32 NS bytes on in both halves
        asm volatile("add.s64 %0, %0, %1;\n" : "+l"(bh) : "n"(2 * NS));
        asm volatile("add.s64 %0, %0, %1;\n" : "+l"(bl) : "n"(2 * NS));
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(c, 0, N / 2);
  }
  if (wt == 0) ring.release(ring.slot);
  ring.advance();
}

// m[MO .. MO + N/2) += A @ B over `stages` ring stages, promoted every
// kPromoteK / KS stages (and at the end): c[0 .. N/2) holds the running
// chunk (m may be c itself, MO >= N/2: a narrow product's master in the
// chunk array's idle registers); WK k8 steps a wgmma window (stage3). wt is the thread's index
// in its warpgroup; the warpgroup's 64 rows are the tile's.
template <int N, int KS, int K, int NS, int MO = 0, int WK = KS / 8, int MN, int CN,
          class RingT>
__device__ __forceinline__ void ring_mma3(float (&m)[MN], float (&c)[CN], RingT& ring,
                                          int stages, const float* a, uint32_t b_off, int wt) {
  constexpr int pk = kPromoteK / KS > 1 ? kPromoteK / KS : 1;
  static_assert(MO + N / 2 <= MN, "master");
  const int r0 = 16 * (wt >> 5) + ((wt & 31) >> 2), t = wt & 3;
  // Written here, outside any wgmma window, so that the compiler sees c dead
  // between products (the wgmmas read it: "+f"), not live across the kernel.
#pragma unroll
  for (int i = 0; i < N / 2; ++i) c[i] = 0.f;
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    stage3<N, KS, K, NS, CN, WK>(c, ring, a, s, b_off, s % pk == 0, r0, t, wt);
    if ((s + 1) % pk == 0 || s + 1 == stages) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) m[MO + i] += c[i];
    }
  }
}

// The fp32 stats projections (attn_f32.cu's attn_stats_f32_kernel and
// attn_heads.cu's heads_proj_f32_kernel) share the two halves below. Each
// item is a 64-row tile times the packed [Wk|Wv] of pack_stats_f32_kernel:
// per 128-column group, D / 32 stages of 32 k-rows.

// attn_f32.cu (attn_stats_f32_reduce_kernel), the last launch of the fp32
// stats and of attn_heads.cu's stats: out[b][e] = the sum over the slots s
// = 0 .. nslots - 1 of part[b][s][e] in slot order, e < nkv into kv (B nkv
// floats), the rest into ksum.
int launch_reduce_slots(const float* part, float* kv, float* ksum, int B, int nslots, int per,
                        int nkv, cudaStream_t stream);

// The producer thread: the ns stages of wpack in order, item after item.
template <class RingT>
__device__ __forceinline__ void fill_items(RingT ring, const float* wpack, int ns, int nitems) {
  for (int it = blockIdx.x; it < nitems; it += gridDim.x)
    for (int st = 0; st < ns; ++st) {
      ring.fill(wpack + (size_t)st * (kStage / 4));
      ring.advance();
    }
}

// The two consumer warpgroups (thread tid of 256) on one item: the tile's
// nvalid rows of x (the rest zero) into X and their mask into ms, then per
// group the tile times the group's columns on ring_mma3, elu1 where a
// column is a K' column (group column n, n mod 2 HD < HD), times the row's
// mask, and out(grp, acc): acc[4 j + 2 hh + e] is row r0 + 8 hh and group
// column 64 cp + 8 j + 2 t + e of warpgroup cp. Its first sync waits for
// the last item's reads of X and ms; out syncs around what else it shares.
template <int D, int HD, class RingT, class Out>
__device__ __forceinline__ void project_kv(float (&acc)[32], float (&c)[32], RingT& ring,
                                           float* X, float* ms, const float* __restrict__ x,
                                           const float* __restrict__ mask, int nvalid, int tid,
                                           Out out) {
  const int cp = tid >> 7, wt = tid & 127;
  const int r0 = 16 * (wt >> 5) + ((wt & 31) >> 2);
  hopper::named_sync(1, 256);
  load_tile<D>(X, x, nvalid, tid, 256);
  if (tid < 64) ms[tid] = tid < nvalid ? mask[tid] : 0.f;
  hopper::named_sync(1, 256);
  const float m[2] = {ms[r0], ms[r0 + 8]};
#pragma unroll 1
  for (int grp = 0; grp < 2 * D / 128; ++grp) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    ring_mma3<64, 32, D, 128>(acc, c, ring, D / 32, X, 32 * 64 * cp, wt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool is_k = (64 * cp + 8 * j) % (2 * HD) < HD;
#pragma unroll
      for (int i = 4 * j; i < 4 * j + 4; ++i)
        acc[i] = (is_k ? elu1(acc[i]) : acc[i]) * m[(i >> 1) & 1];
    }
    out(grp, acc);
  }
}

}  // namespace tf32
}  // namespace scream
