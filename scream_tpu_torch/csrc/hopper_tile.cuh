// Hopper (sm_90a) building blocks for kernels that keep a row tile resident
// in shared memory and stream their weights past it (tail.cu, the stats and
// apply kernels of attn.cu):
//
//   * mbarrier wait / arrive / expect-tx, and the 1-D bulk copy
//     (cp.async.bulk, no tensor map) that completes on an mbarrier;
//   * Ring: a ring of weight stages in shared memory with a full and an
//     empty mbarrier per stage. One producer thread fills it with bulk
//     copies of a weight blob packed once per call into the exact byte
//     order the stages are consumed in (tail.cu:pack_kernel); the consumer warpgroups
//     wait on "full", run their products on the stage, and arrive on
//     "empty" once their wgmma on it has completed;
//   * wgmma.mma_async bf16 x bf16 -> fp32, m64nNk16 for N in {64, 96, 128,
//     192, 256}, A and B both from shared memory through matrix descriptors;
//   * ring_mma: one warpgroup's acc (+)= A @ B over a run of ring stages,
//     releasing each stage as soon as the wgmma that reads it completes.
//
// Shared-memory layout of every wgmma operand: K-major, no swizzle. A core
// matrix is 8 rows (M or N) x 8 bf16 along K, 16 contiguous bytes a row and
// 128 contiguous bytes in all. For a k16 step the two core matrices along K
// lie LBO = 128 bytes apart and the 8-row groups SBO bytes apart:
//   * an A tile of K columns (row tile, hidden chunk): core (row/8, k/8) at
//     ((row/8) * (K/8) + k/8) * 128 bytes, so SBO = 16 K and the k16 step
//     t starts at 256 t (core_off below);
//   * a weight stage of KS k-rows x NS columns: core (t, n/8, c) of k16
//     step t, column group n/8 and k half c at ((t * NS/8 + n/8) * 2 + c)
//     * 128 bytes, so SBO = 256, step t starts at 32 NS t and column n0 at
//     32 n0 (tail.cu:pack_kernel and attn.cu:stats_pack_kernel write it;
//     ops/tail_cuda.py:pack_weights and ops/attn_cuda.py:pack_stats_weights
//     are their plain versions).
//
// Accumulator fragment of m64nNk16 (fp32): thread t of the warpgroup holds
// d[i] for row 16 (t/32) + (t%32)/4 + 8 ((i/2)%2) and column
// 8 (i/4) + 2 (t%4) + i%2.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace scream {
namespace hopper {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---- mbarriers and the bulk copy ------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (bulk copies).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed. A wait that
// outlasts kWaitCycles of the SM clock (~10 s) traps, so that a pipeline
// fault ends the launch with an error instead of hanging the card.
constexpr long long kWaitCycles = 20000000000LL;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > kWaitCycles) {
      __trap();
    }
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both 16-byte
// aligned); completion is counted on the mbarrier `bar` as transaction bytes.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Generic-proxy shared-memory writes become visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` over `n` threads (a multiple of 32).
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma wait or issue.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for d[i0 .. i0 + n) (compile-time bounds): work on them is
// neither hoisted above nor sunk below this point, so a pass over the
// accumulators in groups keeps one group's temporaries live at a time.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R], int i0, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i)
    if (i0 + i < R) asm volatile("" : "+f"(d[i0 + i])::"memory");
}

// `p` as if defined here: address arithmetic on it is not hoisted above
// this point (and so not held in registers across the loop before it).
template <class T>
__device__ __forceinline__ T* opaque(T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// Matrix descriptor, no swizzle: start address, LBO and SBO in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// D += A @ B for one k16 step, m64nNk16, bf16 inputs, fp32 accumulators
// (scale-d 1); A and B are K-major in shared memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  __device__ static __forceinline__ void mma(float (&d)[48], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  __device__ static __forceinline__ void mma(float (&d)[96], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ static __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
  }
};

// ---- the weight ring ------------------------------------------------------

// One view of the ring (each thread keeps its own cursor): NST stages of
// STAGE bytes from shared address `base`, then at base + BARS their full
// and empty barriers (8 bytes each). Both sides walk the stages in the same
// order; `phase` flips each time the cursor wraps. The geometry is
// compile-time, so a cursor costs two registers.
template <int NST, int STAGE, int BARS>
struct Ring {
  uint32_t base;
  int slot = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ explicit Ring(uint32_t base_) : base(base_) {}

  __device__ __forceinline__ uint32_t full(int s) const { return base + BARS + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + BARS + 8 * (NST + s);
  }

  __device__ __forceinline__ void advance() {
    if (++slot == NST) {
      slot = 0;
      phase ^= 1u;
    }
  }

  // Consumer: wait until the current stage has landed; its address.
  __device__ __forceinline__ uint32_t wait_full() const {
    mbar_wait(full(slot), phase);
    return base + slot * STAGE;
  }

  // Consumer: this warpgroup is done reading stage `s`.
  __device__ __forceinline__ void release(int s) const { mbar_arrive(empty(s)); }

  // Producer: wait for the current stage to be free, then fill it with
  // STAGE bytes from `src`.
  __device__ __forceinline__ void fill(const void* src) const {
    mbar_wait(empty(slot), phase ^ 1u);
    mbar_expect_tx(full(slot), STAGE);
    bulk_g2s(base + slot * STAGE, src, STAGE, full(slot));
  }

  // Thread 0 of the block: full barriers take the producer's one arrival
  // (plus the copy's bytes), empty barriers one arrival per consumer
  // warpgroup.
  __device__ __forceinline__ void init(int consumers) const {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), consumers);
    }
    mbar_init_fence();
  }
};

// One warpgroup: acc (+)= A @ B over the next `stages` ring stages of KSTEP
// k16 steps each. `a` is the shared address of the warpgroup's 64-row A
// tile at k = 0 (8-row stride `a_sbo`); each stage's B is read at byte
// offset `b_off` (the warpgroup's first column) inside each of its k16
// blocks of `b_step` bytes. A stage is released once the wgmma group that
// reads it has completed; on return every group has completed. `wt` is the
// thread's index in its warpgroup.
template <int N, int KSTEP, class RingT>
__device__ __forceinline__ void ring_mma(float (&acc)[N / 2], RingT& ring, int stages,
                                         uint32_t a, uint32_t a_sbo, uint32_t b_off,
                                         uint32_t b_step, int wt) {
  int prev = -1;
  for (int s = 0; s < stages; ++s) {
    const uint32_t st = ring.wait_full();
    uint64_t da = desc(a + (uint32_t)(s * KSTEP) * 256u, 128, a_sbo);
    uint64_t db = desc(st + b_off, 128, 256);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KSTEP; ++k) {
      Wgmma<N>::mma(acc, da, db);
      // The next k16 step: A 256 bytes on, B b_step on. Advanced in order
      // (asm volatile), so that the compiler does not compute every step's
      // descriptors ahead and hold them beside the accumulators.
      if (k + 1 < KSTEP) {
        asm volatile("add.s64 %0, %0, 16;\n" : "+l"(da));
        asm volatile("add.s64 %0, %0, %1;\n" : "+l"(db) : "l"((uint64_t)(b_step >> 4)));
      }
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      if (wt == 0) ring.release(prev);
    }
    prev = ring.slot;
    ring.advance();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (wt == 0 && prev >= 0) ring.release(prev);
}

// Element i of a (K, N) weight packed in stages of ks k-rows (the stage
// layout above) comes from row k, column n: i runs over (stage s, k16 step
// j, column group g, k half h, column in group c, k in half kk). The packs
// of tail.cu and attn.cu write it.
__device__ __forceinline__ void kmajor_src(unsigned i, unsigned N, unsigned ks,
                                           unsigned& k, unsigned& n) {
  const unsigned kk = i % 8, c = (i / 8) % 8, h = (i / 64) % 2, g = (i / 128) % (N / 8);
  const unsigned j = (i / (16 * N)) % (ks / 16), s = i / (ks * N);
  k = s * ks + j * 16 + h * 8 + kk;
  n = g * 8 + c;
}

// Byte offset of element (row, col) in a K-major, no-swizzle tile of K
// columns (the A operand layout above).
__device__ __forceinline__ uint32_t core_off(int row, int col, int K) {
  return (uint32_t)(((row >> 3) * (K >> 3) + (col >> 3)) * 128 + (row & 7) * 16 +
                    (col & 7) * 2);
}

// Load `64` rows of K bf16 from global `src` (row stride K) into a K-major
// tile, zero-filling rows at or past `nvalid`; thread `i` of `nthr`. The
// 16-byte chunk i*16 of the tile is row 8 (i / (8 K/8)) + i % 8, chunk
// (i / 8) % (K/8).
template <int K>
__device__ __forceinline__ void load_tile64(bf16* tile, const bf16* src, int nvalid,
                                            int i0, int nthr) {
  constexpr int CH = K / 8;
  for (int i = i0; i < 64 * CH; i += nthr) {
    const int r = ((i >> 3) / CH) * 8 + (i & 7), kc = (i >> 3) % CH;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid) v = *reinterpret_cast<const uint4*>(src + (size_t)r * K + kc * 8);
    reinterpret_cast<uint4*>(tile)[i] = v;
  }
}

}  // namespace hopper
}  // namespace scream
