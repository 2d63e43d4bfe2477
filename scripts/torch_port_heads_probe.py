#!/usr/bin/env python3
"""Where the time of the head-generic apply kernels goes
(``csrc/attn_heads_apply.cu``, ``csrc/attn_heads_apply_f32.cu``, the attend
of ``csrc/attn_heads.cuh``): the same kernels built with one part of the
attend taken out, timed side by side on one card.

Usage, on a machine with an NVIDIA GPU and ``nvcc``:

    python3 scripts/torch_port_heads_probe.py

Each variant is a copy of the two sources and the headers under
``build/heads_probe/<name>/`` with the edits below, compiled with
``csrc/attn_f32.cu`` (the fp32 weight pack's launch) into a library of its
own (one ``nvcc`` a variant, all at once); the port's wrappers call its two
entry points, and the port's own build for the rest (the bf16 weight pack):

* ``base``: the sources as they are;
* ``no_stage``: no band chunk is staged (the wgmma read what the buffer
  holds; every barrier kept);
* ``no_attend``: no attend product is issued (each chunk still staged);
* ``no_normalize``: the normalizer not made (the message is the raw
  attend);
* ``no_attend_stage``: neither staged nor multiplied: what is left is the
  head-specific pipelines, the barriers and the normalizer.

Only ``base`` computes the function; the others are timed only. Per cell
(``chip_smoke.py`` path 12's four cells, and one head of d at d 256 and
384; seeded random inputs, hidden 4 d, apply fed the plain stats) it prints
each variant's best of 3 rounds of 10 calls, in the order base, variants,
base, with the card's name and power limit. It gates nothing.

    python3 scripts/torch_port_heads_probe.py --stats

times the head-generic stats' sum alone (``heads_sum_mma_kernel`` of
``csrc/attn_heads.cu``, its chunk reduce left out) on a seeded workspace
laid out as the projection writes it, built in variants the same way
(``build/heads_probe/stats_<name>/``, ``attn_heads.cu`` alone, its C entry
points replaced by one that launches the sum): ``base``; ``stages6`` and
``stages4``, six or four stages in flight; ``rows64``, stages of 64 rows;
``rows64_stages2``; ``fetch_by_half``, a stage's cp.async pieces ordered by
half (all K' rows, then all V rows) rather than along the workspace rows;
``occupancy6``, bf16 blocks of 64 columns held to 6 an SM (at most 85
registers a thread) instead of 4; ``no_mma``, the rows streamed and no product issued;
``bulk_rows``, each row's K' and V halves staged by a 1-D bulk copy (TMA)
completing on an mbarrier instead of cp.async, and ``bulk_rows_no_mma``;
``bulk_stage_no_mma``, one bulk copy of a stage's whole workspace rows
(streaming only: the rows land unpadded). Per cell (path 12's large cells,
d 256 at 32 heads of 8 in bf16, one head of 256 and, in fp32, 2 heads of
128 and one of 256) it prints each variant's
device time from ``torch.profiler`` (10 calls), with the workspace rewritten
before each call (as the projection leaves it in L2) and without, beside a
copy of the workspace (``torch.Tensor.copy_``: its bytes read and written)
as the card's streaming yardstick.
"""

import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "heads_probe")
# (B, L, d, heads, dtype)
CELLS = [(16, 4096, 256, 2, "bfloat16"), (8, 512, 128, 16, "bfloat16"),
         (8, 4096, 384, 16, "bfloat16"), (16, 4096, 256, 32, "float32"),
         (16, 4096, 256, 1, "bfloat16"), (8, 4096, 384, 1, "bfloat16"),
         (16, 4096, 256, 1, "float32")]
STAGE_BF16 = ("        stage_band_bf16(buf, A::KC, hopper::opaque(kv) + (size_t)b * D * hd, hd, c0, "
              "kc, nk,\n                        C::COLS == 1 ? (int)threadIdx.x : c.wt, "
              "C::COLS == 1 ? NC : 128);\n")
STAGE_F32 = "        stage_band_tf32(buf, KC, kvb, hd, c0, kc, nk, wt, 128);\n"
ATTEND_BF16 = ("        attend_bf16<decltype(fresh)::value>(att, hopper::smem_u32(c.tile) + "
               "(kc / 16) * 256,\n                                            16 * D, "
               "hopper::smem_u32(buf), A::KC, nk);\n")
ATTEND_F32 = "        attend_tf32<D, s>(acc, c, At, kc, nk, bs, KC, w.r0, w.t);\n"
NORM_BF16 = ("      normalize<0, SL / 8>(att, [&c](int j) { return c.col(s * SL / 8 + j); }, q, "
             "kss, hd,\n                           attn_eps, zh, inv);\n")
NORM_F32 = "    normalize<0, NJ>(acc, col, q, kss, hd, attn_eps, zh, inv);\n"
NO_ATTEND_BF16 = "        for (int i = 0; i < SL / 2; ++i) att[i] = (float)nk;\n"
NO_ATTEND_F32 = "        acc[s * kSliceF32 / 2] += (float)nk;\n"
BF, F32 = "attn_heads_apply.cu", "attn_heads_apply_f32.cu"
VARIANTS = {
    "base": [],
    "no_stage": [(BF, STAGE_BF16, ""), (F32, STAGE_F32, "")],
    "no_attend": [(BF, ATTEND_BF16, NO_ATTEND_BF16), (F32, ATTEND_F32, NO_ATTEND_F32)],
    "no_normalize": [(BF, NORM_BF16, ""), (F32, NORM_F32, "")],
    "no_attend_stage": [(BF, STAGE_BF16, ""), (F32, STAGE_F32, ""),
                        (BF, ATTEND_BF16, NO_ATTEND_BF16), (F32, ATTEND_F32, NO_ATTEND_F32)],
}
ENTRIES = ("scream_attn_apply_heads", "scream_attn_apply_heads_f32")


def build(nvcc, flags):
    """One library a variant, the compiles started together; {name: CDLL}."""
    src = os.path.join(REPO, "scream_tpu_torch", "csrc")
    procs = []
    for name, edits in VARIANTS.items():
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f in os.listdir(src):
            if f.endswith(".cuh") or f in (BF, F32, "attn_f32.cu"):
                shutil.copy(os.path.join(src, f), d)
        for f, old, new in edits:
            p = os.path.join(d, f)
            text = open(p).read()
            if text.count(old) != 1:
                raise SystemExit(f"torch_port_heads_probe: {name}: the edit of {f} no longer "
                                 "matches the source")
            open(p, "w").write(text.replace(old, new))
        lib = os.path.join(d, "lib.so")
        procs.append((name, lib, subprocess.Popen(
            [nvcc, *flags, "-shared", "-o", lib, *(os.path.join(d, f) for f in
                                                   (BF, F32, "attn_f32.cu"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, p in procs:
        log = p.communicate(timeout=900)[0]
        fn = None
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1]
            elif "spill" in ln and fn and "apply_heads" in fn:
                print(f"{name}: ptxas, {fn.split('kernelILi')[1].split('E')[0]}"
                      f"{' fp32' if 'f32' in fn else ''}: {ln.strip()}", flush=True)
        if p.returncode:
            raise SystemExit(f"torch_port_heads_probe: {name} does not build:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(lib)
    return libs


class Lib:
    """The port's library with the two head-generic apply entry points of a
    variant's library in place of its own."""

    def __init__(self, port, variant):
        self.port, self.variant = port, variant

    def __getattr__(self, name):
        return getattr(self.variant if name in ENTRIES else self.port, name)


def best_ms(fn):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(10):
            fn()
        e1.record()
        torch.cuda.synchronize()
        rounds.append(e0.elapsed_time(e1) / 10)
    return min(rounds)


STATS_HEADER, STATS_SRC = "attn_heads.cuh", "attn_heads.cu"
STATS_ENTRY = """
extern "C" int scream_heads_sum_probe(const void* ws, void* part, int B, int S, int Sp, int d,
                                      int hd, int f32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return f32 ? launch_sum_reduce((const float*)ws, (float*)part, nullptr, nullptr, B, S, Sp, d,
                                 hd, s)
             : launch_sum_reduce((const bf16*)ws, (float*)part, nullptr, nullptr, B, S, Sp, d,
                                 hd, s);
}
"""
REDUCE = "  return tf32::launch_reduce_slots(part, kv, ksum, B, nchunk, per, d * hd, stream);\n"
ROWS = "constexpr int kSumRows = 32;"
STAGES = "constexpr int kSumStages = 3;"
MMA_LOOP = "    for (int k = 0; k < kSumRows; k += KSTEP) {\n"
NO_MMA = (STATS_SRC, MMA_LOOP, "    for (int k = 0; k < (nst < 0 ? kSumRows : 0); k += KSTEP) {\n")
FETCH = """  auto fetch = [&](int s) {
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
    asm volatile("cp.async.commit_group;\\n" ::: "memory");
  };
"""
FETCH_ORDER = """        const int u = i % CPR, v = i / CPR % 2, q = i / (2 * CPR) % (BW / kGroup);
        const int r = i / (2 * CPR * (BW / kGroup));
"""
# the pieces ordered by half, then row, then group
FETCH_BY_HALF = """        const int u = i % CPR, q = i / CPR % (BW / kGroup);
        const int r = i / (CPR * (BW / kGroup)) % kSumRows;
        const int v = i / (CPR * (BW / kGroup) * kSumRows);
"""
WAIT = '    asm volatile("cp.async.wait_group %0;\\n" ::"n"(kSumStages - 1) : "memory");\n'
BULK_INIT = """  __shared__ __align__(8) uint64_t fullbar[kSumStages];
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSumStages; ++i) hopper::mbar_init(hopper::smem_u32(&fullbar[i]), 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  auto fetch = [&](int s) {
    if (s < nst && threadIdx.x < 32) {
      const uint32_t bar = hopper::smem_u32(&fullbar[s % kSumStages]);
      if (threadIdx.x == 0) hopper::mbar_expect_tx(bar, 2 * kSumRows * BW * (int)sizeof(T));
      __syncwarp();
      const uint32_t dst = hopper::smem_u32(stage + (s % kSumStages) * C::STAGE);
"""
# one bulk copy a group's row half, into the padded rows (kSumRows 32: lane r row r)
BULK_ROWS = BULK_INIT + """      const int r = threadIdx.x;
      for (int q = 0; q < BW / kGroup; ++q) {
        hopper::bulk_g2s(dst + (r * LD + q * kGroup) * (int)sizeof(T),
                         srck + ((size_t)q * Sp + s * kSumRows + r) * (2 * kGroup),
                         kGroup * sizeof(T), bar);
        hopper::bulk_g2s(dst + ((kSumRows + r) * LD + q * kGroup) * (int)sizeof(T),
                         srcv + ((size_t)q * Sp + s * kSumRows + r) * (2 * kGroup),
                         kGroup * sizeof(T), bar);
      }
    }
  };
"""
# one bulk copy a group of the stage's whole workspace rows of block bk,
# unpadded (streaming only)
BULK_STAGE = BULK_INIT + """      if (threadIdx.x < BW / kGroup)
        hopper::bulk_g2s(dst + threadIdx.x * kSumRows * 2 * kGroup * (int)sizeof(T),
                         srck + ((size_t)threadIdx.x * Sp + s * kSumRows) * (2 * kGroup),
                         2 * kSumRows * kGroup * sizeof(T), bar);
    }
  };
"""
BULK_WAIT = "    hopper::mbar_wait(hopper::smem_u32(&fullbar[s % kSumStages]), (s / kSumStages) & 1);\n"
STATS_VARIANTS = {
    "base": [],
    "stages6": [(STATS_HEADER, STAGES, "constexpr int kSumStages = 6;")],
    "stages4": [(STATS_HEADER, STAGES, "constexpr int kSumStages = 4;")],
    "rows64": [(STATS_HEADER, ROWS, "constexpr int kSumRows = 64;")],
    "rows64_stages2": [(STATS_HEADER, ROWS, "constexpr int kSumRows = 64;"),
                       (STATS_HEADER, STAGES, "constexpr int kSumStages = 2;")],
    "fetch_by_half": [(STATS_SRC, FETCH_ORDER, FETCH_BY_HALF)],
    "occupancy6": [(STATS_SRC, "MIN_BLOCKS = 256 / BW;", "MIN_BLOCKS = F32 || BW > kGroup ? 256 / BW : 6;")],
    "no_mma": [NO_MMA],
    "bulk_rows": [(STATS_SRC, FETCH, BULK_ROWS), (STATS_SRC, WAIT, BULK_WAIT)],
    "bulk_rows_no_mma": [(STATS_SRC, FETCH, BULK_ROWS), (STATS_SRC, WAIT, BULK_WAIT), NO_MMA],
    "bulk_stage_no_mma": [(STATS_SRC, FETCH, BULK_STAGE), (STATS_SRC, WAIT, BULK_WAIT), NO_MMA],
}
STATS_CELLS = [(16, 4096, 256, 2, "bfloat16"), (16, 4096, 256, 32, "bfloat16"),
               (8, 4096, 384, 16, "bfloat16"), (16, 4096, 256, 1, "bfloat16"),
               (16, 4096, 256, 32, "float32"), (16, 4096, 256, 2, "float32"),
               (16, 4096, 256, 1, "float32")]


def build_stats(nvcc, flags):
    """One library a stats variant: ``attn_heads.cu`` edited, its C entry
    points replaced by ``scream_heads_sum_probe``; {name: CDLL}."""
    src = os.path.join(REPO, "scream_tpu_torch", "csrc")
    procs = []
    for name, edits in STATS_VARIANTS.items():
        d = os.path.join(OUT, "stats_" + name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f in os.listdir(src):
            if f.endswith(".cuh") or f == STATS_SRC:
                shutil.copy(os.path.join(src, f), d)
        p = os.path.join(d, STATS_SRC)
        text = open(p).read()
        text = text[:text.index('extern "C" {')].replace(REDUCE, "  return 0;\n") + STATS_ENTRY
        open(p, "w").write(text)
        for f, old, new in edits:
            p = os.path.join(d, f)
            text = open(p).read()
            if text.count(old) != 1:
                raise SystemExit(f"torch_port_heads_probe: {name}: the edit of {f} no longer "
                                 "matches the source")
            open(p, "w").write(text.replace(old, new))
        lib = os.path.join(d, "lib.so")
        procs.append((name, lib, subprocess.Popen(
            [nvcc, *flags, "-shared", "-o", lib, os.path.join(d, STATS_SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, p in procs:
        log = p.communicate(timeout=900)[0]
        if p.returncode:
            raise SystemExit(f"torch_port_heads_probe: {name} does not build:\n{log[-3000:]}")
        for ln in log.splitlines():
            if "spill" in ln or "registers" in ln:
                print(f"{name}: ptxas: {ln.strip()}", flush=True)
        libs[name] = ctypes.CDLL(lib)
        fn = libs[name].scream_heads_sum_probe
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return libs


def device_us(fn, before=None):
    """Device time of the kernels ``fn`` launches (10 calls), by name, us a
    call; ``before`` runs ahead of each call, outside the count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            if before:
                before()
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if dt > 0:
            out[ev.key] = dt / 10
    return out


def stats_main(smi):
    import torch

    from scream_tpu_torch.ops import _build

    libs = build_stats(_build.find_nvcc(), _build.NVCC_FLAGS)
    for B, S, d, heads, dt in STATS_CELLS:
        f32 = dt == "float32"
        sp = -(-S // (64 if f32 else 128)) * (64 if f32 else 128)
        g = torch.Generator(device="cuda").manual_seed(B * 1000 + d + heads)
        src = torch.rand((B * sp * 2 * d,), generator=g, device="cuda").to(getattr(torch, dt))
        ws = src.clone()
        part = torch.empty(B * -(-S // 512) * (d * d // heads + d), device="cuda")
        stream = _build.stream_ptr(ws)
        rewrite = lambda: ws.copy_(src)
        out = []
        for name in ["base"] + [n for n in STATS_VARIANTS if n != "base"] + ["base"]:
            fn = lambda: libs[name].scream_heads_sum_probe(ws.data_ptr(), part.data_ptr(), B, S,
                                                          sp, d, d // heads, int(f32), stream)
            us = [sum(v for k, v in device_us(fn, before).items() if "heads_sum" in k)
                  for before in (rewrite, None)]
            out.append(f"{name} {us[0]:.1f} / {us[1]:.1f}")
        copy = sum(device_us(rewrite).values())
        mb = ws.numel() * ws.element_size() / 1e6
        print(f"{dt} d {d}, {heads} heads of {d // heads}, {B} x {S}: sum us (after a workspace "
              f"rewrite / without): " + ", ".join(out) + f" | workspace {mb:.1f} MB, its copy "
              f"{copy:.1f} us ({2 * mb / copy:.2f} TB/s read + write) | {smi}", flush=True)


def main():
    sys.path.insert(0, REPO)
    import torch

    from scream_tpu_torch.ops import _build, attn_cuda

    if not torch.cuda.is_available():
        raise SystemExit("torch_port_heads_probe: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if "--stats" in sys.argv[1:]:
        return stats_main(smi)
    port = _build.kernels()
    libs = build(_build.find_nvcc(), _build.NVCC_FLAGS)
    for lib in libs.values():
        for entry in ENTRIES:
            _build.declare(lib, entry)
    order = ["base"] + [n for n in VARIANTS if n != "base"] + ["base"]
    try:
        for B, L, d, heads, dt in CELLS:
            cd = getattr(torch, dt)
            g = torch.Generator(device="cuda").manual_seed(B * 1000 + d + heads)
            x = torch.randn((B, L, d), generator=g, device="cuda").to(cd)
            m = (torch.rand((B, L), generator=g, device="cuda") > 0.1).float()
            w = lambda *s: (torch.randn(s, generator=g, device="cuda") / s[0] ** 0.5).to(cd)
            Wq, Wk, Wv, Wm, W1, W2 = w(d, d), w(d, d), w(d, d), w(d, d), w(d, 4 * d), w(4 * d, d)
            ones, zeros = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
            KV, ks = attn_cuda.attn_stats_plain(x, m, Wk, Wv, num_heads=heads)
            call = lambda: attn_cuda.attn_apply_heads(
                x, m, KV, ks, Wq, Wm, ones, zeros, W1, W2, ones, zeros, attn_eps=1e-6,
                ln_eps=1e-5, norm_dtype=torch.float32)
            times = []
            for name in order:
                _build._lib = Lib(port, libs[name])
                times.append(f"{name} {best_ms(call):.4f}")
            print(f"{dt} d {d}, {heads} heads of {d // heads}, {B} x {L}: "
                  + ", ".join(times) + f" ms | {smi}", flush=True)
    finally:
        _build._lib = port


if __name__ == "__main__":
    main()
