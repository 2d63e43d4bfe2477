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


def main():
    sys.path.insert(0, REPO)
    import torch

    from scream_tpu_torch.ops import _build, attn_cuda

    if not torch.cuda.is_available():
        raise SystemExit("torch_port_heads_probe: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
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
