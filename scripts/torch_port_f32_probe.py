#!/usr/bin/env python3
"""Where the time of the fp32 attention kernels (``csrc/attn_f32.cu``) goes,
and what their promotion chunk buys: the same kernels built with one part of
their work taken out, or without promotion, timed side by side on one card.

Usage, on a machine with an NVIDIA GPU and ``nvcc``:

    python3 scripts/torch_port_f32_probe.py

Each variant is a copy of ``attn_f32.cu`` and the headers it includes under
``build/f32_probe/<name>/`` with the edits below, compiled alone (one
``nvcc`` a variant, all at once) into a library that the port's wrappers
then call through ``_build._lib``:

* ``base``: the sources as they are;
* ``no_mma``: no wgmma is issued (the A fragments are still loaded and
  split, every stage still waited for and released);
* ``one_pass``: only the hi hi pass of each k8 step (one wgmma of three);
* ``no_copy``: every ring stage is filled with 16 bytes instead of 32 KB
  (the handshake kept, the L2 weight stream gone);
* ``neither``: no wgmma and 16-byte stages;
* ``no_split``: A enters the wgmma unsplit (hi = the fp32 bits, lo = 0);
* ``no_promotion``: ``tf32_tile.cuh:kPromoteK`` so large that no product is
  promoted before its end (one wgmma accumulator over all its k).

``base`` and ``no_promotion`` compute the function, and for them the script
also prints stats' and apply's relative errors against their plain versions
on the same inputs; the others give wrong values and are timed only. Per
shape (16 x 4,096 at d 256 and 60 x 512 at d 128, 8 heads, hidden 4 d,
seeded random inputs) it prints stats' and apply's best of 3 rounds of 10
calls for each variant, in the order base, variants, base.

Then, at the serving shape 8 x 512 (d 128, 8 heads), where the host's time
bounds a call, the host microseconds a call of the fp32 stats and apply
wrappers as built (each one C call that launches its weight pack too), of
their pack wrappers alone (what a separate pack call, the bf16 wrappers'
pattern, would add), and of the bf16 stats wrapper (pack, then kernel). It
gates nothing.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "f32_probe")
SHAPES = [(16, 4096, 256), (60, 512, 128)]
MMA = ("      Wgmma<N>::mma(c, lo[i], bh, w0 + i == 0 ? !fresh : 1);\n"
       "      Wgmma<N>::mma(c, hi[i], bl, 1);\n"
       "      Wgmma<N>::mma(c, hi[i], bh, 1);\n")
NO_MMA = "      c[0] += __uint_as_float(lo[i][0] ^ hi[i][1] ^ hi[i][2] ^ hi[i][3] ^ lo[i][3]);\n"
COPY = ("    mbar_expect_tx(full(slot), STAGE);\n"
        "    bulk_g2s(base + slot * STAGE, src, STAGE, full(slot));")
SMALL_COPY = ("    mbar_expect_tx(full(slot), 16);\n"
              "    bulk_g2s(base + slot * STAGE, src, 16, full(slot));")
SPLIT = "  hi = rna(a);\n  lo = rna(a - __uint_as_float(hi));\n"
PROMOTE = "constexpr int kPromoteK = 64;"
EXACT = ("base", "no_promotion")
VARIANTS = {
    "base": [],
    "no_mma": [("tf32_tile.cuh", MMA, NO_MMA)],
    "one_pass": [("tf32_tile.cuh", MMA,
                  "      Wgmma<N>::mma(c, hi[i], bh, w0 + i == 0 ? !fresh : 1);\n")],
    "no_copy": [("hopper_tile.cuh", COPY, SMALL_COPY)],
    "neither": [("tf32_tile.cuh", MMA, NO_MMA), ("hopper_tile.cuh", COPY, SMALL_COPY)],
    "no_split": [("tf32_tile.cuh", SPLIT, "  hi = __float_as_uint(a);\n  lo = 0u;\n")],
    "no_promotion": [("tf32_tile.cuh", PROMOTE, "constexpr int kPromoteK = 1 << 30;")],
}


def build(nvcc, flags):
    """One library a variant, the compiles started together; {name: CDLL}."""
    src = os.path.join(REPO, "scream_tpu_torch", "csrc")
    procs = []
    for name, edits in VARIANTS.items():
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f in ("attn_f32.cu", "tf32_tile.cuh", "tail_tile.cuh", "hopper_tile.cuh"):
            shutil.copy(os.path.join(src, f), d)
        for f, old, new in edits:
            p = os.path.join(d, f)
            text = open(p).read()
            if text.count(old) != 1:
                raise SystemExit(f"torch_port_f32_probe: {name}: the edit of {f} no longer "
                                 "matches the source")
            open(p, "w").write(text.replace(old, new))
        lib = os.path.join(d, "lib.so")
        procs.append((name, lib, subprocess.Popen(
            [nvcc, *flags, "-shared", "-o", lib, os.path.join(d, "attn_f32.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, p in procs:
        log = p.communicate(timeout=900)[0]
        if p.returncode:
            raise SystemExit(f"torch_port_f32_probe: {name} does not build:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def host_us(fn, n=2000):
    """Host microseconds a call of ``fn``, over ``n`` calls issued back to back."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def host_times(attn_cuda, smi):
    """The wrappers' host time a call at 8 x 512, d 128, 8 heads."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(1)
    B, L, d, H = 8, 512, 128, 8
    x = torch.randn((B, L, d), generator=g, device="cuda")
    m = torch.ones((B, L), device="cuda")
    w = lambda *s: torch.randn(s, generator=g, device="cuda") / s[0] ** 0.5
    Wq, Wk, Wv, Wm, W1, W2 = w(d, d), w(d, d), w(d, d), w(d, d), w(d, 4 * d), w(4 * d, d)
    ones, zeros = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
    KV, ks = attn_cuda.attn_stats(x, m, Wk, Wv, num_heads=H)
    xb, Wkb, Wvb = (t.to(torch.bfloat16) for t in (x, Wk, Wv))
    calls = [
        ("fp32 stats", lambda: attn_cuda.attn_stats(x, m, Wk, Wv, num_heads=H)),
        ("its pack alone", lambda: attn_cuda.pack_stats_weights_f32(Wk, Wv, num_heads=H)),
        ("fp32 apply", lambda: attn_cuda.attn_apply(
            x, m, KV, ks, Wq, Wm, ones, zeros, W1, W2, ones, zeros, attn_eps=1e-6,
            ln_eps=1e-5, norm_dtype=torch.float32)),
        ("its pack alone", lambda: attn_cuda.pack_apply_weights_f32(Wq, Wm, W1, W2)),
        ("bf16 stats (pack, then kernel)",
         lambda: attn_cuda.attn_stats(xb, m, Wkb, Wvb, num_heads=H)),
    ]
    print(f"{B} x {L}, d {d}, host us a call: "
          + ", ".join(f"{k} {host_us(f):.2f}" for k, f in calls) + f" | {smi.strip()}",
          flush=True)


def main():
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import torch

    import chip_smoke
    from scream_tpu_torch.ops import _build, attn_cuda

    if not torch.cuda.is_available():
        raise SystemExit("torch_port_f32_probe: needs a CUDA GPU")
    libs = build(_build.find_nvcc(), _build.NVCC_FLAGS)
    for lib in libs.values():
        for entry in ("scream_attn_stats_f32", "scream_attn_apply_f32"):
            _build.declare(lib, entry)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, L, d in SHAPES:
        x = torch.randn((B, L, d), generator=g, device="cuda")
        m = torch.ones((B, L), device="cuda")
        w = lambda *s: torch.randn(s, generator=g, device="cuda") / s[0] ** 0.5
        Wq, Wk, Wv, Wm, W1, W2 = w(d, d), w(d, d), w(d, d), w(d, d), w(d, 4 * d), w(4 * d, d)
        ones, zeros = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
        KV, ks = attn_cuda.attn_stats_plain(x, m, Wk, Wv, num_heads=8)
        args = (x, m, KV, ks, Wq, Wm, ones, zeros, W1, W2, ones, zeros)
        kw = dict(attn_eps=1e-6, ln_eps=1e-5, norm_dtype=torch.float32)
        out = attn_cuda.attn_apply_plain(*args, **kw)
        for name in ["base", *[v for v in VARIANTS if v != "base"], "base"]:
            _build._lib = libs[name]
            s_ms = chip_smoke.timed(lambda: attn_cuda.attn_stats(x, m, Wk, Wv, num_heads=8))[0]
            a_ms = chip_smoke.timed(lambda: attn_cuda.attn_apply(*args, **kw))[0]
            err = ""
            if name in EXACT:
                KVk, ksk = attn_cuda.attn_stats(x, m, Wk, Wv, num_heads=8)
                s_err = max(chip_smoke.rel_err(KVk, KV), chip_smoke.rel_err(ksk, ks))
                a_err = chip_smoke.rel_err(attn_cuda.attn_apply(*args, **kw), out)
                err = f"; relative error stats {s_err:.3e}, apply {a_err:.3e}"
            print(f"{B} x {L}, d {d}, {name}: stats {s_ms:.4f} ms, apply {a_ms:.4f} ms{err} | "
                  f"{smi.strip()}", flush=True)
    _build._lib = None  # the port's own build of every source
    host_times(attn_cuda, smi)


if __name__ == "__main__":
    main()
