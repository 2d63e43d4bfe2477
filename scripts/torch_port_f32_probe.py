#!/usr/bin/env python3
"""Where the time of the fp32 kernels (``csrc/attn_f32.cu``,
``csrc/tail_f32.cu``) goes, and what their promotion chunk buys: the same
kernels built with one part of their work taken out, or without promotion,
timed side by side on one card.

Usage, on a machine with an NVIDIA GPU and ``nvcc``:

    python3 scripts/torch_port_f32_probe.py
    python3 scripts/torch_port_f32_probe.py --forward [TREE]

Each variant is a copy of ``attn_f32.cu``, ``tail_f32.cu`` and the headers
they include under ``build/f32_probe/<name>/`` with the edits below,
compiled alone (one ``nvcc`` a variant, all at once) into a library that
the port's wrappers then call through ``_build._lib``:

* ``base``: the sources as they are;
* ``no_mma``: no wgmma is issued (the A fragments are still loaded and
  split, every stage still waited for and released);
* ``one_pass``: only the hi hi pass of each k8 step (one wgmma of three);
* ``no_copy``: every ring stage is filled with 16 bytes instead of 32 KB
  (the handshake kept, the L2 weight stream gone);
* ``neither``: no wgmma and 16-byte stages;
* ``no_split``: A enters the wgmma unsplit (hi = the fp32 bits, lo = 0);
* ``no_promotion``: ``tf32_tile.cuh:kPromoteK`` so large that no product is
  promoted before its end (one wgmma accumulator over all its k; the W2
  product still at the end of each hidden chunk);
* ``d384_wk2``: at d 384 the d-wide passes' wgmma windows of 2 k8 steps
  instead of 4 (``tf32_tail.cuh:Block::WK_D``; the tail only).

``base``, ``no_promotion`` and ``d384_wk2`` compute the function, and for
them the script also prints the relative errors against the plain versions
on the same inputs; the others give wrong values and are timed only. The
build prints each variant's ptxas spill line for the tail kernel at each
width. Per shape (16 x
4,096 at d 256 and 60 x 512 at d 128, 8 heads, hidden 4 d, seeded random
inputs) it prints stats' and apply's best of 3 rounds of 10 calls for each
variant, in the order base, variants, base; then the same for the tail at
d 384, 8 x 4,096 rows, hidden 1,536, and at d 256, 16 x 4,096, hidden 1,024.

Then, at the serving shape 8 x 512 (d 128, 8 heads), where the host's time
bounds a call, the host microseconds a call of the fp32 stats and apply
wrappers as built (each one C call that launches its weight pack too), of
their pack wrappers alone (what a separate pack call, the bf16 wrappers'
pattern, would add), and of the bf16 stats wrapper (pack, then kernel). It
gates nothing.

``--forward [TREE]`` times, with the ``scream_tpu_torch`` of ``TREE``
(default: this checkout; an unpacked ``git archive`` of another commit to
compare two in one call), the fp32 d 384 DEM forward at 8 x 4,096 (a
seeded random-init ``DEMTransformer``, every block's tail on the tail
kernel) and the fp32 tail at the two shapes above, best of 3 rounds each,
and nothing else.
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
TAIL_SHAPES = [(8 * 4096, 384), (16 * 4096, 256)]  # (rows, d), hidden 4 d
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
WK_D = "static constexpr int WK_D = PASS64 ? 4 : KS_D / 8;"
EXACT = ("base", "no_promotion", "d384_wk2")
VARIANTS = {
    "base": [],
    "no_mma": [("tf32_tile.cuh", MMA, NO_MMA)],
    "one_pass": [("tf32_tile.cuh", MMA,
                  "      Wgmma<N>::mma(c, hi[i], bh, w0 + i == 0 ? !fresh : 1);\n")],
    "no_copy": [("hopper_tile.cuh", COPY, SMALL_COPY)],
    "neither": [("tf32_tile.cuh", MMA, NO_MMA), ("hopper_tile.cuh", COPY, SMALL_COPY)],
    "no_split": [("tf32_tile.cuh", SPLIT, "  hi = __float_as_uint(a);\n  lo = 0u;\n")],
    "no_promotion": [("tf32_tile.cuh", PROMOTE, "constexpr int kPromoteK = 1 << 30;")],
    "d384_wk2": [("tf32_tail.cuh", WK_D, WK_D.replace("PASS64 ? 4", "PASS64 ? 2"))],
}


def build(nvcc, flags):
    """One library a variant, the compiles started together; {name: CDLL}."""
    src = os.path.join(REPO, "scream_tpu_torch", "csrc")
    procs = []
    for name, edits in VARIANTS.items():
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f in ("attn_f32.cu", "tail_f32.cu", "tf32_tail.cuh", "tf32_tile.cuh",
                  "tail_tile.cuh", "hopper_tile.cuh"):
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
            [nvcc, *flags, "-shared", "-o", lib, os.path.join(d, "attn_f32.cu"),
             os.path.join(d, "tail_f32.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, p in procs:
        log = p.communicate(timeout=900)[0]
        fn = None
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1]
            elif "spill" in ln and fn and "tail_f32_kernel" in fn:
                print(f"{name}: ptxas, {fn.split('ILi')[1].split('E')[0]}-wide tail: "
                      f"{ln.strip()}", flush=True)
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
        ("its pack alone", lambda: attn_cuda.pack_block_weights_f32(Wm, W1, W2, Wq=Wq)),
        ("bf16 stats (pack, then kernel)",
         lambda: attn_cuda.attn_stats(xb, m, Wkb, Wvb, num_heads=H)),
    ]
    print(f"{B} x {L}, d {d}, host us a call: "
          + ", ".join(f"{k} {host_us(f):.2f}" for k, f in calls) + f" | {smi.strip()}",
          flush=True)


def tail_args(rows, d, g):
    """Seeded random fp32 tail inputs on the card: x, q (rows, d), then Wm,
    g1, b1, W1, W2, g2, b2 at hidden 4 d."""
    import torch

    w = lambda *s: torch.randn(s, generator=g, device="cuda") / s[0] ** 0.5
    x, q = (torch.randn((rows, d), generator=g, device="cuda") for _ in range(2))
    ones, zeros = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
    return x, q, w(d, d), ones, zeros, w(d, 4 * d), w(4 * d, d), ones, zeros


def forward_times(tree, smi):
    """``--forward``: the d 384 fp32 DEM forward and the fp32 tail with
    ``tree``'s package."""
    sys.path.insert(0, tree)
    import dataclasses

    import torch

    import chip_smoke
    from scream_tpu_torch.models import DEMTransformer
    from scream_tpu_torch.ops import tail_cuda
    from scream_tpu_torch.pipeline.register import to_device

    model_cfg, _ = chip_smoke.dem_config()
    dem = DEMTransformer(dataclasses.replace(model_cfg, d_model=384, dtype="float32"),
                         device="cuda", generator=torch.Generator().manual_seed(0))
    db = to_device(chip_smoke.dem_batch(chip_smoke.make_dem_items(1, seed=1300, batch=8,
                                                                  points=4096)[0],
                                        cap=4096, coarse=512), "cuda")
    args = (db["dsm"], db["dem_coarse"], db["dsm_mask"], db["dem_coarse_mask"])
    with torch.no_grad():
        best, rounds = chip_smoke.timed(lambda: dem(*args), reps=3, warmup=1)
    print(f"{tree}: fp32 d 384 DEM forward, 8 x 4096: {best:.4f} ms (rounds "
          f"{', '.join(f'{t:.4f}' for t in rounds)}) | {smi.strip()}", flush=True)
    del dem
    g = torch.Generator(device="cuda").manual_seed(2)
    for rows, d in TAIL_SHAPES:
        a = tail_args(rows, d, g)
        with torch.no_grad():
            best, rounds = chip_smoke.timed(lambda: tail_cuda.block_tail(
                *a, dtype=torch.float32, norm_dtype=torch.float32))
        print(f"{tree}: fp32 tail, {rows} rows, d {d}: {best:.4f} ms (rounds "
              f"{', '.join(f'{t:.4f}' for t in rounds)}) | {smi.strip()}", flush=True)


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    if "--forward" in sys.argv[1:]:
        rest = [a for a in sys.argv[1:] if a != "--forward"]
        tree = os.path.abspath(rest[0] if rest else REPO)
        os.chdir(tree)
        return forward_times(tree, smi)
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import torch

    import chip_smoke
    from scream_tpu_torch.ops import _build, attn_cuda, tail_cuda
    from scream_tpu_torch.ops.ffn import tail_plain

    if not torch.cuda.is_available():
        raise SystemExit("torch_port_f32_probe: needs a CUDA GPU")
    libs = build(_build.find_nvcc(), _build.NVCC_FLAGS)
    for lib in libs.values():
        for entry in ("scream_attn_stats_f32", "scream_attn_apply_f32",
                      "scream_block_tail_f32"):
            _build.declare(lib, entry)
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
    f32 = torch.float32
    for rows, d in TAIL_SHAPES:
        a = tail_args(rows, d, g)
        out = tail_plain(*a, cd=f32, nd=f32, eps=1e-5)
        kern = lambda: tail_cuda.block_tail(*a, dtype=f32, norm_dtype=f32)
        for name in ["base", *[v for v in VARIANTS if v != "base"], "base"]:
            _build._lib = libs[name]
            with torch.no_grad():
                ms = chip_smoke.timed(kern)[0]
                err = (f"; relative error {chip_smoke.rel_err(kern(), out):.3e}"
                       if name in EXACT else "")
            print(f"tail {rows} rows, d {d}, {name}: {ms:.4f} ms{err} | {smi.strip()}",
                  flush=True)
        del a, out
    _build._lib = None  # the port's own build of every source
    host_times(attn_cuda, smi)


if __name__ == "__main__":
    main()
