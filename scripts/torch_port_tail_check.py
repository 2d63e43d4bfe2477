#!/usr/bin/env python3
"""Build the port's kernels and hold the block-tail and attention-apply
kernels against their plain versions on one GPU, quickly.

Usage, from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_port_tail_check.py

It builds ``scream_tpu_torch/csrc/*.cu`` (one ``nvcc`` call) and prints the
compiler's register, shared-memory and spill report and its warnings. Then,
smallest shapes first so that a fault shows early:

* ``ops/tail_cuda.py:block_tail`` against ``ops/ffn.py:tail_plain`` on
  seeded random bf16 inputs at every width the kernel takes (d 128, 256,
  384, 512, hidden 4d), with ragged row counts and at the DEM path's 65,536
  and 8,192 rows and 65,536 - 37 and 8,192 + 5;
* the weight pack of both (``tail_cuda.pack_weights``, on the card one
  launch of ``csrc/tail.cu:pack_kernel``) against the plain pack on the
  CPU, bit for bit;
* ``ops/attn_cuda.py``'s stats and apply kernels against their plain
  versions at d 256 (16 x 4,096, 8 x 4,096, 8 x 4,000) and d 128 (8 x 512,
  4 x 1,000), the apply kernel fed the plain stats;

each with its relative error (max |err| over max |ref|), the count of
outputs more than 0.02 apart, and the kernel's and the plain version's
times by CUDA events (mean of 10 after 2 warm-ups). Last, the tail's three
products at 8 x 8,192 rows and d 512 as three cuBLAS calls (``torch.matmul``
in bf16), each timed alone: a reference line for the tail kernel, not a
computation of the same function. It gates nothing: ``chip_smoke.py`` holds
the kernels to their bars; this is the short first call after a kernel
changes.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def cuda_ms(fn, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import torch

    from scream_tpu_torch.ops import _build, attn_cuda, tail_cuda
    from scream_tpu_torch.ops.ffn import tail_plain

    if not torch.cuda.is_available():
        raise SystemExit("torch_port_tail_check: needs a CUDA GPU")
    t0 = time.perf_counter()
    _build.build()
    _build.kernels()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for ln in _build.build_log.splitlines():
        if any(w in ln for w in ("registers", "spill", "warning", "smem", "Compiling entry")):
            print(ln.strip())
    dev, bf, f32 = "cuda", torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=g, device=dev)

    def pack_exact(*ws):
        """The card's weight pack (``pack_kernel``) equals the CPU's plain pack."""
        got = tail_cuda.pack_weights(*ws)
        return torch.equal(got.cpu(), tail_cuda.pack_weights(*(w.cpu() for w in ws)))

    def tail(d, R):
        hid = 4 * d
        args = (randn(R, d).to(bf), randn(R, d).to(bf), randn(d, d) / d ** 0.5,
                1 + 0.1 * randn(d), 0.1 * randn(d), randn(d, hid) / d ** 0.5,
                randn(hid, d) / hid ** 0.5, 1 + 0.1 * randn(d), 0.1 * randn(d))
        kern = lambda: tail_cuda.block_tail(*args, dtype=bf, norm_dtype=f32)
        plain = lambda: tail_plain(*args, cd=bf, nd=f32, eps=1e-5)
        out = kern()
        torch.cuda.synchronize()  # a kernel fault shows here, before the plain version
        ref = plain()
        n_far = int(((out.float() - ref.float()).abs() > 0.02).sum())
        print(f"tail d={d} R={R}: pack exact {pack_exact(args[2], args[5], args[6])}, "
              f"rel {rel(out, ref):.3e}, {n_far} outputs > 0.02 apart, "
              f"finite {bool(torch.isfinite(out.float()).all())} | {cuda_ms(kern):.4f} ms "
              f"| plain {cuda_ms(plain):.4f} ms", flush=True)

    def apply(d, B, L):
        x = randn(B, L, d).to(bf)
        m = (torch.rand((B, L), generator=g, device=dev) > 0.1).float()
        Wq, Wk, Wv, Wm = ((randn(d, d) / d ** 0.5).to(bf) for _ in range(4))
        W1, W2 = (randn(d, 4 * d) / d ** 0.5).to(bf), (randn(4 * d, d) / (4 * d) ** 0.5).to(bf)
        g1, g2 = 1 + 0.1 * randn(d), 1 + 0.1 * randn(d)
        b1, b2 = 0.1 * randn(d), 0.1 * randn(d)
        KV, ks = attn_cuda.attn_stats(x, m, Wk, Wv, num_heads=8)
        KVp, ksp = attn_cuda.attn_stats_plain(x, m, Wk, Wv, num_heads=8)
        a = (x, m, KVp, ksp, Wq, Wm, g1, b1, W1, W2, g2, b2)
        kw = dict(attn_eps=1e-6, ln_eps=1e-5, norm_dtype=f32)
        kern = lambda: attn_cuda.attn_apply(*a, **kw)
        plain = lambda: attn_cuda.attn_apply_plain(*a, **kw)
        o = kern()
        torch.cuda.synchronize()
        op = plain()
        mb = m.bool()
        n_far = int(((o.float() - op.float())[mb].abs() > 0.02).sum())
        print(f"attn d={d} {B} x {L}: pack exact {pack_exact(Wm, W1, W2, Wq)}, "
              f"stats rel {max(rel(KV, KVp), rel(ks, ksp)):.3e}, "
              f"apply rel {rel(o[mb], op[mb]):.3e}, {n_far} outputs > 0.02 apart, finite "
              f"{bool(torch.isfinite(o.float()).all())} | apply {cuda_ms(kern):.4f} ms | "
              f"plain {cuda_ms(plain):.4f} ms", flush=True)

    tail(128, 300)
    tail(512, 33)
    apply(128, 4, 1000)
    apply(256, 4, 1000)
    for d, R in ((256, 1000), (384, 777), (512, 8192), (512, 8192 + 5), (512, 65536),
                 (512, 65536 - 37), (256, 65536)):
        tail(d, R)
    for d, B, L in ((256, 16, 4096), (256, 8, 4096), (256, 8, 4000), (128, 8, 512)):
        apply(d, B, L)

    R, d = 8 * 8192, 512
    x, y, h = randn(R, d).to(bf), randn(R, d).to(bf), randn(R, 4 * d).to(bf)
    Wm, W1, W2 = randn(d, d).to(bf), randn(d, 4 * d).to(bf), randn(4 * d, d).to(bf)
    times = [cuda_ms(lambda: x @ Wm), cuda_ms(lambda: y @ W1), cuda_ms(lambda: h @ W2)]
    print(f"cuBLAS reference, the tail's three products at {R} x {d} (hidden {4 * d}), "
          f"bf16, each alone: x@Wm {times[0]:.4f} ms, y@W1 {times[1]:.4f} ms, h@W2 "
          f"{times[2]:.4f} ms, sum {sum(times):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
