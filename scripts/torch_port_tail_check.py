#!/usr/bin/env python3
"""Build the port's kernels and hold the block-tail kernel against its plain
version on one GPU, quickly.

Usage, from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_port_tail_check.py

It builds ``scream_tpu_torch/csrc/*.cu`` (one ``nvcc`` call), prints the
compiler's register and spill report, then runs ``ops/tail_cuda.py:block_tail``
and ``ops/ffn.py:tail_plain`` on seeded random bf16 inputs at every width
the kernel takes (d 128, 256, 384, 512, hidden 4d), with ragged row counts
and at the DEM path's 65,536 and 8,192 rows: the relative error (max |err|
over max |ref|), the count of outputs more than 0.02 apart, and both times
by CUDA events (mean of 10 after 2 warm-ups). Last it checks the attention
kernels (``attn.cu``, which shares ``csrc/wmma_tile.cuh``) against their
plain versions at d 256 and d 128. It gates nothing: ``chip_smoke.py`` holds
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
    print(f"build {time.perf_counter() - t0:.1f} s")
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            print(ln.strip())
    dev, bf, f32 = "cuda", torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    for d, R in ((128, 300), (256, 1000), (384, 777), (512, 65536), (512, 8192), (512, 33)):
        hid = 4 * d
        args = (randn(R, d).to(bf), randn(R, d).to(bf), randn(d, d) / d ** 0.5,
                1 + 0.1 * randn(d), 0.1 * randn(d), randn(d, hid) / d ** 0.5,
                randn(hid, d) / hid ** 0.5, 1 + 0.1 * randn(d), 0.1 * randn(d))
        kern = lambda: tail_cuda.block_tail(*args, dtype=bf, norm_dtype=f32)
        plain = lambda: tail_plain(*args, cd=bf, nd=f32, eps=1e-5)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        n_far = int(((out.float() - ref.float()).abs() > 0.02).sum())
        print(f"tail d={d} R={R}: rel {rel(out, ref):.3e}, {n_far} outputs > 0.02 apart, "
              f"finite {bool(torch.isfinite(out.float()).all())} | {cuda_ms(kern):.4f} ms "
              f"| plain {cuda_ms(plain):.4f} ms")
    for d in (256, 128):
        x = randn(4, 1000, d).to(bf)
        m = (torch.rand((4, 1000), generator=g, device=dev) > 0.1).float()
        Wq, Wk, Wv, Wm = ((randn(d, d) / d ** 0.5).to(bf) for _ in range(4))
        W1, W2 = (randn(d, 4 * d) / d ** 0.5).to(bf), (randn(4 * d, d) / (4 * d) ** 0.5).to(bf)
        ones, zeros = torch.ones(d, device=dev), torch.zeros(d, device=dev)
        KV, ks = attn_cuda.attn_stats(x, m, Wk, Wv, num_heads=8)
        KVp, ksp = attn_cuda.attn_stats_plain(x, m, Wk, Wv, num_heads=8)
        a = (x, m, KVp, ksp, Wq, Wm, ones, zeros, W1, W2, ones, zeros)
        kw = dict(attn_eps=1e-6, ln_eps=1e-5, norm_dtype=f32)
        o, op = attn_cuda.attn_apply(*a, **kw), attn_cuda.attn_apply_plain(*a, **kw)
        torch.cuda.synchronize()
        mb = m.bool()
        print(f"attn d={d}: stats rel {max(rel(KV, KVp), rel(ks, ksp)):.3e}, apply rel "
              f"{rel(o[mb], op[mb]):.3e}")


if __name__ == "__main__":
    main()
