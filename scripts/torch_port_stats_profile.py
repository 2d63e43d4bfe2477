#!/usr/bin/env python3
"""The stats kernels (``ops/attn_cuda.py:attn_stats``) at the paths' shapes:
a digest of their output bits, their time and each kernel's device time.

Usage, on a machine with an NVIDIA GPU:

    python3 scripts/torch_port_stats_profile.py [TREE] [--f32 | --heads]

``TREE`` (default: this checkout) is the root of the tree whose
``scream_tpu_torch`` is imported, for example an unpacked ``git archive``
of another commit: two trees give the same digests exactly when their
stats kernels give the same bits on these inputs. Per shape (B x S, d;
inputs made on the card from a seed, 20 % of the rows masked) it prints
the SHA-256 of KV and K_sum, the ms of a call by CUDA events (best and all
of 3 rounds of 10 calls) and the device time of each kernel a call
launches under ``torch.profiler`` (10 calls). ``--f32``: the float32
kernels instead (``csrc/attn_f32.cu``) at path 7's and path 9's shapes,
stats and then apply (8 heads, hidden 4 d, fed the plain stats), then the
tail (``csrc/tail_f32.cu``, hidden 4 d) at d 384, 8 x 4,096 and d 256, 16 x
4,096, each with a digest of its output and its weight pack's launch among
its kernels. Without a flag, after the stats: the bf16 apply (8 heads, fed
the plain stats) at 16 x 4,096 (d 256) and 8 x 512 (d 128), and the bf16
tail at d 512, 8 x 8,192 and d 256, 16 x 4,096 (``csrc/tail.cu``).
``--heads``: the head-generic pair (``csrc/attn_heads*.cu``) at the cells of
``chip_smoke.py`` path 12 (bf16 2 heads of 128 and 16 heads of 8 and 24, fp32
32 heads of 8), stats and then apply fed the plain stats. ``--heads-cells``:
the head-generic stats alone at every cell they take (bf16 d 128-384, fp32 d
128-256, each head count the head-specific kernels do not take) at
``chip_smoke.py``'s shape for the width, one line a cell: digest and the best
of 3 rounds of 10 calls. It gates nothing: ``chip_smoke.py`` holds the
kernels to their plain versions.
"""

import hashlib
import os
import sys

SHAPES = [(16, 4096, 256), (8, 4096, 256), (8, 4000, 256), (8, 512, 128), (3, 129, 128),
          (1, 448, 128), (2, 1, 256)]
SHAPES_F32 = [(16, 4096, 256), (60, 512, 128), (8, 512, 128)]
TAIL_SHAPES_F32 = [(8, 4096, 384), (16, 4096, 256)]
APPLY_SHAPES = [(16, 4096, 256), (8, 512, 128)]
TAIL_SHAPES = [(8, 8192, 512), (16, 4096, 256)]
# chip_smoke.py path 12's timed cells: (B, S, d, heads, dtype).
HEADS_CELLS = [(16, 4096, 256, 2, "bfloat16"), (8, 512, 128, 16, "bfloat16"),
               (8, 4096, 384, 16, "bfloat16"), (16, 4096, 256, 32, "float32")]


def profile_call(name, shape, call, digest=None):
    """One line: digest, CUDA-event time and device time by kernel of ``call``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rounds = []
    for _ in range(3):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(10):
            call()
        e1.record()
        torch.cuda.synchronize()
        rounds.append(e0.elapsed_time(e1) / 10)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if dt > 0:
            kname = ev.key.replace("(anonymous namespace)::", "").split("(")[0]
            kname = kname.split("<")[0].split("::")[-1]
            kernels.append(f"{kname} {dt / ev.count:.1f} us")
    B, S, d = shape
    print(f"{name}{B} x {S}, d {d}: " + (f"sha256 {digest[:16]} | " if digest else "")
          + f"{min(rounds):.4f} ms (rounds {', '.join(f'{t:.4f}' for t in rounds)}) | "
          f"device a call: {'; '.join(kernels)} | {torch.cuda.get_device_name(0)}",
          flush=True)


def f32_shapes():
    import torch

    from scream_tpu_torch.ops import attn_cuda, tail_cuda

    for B, S, d in SHAPES_F32:
        g = torch.Generator(device="cuda").manual_seed(B * 100000 + S * 10 + d)
        x = torch.randn((B, S, d), generator=g, device="cuda")
        m = (torch.rand((B, S), generator=g, device="cuda") > 0.2).float()
        w = lambda *s: torch.randn(s, generator=g, device="cuda") / s[0] ** 0.5
        Wq, Wk, Wv, Wm, W1, W2 = w(d, d), w(d, d), w(d, d), w(d, d), w(d, 4 * d), w(4 * d, d)
        ln = [torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")] * 2
        stats = lambda: attn_cuda.attn_stats(x, m, Wk, Wv, num_heads=8)
        KV, ks = stats()
        digest = hashlib.sha256(KV.cpu().numpy().tobytes() + ks.cpu().numpy().tobytes())
        profile_call("fp32 stats ", (B, S, d), stats, digest.hexdigest())
        KVp, ksp = attn_cuda.attn_stats_plain(x, m, Wk, Wv, num_heads=8)
        apply = lambda: attn_cuda.attn_apply(
            x, m, KVp, ksp, Wq, Wm, ln[0], ln[1], W1, W2, ln[2], ln[3], attn_eps=1e-6,
            ln_eps=1e-5, norm_dtype=torch.float32)
        digest = hashlib.sha256(apply().cpu().numpy().tobytes())
        profile_call("fp32 apply ", (B, S, d), apply, digest.hexdigest())
    for B, S, d in TAIL_SHAPES_F32:
        g = torch.Generator(device="cuda").manual_seed(B * 100000 + S * 10 + d)
        x, q = (torch.randn((B, S, d), generator=g, device="cuda") for _ in range(2))
        w = lambda *s: torch.randn(s, generator=g, device="cuda") / s[0] ** 0.5
        Wm, W1, W2 = w(d, d), w(d, 4 * d), w(4 * d, d)
        ln = [torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")] * 2
        tail = lambda: tail_cuda.block_tail(x, q, Wm, ln[0], ln[1], W1, W2, ln[2], ln[3],
                                            dtype=torch.float32, norm_dtype=torch.float32)
        digest = hashlib.sha256(tail().cpu().numpy().tobytes())
        profile_call("fp32 tail ", (B, S, d), tail, digest.hexdigest())


def block_inputs(B, S, d, dtype):
    """x, mask and block weights (hidden 4 d) on the card from a seed of the
    shape; LayerNorm params fp32."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(B * 100000 + S * 10 + d)
    x = torch.randn((B, S, d), generator=g, device="cuda").to(dtype)
    m = (torch.rand((B, S), generator=g, device="cuda") > 0.2).float()
    w = lambda *s: (torch.randn(s, generator=g, device="cuda") / s[0] ** 0.5).to(dtype)
    ln = [torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")] * 2
    return x, m, (w(d, d), w(d, d), w(d, d), w(d, d), w(d, 4 * d), w(4 * d, d)), ln


def apply_call(x, m, W, ln, heads):
    """The apply kernel fed the plain stats: (call, digest of its output)."""
    import torch

    from scream_tpu_torch.ops import attn_cuda

    Wq, Wk, Wv, Wm, W1, W2 = W
    KVp, ksp = attn_cuda.attn_stats_plain(x, m, Wk, Wv, num_heads=heads)
    call = lambda: attn_cuda.attn_apply(x, m, KVp, ksp, Wq, Wm, ln[0], ln[1], W1, W2, ln[2],
                                        ln[3], attn_eps=1e-6, ln_eps=1e-5,
                                        norm_dtype=torch.float32)
    return call, hashlib.sha256(call().float().cpu().numpy().tobytes()).hexdigest()


def bf16_apply_tail():
    import torch

    from scream_tpu_torch.ops import tail_cuda

    bf = torch.bfloat16
    for B, S, d in APPLY_SHAPES:
        x, m, W, ln = block_inputs(B, S, d, bf)
        call, digest = apply_call(x, m, W, ln, 8)
        profile_call("apply ", (B, S, d), call, digest)
    for B, S, d in TAIL_SHAPES:
        x, m, W, ln = block_inputs(B, S, d, bf)
        tail = lambda: tail_cuda.block_tail(x, x, W[3], ln[0], ln[1], W[4], W[5], ln[2], ln[3],
                                            dtype=bf, norm_dtype=torch.float32)
        digest = hashlib.sha256(tail().float().cpu().numpy().tobytes()).hexdigest()
        profile_call("tail ", (B, S, d), tail, digest)


def heads_cells():
    import torch

    from scream_tpu_torch.ops import attn_cuda

    for B, S, d, heads, dt in HEADS_CELLS:
        x, m, W, ln = block_inputs(B, S, d, getattr(torch, dt))
        stats = lambda: attn_cuda.attn_stats(x, m, W[1], W[2], num_heads=heads)
        KV, ks = stats()
        digest = hashlib.sha256(KV.cpu().numpy().tobytes() + ks.cpu().numpy().tobytes())
        label = f"{dt} {heads} heads "
        profile_call(label + "stats ", (B, S, d), stats, digest.hexdigest())
        call, digest = apply_call(x, m, W, ln, heads)
        profile_call(label + "apply ", (B, S, d), call, digest)


# chip_smoke.py CELL_SHAPES: (B, S) by width.
CELL_SHAPES = {128: (8, 512), 256: (16, 4096), 384: (8, 4096)}


def heads_stats_cells():
    import torch

    from scream_tpu_torch.ops import attn_cuda

    for dt, widths in attn_cuda.HEADS_WIDTHS.items():
        for d in widths:
            for hd in range(1, d + 1):
                heads = d // hd
                if d % hd or attn_cuda.head_cell(d, heads, dt):
                    continue
                B, S = CELL_SHAPES[d]
                x, m, W, _ = block_inputs(B, S, d, dt)
                stats = lambda: attn_cuda.attn_stats(x, m, W[1], W[2], num_heads=heads)
                KV, ks = stats()
                digest = hashlib.sha256(KV.cpu().numpy().tobytes() + ks.cpu().numpy().tobytes())
                rounds = []
                for _ in range(3):
                    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    e0.record()
                    for _ in range(10):
                        stats()
                    e1.record()
                    torch.cuda.synchronize()
                    rounds.append(e0.elapsed_time(e1) / 10)
                print(f"{str(dt)[6:]} d {d}, {heads} heads of {hd}, {B} x {S}: sha256 "
                      f"{digest.hexdigest()[:16]} | {min(rounds):.4f} ms | "
                      f"{torch.cuda.get_device_name(0)}", flush=True)


def main():
    args = [a for a in sys.argv[1:] if a not in ("--f32", "--heads", "--heads-cells")]
    root = os.path.abspath(args[0] if args else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    from scream_tpu_torch.ops import attn_cuda

    if not torch.cuda.is_available():
        raise SystemExit("torch_port_stats_profile: needs a CUDA GPU")
    if "--f32" in sys.argv[1:]:
        return f32_shapes()
    if "--heads" in sys.argv[1:]:
        return heads_cells()
    if "--heads-cells" in sys.argv[1:]:
        return heads_stats_cells()
    for B, S, d in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(B * 100000 + S * 10 + d)
        x = torch.randn((B, S, d), generator=g, device="cuda").to(torch.bfloat16)
        m = (torch.rand((B, S), generator=g, device="cuda") > 0.2).float()
        Wk, Wv = ((torch.randn((d, d), generator=g, device="cuda") / d ** 0.5).to(torch.bfloat16)
                  for _ in range(2))
        call = lambda: attn_cuda.attn_stats(x, m, Wk, Wv, num_heads=8)
        KV, ks = call()
        digest = hashlib.sha256(KV.cpu().numpy().tobytes() + ks.cpu().numpy().tobytes())
        profile_call("", (B, S, d), call, digest.hexdigest())
    bf16_apply_tail()


if __name__ == "__main__":
    main()
