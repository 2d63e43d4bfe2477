"""Fused attention-block tail in one hand-written kernel (``csrc/tail.cu``),
port of ``scream_tpu/ops/ffn_pallas.py``.

:func:`block_tail` (kernel ``tail_kernel``, replaces the TPU's
``_tail_kernel`` through ``_tail_pallas``) computes
``LN2(q + relu(LN1(x @ Wm + q) @ W1) @ W2)`` per row, where the fused
attention block does not apply (the attention block's routing,
``models/attention.py:route_block``). It launches the kernel for CUDA
tensors and runs the plain version, :func:`scream_tpu_torch.ops.ffn.tail_plain`,
only for CPU tensors; a shape the kernel does not take raises.

The kernel takes bf16 at d_model 128, 256, 384 and 512 (every bf16 width at
hidden 4d where the JAX package's tail rule holds) with a hidden width in
128-column chunks (:func:`kernel_takes`). fp32 has no kernel yet (ROADMAP).

The backward recomputes :func:`tail_plain` from the saved inputs and
differentiates it, as the JAX package's ``custom_vjp`` (``tail_bwd``) does;
the JAX package has no backward kernel for the tail.
"""

from __future__ import annotations

import torch

from scream_tpu_torch.ops import _build
from scream_tpu_torch.ops.ffn import tail_plain

KERNEL_WIDTHS = (128, 256, 384, 512)
KERNEL_HID_CHUNK = 128


def kernel_takes(d: int, hid: int, dtype: torch.dtype) -> bool:
    """Whether the CUDA kernel is written for this shape and compute dtype."""
    return (d in KERNEL_WIDTHS and hid % KERNEL_HID_CHUNK == 0
            and dtype == torch.bfloat16)


def _check(t, name, dtype, shape):
    # 32-byte alignment: the WMMA fragment loads need it.
    _build.check_tensor(t, name, dtype, shape, align=32)


def _tail_forward(x, q, Wm, g1, b1, W1, W2, g2, b2, kw):
    """The tail for CPU tensors (plain) or through the kernel (CUDA)."""
    cd, nd, eps = kw["cd"], kw["nd"], kw["eps"]
    if not _build.route(x):
        return tail_plain(x, q, Wm, g1, b1, W1, W2, g2, b2, cd=cd, nd=nd, eps=eps)
    *lead, d = x.shape
    hid = W1.shape[1]
    if not kernel_takes(d, hid, cd):
        raise ValueError(f"block_tail kernel takes bf16, d in {KERNEL_WIDTHS} and a "
                         f"hidden multiple of {KERNEL_HID_CHUNK}; got {cd}, d={d}, "
                         f"hidden {hid}")
    if nd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"block_tail kernel: norm dtype {nd} unsupported")
    bf, f32 = torch.bfloat16, torch.float32
    # Weights cast to bf16 once per call, outside the kernel
    # (ffn_pallas.py:119-121).
    c = lambda t: t.to(bf).contiguous()
    p = lambda t: t.to(f32).contiguous()
    x2, q2 = c(x).reshape(-1, d), c(q).reshape(-1, d)
    Wm, W1, W2 = c(Wm), c(W1), c(W2)
    g1, b1, g2, b2 = p(g1), p(b1), p(g2), p(b2)
    R = x2.shape[0]
    _check(x2, "x", bf, (R, d))
    _check(q2, "q", bf, (R, d))
    _check(Wm, "Wm", bf, (d, d))
    _check(W1, "W1", bf, (d, hid))
    _check(W2, "W2", bf, (hid, d))
    for name, t in (("g1", g1), ("b1", b1), ("g2", g2), ("b2", b2)):
        _check(t, name, f32, (d,))
    out = torch.empty((R, d), device=x.device, dtype=bf)
    if R == 0:
        return out.reshape(*lead, d)
    err = _build.kernels().scream_block_tail(
        x2.data_ptr(), q2.data_ptr(), Wm.data_ptr(), g1.data_ptr(), b1.data_ptr(),
        W1.data_ptr(), W2.data_ptr(), g2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        R, d, hid, float(eps), _build.stream_ptr(x))
    _build.check(err, "block_tail")
    block_tail.launches += 1
    return out.reshape(*lead, d)


class _FusedTail(torch.autograd.Function):
    """Kernel forward; the backward recomputes :func:`tail_plain` from the
    saved inputs and differentiates it (``ffn_pallas.tail_bwd``)."""

    @staticmethod
    def forward(ctx, x, q, Wm, g1, b1, W1, W2, g2, b2, kw):
        ctx.kw = kw
        ctx.save_for_backward(x, q, Wm, g1, b1, W1, W2, g2, b2)
        return _tail_forward(x, q, Wm, g1, b1, W1, W2, g2, b2, kw)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = tail_plain(*inputs, **ctx.kw)
            got = iter(torch.autograd.grad(out, wanted, grad.to(out.dtype)))
        return tuple(next(got) if t.requires_grad else None for t in inputs) + (None,)


def block_tail(x, q, Wm, g1, b1, W1, W2, g2, b2, *, dtype, norm_dtype,
               eps: float = 1e-5):
    """Attention-block tail ``LN2(q + FFN(LN1(x @ Wm + q)))``
    (``ffn_pallas.block_tail``): ``x`` ``(..., d)`` the attention output,
    ``q`` the block input (both residuals add it), weights in flax's
    ``(in, out)`` layout, LayerNorm params fp32. Returns ``(..., d)`` in
    ``dtype``. Counts its kernel's launches in ``block_tail.launches``."""
    kw = dict(cd=dtype, nd=norm_dtype, eps=float(eps))
    return _FusedTail.apply(x, q, Wm, g1, b1, W1, W2, g2, b2, kw)


block_tail.launches = 0
