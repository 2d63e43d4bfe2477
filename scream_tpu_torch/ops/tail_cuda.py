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
128-column chunks (:func:`kernel_takes`). The fp32 configuration has its own
kernel, ``tail_f32_kernel`` (``csrc/tail_f32.cu``), at d_model 128, 256 and
384 (every fp32 width where the rule holds): the fp32 apply kernel's tail
body (``csrc/tf32_tail.cuh``), every product split-TF32 ("3xTF32") wgmma,
its weights split and packed by ``pack_block_f32_kernel`` in the same C
call (``ops/attn_cuda.py:pack_block_weights_f32`` is that pack alone, and
its plain version).

The kernel streams its weights through a ring of shared-memory stages
(``csrc/tail_tile.cuh``), one bulk copy a stage; :func:`pack_weights` lays
the weights out once per call in the order and byte layout the stages are
consumed in (the apply kernel of ``ops/attn_cuda.py`` uses it too, with
``Wq`` in front): on the card in one launch of ``pack_kernel``
(``csrc/tail.cu``), part of each wrapper's work, and for CPU tensors by
permuted copies, its plain version.

The backward recomputes :func:`tail_plain` from the saved inputs and
differentiates it, as the JAX package's ``custom_vjp`` (``tail_bwd``) does;
the JAX package has no backward kernel for the tail.
"""

from __future__ import annotations

import torch

from scream_tpu_torch.ops import _build
from scream_tpu_torch.ops.ffn import tail_plain

KERNEL_WIDTHS = (128, 256, 384, 512)
KERNEL_WIDTHS_F32 = (128, 256, 384)
KERNEL_HID_CHUNK = 128
APPLY_MAX_WIDTH = 384  # the widest d of the apply kernel, which packs Wq in front


def kernel_takes(d: int, hid: int, dtype: torch.dtype) -> bool:
    """Whether a CUDA kernel is written for this shape and compute dtype."""
    widths = {torch.bfloat16: KERNEL_WIDTHS, torch.float32: KERNEL_WIDTHS_F32}.get(dtype, ())
    return d in widths and hid % KERNEL_HID_CHUNK == 0


def _kmajor(W, ks):
    """View of ``W`` ``(K, N)`` as stages of ``ks`` k-rows in the wgmma
    operand layout: dims (stage, k16 step, column group of 8, k half, column
    in group, k in half), each innermost 8 k values one 16-byte core-matrix
    row (``csrc/hopper_tile.cuh``)."""
    K, N = W.shape
    return W.reshape(K // ks, ks // 16, 2, 8, N // 8, 8).permute(0, 1, 4, 2, 5, 3)


def pack_weights(Wm, W1, W2, Wq=None) -> torch.Tensor:
    """The tail's weights (and the apply kernel's ``Wq``, first) as one flat
    bf16 blob of ring stages in the order the kernels consume them:
    ``[Wq], Wm``, then per hidden chunk of ``hc`` columns its W1 columns and
    its W2 rows. Weights are ``(in, out)``, any float dtype (cast to bf16
    here); raises on a shape the kernels do not take. CUDA weights go
    through ``pack_kernel``, CPU weights through the permuted copies below,
    which define the layout."""
    if Wm.dim() != 2 or W1.dim() != 2 or W2.dim() != 2:
        raise ValueError("pack_weights: Wm, W1 and W2 must be matrices")
    d, hid = W1.shape
    if d not in KERNEL_WIDTHS or hid <= 0 or hid % KERNEL_HID_CHUNK:
        raise ValueError(f"pack_weights: d in {KERNEL_WIDTHS} and a hidden multiple "
                         f"of {KERNEL_HID_CHUNK}; got W1 {tuple(W1.shape)}")
    if tuple(Wm.shape) != (d, d) or tuple(W2.shape) != (hid, d):
        raise ValueError(f"pack_weights: Wm {tuple(Wm.shape)} and W2 {tuple(W2.shape)} "
                         f"do not match W1 {tuple(W1.shape)}")
    # The ring's geometry (csrc/tail_tile.cuh:Cfg): at d > 256 two
    # warpgroups split each row's columns and a hidden chunk is 128
    # columns, else 64; a W1 stage holds ks_h k-rows of a chunk, any other
    # stage 32 k-rows of a (., d) weight.
    cols = 2 if d > 256 else 1
    hc, ks_h, nch = 64 * cols, d // (2 * cols), hid // (64 * cols)
    if Wq is not None and (tuple(Wq.shape) != (d, d) or d > APPLY_MAX_WIDTH):
        raise ValueError(f"pack_weights: Wq must be ({d}, {d}) at d <= {APPLY_MAX_WIDTH} "
                         f"(the apply kernel's widths), got {tuple(Wq.shape)}")
    ws = ([Wq] if Wq is not None else []) + [Wm, W1, W2]
    if any(not w.is_floating_point() or w.device != W1.device for w in ws):
        raise ValueError("pack_weights: float weights on one device")
    square = ws[:-2]
    blob = torch.empty(len(square) * d * d + 2 * d * hid, dtype=torch.bfloat16,
                       device=W1.device)
    if _build.route(W1):
        dt = W1.dtype if W1.dtype in (torch.float32, torch.bfloat16) else torch.bfloat16
        src = [w.to(dt).contiguous() for w in ws]
        ptr = [w.data_ptr() for w in src]
        err = _build.kernels().scream_pack_weights(
            ptr[0] if Wq is not None else None, *ptr[-3:], int(dt == torch.float32),
            blob.data_ptr(), d, hid, _build.stream_ptr(W1))
        _build.check(err, "pack_weights")
        return blob
    with torch.no_grad():
        for i, W in enumerate(square):
            blob[i * d * d:(i + 1) * d * d].view(d // 32, 2, d // 8, 2, 8, 8).copy_(
                _kmajor(W, 32))
        chunks = blob[len(square) * d * d:].view(nch, 2 * d * hc)
        # W1 (d, hid): chunk n's columns, stages of ks_h k-rows.
        chunks[:, :d * hc].view(nch, d // ks_h, ks_h // 16, hc // 8, 2, 8, 8).copy_(
            W1.reshape(d // ks_h, ks_h // 16, 2, 8, nch, hc // 8, 8)
            .permute(4, 0, 1, 5, 2, 6, 3))
        # W2 (hid, d): chunk n's rows, stages of 32 k-rows.
        chunks[:, d * hc:].view(nch, hc // 32, 2, d // 8, 2, 8, 8).copy_(
            W2.reshape(nch, hc // 32, 2, 2, 8, d // 8, 8).permute(0, 1, 2, 5, 3, 6, 4))
    return blob


def _check(t, name, dtype, shape):
    # 16-byte alignment: the kernel loads rows in 16-byte vectors.
    _build.check_tensor(t, name, dtype, shape, align=16)


def _tail_forward(x, q, Wm, g1, b1, W1, W2, g2, b2, kw):
    """The tail for CPU tensors (plain) or through the kernel (CUDA)."""
    cd, nd, eps = kw["cd"], kw["nd"], kw["eps"]
    if not _build.route(x):
        return tail_plain(x, q, Wm, g1, b1, W1, W2, g2, b2, cd=cd, nd=nd, eps=eps)
    *lead, d = x.shape
    hid = W1.shape[1]
    if not kernel_takes(d, hid, cd):
        raise ValueError(f"block_tail kernels take bf16 at d in {KERNEL_WIDTHS} or fp32 "
                         f"at d in {KERNEL_WIDTHS_F32}, and a hidden multiple of "
                         f"{KERNEL_HID_CHUNK}; got {cd}, d={d}, hidden {hid}")
    if nd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"block_tail kernel: norm dtype {nd} unsupported")
    if cd == torch.float32:
        return _tail_forward_f32(x, q, Wm, g1, b1, W1, W2, g2, b2, nd, eps)
    bf, f32 = torch.bfloat16, torch.float32
    c = lambda t: t.to(bf).contiguous()
    p = lambda t: t.to(f32).contiguous()
    x2, q2 = c(x).reshape(-1, d), c(q).reshape(-1, d)
    g1, b1, g2, b2 = p(g1), p(b1), p(g2), p(b2)
    R = x2.shape[0]
    _check(x2, "x", bf, (R, d))
    _check(q2, "q", bf, (R, d))
    for name, t in (("g1", g1), ("b1", b1), ("g2", g2), ("b2", b2)):
        _check(t, name, f32, (d,))
    out = torch.empty((R, d), device=x.device, dtype=bf)
    if R == 0:
        return out.reshape(*lead, d)
    # The weights cast to bf16 and packed for the ring once per call
    # (ffn_pallas.py:119-121 casts once per call too).
    wpack = pack_weights(Wm, W1, W2)
    _check(wpack, "packed weights", bf, (d * d + 2 * d * hid,))
    err = _build.kernels().scream_block_tail(
        x2.data_ptr(), q2.data_ptr(), wpack.data_ptr(), g1.data_ptr(), b1.data_ptr(),
        g2.data_ptr(), b2.data_ptr(), out.data_ptr(), R, d, hid, float(eps),
        _build.stream_ptr(x))
    _build.check(err, "block_tail")
    block_tail.launches += 1
    return out.reshape(*lead, d)


def _tail_forward_f32(x, q, Wm, g1, b1, W1, W2, g2, b2, nd, eps):
    """The fp32 tail kernel (``csrc/tail_f32.cu``) on CUDA tensors, one C
    call: every tensor fp32, the weights split and packed into a scratch
    blob (``pack_block_f32_kernel`` without ``Wq``), then the tail."""
    *lead, d = x.shape
    hid = W1.shape[1]
    f32 = torch.float32
    c = lambda t: t.to(f32).contiguous()
    x2, q2 = c(x).reshape(-1, d), c(q).reshape(-1, d)
    R = x2.shape[0]
    ws = [c(t) for t in (Wm, g1, b1, W1, W2, g2, b2)]
    for name, t, shape in zip(("x", "q", "Wm", "g1", "b1", "W1", "W2", "g2", "b2"),
                              [x2, q2] + ws,
                              ((R, d), (R, d), (d, d), (d,), (d,), (d, hid), (hid, d),
                               (d,), (d,))):
        _check(t, name, f32, shape)
    out = torch.empty((R, d), device=x.device, dtype=f32)
    if R == 0:
        return out.reshape(*lead, d)
    wpack = x2.new_empty(2 * (d * d + 2 * d * hid))
    err = _build.kernels().scream_block_tail_f32(
        x2.data_ptr(), q2.data_ptr(), *(t.data_ptr() for t in ws), wpack.data_ptr(),
        out.data_ptr(), R, d, hid, float(eps), int(nd == torch.bfloat16),
        _build.stream_ptr(x))
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
