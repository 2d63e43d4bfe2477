"""The attention-block tail in plain PyTorch (port of the plain half of
``scream_tpu/ops/ffn_pallas.py``): merge -> +q -> LN -> FFN(relu) -> +q -> LN.

:func:`tail_plain` is the plain version of the fused tail kernel
(``ops/tail_cuda.py:block_tail``, replacing ``ffn_pallas._tail_kernel``): the
CPU tests run it, the kernel's backward differentiates it, and the unfused
attention block runs it on CPU tensors and where the caller asks for the
plain tail (``ModelConfig(fused_block_tail=False)``). :func:`jax_fusable_tail`
is the JAX package's rule for where the TPU runs the tail kernel; the
attention block's routing (``models/attention.py:route_block``) reads it.
"""

from __future__ import annotations

import torch

# VMEM budget and row tile of the JAX package's rules (ffn_pallas.fusable,
# attn_pallas.fusable_block).
_VMEM_BUDGET = 10 * 1024 * 1024
_TILE_R = 256


def jax_fusable_tail(d: int, hid: int, dtype: torch.dtype) -> bool:
    """The JAX package's rule for its fused tail kernel
    (``ffn_pallas.fusable``): aligned dims and the weight + hidden tiles
    inside its VMEM budget. Where it holds, the TPU runs ``_tail_kernel``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    vmem = (d * d + 2 * d * hid) * itemsize + _TILE_R * hid * 4 \
        + 6 * _TILE_R * d * itemsize
    return d % 128 == 0 and hid % 128 == 0 and vmem < _VMEM_BUDGET


def _ln(t, g, b, eps: float, norm_dtype):
    """``flax.linen.LayerNorm`` math, op for op: fp32 statistics,
    ``var = max(0, E[x^2] - E[x]^2)``, the scale folded into the rsqrt
    multiplier, output cast to ``norm_dtype``."""
    xf = t.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mu * mu, 0.0)
    mul = torch.rsqrt(var + eps) * g.float()
    y = (xf - mu) * mul + b.float()
    return y.to(norm_dtype)


def tail_plain(x, q, Wm, g1, b1, W1, W2, g2, b2, *, cd, nd, eps):
    """The unfused tail: ``LN2(q + relu(LN1(x @ Wm + q) @ W1) @ W2)``,
    rounding to the compute dtype ``cd`` where the flax modules do."""
    m = x.to(cd) @ Wm.to(cd)
    t = m + q.to(cd)
    y = _ln(t, g1, b1, eps, nd).to(cd)
    h = torch.relu(y @ W1.to(cd))
    f = h @ W2.to(cd)
    u = q.to(cd) + f
    return _ln(u, g2, b2, eps, nd).to(cd)
