"""The attention-block tail in plain PyTorch (port of the plain half of
``scream_tpu/ops/ffn_pallas.py``): merge -> +q -> LN -> FFN(relu) -> +q -> LN.

The TPU's fused tail kernel (``ffn_pallas._tail_kernel``) is not ported yet:
on the main path the fused attention kernels subsume it. This module holds
the tail's plain body, which the unfused attention block uses.
"""

from __future__ import annotations

import torch


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
