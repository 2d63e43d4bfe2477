"""Linear attention blocks and the continuous sinusoidal position embedding
(port of ``scream_tpu/models/attention.py``).

* :func:`linear_attention`: the O(N) elu+1 attention (reference
  ``models/transformer.py:11-44``), with the KV contraction and the
  normalizer accumulated in fp32 under bf16 compute.
* :class:`AttentionBlock`: projections -> linear attention -> merge -> FFN,
  with the reference's double q-residual (``models/transformer.py:74-90``).
  :func:`route_block` picks its route by the JAX package's rules, a CUDA
  tensor standing for the TPU: the two fused kernels where the fused-block
  rule holds, else the plain attention and the tail kernel where the tail
  rule holds, else the plain body; it raises ``NotImplementedError`` where
  the port has no kernel for a shape the TPU runs one for. CPU tensors run
  the plain body, as the JAX package does off the TPU.
* :func:`sinusoidal_pe`: the continuous n-dim coordinate embedding
  (``models/transformer.py:135-179``).

Everything is batched ``(B, N, D)`` with boolean validity masks. Weights
keep flax's ``(in, out)`` layout, so ``y = x @ W``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from scream_tpu_torch.ops import attn_cuda, tail_cuda
from scream_tpu_torch.ops.ffn import jax_fusable_tail, tail_plain
from scream_tpu_torch.utils import device as device_util


def sinusoidal_pe(
    xyz: torch.Tensor,
    d_model: int,
    n_dim: int = 3,
    temperature: float = 10000.0,
    scale: float = 2.0 * math.pi,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Continuous sinusoidal PE ``(..., n_dim)`` -> ``(..., d_model)``:
    ``num_pos_feats = d_model // n_dim // 2 * 2`` channels per input dim with
    frequencies ``temperature**(2*(i//2)/num_pos_feats)``, even channels
    sin, odd channels cos, remainder zero-padded."""
    num_pos_feats = d_model // n_dim // 2 * 2
    padding = d_model - num_pos_feats * n_dim

    i = torch.arange(num_pos_feats, dtype=torch.float32, device=xyz.device)
    # torch.full, not torch.tensor: a scalar copied from the host would make
    # the host wait for the device.
    dim_t = torch.pow(torch.full((), temperature, dtype=torch.float32, device=xyz.device),
                      2.0 * torch.floor(i / 2.0) / num_pos_feats)

    pos = xyz.float() * scale
    pos_divided = pos[..., None] / dim_t  # (..., n_dim, num_pos_feats)
    pos_sin = torch.sin(pos_divided[..., 0::2])
    pos_cos = torch.cos(pos_divided[..., 1::2])
    pe = torch.stack([pos_sin, pos_cos], dim=-1).reshape(*xyz.shape[:-1], -1)
    if padding:
        pe = F.pad(pe, (0, padding))
    return pe.to(dtype)


def linear_attention(q, k, v, q_mask=None, kv_mask=None, eps: float = 1e-6):
    """O(N) linear attention with the elu+1 feature map.

    ``q`` ``(B, L, H, D)``, ``k``/``v`` ``(B, S, H, D)``, masks ``(B, L)`` /
    ``(B, S)``. ``KV = K^T V`` then ``out = Q KV / (Q . sum(K))``, both
    contractions accumulated in fp32.
    """
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None].to(Q.dtype)
    if kv_mask is not None:
        K = K * kv_mask[:, :, None, None].to(K.dtype)
        v = v * kv_mask[:, :, None, None].to(v.dtype)

    Kf = K.float()
    KV = torch.einsum("bshd,bshv->bhdv", Kf, v.float())
    K_sum = Kf.sum(1)  # (B, H, D)
    Qf = Q.float()
    Z = 1.0 / (torch.einsum("blhd,bhd->blh", Qf, K_sum) + eps)
    out = torch.einsum("blhd,bhdv->blhv", Qf, KV) * Z[..., None]
    return out.to(q.dtype)


def route_block(d: int, hid: int, num_heads: int, dtype: torch.dtype,
                fused_attn: Optional[bool], fused_tail: Optional[bool],
                on_cuda: bool, shared_kv: bool) -> str:
    """An attention block's route: ``"fused"`` (the two fused-block kernels),
    ``"tail"`` (plain attention, then the tail kernel) or ``"plain"``.

    The JAX package's rules (``models/attention.py:199-243`` with
    ``ffn_pallas.block_tail``'s auto rule), a CUDA tensor standing for the
    TPU backend: the fused block runs when ``fused_attn`` is True, or None
    on CUDA with ``jax_fusable_block``, and k and v are one source
    (``shared_kv``); otherwise the attention is plain and the tail runs its
    kernel when ``fused_tail`` is True, or None on CUDA with
    ``jax_fusable_tail``. So ``fused_attn=False`` leaves the tail on auto;
    only ``fused_tail=False`` asks for the plain tail. On CUDA a route whose
    kernel is not written for the shape raises ``NotImplementedError``
    (no plain body in a kernel's place); on the CPU the kernels' plain
    versions run.
    """
    if shared_kv and (fused_attn or (fused_attn is None and on_cuda and
                                     attn_cuda.jax_fusable_block(d, hid, num_heads,
                                                                 dtype))):
        if on_cuda and not attn_cuda.kernels_take(d, hid, num_heads, dtype):
            raise NotImplementedError(
                f"fused attention block at d_model {d}, {num_heads} heads, "
                f"{dtype}: the CUDA kernels take bf16, d_model in "
                f"{attn_cuda.KERNEL_WIDTHS} and {attn_cuda.KERNEL_HEADS} heads; "
                "other shapes and fp32 are queued in ROADMAP.md (TPU kernels "
                "still to port); pass fused_attention=False for the plain "
                "attention")
        return "fused"
    tail = fused_tail if fused_tail is not None else (
        on_cuda and jax_fusable_tail(d, hid, dtype))
    if tail:
        if on_cuda and not tail_cuda.kernel_takes(d, hid, dtype):
            raise NotImplementedError(
                f"block tail at d_model {d}, hidden {hid}, {dtype}: the CUDA "
                f"kernel takes bf16 at d_model in {tail_cuda.KERNEL_WIDTHS}; "
                "fp32 is queued in ROADMAP.md (TPU kernels still to port); "
                "pass fused_block_tail=False for the plain tail")
        return "tail"
    return "plain"


class _Proj(nn.Module):
    """Bias-free ``(in, out)`` projection weight, xavier-uniform init (the
    layout of flax's ``{name: {"kernel": W}}``)."""

    def __init__(self, d_in: int, d_out: int, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        nn.init.xavier_uniform_(self.kernel, generator=generator)


class _Norm(nn.Module):
    """LayerNorm scale/bias (fp32, ones/zeros)."""

    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))


class AttentionBlock(nn.Module):
    """MHA block: q/k/v projections -> linear attention -> merge -> FFN.

    Both LayerNorms add the block *input* q (the reference's wiring,
    ``models/transformer.py:74-90``); LayerNorm epsilon 1e-5. Parameters:
    ``q_proj, k_proj, v_proj, merge, ffn_in, ffn_out`` (``.kernel``,
    ``(in, out)``) and ``norm1, norm2`` (``.scale, .bias``).

    ``fused_attn`` and ``fused_tail``: None = auto, True = the kernel (its
    plain version on CPU tensors), False = plain code; :func:`route_block`
    picks each call's route.
    """

    def __init__(self, d_model: int, num_heads: int = 8, ffn_mult: int = 4,
                 dtype: torch.dtype = torch.float32,
                 norm_dtype: torch.dtype = torch.float32,
                 fused_attn: Optional[bool] = None,
                 fused_tail: Optional[bool] = None, generator=None):
        super().__init__()
        self.d_model, self.num_heads, self.ffn_mult = d_model, num_heads, ffn_mult
        self.dtype, self.norm_dtype = dtype, norm_dtype
        self.fused_attn, self.fused_tail = fused_attn, fused_tail
        hid = d_model * ffn_mult
        self.q_proj = _Proj(d_model, d_model, generator)
        self.k_proj = _Proj(d_model, d_model, generator)
        self.v_proj = _Proj(d_model, d_model, generator)
        self.merge = _Proj(d_model, d_model, generator)
        self.norm1 = _Norm(d_model)
        self.ffn_in = _Proj(d_model, hid, generator)
        self.ffn_out = _Proj(hid, d_model, generator)
        self.norm2 = _Norm(d_model)

    def message(self, q, k, v, q_mask=None, kv_mask=None):
        """The unfused attention half: projections and linear attention,
        ``(B, L, d)`` in the compute dtype (the tail's input ``x``)."""
        B, L, S = q.shape[0], q.shape[1], k.shape[1]
        hd = self.d_model // self.num_heads
        Wq, Wk, Wv = self.q_proj.kernel, self.k_proj.kernel, self.v_proj.kernel
        cd = self.dtype
        mm = lambda x, W: x.to(cd) @ W.to(cd)
        if k is q and v is q:
            query, key, value = mm(q, torch.cat([Wq, Wk, Wv], 1)).chunk(3, -1)
        elif v is k:
            query = mm(q, Wq)
            key, value = mm(k, torch.cat([Wk, Wv], 1)).chunk(2, -1)
        else:
            query, key, value = mm(q, Wq), mm(k, Wk), mm(v, Wv)
        message = linear_attention(
            query.reshape(B, L, self.num_heads, hd),
            key.reshape(B, S, self.num_heads, hd),
            value.reshape(B, S, self.num_heads, hd), q_mask, kv_mask)
        return message.reshape(B, L, self.d_model)

    def forward(self, q, k, v, q_mask=None, kv_mask=None):
        tail = (self.merge.kernel, self.norm1.scale, self.norm1.bias,
                self.ffn_in.kernel, self.ffn_out.kernel, self.norm2.scale,
                self.norm2.bias)
        shared_kv = (v is k and q.shape[-1] == self.d_model
                     and k.shape[-1] == self.d_model)
        route = route_block(self.d_model, self.d_model * self.ffn_mult,
                            self.num_heads, self.dtype, self.fused_attn,
                            self.fused_tail, device_util.on_cuda(q), shared_kv)
        if route == "fused":
            return attn_cuda.attention_block_fused(
                q, k, q_mask, kv_mask, self.q_proj.kernel, self.k_proj.kernel,
                self.v_proj.kernel, *tail, num_heads=self.num_heads,
                dtype=self.dtype, norm_dtype=self.norm_dtype)
        message = self.message(q, k, v, q_mask, kv_mask)
        if route == "tail":
            return tail_cuda.block_tail(message, q, *tail, dtype=self.dtype,
                                        norm_dtype=self.norm_dtype, eps=1e-5)
        return tail_plain(message, q, *tail, cd=self.dtype, nd=self.norm_dtype,
                          eps=1e-5)
