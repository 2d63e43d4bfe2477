"""Pix2Pix-style PatchGAN discriminator (port of ``scream_tpu/models/gan.py``;
reference ``models/gan.py:15-65``, ``NLayerDiscriminator``).

A stack of 4x4 convolutions: stride 2 doubling the filters up to 8x, one
stride-1 BatchNorm block and a 1-channel logit head, with the reference's
normal(0, 0.02) conv init and normal(1, 0.02) BatchNorm-scale init. The
public input and output keep the JAX package's NHWC layout
(``(B, H, W, C)`` -> ``(B, h, w, 1)``); the module permutes to NCHW inside.
Views fold into the batch, so one pass scores all ``B x V`` images
(:func:`images_to_nhwc`).

BatchNorm follows flax's ``nn.BatchNorm`` exactly, not torch's
``BatchNorm2d``: epsilon 1e-5, running averages updated as
``0.9 * running + 0.1 * batch`` (flax's momentum 0.9, torch's 0.1), and the
running variance takes the *biased* batch variance (``BatchNorm2d`` would
store the unbiased one). Under a data mesh the batch statistics are the
global batch's (:meth:`PatchDiscriminator.sync_batch_stats`): the JAX
package's SPMD step computes them over the whole sharded batch, so the port
sums them over the data ranks inside autograd, and every rank folds the
same global statistics into identical running averages. Parameters use torch's names and layout
(``conv_k.weight`` ``(out, in, 4, 4)``, ``bn_k.weight/bias/running_mean/
running_var``); ``utils.convert.discriminator_from_jax`` maps a flax tree.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from scream_tpu_torch.utils.device import resolve_device

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's convention: running = 0.9 * running + 0.1 * batch


class _BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of an NCHW tensor."""

    def __init__(self, c: int, generator=None):
        super().__init__()
        self.weight = nn.Parameter(1.0 + 0.02 * torch.randn(c, generator=generator))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.sync = None  # (group, n): batch statistics summed over n equal shards

    def forward(self, x, train: bool, update_stats: bool):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=BN_EPS)
        if self.sync is not None:
            return self._synced(x, update_stats)
        if update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
                self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        # Batch statistics, nothing stored: running_mean/var None.
        return F.batch_norm(x, None, None, self.weight, self.bias, training=True,
                            eps=BN_EPS)

    def _synced(self, x, update_stats: bool):
        """Train mode over the global batch of ``n`` equal shards: the mean,
        then the biased variance about it, each a sum over the group inside
        autograd (the backward sums the gradients over it, as a
        synchronized BatchNorm does)."""
        from scream_tpu_torch.parallel.mesh import all_reduce_sum

        group, n = self.sync
        xf = x.float()
        count = n * xf.numel() // xf.shape[1]
        mean = all_reduce_sum(xf.sum((0, 2, 3)), group) / count
        d = xf - mean[None, :, None, None]
        var = all_reduce_sum((d * d).sum((0, 2, 3)), group) / count
        if update_stats:
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        scale = torch.rsqrt(var + BN_EPS) * self.weight
        return (d * scale[None, :, None, None] + self.bias[None, :, None, None]).to(x.dtype)


class PatchDiscriminator(nn.Module):
    """PatchGAN: maps ``(B, H, W, C)`` images to a logit map ``(B, h, w, 1)``.

    ``forward(x, train=True, update_stats=True)``: ``train`` normalizes with
    the batch statistics (flax ``train=True``) and ``update_stats`` then
    also folds them into the running averages (flax's mutable
    ``batch_stats``); ``train=False`` uses the running averages. Parameters
    are drawn from ``generator`` (seed 0 if None) on the CPU, then moved to
    ``device``.
    """

    def __init__(self, input_nc: int = 2, ndf: int = 64, n_layers: int = 3, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.n_layers = n_layers

        def conv(c_in, c_out, stride, bias):
            layer = nn.Conv2d(c_in, c_out, 4, stride=stride, padding=1, bias=bias)
            with torch.no_grad():
                layer.weight.copy_(0.02 * torch.randn(layer.weight.shape,
                                                      generator=generator))
                if bias:
                    layer.bias.zero_()
            return layer

        self.conv_0 = conv(input_nc, ndf, 2, True)
        nf = ndf
        for k in range(1, n_layers + 1):
            nf_next = ndf * min(2 ** k, 8)
            self.add_module(f"conv_{k}", conv(nf, nf_next, 2 if k < n_layers else 1, False))
            self.add_module(f"bn_{k}", _BatchNorm(nf_next, generator))
            nf = nf_next
        self.conv_out = conv(nf, 1, 1, True)
        self.to(dev)

    def sync_batch_stats(self, group=None, n: int = 1) -> None:
        """Take train-mode batch statistics over ``n`` equal shards of the
        batch, one a rank of ``group`` (None: this rank's batch alone)."""
        for m in self.modules():
            if isinstance(m, _BatchNorm):
                m.sync = None if group is None else (group, n)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        # Spatial floor: n_layers stride-2 convs + two k4/s1/p1 convs each
        # shaving a pixel; below it the logit map is empty.
        min_hw = 2 ** self.n_layers * 3
        if x.shape[1] < min_hw or x.shape[2] < min_hw:
            raise ValueError(f"PatchDiscriminator needs inputs >= {min_hw}x{min_hw}; "
                             f"got {x.shape[1]}x{x.shape[2]} (empty logit map)")
        h = F.leaky_relu(self.conv_0(x.float().permute(0, 3, 1, 2)), 0.2)
        for k in range(1, self.n_layers + 1):
            h = getattr(self, f"conv_{k}")(h)
            h = F.leaky_relu(getattr(self, f"bn_{k}")(h, train, update_stats), 0.2)
        return self.conv_out(h).permute(0, 2, 3, 1)


def images_to_nhwc(imgs: torch.Tensor) -> torch.Tensor:
    """Renderer output ``(B, V, 2, w, w)`` -> discriminator input ``(B*V, w, w, 2)``."""
    b, v, c, h, w = imgs.shape
    return imgs.reshape(b * v, c, h, w).permute(0, 2, 3, 1)
