"""Reference building blocks the live model families do not use (counterpart
of adamvs_tpu/nn/extras.py), NCHW (NCDHW for the 3-D blocks).

The reference ships them beside its two models (SURVEY.md §2.2 rows M3 and
M6-M8); the port has them so the block inventory is complete for model
variants:

- ``ConvLSTMCell``: convolutional LSTM, gates ``i, f, o, g`` from one conv
  of ``[x, h]`` (module.py:109-144);
- ``ConvBnReLU3D`` / ``ConvBn3D``: 3-D conv + BatchNorm (+ ReLU) over cost
  volumes [B,C,D,H,W] (module.py:304-321);
- ``ConvGnReLU`` / ``ConvGn`` / ``ConvTransGnReLU``: conv (stride-2
  transposed conv) + GroupNorm with ``max(1, features // group_channel)``
  groups (+ ReLU) (module.py:324-355);
- ``DeformConvBlock``: modulated deformable conv (DCNv2): a conv predicts
  each tap's offset and a sigmoid mask, each tap samples the input
  bilinearly at its displaced position (zeros outside the image), and a 1x1
  ``proj`` combines the taps; ``DeformConvGnReLU`` adds GroupNorm and ReLU
  (module.py:357-503).

Each block computes what the JAX block computes, not the torch reference's
padding: a conv pads as flax's ``padding="SAME"`` does (``same_pads``: at
stride 2 an even size pads (0, 1) where the reference pads (1, 1)), and the
transposed conv is flax's ``ConvTranspose(strides=2, padding="SAME")``, the
input dilated by 2, padded as ``lax.conv_transpose`` pads it and correlated
with the kernel: exactly 2x at every size. ROADMAP.md lists these as known
differences from the reference. BatchNorm is the port's ``BatchNorm2d``
(flax's running statistics, momentum 0.1 here for flax's 0.9, eps 1e-5);
GroupNorm has eps 1e-5 and float32 statistics. Submodules carry the
reference's names (``conv``, ``bn``, ``gn``) and JAX's where the reference
has none (``offset``, ``mask``, ``proj``), so ``train/jax_import.py::from_jax_extras`` fills a
block from a flax one. Every conv computes in the dtype of its input, as
``nn/blocks.py``'s do.

The deformable taps go through the plain ``ops/warp.py::bilinear_sample``
on every device: the gradient reaches the offsets through the sample
positions, which the K6/K7 sampler's backward does not give.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.warp import bilinear_sample
from .blocks import BN_EPS, GN_EPS, BatchNorm2d, Conv2d, ConvTranspose2d


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of one axis under ``padding="SAME"``: the output
    has ``ceil(size / stride)`` samples and the low side takes the smaller
    half of the padding."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """``x`` zero-padded on its spatial axes (all after the first two) as a
    SAME conv of ``kernel`` and ``stride`` pads them."""
    pads = []
    for size in reversed(x.shape[2:]):
        pads += same_pads(size, kernel, stride)
    return F.pad(x, pads) if any(pads) else x


def _transpose_pads(kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of the dilated input under
    ``lax.conv_transpose(padding="SAME")``."""
    total = kernel + stride - 2
    low = kernel - 1 if stride > kernel - 1 else -(-total // 2)
    return low, total - low


def _num_groups(features: int, group_channel: int) -> int:
    """The reference's GroupNorm group count (module.py:327)."""
    return max(1, features // group_channel)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` in the dtype of its input, as ``blocks.Conv2d``."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class BatchNorm3d(BatchNorm2d):
    """The port's ``BatchNorm2d`` over [B,C,D,H,W]: the depth and row axes
    are one axis of a [B,C,D·H,W] view, which has the same statistics per
    channel."""

    def forward(self, x):
        B, C, D, H, W = x.shape
        return super().forward(x.reshape(B, C, D * H, W)).reshape(x.shape)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` with float32 statistics and affine, returned in the
    input's dtype."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class ConvLSTMCell(nn.Module):
    """Convolutional LSTM (module.py:109-144). ``forward((c, h), x)``
    returns ``((c, h), h)``, all [B,hidden,H,W]."""

    def __init__(self, cin: int, hidden: int, kernel: int = 3):
        super().__init__()
        self.hidden, self.kernel = hidden, kernel
        self.conv = Conv2d(cin + hidden, 4 * hidden, kernel, bias=True)

    def forward(self, carry, x):
        c, h = carry
        gates = self.conv(_pad_same(torch.cat([x, h], dim=1), self.kernel, 1))
        i, f, o, g = torch.split(gates, self.hidden, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h

    def init_carry(self, batch: int, height: int, width: int, dtype=torch.float32, device=None):
        z = torch.zeros((batch, self.hidden, height, width), dtype=dtype, device=device)
        return z, z


class ConvBn3D(nn.Module):
    """3-D conv (no bias) + BatchNorm over [B,C,D,H,W] (module.py:315-321)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.conv = Conv3d(cin, features, kernel, stride, bias=False)
        self.bn = BatchNorm3d(features, eps=BN_EPS)

    def forward(self, x):
        return self.bn(self.conv(_pad_same(x, self.kernel, self.stride)))


class ConvBnReLU3D(ConvBn3D):
    """3-D conv + BatchNorm + ReLU (module.py:304-312)."""

    def forward(self, x):
        return F.relu(super().forward(x))


class ConvGn(nn.Module):
    """Conv (no bias) + GroupNorm (module.py:337-345)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 group_channel: int = 8):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.conv = Conv2d(cin, features, kernel, stride, bias=False)
        self.gn = GroupNorm(_num_groups(features, group_channel), features, eps=GN_EPS)

    def forward(self, x):
        return self.gn(self.conv(_pad_same(x, self.kernel, self.stride)))


class ConvGnReLU(ConvGn):
    """Conv + GroupNorm + ReLU (module.py:324-334)."""

    def forward(self, x):
        return F.relu(super().forward(x))


class ConvTransGnReLU(nn.Module):
    """Stride-2 transposed conv (no bias) + GroupNorm + ReLU
    (module.py:348-355): exactly 2x, as flax's SAME ``ConvTranspose``.
    ``ConvTranspose2d`` pads the dilated input by ``kernel - 1 - padding``
    on both sides; the high side is then cut or extended (``output_padding``)
    to flax's padding. Its weight is the flax kernel spatially flipped
    (``from_jax_extras``)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, group_channel: int = 8):
        super().__init__()
        low, high = _transpose_pads(kernel, 2)
        self.cut = max(low - high, 0)
        self.conv = ConvTranspose2d(cin, features, kernel, stride=2, padding=kernel - 1 - low,
                                    output_padding=max(high - low, 0), bias=False)
        self.gn = GroupNorm(_num_groups(features, group_channel), features, eps=GN_EPS)

    def forward(self, x):
        y = self.conv(x)
        if self.cut:
            y = y[..., : y.shape[-2] - self.cut, : y.shape[-1] - self.cut]
        return F.relu(self.gn(y))


class DeformConvBlock(nn.Module):
    """Modulated deformable conv (DCNv2, module.py:357-503). Tap ``t`` of
    the K x K kernel samples the input at ``(y + t//K - r + dy_t, x + t%K -
    r + dx_t)``, r = (K-1)//2, with (dy_t, dx_t) channels ``2t, 2t+1`` of
    ``offset``; with ``modulated`` it is scaled by ``sigmoid(mask)_t``. The
    taps are stacked tap-major (channel ``t·C + c``) into the 1x1 ``proj``.
    ``offset`` and ``mask`` start at zero, so the block starts as a plain
    K x K conv (with every tap halved when modulated)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, modulated: bool = True):
        super().__init__()
        self.kernel = kernel
        taps = kernel * kernel
        self.offset = Conv2d(cin, 2 * taps, kernel, bias=True)
        self.mask = Conv2d(cin, taps, kernel, bias=True) if modulated else None
        self.proj = Conv2d(taps * cin, features, 1, bias=True)
        with torch.no_grad():
            for head in (self.offset, self.mask):
                if head is not None:
                    head.weight.zero_()
                    head.bias.zero_()

    def forward(self, x):
        B, C, H, W = x.shape
        K = self.kernel
        taps = K * K
        xp = _pad_same(x, K, 1)
        off = self.offset(xp).reshape(B, taps, 2, H, W)
        r = (K - 1) // 2
        t = torch.arange(taps, device=x.device)
        ki = (t // K - r).to(x.dtype)[None, :, None, None]
        kj = (t % K - r).to(x.dtype)[None, :, None, None]
        yy = torch.arange(H, dtype=x.dtype, device=x.device)[None, None, :, None]
        xx = torch.arange(W, dtype=x.dtype, device=x.device)[None, None, None, :]
        v = yy + ki + off[:, :, 0]  # [B,taps,H,W]
        u = xx + kj + off[:, :, 1]
        s = bilinear_sample(x.permute(0, 2, 3, 1), u, v)  # [B,taps,H,W,C], zeros outside
        if self.mask is not None:
            s = s * torch.sigmoid(self.mask(xp))[..., None]
        g = s.permute(0, 1, 4, 2, 3).reshape(B, taps * C, H, W)
        return self.proj(g)


class DeformConvGnReLU(nn.Module):
    """Deformable conv + GroupNorm + ReLU (module.py:497-503)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, group_channel: int = 8):
        super().__init__()
        self.conv = DeformConvBlock(cin, features, kernel)
        self.gn = GroupNorm(_num_groups(features, group_channel), features, eps=GN_EPS)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))
