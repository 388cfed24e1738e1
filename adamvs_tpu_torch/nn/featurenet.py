"""Feature U-Nets (counterpart of adamvs_tpu/nn/featurenet.py).

Both output {"stage1": 4b @ H/4, "stage2": 2b @ H/2, "stage3": b @ H}, NCHW,
from one trunk (``conv0``..``conv2``) and two ``DeConvFuse`` up steps:

- ``AdaFeatureNet``: each output level concatenates two SPP branches (k×k
  average pool with stride k, 1x1 ConvBlock, bilinear upsampling back) with
  the level's features, then a 1x1 conv without bias;
- ``RedFeatureNet`` (MS-REDNet): ``arch_mode="unet"``, a 1x1 conv without
  bias on each level's features; ``arch_mode="fpn"``, no up steps: the
  coarsest trunk level (4b channels) is upsampled 2x by nearest neighbour and
  added to a 1x1 lateral conv with bias of the next trunk level, twice, and a
  3x3 conv without bias gives each finer output.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.regression import resize_bilinear
from .blocks import Conv2d, ConvBlock, DeConvFuse


class _SPPBranch(nn.Sequential):
    """AvgPool k×k -> 1x1 ConvBlock -> bilinear upsample back to the input
    size. Index 0 is the pool, so the conv block's names are ``1.conv`` /
    ``1.bn`` as in the reference."""

    def __init__(self, cin: int, cout: int, pool: int):
        super().__init__(nn.AvgPool2d(pool, pool), ConvBlock(cin, cout, kernel=1))

    def forward(self, x):
        return resize_bilinear(super().forward(x), x.shape[2], x.shape[3])


def _trunk(module: nn.Module, b: int) -> None:
    """``conv0`` (b @ H), ``conv1`` (2b @ H/2), ``conv2`` (4b @ H/4)."""
    module.conv0 = nn.Sequential(ConvBlock(3, b), ConvBlock(b, b))
    module.conv1 = nn.Sequential(ConvBlock(b, 2 * b, 5, 2), ConvBlock(2 * b, 2 * b),
                                 ConvBlock(2 * b, 2 * b))
    module.conv2 = nn.Sequential(ConvBlock(2 * b, 4 * b, 5, 2), ConvBlock(4 * b, 4 * b),
                                 ConvBlock(4 * b, 4 * b))


class AdaFeatureNet(nn.Module):
    def __init__(self, base: int = 8, num_stages: int = 3):
        super().__init__()
        b = base
        self.num_stages = num_stages
        _trunk(self, b)
        self.branch1_1 = _SPPBranch(4 * b, 2 * b, 4)
        self.branch1_2 = _SPPBranch(4 * b, 2 * b, 8)
        self.out1 = Conv2d(8 * b, 4 * b, 1, bias=False)
        if num_stages >= 2:
            self.deconv1 = DeConvFuse(4 * b, 2 * b)
            self.branch2_1 = _SPPBranch(2 * b, b, 4)
            self.branch2_2 = _SPPBranch(2 * b, b, 8)
            self.out2 = Conv2d(4 * b, 2 * b, 1, bias=False)
        if num_stages >= 3:
            self.deconv2 = DeConvFuse(2 * b, b)
            self.branch3_1 = _SPPBranch(b, b // 2, 4)
            self.branch3_2 = _SPPBranch(b, b // 2, 8)
            self.out3 = Conv2d(2 * b, b, 1, bias=False)

    def forward(self, x) -> dict[str, torch.Tensor]:
        c0 = self.conv0(x)
        c1 = self.conv1(c0)
        intra = self.conv2(c1)
        out = {"stage1": self.out1(torch.cat([self.branch1_1(intra), self.branch1_2(intra), intra], 1))}
        if self.num_stages >= 2:
            intra = self.deconv1(c1, intra)
            out["stage2"] = self.out2(
                torch.cat([self.branch2_1(intra), self.branch2_2(intra), intra], 1))
        if self.num_stages >= 3:
            intra = self.deconv2(c0, intra)
            out["stage3"] = self.out3(
                torch.cat([self.branch3_1(intra), self.branch3_2(intra), intra], 1))
        return out


class RedFeatureNet(nn.Module):
    """MS-REDNet feature net in its ``unet`` or ``fpn`` form
    (adamvs_tpu/nn/featurenet.py:107-163). The ``fpn`` submodules carry the
    reference FeatureNet's FPN names (``inner1``, ``inner2`` lateral convs,
    ``out2``, ``out3``); with two stages ``out2`` gives b channels, as
    there."""

    ARCH_MODES = ("unet", "fpn")

    def __init__(self, base: int = 8, num_stages: int = 3, arch_mode: str = "unet"):
        super().__init__()
        if arch_mode not in self.ARCH_MODES:
            raise ValueError(f"arch_mode must be one of {self.ARCH_MODES}, got {arch_mode!r}")
        b = base
        self.num_stages = num_stages
        self.arch_mode = arch_mode
        _trunk(self, b)
        self.out1 = Conv2d(4 * b, 4 * b, 1, bias=False)
        if arch_mode == "fpn":
            if num_stages >= 2:
                self.inner1 = Conv2d(2 * b, 4 * b, 1)
                self.out2 = Conv2d(4 * b, 2 * b if num_stages == 3 else b, 3, padding=1,
                                   bias=False)
            if num_stages >= 3:
                self.inner2 = Conv2d(b, 4 * b, 1)
                self.out3 = Conv2d(4 * b, b, 3, padding=1, bias=False)
            return
        if num_stages >= 2:
            self.deconv1 = DeConvFuse(4 * b, 2 * b)
            self.out2 = Conv2d(2 * b, 2 * b, 1, bias=False)
        if num_stages >= 3:
            self.deconv2 = DeConvFuse(2 * b, b)
            self.out3 = Conv2d(b, b, 1, bias=False)

    def out_channels(self) -> tuple[int, ...]:
        """The channels of stage 1, 2, ... (``out1``, ``out2``, ...)."""
        return tuple(getattr(self, f"out{i + 1}").out_channels for i in range(self.num_stages))

    def forward(self, x) -> dict[str, torch.Tensor]:
        c0 = self.conv0(x)
        c1 = self.conv1(c0)
        intra = self.conv2(c1)
        out = {"stage1": self.out1(intra)}
        if self.arch_mode == "fpn":
            for i, lateral in enumerate((c1, c0)[:self.num_stages - 1]):
                up = F.interpolate(intra, scale_factor=2, mode="nearest")
                intra = up + getattr(self, f"inner{i + 1}")(lateral)
                out[f"stage{i + 2}"] = getattr(self, f"out{i + 2}")(intra)
            return out
        if self.num_stages >= 2:
            intra = self.deconv1(c1, intra)
            out["stage2"] = self.out2(intra)
        if self.num_stages >= 3:
            intra = self.deconv2(c0, intra)
            out["stage3"] = self.out3(intra)
        return out
