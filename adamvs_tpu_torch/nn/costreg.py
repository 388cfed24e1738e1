"""Cost-volume regularisers (counterpart of adamvs_tpu/nn/costreg.py), NCHW.

- ``CostRegNet2D``: 2D U-Net with the depth axis as channels (three stride-2
  downs, three transposed-conv ups with additive skips, 3x3 head), the
  stage-1 per-view matching regulariser.
- ``AdaRedCell``: one depth step of the Ada-MVS recurrent regulariser:
  conv -> GRU(b) -> stride-2 conv -> GRU(2b) -> deconv + skip -> 1-channel
  head (a stride-2 deconv to 2x when ``up``, else a 3x3 conv).
- ``RedCell``: one depth step of the MS-REDNet recurrent encoder-decoder:
  four GroupNorm GRUs at 1, 1/2, 1/4 and 1/8 resolution, joined by stride-2
  transposed convs, and a 1-channel head.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import (BN_EPS, BatchNorm2d, ConvBlock, ConvGRUCell, ConvReLU, ConvTransReLU,
                     GNConvGRUCell)


def _up(c: int) -> nn.Sequential:
    return nn.Sequential(
        nn.ConvTranspose2d(c, c, 3, stride=2, padding=1, output_padding=1, bias=False),
        BatchNorm2d(c, eps=BN_EPS),
        nn.ReLU(),
    )


class CostRegNet2D(nn.Module):
    """U-Net over [B,D,h,w] (depth as channels). Output same shape."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.conv0 = ConvBlock(c, c)
        self.conv1 = ConvBlock(c, c, stride=2)
        self.conv2 = ConvBlock(c, c)
        self.conv3 = ConvBlock(c, c, stride=2)
        self.conv4 = ConvBlock(c, c)
        self.conv5 = ConvBlock(c, c, stride=2)
        self.conv6 = ConvBlock(c, c)
        self.conv7 = _up(c)
        self.conv9 = _up(c)
        self.conv11 = _up(c)
        self.prob = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        y = self.conv6(self.conv5(c4))
        y = c4 + self.conv7(y)
        y = c2 + self.conv9(y)
        y = c0 + self.conv11(y)
        return self.prob(y)


class AdaRedCell(nn.Module):
    """Ada-MVS recurrent regulariser, one depth slice.

    state = (h1 [B,b,h,w], h2 [B,2b,h/2,w/2]); input [B,cin,h,w]; output cost
    [B,1,2h,2w] when ``up`` else [B,1,h,w].
    """

    def __init__(self, cin: int, base: int = 8, up: bool = True):
        super().__init__()
        b = base
        self.base = base
        self.up = up
        self.conv1 = ConvReLU(cin, b)
        self.conv_gru1 = ConvGRUCell(b, b)
        self.conv2 = ConvReLU(b, 2 * b, stride=2)
        self.conv_gru2 = ConvGRUCell(2 * b, 2 * b)
        self.upconv1 = nn.ConvTranspose2d(2 * b, b, 3, stride=2, padding=1, output_padding=1)
        if up:
            self.upconv2d = nn.ConvTranspose2d(b, 1, 3, stride=2, padding=1, output_padding=1)
        else:
            self.upconv2d = nn.Conv2d(b, 1, 3, padding=1)

    def forward(self, state, x):
        h1, h2 = state
        c1 = self.conv1(x)
        h1 = self.conv_gru1(h1, c1)
        c2 = self.conv2(h1)
        h2 = self.conv_gru2(h2, c2)
        u1 = F.relu(self.upconv1(h2) + h1)
        return (h1, h2), self.upconv2d(u1)

    def init_state(self, batch: int, height: int, width: int, dtype, device):
        b = self.base
        return (
            torch.zeros((batch, b, height, width), dtype=dtype, device=device),
            torch.zeros((batch, 2 * b, height // 2, width // 2), dtype=dtype, device=device),
        )


class RedCell(nn.Module):
    """MS-REDNet recurrent encoder-decoder, one depth slice.

    state = (h1 [B,b,h,w], h2 [B,2b,h/2,w/2], h3 [B,4b,h/4,w/4],
    h4 [B,8b,h/8,w/8]); input cost [B,cin,h,w]; output cost [B,1,h,w]. The
    input is negated first, as the reference feeds the negated variance. The
    head ``upconv2d`` is a stride-1 transposed conv, as in the reference.
    """

    def __init__(self, cin: int, base: int = 8):
        super().__init__()
        b = base
        self.base = base
        self.conv_gru1 = GNConvGRUCell(cin, b)
        self.conv_gru2 = GNConvGRUCell(2 * b, 2 * b)
        self.conv_gru3 = GNConvGRUCell(4 * b, 4 * b)
        self.conv_gru4 = GNConvGRUCell(8 * b, 8 * b)
        self.conv1 = ConvReLU(cin, 2 * b, stride=2)
        self.conv2 = ConvReLU(2 * b, 4 * b, stride=2)
        self.conv3 = ConvReLU(4 * b, 8 * b, stride=2)
        self.upconv3 = ConvTransReLU(8 * b, 4 * b)
        self.upconv2 = ConvTransReLU(4 * b, 2 * b)
        self.upconv1 = ConvTransReLU(2 * b, b)
        self.upconv2d = nn.ConvTranspose2d(b, 1, 3, padding=1)

    def forward(self, state, cost):
        h1, h2, h3, h4 = state
        x = -cost
        c1 = self.conv1(x)
        c2 = self.conv2(c1)
        c3 = self.conv3(c2)
        h4 = self.conv_gru4(h4, c3)
        u3 = self.upconv3(h4)
        h3 = self.conv_gru3(h3, c2)
        u2 = self.upconv2(u3 + h3)
        h2 = self.conv_gru2(h2, c1)
        u1 = self.upconv1(u2 + h2)
        h1 = self.conv_gru1(h1, x)
        return (h1, h2, h3, h4), self.upconv2d(u1 + h1)

    def init_state(self, batch: int, height: int, width: int, dtype, device):
        b = self.base
        return tuple(
            torch.zeros((batch, c, height // s, width // s), dtype=dtype, device=device)
            for c, s in ((b, 1), (2 * b, 2), (4 * b, 4), (8 * b, 8))
        )
