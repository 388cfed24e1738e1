"""Building blocks (counterpart of adamvs_tpu/nn/blocks.py), NCHW.

Submodule names follow the reference PyTorch model, so a reference
state_dict loads as it is:

- ``ConvBlock``: conv without bias + BatchNorm + ReLU;
- ``DeconvBlock``: stride-2 transposed conv + BatchNorm + ReLU, exactly 2x;
- ``ConvReLU``: conv without bias + ReLU;
- ``ConvGRUCell``: sigmoid gates from concat(x, h), tanh candidate from
  concat(x, r*h), ``h' = u*h + (1-u)*c``;
- ``DeConvFuse``: deconv x2, concat skip, ConvBlock.

A conv is ``nn.Conv2d(padding=(k-1)//2)``; a stride-2 transposed conv is
``nn.ConvTranspose2d(3, stride=2, padding=1, output_padding=1)``. The
JAX package's shift-einsum convolutions (nn/fastconv.py) are a TPU
workaround with the same semantics and are not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


class ConvBlock(nn.Module):
    """conv (no bias) + BatchNorm + ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding=(kernel - 1) // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class DeconvBlock(nn.Module):
    """Stride-2 3x3 transposed conv (no bias) + BatchNorm + ReLU, exactly 2x."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1,
                                       bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ConvReLU(nn.Module):
    """3x3 conv without bias + ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride, padding=1, bias=False)

    def forward(self, x):
        return F.relu(self.conv(x))


class ConvGRUCell(nn.Module):
    """Plain 3x3 convolutional GRU; ``forward(h, x)`` returns the new state."""

    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.conv_gates = nn.Sequential(nn.Conv2d(cin + hidden, 2 * hidden, 3, padding=1))
        self.convc = nn.Sequential(nn.Conv2d(cin + hidden, hidden, 3, padding=1))

    def forward(self, h, x):
        gates = self.conv_gates(torch.cat([x, h], dim=1))
        r, u = torch.split(gates, self.hidden, dim=1)
        r = torch.sigmoid(r)
        u = torch.sigmoid(u)
        c = torch.tanh(self.convc(torch.cat([x, r * h], dim=1)))
        return u * h + (1 - u) * c


class DeConvFuse(nn.Module):
    """U-Net up step: deconv x2, concat skip, fuse 3x3 ConvBlock."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.deconv = DeconvBlock(cin, cout)
        self.conv = ConvBlock(2 * cout, cout)

    def forward(self, skip, x):
        return self.conv(torch.cat([self.deconv(x), skip], dim=1))


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation of every conv in ``module``: PyTorch's default
    uniform(±1/sqrt(fan_in)) for weights and biases, drawn from ``generator``
    so a seed fixes the weights. BatchNorm keeps its identity init."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.weight.shape[1] * m.weight[0, 0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.copy_(torch.empty(m.weight.shape).uniform_(-bound, bound, generator=generator))
            if m.bias is not None:
                m.bias.copy_(torch.empty(m.bias.shape).uniform_(-bound, bound, generator=generator))
