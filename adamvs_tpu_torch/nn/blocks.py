"""Building blocks (counterpart of adamvs_tpu/nn/blocks.py), NCHW.

Submodule names follow the reference PyTorch model, so a reference
state_dict loads as it is:

- ``BatchNorm2d``: ``nn.BatchNorm2d`` with the JAX package's running
  statistics in train mode (see the class);
- ``ConvBlock``: conv without bias + BatchNorm + ReLU;
- ``DeconvBlock``: stride-2 transposed conv + BatchNorm + ReLU, exactly 2x;
- ``ConvReLU``: conv without bias + ReLU;
- ``ConvTransReLU``: stride-2 transposed conv without bias + ReLU, exactly 2x;
- ``ConvGRUCell``: sigmoid gates from concat(x, h), tanh candidate from
  concat(x, r*h), ``h' = u*h + (1-u)*c``;
- ``GNConvGRUCell``: the same GRU with GroupNorm(1) on each gate and on the
  candidate before their activations (``group_norm1``);
- ``DeConvFuse``: deconv x2, concat skip, ConvBlock.

A conv is ``Conv2d(padding=(k-1)//2)``; a stride-2 transposed conv is
``ConvTranspose2d(3, stride=2, padding=1, output_padding=1)``. The
JAX package's shift-einsum convolutions (nn/fastconv.py) are a TPU
workaround with the same semantics and are not ported.

Mixed precision is flax's ``dtype=bf16`` with float32 parameters: every
block computes in the dtype of its input. ``Conv2d`` and ``ConvTranspose2d``
cast their weight and bias to the input's dtype at each call, so float32
parameters serve a bf16 forward and receive float32 gradients (a weight used
at every depth step gets the float32 sum of its per-step gradients, as the
cast's transpose sums them in flax). The casts are no-ops for a model whose
parameters were cast to its compute dtype (bf16 inference).
BatchNorm and GroupNorm reduce in float32 and return the input's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
GN_EPS = 1e-5


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in the dtype of its input: weight and bias are cast to
    it at the call."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in the dtype of its input: weight and bias are
    cast to it at the call."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm as the JAX package keeps it (flax ``BatchNorm``, momentum 0.9
    there, 0.1 here). In train mode it normalises with the batch mean and
    biased variance, as ``nn.BatchNorm2d`` does, and moves the running
    variance toward that same biased variance, where ``nn.BatchNorm2d`` takes
    the unbiased one (n/(n-1), n the pixels per channel in the batch). In
    eval mode it is ``nn.BatchNorm2d``. A bf16 input with float32 parameters
    is normalised from float32 statistics and returned in bf16, as flax's
    ``BatchNorm(dtype=bf16)`` does; the running statistics stay in their
    own dtype. The state_dict names are its."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, training=True, eps=self.eps)


class ConvBlock(nn.Module):
    """conv (no bias) + BatchNorm + ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, padding=(kernel - 1) // 2, bias=False)
        self.bn = BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class DeconvBlock(nn.Module):
    """Stride-2 3x3 transposed conv (no bias) + BatchNorm + ReLU, exactly 2x."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1,
                                       bias=False)
        self.bn = BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ConvReLU(nn.Module):
    """3x3 conv without bias + ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, stride, padding=1, bias=False)

    def forward(self, x):
        return F.relu(self.conv(x))


class ConvTransReLU(nn.Module):
    """Stride-2 3x3 transposed conv without bias + ReLU, exactly 2x."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1,
                                       bias=False)

    def forward(self, x):
        return F.relu(self.conv(x))


class ConvGRUCell(nn.Module):
    """Plain 3x3 convolutional GRU; ``forward(h, x)`` returns the new state."""

    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.conv_gates = nn.Sequential(Conv2d(cin + hidden, 2 * hidden, 3, padding=1))
        self.convc = nn.Sequential(Conv2d(cin + hidden, hidden, 3, padding=1))

    def forward(self, h, x):
        gates = self.conv_gates(torch.cat([x, h], dim=1))
        r, u = torch.split(gates, self.hidden, dim=1)
        r = torch.sigmoid(r)
        u = torch.sigmoid(u)
        c = torch.tanh(self.convc(torch.cat([x, r * h], dim=1)))
        return u * h + (1 - u) * c


def group_norm1(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """``norm``, a GroupNorm with one group, applied to ``x`` [B,C,H,W]: mean
    and variance over (C, H, W) per sample in float32, then the per-channel
    affine as one ``addcmul``, in the dtype of ``x``. It computes what
    ``norm(x)`` does; PyTorch's own kernel reduces each (sample, group) in a
    single thread block, so with one group a full-resolution map is reduced
    by one block at a time, where ``var_mean`` spreads the reduction over
    the card."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=(1, 2, 3), correction=0, keepdim=True)
    scale = norm.weight.float()[None, :, None, None] * torch.rsqrt(var + norm.eps)
    shift = norm.bias.float()[None, :, None, None] - mean * scale
    return torch.addcmul(shift, x32, scale).to(x.dtype)


class GNConvGRUCell(nn.Module):
    """3x3 convolutional GRU with GroupNorm(1) on both gates and on the
    candidate: each norm's statistics are global over (C, H, W) per sample,
    as flax's ``GroupNorm(num_groups=1)`` computes them (``group_norm1``).
    ``forward(h, x)`` returns the new state."""

    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.gate_conv = Conv2d(cin + hidden, 2 * hidden, 3, padding=1)
        self.reset_gate_norm = nn.GroupNorm(1, hidden, eps=GN_EPS)
        self.update_gate_norm = nn.GroupNorm(1, hidden, eps=GN_EPS)
        self.output_conv = Conv2d(cin + hidden, hidden, 3, padding=1)
        self.output_norm = nn.GroupNorm(1, hidden, eps=GN_EPS)

    def forward(self, h, x):
        r, u = torch.split(self.gate_conv(torch.cat([x, h], dim=1)), self.hidden, dim=1)
        r = torch.sigmoid(group_norm1(r, self.reset_gate_norm))
        u = torch.sigmoid(group_norm1(u, self.update_gate_norm))
        o = torch.tanh(group_norm1(self.output_conv(torch.cat([x, r * h], dim=1)),
                                   self.output_norm))
        return u * h + (1 - u) * o


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
    so a seed fixes the weights. BatchNorm and GroupNorm keep their identity
    init."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.weight.shape[1] * m.weight[0, 0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.copy_(torch.empty(m.weight.shape).uniform_(-bound, bound, generator=generator))
            if m.bias is not None:
                m.bias.copy_(torch.empty(m.bias.shape).uniform_(-bound, bound, generator=generator))
