"""The AdaRedCell recurrence over depth: kernel K3 and its plain version.

Counterpart of ``adamvs_tpu/ops/red_scan.py::ada_red_scan``: the recurrent
regulariser of one stage run over all D slices of the fused volume, giving
the regularised cost volume [D,B,oh,ow] (oh = 2h when the cell's ``up``).
The CUDA kernel is ``csrc/red_scan.cu`` (a host loop over depth of direct
convolution kernels, see the note there); the plain version steps the
port's ``AdaRedCell`` module over D.

A wrapper takes the plain version for CPU tensors. For CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from ..kernels import build
from ..nn.costreg import AdaRedCell

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BASES = (4, 8)
_SMEM_LIMIT = 48 * 1024


def red_scan_ref(cell: AdaRedCell, vol: torch.Tensor) -> torch.Tensor:
    """Plain K3: ``cell`` stepped over ``vol`` [D,B,cin,h,w] from zero states;
    returns the cost [D,B,oh,ow] in the volume's dtype. It runs under
    autograd too: the training path steps the cell with it."""
    D, B, _, h, w = vol.shape
    state = cell.init_state(B, h, w, vol.dtype, vol.device)
    costs = []
    for d in range(D):
        state, cost = cell(state, vol[d])
        costs.append(cost[:, 0])
    return torch.stack(costs)


def _conv_w(conv) -> torch.Tensor:
    # Conv2d weight [co, ci, 3, 3] -> [(ci, ky, kx), co]
    return conv.weight.detach().float().permute(1, 2, 3, 0).contiguous()


def _deconv_w(conv) -> torch.Tensor:
    # ConvTranspose2d weight [ci, co, 3, 3] -> [(ci, ky, kx), co]
    return conv.weight.detach().float().permute(0, 2, 3, 1).contiguous()


def _bias(conv) -> torch.Tensor:
    return conv.bias.detach().float().contiguous()


def pack_red_weights(cell: AdaRedCell) -> list[torch.Tensor]:
    """The cell's weights in the order and layout the kernel reads: wc1, wg1,
    bg1, wn1, bn1, wc2, wg2, bg2, wn2, bn2, wu1, bu1, wh, bh; each conv as
    float32 [(ci, ky, kx), co]."""
    g1, c1 = cell.conv_gru1.conv_gates[0], cell.conv_gru1.convc[0]
    g2, c2 = cell.conv_gru2.conv_gates[0], cell.conv_gru2.convc[0]
    head = cell.upconv2d
    return [
        _conv_w(cell.conv1.conv),
        _conv_w(g1), _bias(g1), _conv_w(c1), _bias(c1),
        _conv_w(cell.conv2.conv),
        _conv_w(g2), _bias(g2), _conv_w(c2), _bias(c2),
        _deconv_w(cell.upconv1), _bias(cell.upconv1),
        _deconv_w(head) if cell.up else _conv_w(head), _bias(head),
    ]


@functools.cache
def _entry():
    lib = build.load_library("red_scan")
    return lib, build.bind(lib, "adamvs_red_scan", n_ptr=17, n_int=8)


def red_scan(cell: AdaRedCell, vol: torch.Tensor) -> torch.Tensor:
    """K3: the cost volume [D,B,oh,ow] of ``cell`` over ``vol`` [D,B,cin,h,w]
    (see ``red_scan_ref``)."""
    if vol.device.type == "cpu":
        return red_scan_ref(cell, vol)
    if vol.device.type != "cuda":
        raise ValueError(f"red_scan takes CUDA tensors, got {vol.device}")
    if vol.dtype not in _DTYPE_CODE or vol.ndim != 5 or not vol.is_contiguous():
        raise ValueError(f"vol must be a contiguous float32/bfloat16 [D,B,C,h,w], got "
                         f"{vol.dtype} {tuple(vol.shape)}")
    D, B, cin, h, w = vol.shape
    b = cell.base
    if b not in _BASES or h % 2 or w % 2 or cin * 9 * b * 4 > _SMEM_LIMIT:
        raise ValueError(f"unsupported red_scan shape: base {b}, cin {cin}, h {h}, w {w}")
    weights = pack_red_weights(cell)
    if any(t.device != vol.device for t in weights):
        raise ValueError("cell weights and volume must be on one device")
    oh, ow = (2 * h, 2 * w) if cell.up else (h, w)
    cost = torch.empty((D, B, oh, ow), dtype=vol.dtype, device=vol.device)
    n1 = B * b * h * w
    n2 = B * 2 * b * (h // 2) * (w // 2)
    scratch = torch.empty(5 * n1 + 4 * n2, dtype=vol.dtype, device=vol.device)
    lib, fn = _entry()
    err = fn(_DTYPE_CODE[vol.dtype], b, cin, int(cell.up), D, B, h, w,
             vol.data_ptr(), *(t.data_ptr() for t in weights), cost.data_ptr(),
             scratch.data_ptr(), torch.cuda.current_stream(vol.device).cuda_stream)
    build.check(lib, err, "red_scan")
    red_scan.launches += 1
    return cost


red_scan.launches = 0
