"""The AdaRedCell recurrence over depth: kernel K3 and its plain version.

Counterpart of ``adamvs_tpu/ops/red_scan.py::ada_red_scan``: the recurrent
regulariser of one stage run over all D slices of the fused volume, giving
the regularised cost volume [D,B,oh,ow] (oh = 2h when the cell's ``up``).
The plain version steps the port's ``AdaRedCell`` module over D.

The CUDA kernel is ``csrc/red_scan.cu`` (see the note there). It is bound by
its convolutions' operations, so both its forms run them on the tensor
cores: three fused launches per depth step, one for each level of the cell
(phase A: c1 and GRU1 at full resolution; phase B: the stride-2 c2 and GRU2
at half resolution; phase C: the transposed convolution with the skip, and
the head). Every tile recomputes its halo, so a phase reads its neighbours'
GRU states, and the states ping-pong between two buffers by depth parity
instead of being updated in place. Each convolution is an implicit GEMM
whose weights are laid out in the order of the ``mma`` B fragments, once for
as long as the weights do not change (``_packed_weights``): in bf16 by
``pack_red_fragments`` (the inference path), in float32 by
``pack_red_fragments_tf32`` (the trainer's eval step and ``predict`` in
float32), which splits each weight into two TF32 values, hi + lo. The float32
form multiplies in split TF32 (3xTF32: a_hi b_hi + a_hi b_lo + a_lo b_hi,
float32 sums), whose error of about 2^-21 of a product keeps its 1e-4
agreement with the plain version over 48 recurrent steps, where one-pass TF32
would not. The wrapper dispatches on the dtype.

A wrapper takes the plain version for CPU tensors. For CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from ..kernels import build
from ..nn.costreg import AdaRedCell

_BASES = (4, 8)
_TC_WIDTHS = (8, 16, 32, 64)  # input widths of the tensor-core form's instances
# taps of a stride-2 transposed convolution's output phase by its parity: an
# even output row 2i reads ky=1 at input row i, an odd one ky=2 at row i and
# ky=0 at row i+1 (oy = 2 iy - 1 + ky)
DECONV_TAPS = {0: (1,), 1: (2, 0)}


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


def _groups(channels: int) -> int:
    """8-channel K slices of a GEMM input of ``channels`` channels."""
    return -(-channels // 8)


def tc_width(cin: int) -> int | None:
    """The channels the tensor-core form holds a volume of ``cin`` channels
    in: the next of ``_TC_WIDTHS``, zero past ``cin``; None above them all."""
    return next((c for c in _TC_WIDTHS if c >= cin), None)


def conv_gemm_weights(weight: torch.Tensor, groups: int | None = None) -> torch.Tensor:
    """A 3x3 Conv2d weight [co, ci, 3, 3] as the dense GEMM operand B
    [9 * 8G, co]: row ((ky * 3 + kx) * G + g) * 8 + j holds input channel
    8g + j of tap (ky, kx), zero past ci (G = ``groups``, by default
    ceil(ci / 8))."""
    co, ci = weight.shape[:2]
    dense = weight.new_zeros((3, 3, 8 * (groups or _groups(ci)), co))
    dense[:, :, :ci] = weight.permute(2, 3, 1, 0)
    return dense.reshape(-1, co)


def deconv_gemm_weights(weight: torch.Tensor, a: int, c: int) -> torch.Tensor:
    """The GEMM operand B of output phase (a, c), the parities of the output
    row and column, of a stride-2 ConvTranspose2d weight [ci, co, 3, 3]: its
    taps (``DECONV_TAPS``, rows major) in turn, 8G rows each as in
    ``conv_gemm_weights``."""
    ci, co = weight.shape[:2]
    taps = [(ky, kx) for ky in DECONV_TAPS[a] for kx in DECONV_TAPS[c]]
    dense = weight.new_zeros((len(taps), 8 * _groups(ci), co))
    for t, (ky, kx) in enumerate(taps):
        dense[t, :ci] = weight[:, :, ky, kx]
    return dense.reshape(-1, co)


def mma_fragments(dense: torch.Tensor, k: int, dtype=torch.bfloat16) -> torch.Tensor:
    """A dense GEMM operand B [K, N] over taps of 8-channel slices
    (``conv_gemm_weights``) in the order of the ``mma`` B fragments of steps
    k deep, N padded to a multiple of 8 with zeros, in ``dtype``. k = 8 (one
    slice per step): [K/8, N/8, 32 lanes, 2], lane l of step s and n-tile t
    holding B[8s + 2(l % 4) + e, 8t + l // 4] for e = 0, 1. k = 16 (two
    slices of a tap per step, bf16 m16n8k16): [K/16, N/8, 32, 4], those 8
    rows and then the 8 after them."""
    K, N = dense.shape
    ks, nt = K // k, -(-N // 8)
    pad = dense.new_zeros((K, 8 * nt))
    pad[:, :N] = dense
    if k == 8:  # row 8s + 2q + e, column 8t + g -> [s, t, lane = 4g + q, e]
        frag = pad.reshape(ks, 4, 2, nt, 8).permute(0, 3, 4, 1, 2)
    else:  # row 16s + 8r + 2q + e -> [s, t, lane = 4g + q, 2r + e]
        frag = pad.reshape(ks, 2, 4, 2, nt, 8).permute(0, 4, 5, 2, 1, 3)
    return frag.reshape(ks, nt, 32, -1).to(dtype).contiguous()


def pack_red_fragments(cell: AdaRedCell, dtype=torch.bfloat16) -> list[torch.Tensor]:
    """The cell's weights in the order and layout the tensor-core kernel
    reads: the B fragments (``mma_fragments``, rounded to ``dtype``) of conv1
    (over ``tc_width`` input channels), the GRU1 gates and candidate, conv2,
    the GRU2 gates and candidate, and the four output phases of upconv1 concatenated along their steps in the
    order (0, 0), (0, 1), (1, 0), (1, 1); then float32 bg1, bn1, bg2, bn2, bu1,
    the head [(ci, ky, kx)] rounded to ``dtype``, and its bias."""
    g1, c1 = cell.conv_gru1.conv_gates[0], cell.conv_gru1.convc[0]
    g2, c2 = cell.conv_gru2.conv_gates[0], cell.conv_gru2.convc[0]
    head = cell.upconv2d

    def conv(m, groups=None):
        w = m.weight.detach().float()
        groups = groups or _groups(w.shape[1])
        return mma_fragments(conv_gemm_weights(w, groups), 8 if groups == 1 else 16, dtype)

    up1 = cell.upconv1.weight.detach().float()
    k = 8 if _groups(up1.shape[0]) == 1 else 16
    phases = [mma_fragments(deconv_gemm_weights(up1, a, c), k, dtype) for a in (0, 1) for c in (0, 1)]
    wh = (_deconv_w(head) if cell.up else _conv_w(head)).to(dtype).float()
    return [
        conv(cell.conv1.conv, tc_width(cell.conv1.conv.weight.shape[1]) // 8),
        conv(g1), conv(c1), conv(cell.conv2.conv), conv(g2), conv(c2),
        torch.cat(phases), _bias(g1), _bias(c1), _bias(g2), _bias(c2), _bias(cell.upconv1),
        wh.contiguous(), _bias(head),
    ]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the
    nearest value whose low 13 mantissa bits are zero, ties away from zero;
    float32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = ``x`` rounded to TF32, lo = x - hi rounded to TF32, so
    hi + lo gives back x to about 2^-23 of |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def pack_red_fragments_tf32(cell: AdaRedCell) -> list[torch.Tensor]:
    """The cell's weights in the order and layout the float32 kernel reads:
    the B fragments of conv1 (over ``tc_width`` input channels), the GRU1
    gates and candidate, conv2, the GRU2 gates and candidate, and the four
    output phases of upconv1 concatenated along their steps in the order
    (0, 0), (0, 1), (1, 0), (1, 1), each [K/8, N/8, 32, 4] float32: the k8
    fragment (``mma_fragments``) split by ``tf32_split`` into (b0_hi, b1_hi,
    b0_lo, b1_lo) per lane; then bg1, bn1, bg2, bn2, bu1, the head [(ci, ky,
    kx)] and its bias, float32."""
    g1, c1 = cell.conv_gru1.conv_gates[0], cell.conv_gru1.convc[0]
    g2, c2 = cell.conv_gru2.conv_gates[0], cell.conv_gru2.convc[0]
    head = cell.upconv2d

    def split(dense):
        hi, lo = tf32_split(mma_fragments(dense, 8, torch.float32))
        return torch.cat([hi, lo], dim=-1).contiguous()

    def conv(m, groups=None):
        return split(conv_gemm_weights(m.weight.detach().float(), groups))

    up1 = cell.upconv1.weight.detach().float()
    phases = [split(deconv_gemm_weights(up1, a, c)) for a in (0, 1) for c in (0, 1)]
    wh = _deconv_w(head) if cell.up else _conv_w(head)
    return [
        conv(cell.conv1.conv, tc_width(cell.conv1.conv.weight.shape[1]) // 8),
        conv(g1), conv(c1), conv(cell.conv2.conv), conv(g2), conv(c2),
        torch.cat(phases), _bias(g1), _bias(c1), _bias(g2), _bias(c2), _bias(cell.upconv1),
        wh, _bias(head),
    ]


# the packed weights of each cell the kernel ran with, and the key they were packed under
_PACKED: "weakref.WeakKeyDictionary[AdaRedCell, tuple]" = weakref.WeakKeyDictionary()


def _packed_weights(cell: AdaRedCell, dtype) -> list[torch.Tensor]:
    """``pack_red_fragments`` (bf16) or ``pack_red_fragments_tf32`` (float32) of
    ``cell``, packed again only when a parameter's storage or version counter
    has changed: packing is about a hundred small tensor operations,
    milliseconds of host time per call. Optimizer steps and
    ``load_state_dict`` bump the counters; a write through ``.data`` does not
    and is not seen."""
    key = (dtype, *((p.data_ptr(), p._version) for p in cell.parameters()))
    hit = _PACKED.get(cell)
    if hit is None or hit[0] != key:
        hit = (key, pack_red_fragments(cell) if dtype == torch.bfloat16
               else pack_red_fragments_tf32(cell))
        _PACKED[cell] = hit
    return hit[1]


@functools.cache
def _entry(name: str):
    lib = build.load_library("red_scan")
    return lib, build.bind(lib, name, n_ptr=17, n_int=7)


def red_scan(cell: AdaRedCell, vol: torch.Tensor) -> torch.Tensor:
    """K3: the cost volume [D,B,oh,ow] of ``cell`` over ``vol`` [D,B,cin,h,w]
    (see ``red_scan_ref``)."""
    if vol.device.type == "cpu":
        return red_scan_ref(cell, vol)
    if vol.device.type != "cuda":
        raise ValueError(f"red_scan takes CUDA tensors, got {vol.device}")
    if vol.dtype not in (torch.float32, torch.bfloat16) or vol.ndim != 5 or not vol.is_contiguous():
        raise ValueError(f"vol must be a contiguous float32/bfloat16 [D,B,C,h,w], got "
                         f"{vol.dtype} {tuple(vol.shape)}")
    D, B, cin, h, w = vol.shape
    b = cell.base
    if b not in _BASES or h % 2 or w % 2 or tc_width(cin) is None:
        raise ValueError(f"unsupported red_scan shape: base {b}, cin {cin}, h {h}, w {w}, "
                         f"{vol.dtype}")
    weights = _packed_weights(cell, vol.dtype)
    if any(t.device != vol.device for t in weights):
        raise ValueError("cell weights and volume must be on one device")
    oh, ow = (2 * h, 2 * w) if cell.up else (h, w)
    cost = torch.empty((D, B, oh, ow), dtype=vol.dtype, device=vol.device)
    n1 = B * b * h * w
    n2 = B * 2 * b * (h // 2) * (w // 2)
    # the two GRU state sets of the ping-pong
    scratch = torch.empty(2 * (n1 + n2), dtype=vol.dtype, device=vol.device)
    lib, fn = _entry("adamvs_red_scan_bf16" if vol.dtype == torch.bfloat16 else "adamvs_red_scan_f32")
    err = fn(b, cin, int(cell.up), D, B, h, w, vol.data_ptr(), *(t.data_ptr() for t in weights),
             cost.data_ptr(), scratch.data_ptr(), torch.cuda.current_stream(vol.device).cuda_stream)
    build.check(lib, err, "red_scan")
    red_scan.launches += 1
    return cost


red_scan.launches = 0


def red_scan_plan(base: int, cin: int, up: bool, B: int, h: int, w: int) -> list[dict]:
    """The float32 kernel's three launches per depth step at these shapes,
    without running them: per phase (A, B, C) its grid, tile, shared memory
    and resident blocks per SM. Needs the CUDA library and a card."""
    lib = build.load_library("red_scan")
    fn = lib.adamvs_red_scan_f32_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 21)()
    build.check(lib, fn(base, cin, int(up), B, h, w, ctypes.addressof(info)), "red_scan_plan")
    return [{"phase": "ABC"[i], "grid": tuple(info[7 * i:7 * i + 3]),
             "tile": tuple(info[7 * i + 3:7 * i + 5]), "smem_bytes": info[7 * i + 5],
             "blocks_per_sm": info[7 * i + 6]} for i in range(3)]
