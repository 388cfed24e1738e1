"""The yardstick's arithmetic: published peaks of one H100, the work of the
Ada-MVS and MS-REDNet forwards counted from their shapes, and the least work
of kernels K2 (the visibility-weighted plane sweep) and K3 (the AdaRedCell
recurrence).

Model FLOPs count what the published model computes, whatever implements it:
every convolution's multiply-adds as 2 (output pixels x cout x cin x k^2; a
transposed convolution's input pixels x cin x cout x k^2), the plane sweeps'
sampling and products, and the softmax regressions; normalisations,
activations, poolings and coordinates are left out. A training step counts
three forwards (the backward twice the forward).

The K2 and K3 formulas are frozen copies of the repository's
``chip_smoke.py::_sweep_work`` ("K2") and ``red_scan_work``: each input read
once, each output written once, operations over the peak of the kernel's
arithmetic.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
F32_FLOPS = PEAK_FLOPS["fp32"]


def conv_macs(cin: int, cout: int, k: int, out_px: int) -> int:
    return out_px * cout * cin * k * k


def deconv_macs(cin: int, cout: int, k: int, in_px: int) -> int:
    return in_px * cout * cin * k * k


def _trunk(b: int, h: int, w: int) -> int:
    px0, px1, px2 = h * w, (h // 2) * (w // 2), (h // 4) * (w // 4)
    return (conv_macs(3, b, 3, px0) + conv_macs(b, b, 3, px0)
            + conv_macs(b, 2 * b, 5, px1) + 2 * conv_macs(2 * b, 2 * b, 3, px1)
            + conv_macs(2 * b, 4 * b, 5, px2) + 2 * conv_macs(4 * b, 4 * b, 3, px2))


def _fuse_up(cin: int, cout: int, in_px: int, out_px: int) -> int:
    """DeConvFuse: a stride-2 transposed 3x3 conv, then a 3x3 conv over the concat."""
    return deconv_macs(cin, cout, 3, in_px) + conv_macs(2 * cout, cout, 3, out_px)


def _spp(cin: int, cout: int, h: int, w: int) -> int:
    return sum(conv_macs(cin, cout, 1, (h // k) * (w // k)) for k in (4, 8))


def feature_macs(model: str, b: int, h: int, w: int) -> int:
    """One view's feature net (Ada-MVS's with SPP branches, or MS-REDNet's
    ``unet``) at an input of h x w."""
    hs = [(h // 4, w // 4), (h // 2, w // 2), (h, w)]
    px = [a * c for a, c in hs]
    macs = _trunk(b, h, w) + _fuse_up(4 * b, 2 * b, px[0], px[1]) + _fuse_up(2 * b, b, px[1], px[2])
    if model == "adamvs":
        macs += _spp(4 * b, 2 * b, *hs[0]) + conv_macs(8 * b, 4 * b, 1, px[0])
        macs += _spp(2 * b, b, *hs[1]) + conv_macs(4 * b, 2 * b, 1, px[1])
        macs += _spp(b, b // 2, *hs[2]) + conv_macs(2 * b, b, 1, px[2])
    else:
        macs += (conv_macs(4 * b, 4 * b, 1, px[0]) + conv_macs(2 * b, 2 * b, 1, px[1])
                 + conv_macs(b, b, 1, px[2]))
    return macs


def costreg2d_macs(c: int, h: int, w: int) -> int:
    """Stage 1's 2-D U-Net over one [c,h,w] volume."""
    p = [(h // 2 ** i) * (w // 2 ** i) for i in range(4)]
    macs = conv_macs(c, c, 3, p[0]) * 2  # conv0, prob
    for i in (1, 2, 3):
        macs += 2 * conv_macs(c, c, 3, p[i])  # the stride-2 conv and the one after
        macs += deconv_macs(c, c, 3, p[i])  # the transposed conv back to p[i-1]
    return macs


def adaredcell_macs(cin: int, b: int, up: bool, h: int, w: int) -> int:
    """One depth step of the AdaRedCell at h x w."""
    hw, q = h * w, (h // 2) * (w // 2)
    macs = (conv_macs(cin, b, 3, hw) + conv_macs(2 * b, 2 * b, 3, hw) + conv_macs(2 * b, b, 3, hw)
            + conv_macs(b, 2 * b, 3, q) + conv_macs(4 * b, 4 * b, 3, q)
            + conv_macs(4 * b, 2 * b, 3, q) + deconv_macs(2 * b, b, 3, q))
    return macs + (deconv_macs(b, 1, 3, hw) if up else conv_macs(b, 1, 3, hw))


def redcell_macs(cin: int, b: int, h: int, w: int) -> int:
    """One depth step of MS-REDNet's RedCell at h x w."""
    q = [(h // 2 ** i) * (w // 2 ** i) for i in range(4)]
    chans = [cin, 2 * b, 4 * b, 8 * b]  # each level's input
    hid = [b, 2 * b, 4 * b, 8 * b]
    macs = sum(conv_macs(chans[i], chans[i + 1], 3, q[i + 1]) for i in range(3))
    for i in range(4):  # GRU i at level i: gates and candidate over concat(x, h)
        macs += conv_macs(chans[i] + hid[i], 2 * hid[i], 3, q[i])
        macs += conv_macs(chans[i] + hid[i], hid[i], 3, q[i])
    macs += sum(deconv_macs(hid[i + 1], hid[i], 3, q[i + 1]) for i in range(3))
    return macs + deconv_macs(b, 1, 3, q[0])


def sweep_flops(kind: str, vs: int, d: int, hw: int, c: int) -> int:
    """A plane sweep's arithmetic: per (source, hypothesis, pixel) the
    bilinear sample's four multiply-adds per channel (8C); then "corr" the
    dot product with the reference (2C), "fused" the product with the
    reference and the weighted sum (3C), "var" the sum and the sum of
    squares (3C) and per (hypothesis, pixel) the variance (5C)."""
    per = {"corr": 10, "fused": 11, "var": 11}[kind] * c
    return vs * d * hw * per + (d * hw * 5 * c if kind == "var" else 0)


def model_forward_work(cfg: dict, h: int, w: int) -> tuple[int, int]:
    """(convolution multiply-adds, other FLOPs) of one forward of ``cfg`` (a
    configuration file's content) on one sample of ``cfg["views"]`` frames
    of h x w."""
    model, b, V = cfg["model"], cfg["base"], cfg["views"]
    nd, cr = cfg["ndepths"], cfg["cr_base_chs"]
    vs = V - 1
    chans = (4 * b, 2 * b, b)
    macs = V * feature_macs(model, b, h, w)
    flops = 0
    for si, D in enumerate(nd):
        sh, sw = h // 2 ** (2 - si), w // 2 ** (2 - si)
        hw = sh * sw
        if model == "adamvs":
            up = si < 2
            if si == 0:
                macs += vs * costreg2d_macs(D, sh, sw)
                flops += sweep_flops("corr", vs, D, hw, chans[si]) + vs * D * hw * 5
            flops += sweep_flops("fused", vs, D, hw, chans[si])
            macs += D * adaredcell_macs(chans[si], cr[si], up, sh, sw)
            flops += D * hw * (4 if up else 1) * 5
        else:
            flops += sweep_flops("var", vs, D, hw, chans[si])
            macs += D * redcell_macs(chans[si], cr[si], sh, sw)
            flops += D * hw * 5
    return macs, flops


def model_forward_flops(cfg: dict, h: int, w: int, batch: int = 1) -> float:
    """FLOPs of one forward on ``batch`` samples: the convolutions'
    multiply-adds as 2, and the sweeps' and regressions' arithmetic."""
    macs, flops = model_forward_work(cfg, h, w)
    return batch * (2.0 * macs + flops)


# --- kernel bounds ---------------------------------------------------------------

def bound_s(nbytes: float, flops: float, peak: float) -> float:
    """The least time: bytes over the memory rate or operations over ``peak``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def k2_work(vs: int, h: int, w: int, c: int, d: int, elem_bytes: int) -> tuple[float, float]:
    """(bytes, float32 operations) of one K2 call (``chip_smoke.py::
    _sweep_work("K2")``): ref and sources read once, the float32 weights,
    lo and step read once, the volume written once; per source and pixel the
    ray R.[x,y,1] (12), per hypothesis and pixel lo + d step (2), per sample
    the coordinates, floors, fractions and tap weights (18), four weight
    products (4) and four multiply-adds per channel (8C), and per
    hypothesis, pixel and channel the product with ref (C)."""
    hw = h * w
    nbytes = (1 + vs) * hw * c * elem_bytes + 2 * hw * 4 + vs * hw * 4 + d * hw * c * elem_bytes
    flops = vs * hw * 12 + d * hw * 2 + vs * d * hw * (18 + 4 + 8 * c) + d * hw * c
    return nbytes, flops


def k3_work(base: int, cin: int, h: int, w: int, d: int, up: bool,
            elem_bytes: int) -> tuple[float, float]:
    """(bytes, operations) of one K3 call (``chip_smoke.py::red_scan_work``):
    the volume read and the cost written once; every convolution of every
    depth step's cell, multiply-adds counted as 2."""
    b = base
    hw, qw = h * w, (h // 2) * (w // 2)
    macs = 9 * (hw * (cin * b + 2 * b * 2 * b + 2 * b * b)
                + qw * (b * 2 * b + 4 * b * 4 * b + 4 * b * 2 * b)
                + qw * 2 * b * b
                + hw * b)
    oh, ow = (2 * h, 2 * w) if up else (h, w)
    return d * (cin * hw + oh * ow) * elem_bytes, 2.0 * macs * d
