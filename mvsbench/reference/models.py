"""Plain float32 PyTorch forwards of Ada-MVS and MS-REDNet (CascadeREDNet with
its ``unet`` feature net), written from the published models
(gpcv-liujin/Ada-MVS ``models/``) for the benchmark's comparison.

No kernel, cache or batching trick: convolutions are ``F.conv2d`` /
``F.conv_transpose2d``; a plane sweep back-projects every reference pixel
to each hypothesis plane, projects it into the source and samples the source
bilinearly by gathering its four taps (zeros outside the image, nothing
behind the camera); the recurrent regularisers are stepped one depth slice at
a time; depth is the softmax-weighted mean of the hypotheses. Module names
are the reference's, so one state dict loads here and into the system under
test.

Semantics kept from the published models, with the departures the JAX
package and its port make and document (so both sides compute one thing):
stage 1 samples ``D`` hypotheses uniformly over [min, max]; a later stage
samples a per-pixel window of ``D`` hypotheses around the previous depth,
``ratio · (max - min) / num_depth`` apart times ``D / (D - 1)``; Ada-MVS
stages 1 and 2 emit their cost at twice their resolution; BatchNorm in
train mode normalises with the batch's biased variance and moves its
running variance toward that same value (flax's rule); GroupNorm has one
group. ``Numerics`` rounds at the points a lower-precision run would (the
control); by default it does nothing.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .numerics import FLOAT32, Numerics

BN_EPS = 1e-5
GN_EPS = 1e-5
BN_MOMENTUM = 0.1


# --- layers --------------------------------------------------------------------

def conv(m: nn.Conv2d, x: torch.Tensor, nx: Numerics) -> torch.Tensor:
    return nx.q(F.conv2d(nx.q(x), nx.q(m.weight), m.bias, m.stride, m.padding))


def deconv(m: nn.ConvTranspose2d, x: torch.Tensor, nx: Numerics) -> torch.Tensor:
    return nx.q(F.conv_transpose2d(nx.q(x), nx.q(m.weight), m.bias, m.stride, m.padding,
                                   m.output_padding))


def batch_norm(m: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Eval mode: the running statistics. Train mode: the batch's mean and
    biased variance, and the running statistics moved toward them."""
    if not m.training:
        return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0,
                            BN_EPS)
    mean = x.mean(dim=(0, 2, 3))
    var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
    with torch.no_grad():
        m.running_mean.lerp_(mean, BN_MOMENTUM)
        m.running_var.lerp_(var, BN_MOMENTUM)
        m.num_batches_tracked += 1
    xhat = (x - mean[None, :, None, None]) / torch.sqrt(var + BN_EPS)[None, :, None, None]
    return xhat * m.weight[None, :, None, None] + m.bias[None, :, None, None]


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of the last two axes, half-pixel centres."""
    if x.shape[-2:] == (h, w):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((-1, 1) + tuple(x.shape[-2:])), size=(h, w), mode="bilinear",
                      align_corners=False)
    return y.reshape(tuple(lead) + (h, w))


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def run(self, x, nx):
        return F.relu(nx.q(batch_norm(self.bn, conv(self.conv, x, nx))))


class DeconvBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.ConvTranspose2d(cin, cout, 3, 2, 1, output_padding=1, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def run(self, x, nx):
        return F.relu(nx.q(batch_norm(self.bn, deconv(self.conv, x, nx))))


class DeConvFuse(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.deconv = DeconvBlock(cin, cout)
        self.conv = ConvBlock(2 * cout, cout)

    def run(self, skip, x, nx):
        return self.conv.run(torch.cat([self.deconv.run(x, nx), skip], 1), nx)


class ConvReLU(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)

    def run(self, x, nx):
        return F.relu(conv(self.conv, x, nx))


class ConvTransReLU(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.ConvTranspose2d(cin, cout, 3, 2, 1, output_padding=1, bias=False)

    def run(self, x, nx):
        return F.relu(deconv(self.conv, x, nx))


def _seq(*mods):
    return nn.Sequential(*mods)


def _trunk(m: nn.Module, b: int) -> None:
    m.conv0 = _seq(ConvBlock(3, b), ConvBlock(b, b))
    m.conv1 = _seq(ConvBlock(b, 2 * b, 5, 2), ConvBlock(2 * b, 2 * b), ConvBlock(2 * b, 2 * b))
    m.conv2 = _seq(ConvBlock(2 * b, 4 * b, 5, 2), ConvBlock(4 * b, 4 * b),
                   ConvBlock(4 * b, 4 * b))


def _run_seq(seq, x, nx):
    for blk in seq:
        x = blk.run(x, nx)
    return x


def _trunk_run(m, x, nx):
    c0 = _run_seq(m.conv0, x, nx)
    c1 = _run_seq(m.conv1, c0, nx)
    return c0, c1, _run_seq(m.conv2, c1, nx)


# --- feature nets --------------------------------------------------------------

class SPPBranch(nn.Sequential):
    """k x k average pool, 1x1 ConvBlock, bilinear resize back."""

    def __init__(self, cin, cout, pool):
        super().__init__(nn.AvgPool2d(pool, pool), ConvBlock(cin, cout, 1))

    def run(self, x, nx):
        y = self[1].run(F.avg_pool2d(x, self[0].kernel_size, self[0].stride), nx)
        return nx.q(resize(y, x.shape[2], x.shape[3]))


class AdaFeatureNet(nn.Module):
    def __init__(self, b):
        super().__init__()
        _trunk(self, b)
        self.branch1_1, self.branch1_2 = SPPBranch(4 * b, 2 * b, 4), SPPBranch(4 * b, 2 * b, 8)
        self.out1 = nn.Conv2d(8 * b, 4 * b, 1, bias=False)
        self.deconv1 = DeConvFuse(4 * b, 2 * b)
        self.branch2_1, self.branch2_2 = SPPBranch(2 * b, b, 4), SPPBranch(2 * b, b, 8)
        self.out2 = nn.Conv2d(4 * b, 2 * b, 1, bias=False)
        self.deconv2 = DeConvFuse(2 * b, b)
        self.branch3_1, self.branch3_2 = SPPBranch(b, b // 2, 4), SPPBranch(b, b // 2, 8)
        self.out3 = nn.Conv2d(2 * b, b, 1, bias=False)

    def run(self, x, nx):
        c0, c1, y = _trunk_run(self, x, nx)
        outs = {}
        for i, (skip, up) in enumerate(((None, None), (c1, self.deconv1), (c0, self.deconv2))):
            if up is not None:
                y = up.run(skip, y, nx)
            b1, b2 = getattr(self, f"branch{i + 1}_1"), getattr(self, f"branch{i + 1}_2")
            cat = torch.cat([b1.run(y, nx), b2.run(y, nx), y], 1)
            outs[f"stage{i + 1}"] = conv(getattr(self, f"out{i + 1}"), cat, nx)
        return outs


class RedFeatureNet(nn.Module):
    """MS-REDNet's ``unet`` feature net."""

    def __init__(self, b):
        super().__init__()
        _trunk(self, b)
        self.out1 = nn.Conv2d(4 * b, 4 * b, 1, bias=False)
        self.deconv1 = DeConvFuse(4 * b, 2 * b)
        self.out2 = nn.Conv2d(2 * b, 2 * b, 1, bias=False)
        self.deconv2 = DeConvFuse(2 * b, b)
        self.out3 = nn.Conv2d(b, b, 1, bias=False)

    def run(self, x, nx):
        c0, c1, y = _trunk_run(self, x, nx)
        outs = {"stage1": conv(self.out1, y, nx)}
        y = self.deconv1.run(c1, y, nx)
        outs["stage2"] = conv(self.out2, y, nx)
        y = self.deconv2.run(c0, y, nx)
        outs["stage3"] = conv(self.out3, y, nx)
        return outs


# --- regularisers --------------------------------------------------------------

class _Up(nn.Sequential):
    def __init__(self, c):
        super().__init__(nn.ConvTranspose2d(c, c, 3, 2, 1, output_padding=1, bias=False),
                         nn.BatchNorm2d(c, eps=BN_EPS), nn.ReLU())

    def run(self, x, nx):
        return F.relu(nx.q(batch_norm(self[1], deconv(self[0], x, nx))))


class CostRegNet2D(nn.Module):
    """2-D U-Net over [N,D,h,w], depth as channels."""

    def __init__(self, c):
        super().__init__()
        self.conv0, self.conv1 = ConvBlock(c, c), ConvBlock(c, c, stride=2)
        self.conv2, self.conv3 = ConvBlock(c, c), ConvBlock(c, c, stride=2)
        self.conv4, self.conv5 = ConvBlock(c, c), ConvBlock(c, c, stride=2)
        self.conv6 = ConvBlock(c, c)
        self.conv7, self.conv9, self.conv11 = _Up(c), _Up(c), _Up(c)
        self.prob = nn.Conv2d(c, c, 3, 1, 1)

    def run(self, x, nx):
        c0 = self.conv0.run(x, nx)
        c2 = self.conv2.run(self.conv1.run(c0, nx), nx)
        c4 = self.conv4.run(self.conv3.run(c2, nx), nx)
        y = self.conv6.run(self.conv5.run(c4, nx), nx)
        y = nx.q(c4 + self.conv7.run(y, nx))
        y = nx.q(c2 + self.conv9.run(y, nx))
        y = nx.q(c0 + self.conv11.run(y, nx))
        return conv(self.prob, y, nx)


class ConvGRU(nn.Module):
    def __init__(self, cin, hid):
        super().__init__()
        self.hid = hid
        self.conv_gates = _seq(nn.Conv2d(cin + hid, 2 * hid, 3, 1, 1))
        self.convc = _seq(nn.Conv2d(cin + hid, hid, 3, 1, 1))

    def run(self, h, x, nx):
        g = conv(self.conv_gates[0], torch.cat([x, h], 1), nx)
        r, u = nx.q(torch.sigmoid(g[:, :self.hid])), nx.q(torch.sigmoid(g[:, self.hid:]))
        c = nx.q(torch.tanh(conv(self.convc[0], torch.cat([x, nx.q(r * h)], 1), nx)))
        return nx.q(u * h + (1 - u) * c)


class GNConvGRU(nn.Module):
    def __init__(self, cin, hid):
        super().__init__()
        self.hid = hid
        self.gate_conv = nn.Conv2d(cin + hid, 2 * hid, 3, 1, 1)
        self.reset_gate_norm = nn.GroupNorm(1, hid, eps=GN_EPS)
        self.update_gate_norm = nn.GroupNorm(1, hid, eps=GN_EPS)
        self.output_conv = nn.Conv2d(cin + hid, hid, 3, 1, 1)
        self.output_norm = nn.GroupNorm(1, hid, eps=GN_EPS)

    def run(self, h, x, nx):
        g = conv(self.gate_conv, torch.cat([x, h], 1), nx)
        gn = lambda t, m: nx.q(F.group_norm(t, 1, m.weight, m.bias, GN_EPS))  # noqa: E731
        r = nx.q(torch.sigmoid(gn(g[:, :self.hid], self.reset_gate_norm)))
        u = nx.q(torch.sigmoid(gn(g[:, self.hid:], self.update_gate_norm)))
        o = nx.q(torch.tanh(gn(conv(self.output_conv, torch.cat([x, nx.q(r * h)], 1), nx),
                               self.output_norm)))
        return nx.q(u * h + (1 - u) * o)


class AdaRedCell(nn.Module):
    """One depth step of Ada-MVS's recurrent regulariser."""

    def __init__(self, cin, b, up):
        super().__init__()
        self.b, self.up = b, up
        self.conv1 = ConvReLU(cin, b)
        self.conv_gru1 = ConvGRU(b, b)
        self.conv2 = ConvReLU(b, 2 * b, 2)
        self.conv_gru2 = ConvGRU(2 * b, 2 * b)
        self.upconv1 = nn.ConvTranspose2d(2 * b, b, 3, 2, 1, output_padding=1)
        self.upconv2d = (nn.ConvTranspose2d(b, 1, 3, 2, 1, output_padding=1) if up
                         else nn.Conv2d(b, 1, 3, 1, 1))

    def init(self, B, h, w, like):
        return (like.new_zeros(B, self.b, h, w), like.new_zeros(B, 2 * self.b, h // 2, w // 2))

    def step(self, h1, h2, x, nx):
        h1 = self.conv_gru1.run(h1, self.conv1.run(x, nx), nx)
        h2 = self.conv_gru2.run(h2, self.conv2.run(h1, nx), nx)
        u1 = F.relu(nx.q(deconv(self.upconv1, h2, nx) + h1))
        head = deconv if self.up else conv
        return h1, h2, head(self.upconv2d, u1, nx)[:, 0]


class RedCell(nn.Module):
    """One depth step of MS-REDNet's recurrent encoder-decoder."""

    def __init__(self, cin, b):
        super().__init__()
        self.b = b
        self.conv_gru1, self.conv_gru2 = GNConvGRU(cin, b), GNConvGRU(2 * b, 2 * b)
        self.conv_gru3, self.conv_gru4 = GNConvGRU(4 * b, 4 * b), GNConvGRU(8 * b, 8 * b)
        self.conv1, self.conv2 = ConvReLU(cin, 2 * b, 2), ConvReLU(2 * b, 4 * b, 2)
        self.conv3 = ConvReLU(4 * b, 8 * b, 2)
        self.upconv3, self.upconv2 = ConvTransReLU(8 * b, 4 * b), ConvTransReLU(4 * b, 2 * b)
        self.upconv1 = ConvTransReLU(2 * b, b)
        self.upconv2d = nn.ConvTranspose2d(b, 1, 3, 1, 1)

    def init(self, B, h, w, like):
        b = self.b
        return tuple(like.new_zeros(B, c, h // s, w // s)
                     for c, s in ((b, 1), (2 * b, 2), (4 * b, 4), (8 * b, 8)))

    def step(self, h1, h2, h3, h4, cost, nx):
        x = -cost
        c1 = self.conv1.run(x, nx)
        c2 = self.conv2.run(c1, nx)
        c3 = self.conv3.run(c2, nx)
        h4 = self.conv_gru4.run(h4, c3, nx)
        u3 = self.upconv3.run(h4, nx)
        h3 = self.conv_gru3.run(h3, c2, nx)
        u2 = self.upconv2.run(nx.q(u3 + h3), nx)
        h2 = self.conv_gru2.run(h2, c1, nx)
        u1 = self.upconv1.run(nx.q(u2 + h2), nx)
        h1 = self.conv_gru1.run(h1, x, nx)
        return h1, h2, h3, h4, deconv(self.upconv2d, nx.q(u1 + h1), nx)[:, 0]


# --- plane sweep ---------------------------------------------------------------

def sample_coords(src_proj, ref_proj, hyp, h, w):
    """Where reference pixel (x, y) at depth ``hyp`` [B,k,h,w] lands in the
    source: (u, v) [B,k,h,w], detached; behind the camera -> far outside."""
    with torch.no_grad():
        P = src_proj.float() @ torch.linalg.inv(ref_proj.float())  # [B,4,4]
        R, t = P[:, :3, :3], P[:, :3, 3]
        x = torch.arange(w, device=hyp.device, dtype=torch.float32)
        y = torch.arange(h, device=hyp.device, dtype=torch.float32)
        ray = (R[:, :, 0, None, None] * x + R[:, :, 1, None, None] * y[:, None]
               + R[:, :, 2, None, None])  # [B,3,h,w]
        p = ray[:, :, None] * hyp[:, None] + t[:, :, None, None, None]  # [B,3,k,h,w]
        z = p[:, 2]
        ok = z > 1e-6
        z = torch.where(ok, z, torch.ones_like(z))
        u = torch.where(ok, p[:, 0] / z, torch.full_like(z, -1e9))
        v = torch.where(ok, p[:, 1] / z, torch.full_like(z, -1e9))
    return u, v


def bilinear(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``src`` [B,C,H,W] sampled at (u, v) [B,...]: [B,C,...], taps outside
    the image count 0."""
    B, C, H, W = src.shape
    shape = u.shape[1:]
    u, v = u.reshape(B, -1), v.reshape(B, -1)
    x0, y0 = torch.floor(u), torch.floor(v)
    fx, fy = u - x0, v - y0
    flat = src.reshape(B, C, H * W)
    out = 0
    for dx, dy, wt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                       (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        tap = torch.gather(flat, 2, idx[:, None].expand(B, C, idx.shape[1]))
        out = out + tap * (wt * inside)[:, None]
    return out.reshape((B, C) + tuple(shape))


def hypotheses(lo, step, d0, d1):
    d = torch.arange(d0, d1, device=lo.device, dtype=torch.float32)
    return lo[:, None] + d[None, :, None, None] * step[:, None]  # [B,k,h,w]


def warped(src, src_proj, ref_proj, lo, step, d0, d1):
    """The source [B,C,H,W] warped to the reference at hypotheses d0..d1:
    [B,C,k,h,w]."""
    h, w = lo.shape[1:]
    u, v = sample_coords(src_proj, ref_proj, hypotheses(lo.detach(), step.detach(), d0, d1), h, w)
    return bilinear(src, u, v)


def sweep(kind, ref, srcs, projs, lo, step, D, nx, weights=None, block=8, recompute=False):
    """Plane-sweep volume of ``ref`` [B,C,h,w] against ``srcs`` (a list of
    [B,C,H,W]) with ``projs`` [B,V,4,4] at ``lo + d step``:
    ``"corr"``: per source the channel mean of ref x warped, [Vs,B,D,h,w];
    ``"fused"``: sum over sources of w'_v ref x warped_v with w' = w / (1e-5 +
    sum w), [D,B,C,h,w]; ``"var"``: the variance over {ref, warped sources},
    [D,B,C,h,w]. Built ``block`` hypotheses at a time; ``recompute``: each
    block's warps are recomputed in the backward instead of kept."""
    ref = nx.q(ref)
    srcs = [nx.q(s) for s in srcs]
    Vs = len(srcs)
    wn = weights / (1e-5 + weights.sum(dim=1, keepdim=True)) if weights is not None else None

    def one(d0, d1):
        ws = [warped(s, projs[:, v + 1], projs[:, 0], lo, step, d0, d1)
              for v, s in enumerate(srcs)]
        r = ref[:, :, None]
        if kind == "corr":
            return torch.stack([(r * x).mean(dim=1) for x in ws])  # [Vs,B,k,h,w]
        if kind == "fused":
            acc = sum(r * x * wn[:, v, None, None] for v, x in enumerate(ws))
            return acc.permute(2, 0, 1, 3, 4)
        s = r + sum(ws)
        sq = r * r + sum(x * x for x in ws)
        m = s / (Vs + 1)
        return (sq / (Vs + 1) - m * m).permute(2, 0, 1, 3, 4)

    parts = []
    for d0 in range(0, D, block):
        d1 = min(D, d0 + block)
        if recompute and torch.is_grad_enabled():
            parts.append(checkpoint(one, d0, d1, use_reentrant=False))
        else:
            parts.append(one(d0, d1))
    return nx.q(torch.cat(parts, dim=2 if kind == "corr" else 0))


def regress(costs, lo, step):
    """Softmax over depth of ``costs`` [D,B,h,w] at hypotheses ``lo + d
    step``: (depth, confidence = the largest probability)."""
    D = costs.shape[0]
    c = costs.float()
    e = torch.exp(c - c.amax(dim=0))
    s = e.sum(dim=0) + 1e-10
    hyp = hypotheses(lo, step, 0, D).transpose(0, 1)  # [D,B,h,w]
    return (e * hyp).sum(dim=0) / s, e.amax(dim=0) / s


def window(prev, D, interval):
    """(lo, step) of ``D`` hypotheses centred on ``prev``."""
    lo = prev - D / 2 * interval
    return lo, (prev + D / 2 * interval - lo) / (D - 1)


# --- models --------------------------------------------------------------------

class _Net(nn.Module):
    def __init__(self, cin, b, up, reg_depths):
        super().__init__()
        if reg_depths:
            self.reg = CostRegNet2D(reg_depths)
        self.reg_fuse = AdaRedCell(cin, b, up)


def _images(imgs):
    B, V = imgs.shape[:2]
    return imgs.reshape((B * V,) + imgs.shape[2:]).permute(0, 3, 1, 2).float(), B, V


def _split(feat, B, V):
    f = feat.reshape((B, V) + feat.shape[1:])
    return f[:, 0], [f[:, v] for v in range(1, V)]


class AdaMVS(nn.Module):
    def __init__(self, ndepths=(48, 32, 8), ratios=(4.0, 2.0, 1.0), base=8, cr_base=(8, 8, 8)):
        super().__init__()
        self.ndepths, self.ratios = tuple(ndepths), tuple(ratios)
        self.feature = AdaFeatureNet(base)
        chans = (4 * base, 2 * base, base)
        self.DepthNet = nn.ModuleList(
            _Net(chans[i], cr_base[i], i < 2, ndepths[0] if i == 0 else 0) for i in range(3))

    def forward(self, imgs, projs, depth_values, num_depth=None, nx: Numerics = FLOAT32,
                checkpoint_steps: bool = False):
        """``imgs`` [B,V,H,W,3], ``projs`` {"stageK": [B,V,4,4]},
        ``depth_values`` [B,3] (min, max, interval) or [B,2] with
        ``num_depth``. Per stage {"depth", "photometric_confidence"} (and at
        stage 1 ``pair_result``, the per-view depths); the last stage's also
        at the top. In train mode BatchNorm takes batch statistics and stage
        1's regulariser runs once per source view."""
        x, B, V = _images(imgs)
        dmin, dmax = depth_values[:, 0].float(), depth_values[:, 1].float()
        interval = (depth_values[:, 2].float() if depth_values.shape[1] == 3
                    else (dmax - dmin) / num_depth)
        feats = self.feature.run(x, nx)
        out, prev, pair_conf = {}, None, None
        for si, D in enumerate(self.ndepths):
            net = self.DepthNet[si]
            ref, srcs = _split(feats[f"stage{si + 1}"], B, V)
            projs_k = projs[f"stage{si + 1}"].float()
            h, w = ref.shape[2:]
            stage = {}
            if si == 0:
                lo = dmin[:, None, None].expand(B, h, w)
                step = ((dmax - dmin) / (D - 1))[:, None, None].expand(B, h, w)
                corr = sweep("corr", ref, srcs, projs_k, lo, step, D, nx,
                             recompute=checkpoint_steps)  # [Vs,B,D,h,w]
                if self.training:
                    logits = torch.stack([net.reg.run(corr[v], nx) for v in range(V - 1)])
                else:
                    logits = net.reg.run(corr.reshape((V - 1) * B, D, h, w), nx).reshape(
                        corr.shape)
                prob = nx.q(torch.softmax(logits, dim=2))
                d = torch.arange(D, device=x.device)
                hyp0 = dmin[:, None] + d * ((dmax - dmin) / (D - 1))[:, None]
                stage["pair_result"] = tuple((prob * hyp0[None, :, :, None, None]).sum(dim=2))
                pair_conf = prob.amax(dim=2).transpose(0, 1)  # [B,Vs,h,w]
                weights = pair_conf
            else:
                weights = resize(pair_conf, h, w)
                lo, step = window(prev, D, (self.ratios[si] * interval)[:, None, None])
            vol = sweep("fused", ref, srcs, projs_k, lo, step, D, nx, weights,
                        recompute=checkpoint_steps)  # [D,B,C,h,w]
            cell = net.reg_fuse
            h1, h2 = cell.init(B, h, w, vol)
            costs = []
            for d in range(D):
                if checkpoint_steps and torch.is_grad_enabled():
                    h1, h2, c = checkpoint(cell.step, h1, h2, vol[d], nx, use_reentrant=False)
                else:
                    h1, h2, c = cell.step(h1, h2, vol[d], nx)
                costs.append(c)
            costs = torch.stack(costs)
            oh, ow = costs.shape[2:]
            depth, conf = regress(costs, resize(lo, oh, ow), resize(step, oh, ow))
            stage.update(depth=depth, photometric_confidence=conf)
            out[f"stage{si + 1}"] = stage
            prev = depth
        out.update(out[f"stage{len(self.ndepths)}"])
        return out


class MSREDNet(nn.Module):
    def __init__(self, ndepths=(48, 32, 8), ratios=(4.0, 2.0, 1.0), base=8, cr_base=(8, 8, 8)):
        super().__init__()
        self.ndepths, self.ratios = tuple(ndepths), tuple(ratios)
        self.feature = RedFeatureNet(base)
        chans = (4 * base, 2 * base, base)
        self.cost_regularization = nn.ModuleList(RedCell(chans[i], cr_base[i]) for i in range(3))

    def forward(self, imgs, projs, depth_values, num_depth=None, nx: Numerics = FLOAT32,
                checkpoint_steps: bool = False):
        """As ``AdaMVS.forward``; a later stage's window is formed at the full
        frame and resized to the stage."""
        x, B, V = _images(imgs)
        H, W = x.shape[2:]
        dmin, dmax = depth_values[:, 0].float(), depth_values[:, 1].float()
        interval = (depth_values[:, 2].float() if depth_values.shape[1] == 3
                    else (dmax - dmin) / num_depth)
        feats = self.feature.run(x, nx)
        out, prev = {}, None
        for si, D in enumerate(self.ndepths):
            ref, srcs = _split(feats[f"stage{si + 1}"], B, V)
            h, w = ref.shape[2:]
            if prev is None:
                lo = dmin[:, None, None].expand(B, h, w)
                step = ((dmax - dmin) / (D - 1))[:, None, None].expand(B, h, w)
            else:
                lo_f, step_f = window(resize(prev, H, W), D,
                                      (self.ratios[si] * interval)[:, None, None])
                lo, step = resize(lo_f, h, w), resize(step_f, h, w)
            vol = sweep("var", ref, srcs, projs[f"stage{si + 1}"].float(), lo, step, D, nx,
                        recompute=checkpoint_steps)
            cell = self.cost_regularization[si]
            state = cell.init(B, h, w, vol)
            costs = []
            for d in range(D):
                if checkpoint_steps and torch.is_grad_enabled():
                    *state, c = checkpoint(cell.step, *state, vol[d], nx, use_reentrant=False)
                else:
                    *state, c = cell.step(*state, vol[d], nx)
                costs.append(c)
            depth, conf = regress(torch.stack(costs), lo, step)
            out[f"stage{si + 1}"] = {"depth": depth, "photometric_confidence": conf}
            prev = depth
        out.update(out[f"stage{len(self.ndepths)}"])
        return out


MODELS = {"adamvs": AdaMVS, "msrednet": MSREDNet}
