"""MS-REDNet (counterpart of adamvs_tpu/models/msrednet.py).

Computes what the JAX ``MSREDNet.__call__`` computes (msrednet.py:281-466):

1. ``RedFeatureNet`` runs on all B·V views;
2. per stage, the hypotheses are ``lo + d·step`` per pixel: uniform over
   [min, max] at stage 1; at a later stage the previous depth is resized to
   full resolution, the window is formed there and ``lo``/``step`` are
   resized to the stage resolution (the reference's order of resampling,
   msrednet.py:376-386);
3. per hypothesis, the variance over {ref, warped sources} is fed to one
   ``RedCell`` step (carried GRU states) and its cost folded into an online
   softmax, which gives depth and confidence.

Two forms build the variance:

- ``sweep_impl="fused"`` (the JAX bench's form, ``_RedIdxStreamCell``): kernel
  K4 builds the whole [D,B,C,h,w] volume in one launch per stage;
- ``sweep_impl="scan"`` (``_RedStreamCell``): per hypothesis and source view,
  the warp samples through kernel K6/K7, and ``s``/``sq`` accumulate in
  float32. The JAX scan form accumulates them in the model dtype: in float32
  the two agree; in bf16 this form is the more exact.

The regulariser runs in two forms chosen by ``reg_impl``:

- ``"scan"``: ``RedCell`` stepped per hypothesis into the online softmax;
- ``"precomp"`` (inference in the fused form only, JAX
  ``red_precomp_depth``): ``red_precomp_depth`` over K4's volume, the
  input-side convolutions batched over chunks of depths.

Training (``train=True``) runs under autograd with BatchNorm in train mode
(the caller's ``model.train()``), ``RedCell`` stepped over D into the online
softmax, in either sweep form: ``"fused"`` (the JAX ``use_fused_t`` branch)
through the differentiable ``var_sweep_volume_t`` (K4 forward, K5
backward); ``"scan"`` (JAX ``_RedStreamCell``, the CLI's default) through
``variance_slice``, whose sampler calls are differentiable (K6/K7 forward,
K6/K7-bwd backward). ``reg_impl`` does not change training, as in JAX. The
gradient reaches the previous stage's depth through the hypotheses. Stage
1 sweeps min -> max in training too: the JAX model's documented deviation
from the reference (adamvs_tpu/models/msrednet.py:26-35), kept.

The compute dtype ``compute_dtype`` is flax's ``dtype``, one rule whatever
the parameters' dtype: float32 parameters with ``compute_dtype=torch.bfloat16`` train as
the JAX model with ``dtype=bf16`` does (``nn/blocks.py``); the softmax,
depths and confidences stay float32. ``sample_dtype`` (JAX
``warp_impl="pallas2bf16"`` on a float32 model) rounds the scan form's
sources to it once per stage and samples them into float32. ``arch_mode``
chooses the feature net's ``unet`` or ``fpn`` form.

Module names follow the reference ``CascadeREDNet`` (``feature``,
``cost_regularization.{i}``), so a reference state_dict loads with
``load_state_dict``. ``share_cr`` is rejected by the JAX model too and is
not ported. ``depth_values`` is [B,3] = [min,max,interval] or [B,2] =
[min,max] with ``num_depth``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import group_norm1
from ..nn.costreg import RedCell
from ..nn.featurenet import RedFeatureNet
from ..ops.regression import (
    online_softmax_finalize,
    online_softmax_init,
    online_softmax_update,
    resize_bilinear,
)
from ..ops.sampling import window_min_and_interval
from ..ops.sweep_fuse import var_sweep_volume, var_sweep_volume_t
from ..ops.warp_sample import plane_sweep_warp_sampled
from .adamvs import SWEEP_IMPLS, parse_depth_values, stage_features

REG_IMPLS = ("scan", "precomp")
# depths per chunk of red_precomp_depth (the JAX default)
PRECOMP_CHUNK = 8


def variance_slice(ref, srcs, src_projs, ref_proj, hyp) -> torch.Tensor:
    """The scan form's variance at one hypothesis ``hyp`` [B,h,w]: ref
    [B,h,w,C] and the Vs sources warped through K6/K7 (sampled into the
    dtype of ``ref``; ``srcs`` may be held in another), summed in float32;
    returns [B,C,h,w] in the dtype of ``ref``."""
    nv = srcs.shape[0] + 1
    s = ref.float()
    sq = s * s
    for v in range(srcs.shape[0]):
        warped = plane_sweep_warp_sampled(srcs[v], src_projs[v], ref_proj, hyp[:, None],
                                          out_dtype=ref.dtype)[:, 0]
        warped = warped.float()
        s = s + warped
        sq = sq + warped * warped
    m = s / nv
    return (sq / nv - m * m).to(ref.dtype).permute(0, 3, 1, 2).contiguous()


def _x_side(gru, x):
    """The x-halves of a ``GNConvGRUCell``'s two convolutions, which take
    concat(x, h): the gate's and the candidate's input terms, biases
    included."""
    cin = x.shape[1]
    return tuple(F.conv2d(x, conv.weight[:, :cin].to(x.dtype), conv.bias.to(x.dtype), padding=1)
                 for conv in (gru.gate_conv, gru.output_conv))


def _h_weights(gru, dtype) -> tuple:
    """The h-halves (the last ``hidden`` input channels) of the two
    convolutions' weights, contiguous, in ``dtype``."""
    return tuple(conv.weight[:, -gru.hidden:].to(dtype).contiguous()
                 for conv in (gru.gate_conv, gru.output_conv))


def _gru_h_step(gru, wh, h, gx, cx):
    """One ``GNConvGRUCell`` step from its x-side terms ``gx`` and ``cx``,
    computed beforehand: only the h-side convolutions (weights ``wh``), the
    three GroupNorms and the cell's elementwise math."""
    gates = gx + F.conv2d(h, wh[0], padding=1)
    r, u = torch.split(gates, gru.hidden, dim=1)
    r = torch.sigmoid(group_norm1(r, gru.reset_gate_norm))
    u = torch.sigmoid(group_norm1(u, gru.update_gate_norm))
    o = torch.tanh(group_norm1(cx + F.conv2d(r * h, wh[1], padding=1), gru.output_norm))
    return u * h + (1 - u) * o


def red_precomp_depth(cell: RedCell, var_all: torch.Tensor, lo: torch.Tensor,
                      step: torch.Tensor, chunk: int = PRECOMP_CHUNK) -> tuple:
    """The ``RedCell`` recurrence over the variance volume ``var_all``
    [D,B,C,h,w] into the online softmax over ``lo + d·step`` ([B,h,w]),
    restructured as JAX ``red_precomp_depth`` (adamvs_tpu/models/msrednet.py:
    122-249): each GRU convolution over concat(x, h) splits by linearity into
    conv_x(x) + conv_h(h); per chunk of K depths (``chunk`` if it divides D,
    else K = D) the encoder ``conv1..conv3`` and every x-side convolution run
    once over the K·B slices, the depth steps run only the h-side
    convolutions, GroupNorm (``group_norm1``, statistics over (C, h, w) per
    slice) and the cell math, and the decoder (``upconv3..1``, the head
    ``upconv2d``) runs once over the chunk's K·B states before its costs fold
    into the softmax. Chunks bound the memory: JAX ran out of device memory
    batching all of D at the bench's shapes. Inference only. Returns (depth,
    confidence), each [B,h,w] float32."""
    D, B, C, h, w = var_all.shape
    K = chunk if D % chunk == 0 else D
    grus = (cell.conv_gru1, cell.conv_gru2, cell.conv_gru3, cell.conv_gru4)
    whs = [_h_weights(g, var_all.dtype) for g in grus]
    states = list(cell.init_state(B, h, w, var_all.dtype, var_all.device))
    acc = online_softmax_init((B, h, w), device=var_all.device)
    for d0 in range(0, D, K):
        x = -var_all[d0:d0 + K].reshape(K * B, C, h, w)
        c1 = cell.conv1(x)
        c2 = cell.conv2(c1)
        c3 = cell.conv3(c2)
        xs = [_x_side(gru, inp) for gru, inp in zip(grus, (x, c1, c2, c3))]
        del x, c1, c2, c3
        outs = [[], [], [], []]
        for k in range(K):
            for li, (gru, wh) in enumerate(zip(grus, whs)):
                gx, cx = xs[li]
                states[li] = _gru_h_step(gru, wh, states[li], gx[k * B:(k + 1) * B],
                                         cx[k * B:(k + 1) * B])
                outs[li].append(states[li])
        del xs
        r1, r2, r3, r4 = (torch.cat(o) for o in outs)
        u3 = cell.upconv3(r4)
        u2 = cell.upconv2(u3 + r3)
        u1 = cell.upconv1(u2 + r2)
        cost = cell.upconv2d(u1 + r1)[:, 0].float()  # [K*B,h,w]
        del outs, r1, r2, r3, r4, u3, u2, u1
        for k in range(K):
            acc = online_softmax_update(acc, cost[k * B:(k + 1) * B], lo + float(d0 + k) * step)
    return online_softmax_finalize(acc)


class MSREDNet(nn.Module):
    """MS-REDNet cascade, inference and training, computing in
    ``compute_dtype`` (``build_model(dtype=torch.bfloat16)`` casts the
    parameters too, for inference); ``sample_dtype`` rounds the scan form's
    sources before sampling (module docstring)."""

    def __init__(self, ndepths=(48, 32, 8), depth_intervals_ratio=(4.0, 2.0, 1.0),
                 base: int = 8, cr_base=(8, 8, 8), sweep_impl: str = "fused",
                 reg_impl: str = "scan", arch_mode: str = "unet",
                 compute_dtype: torch.dtype = torch.float32,
                 sample_dtype: torch.dtype | None = None):
        super().__init__()
        if sweep_impl not in SWEEP_IMPLS:
            raise ValueError(f"sweep_impl must be one of {SWEEP_IMPLS}, got {sweep_impl!r}")
        if reg_impl not in REG_IMPLS:
            raise ValueError(f"reg_impl must be one of {REG_IMPLS}, got {reg_impl!r}")
        if reg_impl == "precomp" and sweep_impl != "fused":
            raise ValueError(f"reg_impl='precomp' runs over K4's volume and needs "
                             f"sweep_impl='fused' (got {sweep_impl!r})")
        self.compute_dtype = compute_dtype
        self.sample_dtype = sample_dtype
        self.ndepths = tuple(ndepths)
        self.depth_intervals_ratio = tuple(depth_intervals_ratio)
        self.sweep_impl = sweep_impl
        self.reg_impl = reg_impl
        n = len(self.ndepths)
        self.feature = RedFeatureNet(base, num_stages=n, arch_mode=arch_mode)
        self.chans = self.feature.out_channels()
        self.cost_regularization = nn.ModuleList(RedCell(self.chans[i], cr_base[i])
                                                 for i in range(n))

    def feature_module(self) -> nn.Module:
        """The feature net, NCHW in and {"stageK": [N,C,h,w]} out: the pyramid
        that ``forward(features=...)`` takes, computed apart."""
        return self.feature

    def forward(self, imgs, proj_matrices, depth_values, num_depth: int | None = None,
                train: bool = False, features: dict | None = None) -> dict:
        """``imgs`` [B,V,H,W,3], ``proj_matrices`` {"stageK": [B,V,4,4]},
        ``depth_values`` [B,3] = [min,max,interval] or [B,2] = [min,max]
        split into ``num_depth`` intervals. ``features`` (optional)
        {"stageK": [B,V,C,h,w] or [B,V,h,w,C]} replaces the feature net
        (``imgs`` may then be None; the last stage's maps give the frame
        size). Returns per stage ``depth`` and
        ``photometric_confidence`` [B,h,w], the last stage's also at the top
        level. ``train=True`` runs the training form under autograd and needs
        the module in train mode; otherwise the inference form runs without
        gradients."""
        if not train:
            with torch.no_grad():
                return self._cascade(imgs, proj_matrices, depth_values, num_depth, False,
                                     features)
        if not self.training:
            raise ValueError("train=True needs the module in train mode (model.train())")
        return self._cascade(imgs, proj_matrices, depth_values, num_depth, True, features)

    def _cascade(self, imgs, proj_matrices, depth_values, num_depth, train: bool,
                 features) -> dict:
        dtype = self.compute_dtype
        dmin, dmax, interval = parse_depth_values(depth_values.float(), num_depth)
        if features is None:
            B, V, H, W = imgs.shape[:4]
            feats = self.feature(
                imgs.reshape((B * V,) + imgs.shape[2:]).permute(0, 3, 1, 2).to(dtype))
        else:
            feats, B, V = stage_features(features, self.chans)
            H, W = feats[f"stage{len(self.ndepths)}"].shape[2:]
        device = depth_values.device
        var_fn = var_sweep_volume_t if train else var_sweep_volume

        outputs: dict = {}
        prev_depth = None
        for si, D in enumerate(self.ndepths):
            key = f"stage{si + 1}"
            f = feats[key].to(dtype)
            C, h, w = f.shape[1:]
            f = f.reshape(B, V, C, h, w).permute(0, 1, 3, 4, 2)  # [B,V,h,w,C]
            ref = f[:, 0].contiguous()
            srcs = f[:, 1:].transpose(0, 1).contiguous()  # [Vs,B,h,w,C]
            if self.sweep_impl == "scan" and self.sample_dtype:
                srcs = srcs.to(self.sample_dtype)  # once per stage (JAX prepare_warp_sources)
            projs = proj_matrices[key].float()
            ref_proj, src_projs = projs[:, 0], projs[:, 1:].transpose(0, 1)
            if prev_depth is None:
                lo = dmin[:, None, None].expand(B, h, w).contiguous()
                step = ((dmax - dmin) / (D - 1))[:, None, None].expand(B, h, w).contiguous()
            else:
                prev_full = resize_bilinear(prev_depth, H, W)
                ratio = self.depth_intervals_ratio[si]
                lo_f, step_f = window_min_and_interval(prev_full, D,
                                                       (ratio * interval)[:, None, None])
                lo = resize_bilinear(lo_f, h, w).contiguous()
                step = resize_bilinear(step_f, h, w).contiguous()

            cell = self.cost_regularization[si]
            vol = (var_fn(ref, srcs, src_projs, ref_proj, lo, step, D)
                   if self.sweep_impl == "fused" else None)  # [D,B,C,h,w]
            if self.reg_impl == "precomp" and not train:
                depth, conf = red_precomp_depth(cell, vol, lo, step)
            else:
                state = cell.init_state(B, h, w, dtype, device)
                acc = online_softmax_init((B, h, w), device=device)
                for d in range(D):
                    hyp = lo + float(d) * step
                    x = vol[d] if vol is not None else variance_slice(
                        ref, srcs, src_projs, ref_proj, hyp)
                    state, cost = cell(state, x)
                    acc = online_softmax_update(acc, cost[:, 0].float(), hyp)
                depth, conf = online_softmax_finalize(acc)
            outputs[key] = {"depth": depth, "photometric_confidence": conf}
            prev_depth = depth

        outputs.update(outputs[f"stage{len(self.ndepths)}"])
        return outputs
