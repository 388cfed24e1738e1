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

Training (``train=True``, the JAX ``use_fused_t`` branch) runs the fused form
under autograd with BatchNorm in train mode (the caller's ``model.train()``):
the differentiable ``var_sweep_volume_t`` (K4 forward, K5 backward), then
``RedCell`` stepped over D into the online softmax. The gradient reaches the
previous stage's depth through the hypotheses. The scan form is
inference-only here.

Module names follow the reference ``CascadeREDNet`` (``feature``,
``cost_regularization.{i}``), so a reference state_dict loads with
``load_state_dict``. ``share_cr`` is rejected by the JAX model too and is
not ported. ``depth_values`` is [B,3] = [min,max,interval] or [B,2] =
[min,max] with ``num_depth``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

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


def variance_slice(ref, srcs, src_projs, ref_proj, hyp) -> torch.Tensor:
    """The scan form's variance at one hypothesis ``hyp`` [B,h,w]: ref
    [B,h,w,C] and the Vs sources warped through K6/K7, summed in float32;
    returns [B,C,h,w] in the feature dtype."""
    nv = srcs.shape[0] + 1
    s = ref.float()
    sq = s * s
    for v in range(srcs.shape[0]):
        warped = plane_sweep_warp_sampled(srcs[v], src_projs[v], ref_proj, hyp[:, None])[:, 0]
        warped = warped.float()
        s = s + warped
        sq = sq + warped * warped
    m = s / nv
    return (sq / nv - m * m).to(ref.dtype).permute(0, 3, 1, 2).contiguous()


class MSREDNet(nn.Module):
    """MS-REDNet cascade, inference and training. The working dtype is the parameters'
    dtype (``model.to(torch.bfloat16)`` runs the model in bf16)."""

    def __init__(self, ndepths=(48, 32, 8), depth_intervals_ratio=(4.0, 2.0, 1.0),
                 base: int = 8, cr_base=(8, 8, 8), sweep_impl: str = "fused"):
        super().__init__()
        if sweep_impl not in SWEEP_IMPLS:
            raise ValueError(f"sweep_impl must be one of {SWEEP_IMPLS}, got {sweep_impl!r}")
        self.ndepths = tuple(ndepths)
        self.depth_intervals_ratio = tuple(depth_intervals_ratio)
        self.sweep_impl = sweep_impl
        n = len(self.ndepths)
        self.feature = RedFeatureNet(base, num_stages=n)
        self.chans = (4 * base, 2 * base, base)[:n]
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
        if self.sweep_impl != "fused":
            raise ValueError(f"training runs the fused form; sweep_impl is {self.sweep_impl!r}")
        return self._cascade(imgs, proj_matrices, depth_values, num_depth, True, features)

    def _cascade(self, imgs, proj_matrices, depth_values, num_depth, train: bool,
                 features) -> dict:
        dtype = self.feature.out1.weight.dtype
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
            state = cell.init_state(B, h, w, dtype, device)
            acc = online_softmax_init((B, h, w), device=device)
            vol = (var_fn(ref, srcs, src_projs, ref_proj, lo, step, D)
                   if self.sweep_impl == "fused" else None)  # [D,B,C,h,w]
            for d in range(D):
                hyp = lo + float(d) * step
                x = vol[d] if vol is not None else variance_slice(ref, srcs, src_projs, ref_proj,
                                                                  hyp)
                state, cost = cell(state, x)
                acc = online_softmax_update(acc, cost[:, 0].float(), hyp)
            depth, conf = online_softmax_finalize(acc)
            outputs[key] = {"depth": depth, "photometric_confidence": conf}
            prev_depth = depth

        outputs.update(outputs[f"stage{len(self.ndepths)}"])
        return outputs
