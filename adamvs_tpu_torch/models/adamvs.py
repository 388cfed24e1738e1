"""Ada-MVS (counterpart of adamvs_tpu/models/adamvs.py).

Inference computes what the JAX model's ``sweep_impl="fused"``,
``reg_impl="pallas"`` inference branch computes (adamvs.py:548-816):

1. the feature net runs on all B·V views;
2. stage 1: per source view, a correlation volume (K1) over the uniform
   hypotheses is regularised by ``CostRegNet2D``; its softmax gives the
   per-view confidence (max probability) and depth (soft argmax);
3. stages 2 and 3 take those confidences, bilinearly resized, as visibility
   weights, and a per-pixel window around the previous depth;
4. every stage builds the visibility-weighted fused volume (K2), runs the
   AdaRedCell recurrence over it (K3) and regresses depth and confidence by a
   full softmax over the cost.

Stages 1 and 2 emit their cost at 2x resolution (``up``), so the depth of
stage k lands at the resolution of stage k+1.

Training (``train=True``, the JAX ``sweep_impl="fused"`` train branch,
``use_fused_t``) runs the same cascade under autograd, with BatchNorm in
train mode (the caller's ``model.train()``): the volumes through the
differentiable ``corr_sweep_volume_t`` and ``fused_sweep_volume_t`` (K1/K2
forward, K5 backward), and each stage's ``AdaRedCell`` stepped over D in
PyTorch, not K3, which has no backward. The gradient reaches the previous
stage's depth through the regression's hypotheses and the visibility
weights through the fused volume; only the sample positions carry none.

Module names follow the reference PyTorch model (``feature``,
``DepthNet.{i}.reg``, ``DepthNet.{i}.reg_fuse``), so a reference state_dict
loads with ``load_state_dict``. Only stage 1 has a ``reg``: the reference's
stage-2/3 ``CostRegNet2D`` weights are never used and are not instantiated.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.costreg import AdaRedCell, CostRegNet2D
from ..nn.featurenet import AdaFeatureNet
from ..ops.red_scan import red_scan, red_scan_ref
from ..ops.regression import resize_bilinear, softmax_regression
from ..ops.sampling import uniform_depth_samples, window_min_and_interval
from ..ops.sweep_fuse import (
    corr_sweep_volume,
    corr_sweep_volume_t,
    fused_sweep_volume,
    fused_sweep_volume_t,
)

# cost up-sampling by stage: stages 1 and 2 emit at 2x, stage 3 does not
_UP_BY_STAGE = (True, True, False)


def parse_depth_values(depth_values: torch.Tensor, num_depth: int | None):
    """(dmin [B], dmax [B], interval [B]) from the training form [B,3] =
    [min,max,interval], or from the prediction form [B,2] = [min,max] with
    interval = (max-min)/num_depth."""
    if depth_values.ndim != 2 or depth_values.shape[-1] not in (2, 3):
        raise ValueError(f"depth_values must be [B,2] or [B,3], got {tuple(depth_values.shape)}")
    dmin, dmax = depth_values[:, 0], depth_values[:, 1]
    if depth_values.shape[-1] == 3:
        return dmin, dmax, depth_values[:, 2]
    if num_depth is None:
        raise ValueError("depth_values [B,2] needs num_depth")
    return dmin, dmax, (dmax - dmin) / num_depth


class _DepthNet(nn.Module):
    def __init__(self, cin: int, cr_base: int, up: bool, reg_depths: int | None):
        super().__init__()
        if reg_depths is not None:
            self.reg = CostRegNet2D(reg_depths)
        self.reg_fuse = AdaRedCell(cin, cr_base, up)


class AdaMVS(nn.Module):
    """Ada-MVS cascade, inference and training. The working dtype is the parameters'
    dtype (``model.to(torch.bfloat16)`` runs the model in bf16)."""

    def __init__(self, ndepths=(48, 32, 8), depth_intervals_ratio=(4.0, 2.0, 1.0),
                 base: int = 8, cr_base=(8, 8, 8)):
        super().__init__()
        self.ndepths = tuple(ndepths)
        self.depth_intervals_ratio = tuple(depth_intervals_ratio)
        n = len(self.ndepths)
        self.feature = AdaFeatureNet(base, num_stages=n)
        chans = (4 * base, 2 * base, base)
        self.DepthNet = nn.ModuleList(
            _DepthNet(chans[i], cr_base[i], _UP_BY_STAGE[i], self.ndepths[0] if i == 0 else None)
            for i in range(n)
        )

    def forward(self, imgs, proj_matrices, depth_values, num_depth: int | None = None,
                train: bool = False) -> dict:
        """``imgs`` [B,V,H,W,3], ``proj_matrices`` {"stageK": [B,V,4,4]},
        ``depth_values`` [B,3] = [min,max,interval] or [B,2] = [min,max]
        split into ``num_depth`` intervals. Returns the JAX model's outputs
        dict: per stage ``depth`` and ``photometric_confidence`` [B,h,w],
        ``pair_result`` (per source view [B,h1,w1], stage 1 only) and
        ``pair_confidence`` [B,h1,w1,V-1]; the last stage's entries also at
        the top level. ``train=True`` runs the training form under autograd
        and needs the module in train mode; otherwise the inference form runs
        without gradients."""
        if not train:
            with torch.no_grad():
                return self._cascade(imgs, proj_matrices, depth_values, num_depth, False)
        if not self.training:
            raise ValueError("train=True needs the module in train mode (model.train())")
        return self._cascade(imgs, proj_matrices, depth_values, num_depth, True)

    def _cascade(self, imgs, proj_matrices, depth_values, num_depth, train: bool) -> dict:
        dtype = self.feature.out1.weight.dtype
        dmin, dmax, interval = parse_depth_values(depth_values.float(), num_depth)
        B, V = imgs.shape[:2]
        Vs = V - 1
        feats = self.feature(imgs.reshape((B * V,) + imgs.shape[2:]).permute(0, 3, 1, 2).to(dtype))
        corr_fn = corr_sweep_volume_t if train else corr_sweep_volume
        fused_fn = fused_sweep_volume_t if train else fused_sweep_volume

        outputs: dict = {}
        prev_depth = pair_conf = None
        for si, D in enumerate(self.ndepths):
            key = f"stage{si + 1}"
            net = self.DepthNet[si]
            f = feats[key]
            C, h, w = f.shape[1:]
            f = f.reshape(B, V, C, h, w).permute(0, 1, 3, 4, 2)  # [B,V,h,w,C]
            ref = f[:, 0].contiguous()
            srcs = f[:, 1:].transpose(0, 1).contiguous()  # [Vs,B,h,w,C]
            projs = proj_matrices[key].float()
            ref_proj, src_projs = projs[:, 0], projs[:, 1:].transpose(0, 1)

            pair_results: tuple = ()
            if si == 0:
                lo = dmin[:, None, None].expand(B, h, w).contiguous()
                step = ((dmax - dmin) / (D - 1))[:, None, None].expand(B, h, w).contiguous()
                hyp0 = uniform_depth_samples(torch.stack([dmin, dmax], dim=1), D)  # [B,D]
                corr = corr_fn(ref, srcs, src_projs, ref_proj, lo, step, D).to(dtype)
                if train:  # per view, so BatchNorm takes each view's batch statistics
                    logits = torch.cat([net.reg(corr[v]) for v in range(Vs)]).float()
                else:
                    logits = net.reg(corr.reshape(Vs * B, D, h, w)).float()
                prob = torch.softmax(logits, dim=1)  # rows v*B + b
                conf = prob.amax(dim=1).reshape(Vs, B, h, w)
                pdepth = (prob * hyp0.repeat(Vs, 1)[:, :, None, None]).sum(dim=1)
                pair_conf = conf.transpose(0, 1).contiguous()  # [B,Vs,h,w]
                pair_results = tuple(pdepth.reshape(Vs, B, h, w))
                weights = pair_conf
            else:
                weights = F.interpolate(pair_conf, size=(h, w), mode="bilinear",
                                        align_corners=False)
                ratio = self.depth_intervals_ratio[si]
                lo, step = window_min_and_interval(prev_depth, D, (ratio * interval)[:, None, None])

            fused = fused_fn(ref, srcs, weights, src_projs, ref_proj, lo, step, D)
            # K3 has no backward: training steps the cell under autograd
            cost = (red_scan_ref if train else red_scan)(net.reg_fuse, fused)
            oh, ow = cost.shape[2:]  # [D,B,oh,ow]
            depth, conf = softmax_regression(
                cost, resize_bilinear(lo, oh, ow), resize_bilinear(step, oh, ow)
            )
            outputs[key] = {
                "depth": depth,
                "photometric_confidence": conf,
                "pair_result": pair_results,
                "pair_confidence": pair_conf.permute(0, 2, 3, 1),
            }
            prev_depth = depth

        outputs.update(outputs[f"stage{len(self.ndepths)}"])
        return outputs

