"""Cascade losses (counterpart of adamvs_tpu/models/losses.py).

- ``cas_mvs_vis_loss`` (Ada-MVS): per stage, the masked smooth-L1 of the
  depth, bilinearly resized to the GT's resolution, plus the mean over the
  source views of the same term on each per-view pair depth, weighted by
  ``dlossw``. The whole batch contributes, as in the JAX package.
- ``cas_rednet_loss`` (MS-REDNet): per stage, the masked smooth-L1 of the
  depth, weighted by ``dlossw``.

A masked mean over an empty mask is 0; under data parallelism it is the
global batch's (``masked_mean``). Both return (total, the last stage's depth
term).
"""

from __future__ import annotations

import torch

from ..ops.regression import resize_bilinear
from ..parallel.distributed import all_reduce_sum, data_group


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """Huber with beta 1, elementwise."""
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` where ``mask``; 0 for an empty mask. Inside
    ``parallel.data_parallel(group)`` the numerator and the denominator are
    summed over the group's ranks first (differentiably), so the mean is the
    global batch's on every rank."""
    w = mask.to(values.dtype)
    num, den = (values * w).sum(), w.sum()
    group = data_group()
    if group is not None:
        num, den = all_reduce_sum(torch.stack([num, den]), group).unbind()
    return num / den.clamp(min=1.0)


def _stage_depth_loss(depth_est, depth_gt, mask):
    est = resize_bilinear(depth_est, depth_gt.shape[-2], depth_gt.shape[-1])
    return masked_mean(smooth_l1(est - depth_gt), mask)


def _stage_keys(outputs) -> list[str]:
    return sorted(k for k in outputs if k.startswith("stage"))


def cas_mvs_vis_loss(outputs, depth_gt_ms, mask_ms, dlossw=(0.5, 1.0, 2.0)):
    """(total, last stage's depth loss) of an Ada-MVS outputs dict against
    the GT pyramid ``depth_gt_ms``/``mask_ms`` {"stageK": [B,h,w]}."""
    total = depth_loss = torch.zeros((), device=depth_gt_ms["stage1"].device)
    for key in _stage_keys(outputs):
        stage = outputs[key]
        idx = int(key.removeprefix("stage")) - 1
        gt, mask = depth_gt_ms[key], mask_ms[key] > 0.5
        depth_loss = _stage_depth_loss(stage["depth"], gt, mask)
        pair = stage.get("pair_result", ())
        pair_loss = (sum(_stage_depth_loss(p, gt, mask) for p in pair) / len(pair)
                     if pair else 0.0)
        w = dlossw[idx] if dlossw is not None else 1.0
        total = total + w * (depth_loss + pair_loss)
    return total, depth_loss


def cas_rednet_loss(outputs, depth_gt_ms, mask_ms, dlossw=(0.5, 1.0, 2.0)):
    """(total, last stage's depth loss) of an MS-REDNet outputs dict."""
    total = depth_loss = torch.zeros((), device=depth_gt_ms["stage1"].device)
    for key in _stage_keys(outputs):
        idx = int(key.removeprefix("stage")) - 1
        depth_loss = _stage_depth_loss(outputs[key]["depth"], depth_gt_ms[key],
                                       mask_ms[key] > 0.5)
        w = dlossw[idx] if dlossw is not None else 1.0
        total = total + w * depth_loss
    return total, depth_loss
