"""Evaluation metrics (counterpart of adamvs_tpu/train/metrics.py).

Each is computed per image over its mask and averaged over the batch:

- ``abs_depth_error``: mean |error| over the masked pixels whose error is
  below ``threshold`` (100 intervals where ``eval_metrics`` calls it);
- ``threshold_metric``: the fraction of masked pixels with |error| < ``thres``;
- ``interval_metric``: the fraction with |error| / interval < ``k``.

An image with an empty mask contributes 0.
"""

from __future__ import annotations

import torch


def _per_image_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean per image: values/mask [B,H,W] -> [B]."""
    m = mask.to(values.dtype)
    return (values * m).sum(dim=(1, 2)) / m.sum(dim=(1, 2)).clamp(min=1.0)


def abs_depth_error(depth_est, depth_gt, mask, threshold) -> torch.Tensor:
    diff = (depth_est - depth_gt).abs()
    return _per_image_mean(diff, mask & (diff < threshold)).mean()


def threshold_metric(depth_est, depth_gt, mask, thres) -> torch.Tensor:
    err = (depth_est - depth_gt).abs()
    return _per_image_mean((err < thres).float(), mask).mean()


def interval_metric(depth_est, depth_gt, interval, mask, k) -> torch.Tensor:
    err = (depth_est - depth_gt).abs() / interval
    return _per_image_mean((err < k).float(), mask).mean()


def eval_metrics(depth_est, depth_gt, mask, depth_interval) -> dict[str, torch.Tensor]:
    """The metric set of the evaluation step, with ``depth_interval`` [B]."""
    interval = depth_interval.reshape(-1, 1, 1)
    m = mask > 0.5
    return {
        "abs_depth_error": abs_depth_error(depth_est, depth_gt, m, 100.0 * interval),
        "thres1interval_error": threshold_metric(depth_est, depth_gt, m, 1.0 * interval),
        "thres6interval_error": threshold_metric(depth_est, depth_gt, m, 6.0 * interval),
        "thres3interval_error": interval_metric(depth_est, depth_gt, interval, m, 3.0),
    }
