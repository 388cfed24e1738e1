"""Cascade depth-hypothesis samplers (counterpart of adamvs_tpu/ops/sampling.py).

Stage 1 samples uniformly over [min, max]; a later stage samples a per-pixel
window around the previous depth, ``lo = prev - D/2·Δ``, with spacing
``D·Δ/(D-1)`` and no clamping to the depth range.
"""

from __future__ import annotations

import torch


def uniform_depth_samples(depth_range: torch.Tensor, ndepth: int) -> torch.Tensor:
    """depth_range [B,2] = [min,max] -> [B,D] uniform hypotheses."""
    lo = depth_range[:, 0]
    hi = depth_range[:, 1]
    step = (hi - lo) / (ndepth - 1)
    i = torch.arange(ndepth, dtype=torch.float32, device=depth_range.device)
    return lo[:, None] + i[None, :] * step[:, None]


def window_min_and_interval(prev_depth: torch.Tensor, ndepth: int, interval):
    """Per-pixel window (lo, step), each shaped like ``prev_depth``:
    hypothesis i is ``lo + i * step``."""
    lo = prev_depth - ndepth / 2 * interval
    hi = prev_depth + ndepth / 2 * interval
    step = (hi - lo) / (ndepth - 1)
    return lo, step


def windowed_depth_samples(prev_depth: torch.Tensor, ndepth: int, interval) -> torch.Tensor:
    """prev_depth [B,H,W] -> [B,D,H,W] per-pixel windowed hypotheses."""
    lo, step = window_min_and_interval(prev_depth, ndepth, interval)
    i = torch.arange(ndepth, dtype=torch.float32, device=prev_depth.device)[None, :, None, None]
    return lo[:, None] + i * step[:, None]
