"""Soft-argmax depth regression (counterpart of adamvs_tpu/ops/regression.py).

``depth_regression`` is the full-volume form over a softmax volume.
``softmax_regression`` is the full-softmax tail the fused path runs over the
regularised cost volume (adamvs_tpu/models/adamvs.py:755-766); the online
(streamed) form carries a running max and gives the same result, and two of
its partial states merge into one (``online_softmax_merge``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``F.interpolate(mode='bilinear', align_corners=False)`` on the trailing
    two dims of an arbitrarily batched tensor (the JAX package's
    ``antialias=False`` resize)."""
    if x.shape[-2] == height and x.shape[-1] == width:
        return x
    lead = x.shape[:-2]
    y = F.interpolate(
        x.reshape((-1, 1) + tuple(x.shape[-2:])), size=(height, width),
        mode="bilinear", align_corners=False,
    )
    return y.reshape(tuple(lead) + (height, width))


def depth_regression(prob: torch.Tensor, depth_values: torch.Tensor) -> torch.Tensor:
    """Soft-argmax depth ``Σ_d p(d)·d`` [B,H,W] of the softmax volume
    ``prob`` [B,D,H,W] (module.py:617-625); ``depth_values`` [B,D] planes,
    or [B,D,h,w] maps resized bilinearly to (H, W) (``resize_bilinear``)."""
    H, W = prob.shape[2:]
    if depth_values.ndim == 2:
        dv = depth_values[:, :, None, None]
    else:
        dv = resize_bilinear(depth_values, H, W)
    return (prob * dv).sum(dim=1)


class OnlineSoftmax(NamedTuple):
    """Carried state of the streamed softmax regression."""

    m: torch.Tensor  # running max of costs
    s: torch.Tensor  # Σ exp(c - m)
    ds: torch.Tensor  # Σ depth · exp(c - m)
    pmax: torch.Tensor  # max exp(c - m)


def online_softmax_init(shape, device=None) -> OnlineSoftmax:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return OnlineSoftmax(m=torch.full_like(z, -torch.inf), s=z, ds=z.clone(), pmax=z.clone())


def online_softmax_update(state: OnlineSoftmax, cost: torch.Tensor, depth: torch.Tensor) -> OnlineSoftmax:
    """Fold in one depth slice."""
    m_new = torch.maximum(state.m, cost)
    scale = torch.exp(state.m - m_new)
    e = torch.exp(cost - m_new)
    return OnlineSoftmax(
        m=m_new,
        s=state.s * scale + e,
        ds=state.ds * scale + depth * e,
        pmax=torch.maximum(state.pmax * scale, e),
    )


def online_softmax_merge(a: OnlineSoftmax, b: OnlineSoftmax) -> OnlineSoftmax:
    """Merge two partial streams (associative and commutative), so blocks of
    depths scanned apart give the state of one scan over all of them. A
    still-empty state (``m = -inf``, an empty shard) takes scale 1 where
    ``exp(-inf - -inf)`` would be NaN."""
    m_new = torch.maximum(a.m, b.m)
    one = torch.ones((), dtype=m_new.dtype, device=m_new.device)
    sa = torch.where(a.m == m_new, one, torch.exp(a.m - m_new))
    sb = torch.where(b.m == m_new, one, torch.exp(b.m - m_new))
    return OnlineSoftmax(
        m=m_new,
        s=a.s * sa + b.s * sb,
        ds=a.ds * sa + b.ds * sb,
        pmax=torch.maximum(a.pmax * sa, b.pmax * sb),
    )


def online_softmax_finalize(state: OnlineSoftmax):
    """(depth, confidence): softmax-regressed depth and max probability."""
    s = state.s + 1e-10
    return state.ds / s, state.pmax / s


def softmax_regression(cost: torch.Tensor, lo: torch.Tensor, step: torch.Tensor):
    """Full softmax over depth of ``cost`` [D,B,h,w] with hypotheses
    ``lo + d·step`` ([B,h,w] each): max-stabilised, ``s = Σe + 1e-10``,
    depth ``Σ e·hyp / s`` and confidence ``max(e) / s``."""
    D = cost.shape[0]
    c32 = cost.float()
    m = c32.amax(dim=0)
    e = torch.exp(c32 - m)
    s = e.sum(dim=0) + 1e-10
    d_idx = torch.arange(D, dtype=torch.float32, device=cost.device)
    hyp = lo[None] + d_idx[:, None, None, None] * step[None]
    depth = (e * hyp).sum(dim=0) / s
    conf = e.amax(dim=0) / s
    return depth, conf
