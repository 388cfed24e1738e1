"""Plane-sweep homography warping (plain PyTorch).

Counterpart of ``adamvs_tpu/ops/warp.py``, with the same semantics:

- relative transform ``P = src_proj @ inv(ref_proj)`` in float32, or with
  ``grid_dtype=torch.float64`` the transform and the coordinates in float64
  (the reference's ``homo_warping_double``, module.py:571-612, for long focal
  lengths where float32 pixel coordinates lose ulps), cast back to the
  features' dtype before sampling;
- reference pixel (x, y) back-projected at depth d: ``p = R·[x,y,1]·d + t``;
- samples with ``z <= 1e-6`` (behind the camera) are pushed to -1e9 so the
  zeros padding drops them;
- bilinear sampling at unnormalised pixel coordinates, zeros padding, a tap
  valid only when ``0 <= xi <= W-1`` and ``0 <= yi <= H-1``;
- the sampling grid carries no gradient.

Layout is NHWC, as in the JAX package; outputs are [B, D, H, W, C].
"""

from __future__ import annotations

import torch


def warp_transform(src_proj: torch.Tensor, ref_proj: torch.Tensor, dtype=torch.float32):
    """rot [...,3,3], trans [...,3] of the ref->src pixel-space transform,
    computed in ``dtype``."""
    proj = src_proj.to(dtype) @ torch.linalg.inv(ref_proj.to(dtype))
    return proj[..., :3, :3], proj[..., :3, 3]


def view_transforms(src_projs: torch.Tensor, ref_proj: torch.Tensor):
    """The ``warp_transform`` of each source view, stacked in the batch axis:
    rot [Vs·B,3,3] and trans [Vs·B,3] (row v·B + b) for ``src_projs``
    [Vs,B,4,4] and ``ref_proj`` [B,4,4], each view's the same matrix as its
    own call gives. The scan forms compute them once per stage and sample
    every view of a hypothesis slice in one call."""
    rots, trans = zip(*(warp_transform(p, ref_proj) for p in src_projs))
    return torch.cat(rots), torch.cat(trans)


def _source_coords(rot, trans, depth, height: int, width: int):
    """(u, v) source pixel coordinates, each [B,D,H,W], in the dtype of
    ``rot``. ``depth`` is [B,D] (fronto-parallel planes) or [B,D,H,W]."""
    dev = rot.device
    x = torch.arange(width, dtype=rot.dtype, device=dev)
    y = torch.arange(height, dtype=rot.dtype, device=dev)
    rx = rot[:, :, 0][:, :, None, None] * x[None, None, None, :]
    ry = rot[:, :, 1][:, :, None, None] * y[None, None, :, None]
    rot_xyz = rx + ry + rot[:, :, 2][:, :, None, None]  # [B,3,H,W]
    if depth.ndim == 2:
        d = depth[:, None, :, None, None]
    else:
        d = depth[:, None]
    p = rot_xyz[:, :, None] * d + trans[:, :, None, None, None]  # [B,3,D,H,W]
    z = p[:, 2]
    safe = z > 1e-6
    z = torch.where(safe, z, torch.ones_like(z))
    far = torch.full_like(z, -1e9)
    u = torch.where(safe, p[:, 0] / z, far)
    v = torch.where(safe, p[:, 1] / z, far)
    return u, v


def bilinear_sample(feat: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample ``feat`` [B,H,W,C] at pixel coords (u, v) [B,...] with
    zeros padding. Returns [B, ..., C]."""
    B, H, W, C = feat.shape
    out_shape = u.shape[1:]
    u = u.reshape(B, -1)
    v = v.reshape(B, -1)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    flat = feat.reshape(B, H * W, C)
    bidx = torch.arange(B, device=feat.device)[:, None]

    def tap(xi, yi, w):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xi_c = xi.clamp(0, W - 1).long()
        yi_c = yi.clamp(0, H - 1).long()
        vals = flat[bidx, yi_c * W + xi_c]  # [B,N,C]
        return vals * (w * valid)[..., None]

    out = (
        tap(u0, v0, (1 - du) * (1 - dv))
        + tap(u0 + 1, v0, du * (1 - dv))
        + tap(u0, v0 + 1, (1 - du) * dv)
        + tap(u0 + 1, v0 + 1, du * dv)
    )
    return out.reshape((B,) + tuple(out_shape) + (C,))


def sweep_coords(
    src_feat: torch.Tensor,  # [B,Hs,Ws,C]
    src_proj: torch.Tensor,  # [B,4,4]
    ref_proj: torch.Tensor,  # [B,4,4]
    depth: torch.Tensor,  # [B,D] or [B,D,H,W]
    grid_hw: tuple[int, int] | None = None,
    grid_dtype: torch.dtype | None = None,
):
    """(u, v) [B,D,H,W], detached: where each reference pixel lands in the
    source at each depth. The reference grid (H, W) comes from a per-pixel
    ``depth``, else from ``grid_hw``, else from the source shape. The
    coordinates are float32, or with ``grid_dtype`` computed in it and cast
    to the features' dtype."""
    if depth.ndim == 4:
        H, W = depth.shape[2:4]
    elif grid_hw is not None:
        H, W = grid_hw
    else:
        H, W = src_feat.shape[1:3]
    dtype = grid_dtype or torch.float32
    rot, trans = warp_transform(src_proj, ref_proj, dtype)
    u, v = _source_coords(rot, trans, depth.to(dtype), H, W)
    if grid_dtype is not None:
        u, v = u.to(src_feat.dtype), v.to(src_feat.dtype)
    return u.detach(), v.detach()


def plane_sweep_warp(src_feat, src_proj, ref_proj, depth, grid_hw=None,
                     grid_dtype=None) -> torch.Tensor:
    """Warp source features to the reference frustum. Returns [B,D,H,W,C]
    in the features' dtype (see ``sweep_coords`` for the grid)."""
    return bilinear_sample(src_feat, *sweep_coords(src_feat, src_proj, ref_proj, depth, grid_hw,
                                                   grid_dtype))


def pad_channels(x: torch.Tensor, Cp: int, dim: int = -1) -> torch.Tensor:
    """``x`` zero-padded along ``dim`` to ``Cp`` channels (``x`` itself when
    it has them): the kernels' channel widths (``ops/sweep_fuse.py::
    sweep_plan``, ``ops/warp_sample.py::sample_width``)."""
    C = x.shape[dim]
    if C == Cp:
        return x
    pad = list(x.shape)
    pad[dim] = Cp - C
    return torch.cat([x, x.new_zeros(pad)], dim=dim)
