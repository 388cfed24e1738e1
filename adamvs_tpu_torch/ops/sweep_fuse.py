"""Plane-sweep cost volumes: kernels K1 (corr), K2 (fused) and K4 (var) and
their plain versions.

Counterpart of ``adamvs_tpu/ops/sweep_fuse.py``. The JAX package builds these
volumes with one Pallas kernel (``_sweep_kernel``); here they are the CUDA
kernels of ``csrc/sweep_fuse.cu`` (direct gather, see the note there). The
plain versions are built from ``ops/warp.py::plane_sweep_warp`` and compute in
float32, like the exact forms ``_xla_corr_volume``, ``_xla_fused_volume`` and
``_xla_var_volume`` they mirror.

Layouts: features are NHWC at this boundary, as in the JAX package (ref
[B,h,w,C], sources [Vs,B,h,w,C]); the corr volume is [Vs,B,D,h,w] (depth as
channels, what the stage-1 ``CostRegNet2D`` reads); the fused and variance
volumes are [D,B,C,h,w] (what the K3 regulariser and MS-REDNet's ``RedCell``
read one depth slice at a time). Visibility weights are [B,Vs,h,w].

A wrapper takes the plain version for CPU tensors. For CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from ..kernels import build
from .warp import plane_sweep_warp, warp_transform

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CHANNELS = (8, 16, 32)
_MAX_VIEWS = 16


def sweep_geometry(src_projs: torch.Tensor, ref_proj: torch.Tensor) -> torch.Tensor:
    """[Vs,B,4,4] + [B,4,4] -> [Vs*B, 12] float32: the ref->src rotation
    (row-major) then translation, as ``_geom_array`` packs it."""
    rot, trans = warp_transform(src_projs, ref_proj[None])
    Vs, B = src_projs.shape[:2]
    return torch.cat([rot.reshape(Vs * B, 9), trans.reshape(Vs * B, 3)], dim=1).contiguous()


def normalize_weights(weights: torch.Tensor) -> torch.Tensor:
    """[B,Vs,h,w] visibility weights -> ``w / (1e-5 + Σ_v w)`` in float32."""
    w = weights.float()
    return w / (1e-5 + w.sum(dim=1, keepdim=True))


def _blocks(D: int, block: int):
    return [(d0, min(D, d0 + block)) for d0 in range(0, D, block)]


def _hyp(lo, step, d0, d1):
    d = torch.arange(d0, d1, dtype=torch.float32, device=lo.device)
    return lo[:, None] + d[None, :, None, None] * step[:, None]  # [B,k,h,w]


def corr_volume_ref(ref, srcs, src_projs, ref_proj, lo, step, num_depth: int, block: int = 8):
    """Plain K1: per-view channel-mean correlation [Vs,B,D,h,w] float32,
    ``mean_C(ref ⊙ warp_v(lo + d·step))``."""
    Vs, B = srcs.shape[:2]
    h, w = ref.shape[1:3]
    ref32 = ref.float()
    out = torch.empty((Vs, B, num_depth, h, w), dtype=torch.float32, device=ref.device)
    for d0, d1 in _blocks(num_depth, block):
        hyp = _hyp(lo, step, d0, d1)
        for v in range(Vs):
            warped = plane_sweep_warp(srcs[v].float(), src_projs[v], ref_proj, hyp)
            out[v, :, d0:d1] = (ref32[:, None] * warped).mean(dim=-1)
    return out


def fused_volume_ref(ref, srcs, weights, src_projs, ref_proj, lo, step, num_depth: int,
                     block: int = 8):
    """Plain K2: visibility-weighted volume [D,B,C,h,w] in the feature dtype,
    ``Σ_v w'_v (ref ⊙ warp_v(lo + d·step))`` with ``w' = normalize_weights(w)``,
    computed in float32."""
    Vs, B = srcs.shape[:2]
    h, w, C = ref.shape[1:4]
    ref32 = ref.float()
    wn = normalize_weights(weights)
    out = torch.empty((num_depth, B, C, h, w), dtype=ref.dtype, device=ref.device)
    for d0, d1 in _blocks(num_depth, block):
        hyp = _hyp(lo, step, d0, d1)
        acc = 0.0
        for v in range(Vs):
            warped = plane_sweep_warp(srcs[v].float(), src_projs[v], ref_proj, hyp)
            acc = acc + (ref32[:, None] * warped) * wn[:, v, None, :, :, None]
        out[d0:d1] = acc.permute(1, 0, 4, 2, 3)
    return out


def var_volume_ref(ref, srcs, src_projs, ref_proj, lo, step, num_depth: int, block: int = 8):
    """Plain K4: variance volume [D,B,C,h,w] in the feature dtype over the
    nv = Vs+1 views {ref, warp_1..warp_Vs} at ``lo + d·step``:
    ``sq/nv - (s/nv)²`` with ``s`` and ``sq`` summed in float32 from ref
    through the views in order."""
    Vs, B = srcs.shape[:2]
    h, w, C = ref.shape[1:4]
    nv = Vs + 1
    ref32 = ref.float()
    out = torch.empty((num_depth, B, C, h, w), dtype=ref.dtype, device=ref.device)
    for d0, d1 in _blocks(num_depth, block):
        hyp = _hyp(lo, step, d0, d1)
        s = ref32[:, None].expand(B, d1 - d0, h, w, C)
        sq = s * s
        for v in range(Vs):
            warped = plane_sweep_warp(srcs[v].float(), src_projs[v], ref_proj, hyp)
            s = s + warped
            sq = sq + warped * warped
        m = s / nv
        out[d0:d1] = (sq / nv - m * m).permute(1, 0, 4, 2, 3)
    return out


@functools.cache
def _entries():
    lib = build.load_library("sweep_fuse")
    return lib, {
        "corr": build.bind(lib, "adamvs_corr_sweep", n_ptr=6, n_int=9),
        "fused": build.bind(lib, "adamvs_fused_sweep", n_ptr=7, n_int=9),
        "var": build.bind(lib, "adamvs_var_sweep", n_ptr=6, n_int=9),
    }


def _check_inputs(ref, srcs, src_projs, ref_proj, lo, step):
    if ref.device.type != "cuda":
        raise ValueError(f"the sweep kernels take CUDA tensors, got {ref.device}")
    Vs, B, H, W, C = srcs.shape
    if ref.dtype not in _DTYPE_CODE or srcs.dtype != ref.dtype:
        raise ValueError(f"features must be float32 or bfloat16 and alike, "
                         f"got {ref.dtype}/{srcs.dtype}")
    if C not in _CHANNELS or ref.shape[0] != B or ref.shape[3] != C:
        raise ValueError(f"unsupported feature shapes ref {tuple(ref.shape)} "
                         f"srcs {tuple(srcs.shape)}")
    h, w = ref.shape[1:3]
    for t in (lo, step):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, h, w):
            raise ValueError(f"lo/step must be float32 [B,h,w], got {t.dtype} {tuple(t.shape)}")
    for t in (ref, srcs, lo, step):
        if t.device != ref.device or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous and on one device")
    if src_projs.device != ref.device or ref_proj.device != ref.device:
        raise ValueError("projections must be on the features' device")
    return Vs, B, H, W, C, h, w


def corr_sweep_volume(ref, srcs, src_projs, ref_proj, lo, step, num_depth: int) -> torch.Tensor:
    """K1: [Vs,B,D,h,w] float32 correlation volumes (see ``corr_volume_ref``)."""
    if ref.device.type == "cpu":
        return corr_volume_ref(ref, srcs, src_projs, ref_proj, lo, step, num_depth)
    Vs, B, H, W, C, h, w = _check_inputs(ref, srcs, src_projs, ref_proj, lo, step)
    geom = sweep_geometry(src_projs, ref_proj)
    out = torch.empty((Vs, B, num_depth, h, w), dtype=torch.float32, device=ref.device)
    lib, fns = _entries()
    err = fns["corr"](_DTYPE_CODE[ref.dtype], Vs, B, h, w, H, W, C, num_depth,
                      ref.data_ptr(), srcs.data_ptr(), geom.data_ptr(), lo.data_ptr(),
                      step.data_ptr(), out.data_ptr(),
                      torch.cuda.current_stream(ref.device).cuda_stream)
    build.check(lib, err, "corr_sweep_volume")
    corr_sweep_volume.launches += 1
    return out


corr_sweep_volume.launches = 0


def fused_sweep_volume(ref, srcs, weights, src_projs, ref_proj, lo, step,
                       num_depth: int) -> torch.Tensor:
    """K2: [D,B,C,h,w] visibility-weighted volume in the feature dtype (see
    ``fused_volume_ref``)."""
    if ref.device.type == "cpu":
        return fused_volume_ref(ref, srcs, weights, src_projs, ref_proj, lo, step, num_depth)
    Vs, B, H, W, C, h, w = _check_inputs(ref, srcs, src_projs, ref_proj, lo, step)
    if Vs > _MAX_VIEWS or tuple(weights.shape) != (B, Vs, h, w) or weights.device != ref.device:
        raise ValueError(f"weights must be [B,Vs,h,w] with Vs <= {_MAX_VIEWS} on the features' "
                         f"device, got {tuple(weights.shape)} on {weights.device}")
    geom = sweep_geometry(src_projs, ref_proj)
    wn = normalize_weights(weights).contiguous()
    out = torch.empty((num_depth, B, C, h, w), dtype=ref.dtype, device=ref.device)
    lib, fns = _entries()
    err = fns["fused"](_DTYPE_CODE[ref.dtype], Vs, B, h, w, H, W, C, num_depth,
                       ref.data_ptr(), srcs.data_ptr(), geom.data_ptr(), lo.data_ptr(),
                       step.data_ptr(), wn.data_ptr(), out.data_ptr(),
                       torch.cuda.current_stream(ref.device).cuda_stream)
    build.check(lib, err, "fused_sweep_volume")
    fused_sweep_volume.launches += 1
    return out


fused_sweep_volume.launches = 0


def var_sweep_volume(ref, srcs, src_projs, ref_proj, lo, step, num_depth: int) -> torch.Tensor:
    """K4: [D,B,C,h,w] variance volume in the feature dtype (see
    ``var_volume_ref``)."""
    if ref.device.type == "cpu":
        return var_volume_ref(ref, srcs, src_projs, ref_proj, lo, step, num_depth)
    Vs, B, H, W, C, h, w = _check_inputs(ref, srcs, src_projs, ref_proj, lo, step)
    if Vs > _MAX_VIEWS:
        raise ValueError(f"var_sweep_volume takes at most {_MAX_VIEWS} source views, got {Vs}")
    geom = sweep_geometry(src_projs, ref_proj)
    out = torch.empty((num_depth, B, C, h, w), dtype=ref.dtype, device=ref.device)
    lib, fns = _entries()
    err = fns["var"](_DTYPE_CODE[ref.dtype], Vs, B, h, w, H, W, C, num_depth,
                     ref.data_ptr(), srcs.data_ptr(), geom.data_ptr(), lo.data_ptr(),
                     step.data_ptr(), out.data_ptr(),
                     torch.cuda.current_stream(ref.device).cuda_stream)
    build.check(lib, err, "var_sweep_volume")
    var_sweep_volume.launches += 1
    return out


var_sweep_volume.launches = 0
