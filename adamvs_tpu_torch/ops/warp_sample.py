"""Bilinear sampling at given pixel coordinates: kernel K6/K7 and its plain
version.

Counterpart of ``adamvs_tpu/ops/warp_pallas2.py`` (K6,
``banded_bilinear_sample_pallas2``) and ``adamvs_tpu/ops/warp_pallas.py`` (K7,
``banded_bilinear_sample_pallas``): two TPU layouts of one function, served
here by the one CUDA kernel of ``csrc/bilinear_sample.cu``. The TPU kernels'
band truncation (a tap outside the band reads as zero) is not copied: the
kernel is exact everywhere, as ``ops/warp.py::bilinear_sample`` is.

Sampling runs in float32 and the result is in the feature dtype: a bf16
feature map is sampled from its bf16 values with float32 weights and sums,
as the JAX ``pallas2bf16`` operand mode does for a bf16 model.

A wrapper takes the plain version for CPU tensors. For CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from ..kernels import build
from .warp import bilinear_sample, pad_channels, sweep_coords

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def sample_width(C: int) -> int:
    """The padded width the kernel samples for ``C`` channels: ``C`` rounded
    up to a multiple of 8 (its rows move as 16-byte vectors; it takes them in
    channel groups of 32, 16 or 8). Raises ``ValueError`` below 1."""
    if C < 1:
        raise ValueError(f"the sampler takes any C >= 1, got C {C}")
    return -(-C // 8) * 8


def sample_bilinear_ref(feat: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain K6/K7: ``feat`` [B,H,W,C] sampled at (u, v) [B,N,h,w] with zeros
    padding, in float32, cast to the feature dtype: [B,N,h,w,C]."""
    return bilinear_sample(feat.float(), u.float(), v.float()).to(feat.dtype)


@functools.cache
def _entry():
    lib = build.load_library("bilinear_sample")
    return lib, build.bind(lib, "adamvs_bilinear_sample", n_ptr=4, n_int=8)


def sample_bilinear(feat: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K6/K7: [B,N,h,w,C] in the feature dtype (see ``sample_bilinear_ref``)."""
    if feat.device.type == "cpu":
        return sample_bilinear_ref(feat, u, v)
    if feat.device.type != "cuda":
        raise ValueError(f"sample_bilinear takes CUDA tensors, got {feat.device}")
    B, H, W, C = feat.shape
    Cp = sample_width(C)
    if feat.dtype not in _DTYPE_CODE:
        raise ValueError(f"feat must be float32/bfloat16 [B,H,W,C], got {feat.dtype} "
                         f"{tuple(feat.shape)}")
    if u.ndim != 4 or u.shape[0] != B or u.shape != v.shape:
        raise ValueError(f"u and v must be [B,N,h,w] alike, got {tuple(u.shape)} {tuple(v.shape)}")
    for t in (feat, u, v):
        if t.device != feat.device or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous and on one device")
    if u.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(f"u and v must be float32, got {u.dtype} {v.dtype}")
    if feat.data_ptr() % 16:
        raise ValueError("feat must be 16-byte aligned (its rows are read as 16-byte vectors)")
    N, h, w = u.shape[1:]
    feat = pad_channels(feat, Cp)
    out = torch.empty((B, N, h, w, Cp), dtype=feat.dtype, device=feat.device)
    lib, fn = _entry()
    err = fn(_DTYPE_CODE[feat.dtype], B, N, h, w, H, W, Cp, feat.data_ptr(), u.data_ptr(),
             v.data_ptr(), out.data_ptr(), torch.cuda.current_stream(feat.device).cuda_stream)
    build.check(lib, err, "sample_bilinear")
    sample_bilinear.launches += 1
    return out if Cp == C else out[..., :C].contiguous()


sample_bilinear.launches = 0


def plane_sweep_warp_sampled(src, src_proj, ref_proj, depth, grid_hw=None) -> torch.Tensor:
    """``ops/warp.py::plane_sweep_warp`` with the sampling through K6/K7:
    the coordinates in plain PyTorch, as the JAX wrappers compute them in XLA
    (warp_pallas2.py:339-342). Returns [B,D,H,W,C] in the feature dtype."""
    return sample_bilinear(src, *sweep_coords(src, src_proj, ref_proj, depth, grid_hw))
