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
as the JAX ``pallas2bf16`` operand mode does for a bf16 model. With
``out_dtype=torch.float32`` a bf16 map is sampled into float32 instead, as
``pallas2bf16`` does for a float32 model whose features it rounds to bf16
(adamvs_tpu/ops/warp_pallas2.py:190-194, 221-222); the TPU kernel's bf16
rounding of the hat weights inside its matmul is a TPU artefact, not copied.

The gradient with respect to the features (the coordinates carry none, as
the JAX warp stops them, ``adamvs_tpu/ops/warp.py:134-135``) is K6/K7-bwd,
the second kernel of ``csrc/bilinear_sample.cu``: ``sample_bilinear`` on CUDA
tensors is an autograd Function whose backward launches it
(``sample_bilinear_bwd``). Its plain version is autograd through
``ops/warp.py::bilinear_sample`` (``sample_bilinear_bwd_ref``).

A wrapper takes the plain version for CPU tensors. For CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from ..kernels import build
from .warp import bilinear_sample, pad_channels, sweep_coords

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's forms by (feature dtype, output dtype)
_SAMPLE_CODE = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
                (torch.bfloat16, torch.float32): 2}


def sample_width(C: int) -> int:
    """The padded width the kernel samples for ``C`` channels: ``C`` rounded
    up to a multiple of 8 (its rows move as 16-byte vectors; it takes them in
    channel groups of 32, 16 or 8). Raises ``ValueError`` below 1."""
    if C < 1:
        raise ValueError(f"the sampler takes any C >= 1, got C {C}")
    return -(-C // 8) * 8


def sample_bilinear_ref(feat: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain K6/K7: ``feat`` [B,H,W,C] sampled at (u, v) [B,N,h,w] with zeros
    padding, in float32, cast to ``out_dtype`` (the feature dtype unless
    given): [B,N,h,w,C]."""
    return bilinear_sample(feat.float(), u.float(), v.float()).to(out_dtype or feat.dtype)


def sample_bilinear_bwd_ref(dout: torch.Tensor, u: torch.Tensor, v: torch.Tensor, H: int,
                            W: int) -> torch.Tensor:
    """Plain K6/K7-bwd: the gradient of ``sample_bilinear_ref`` with respect
    to an [B,H,W,C] feature map for the cotangent ``dout`` [B,N,h,w,C], the
    coordinates detached: autograd of ``ops/warp.py::bilinear_sample`` in
    float32, cast to the dtype of ``dout``."""
    B, C = dout.shape[0], dout.shape[-1]
    with torch.enable_grad():
        feat = torch.zeros((B, H, W, C), dtype=torch.float32, device=dout.device,
                           requires_grad=True)
        out = bilinear_sample(feat, u.detach().float(), v.detach().float())
        (grad,) = torch.autograd.grad(out, feat, dout.float())
    return grad.to(dout.dtype)


@functools.cache
def _entry():
    lib = build.load_library("bilinear_sample")
    return lib, build.bind(lib, "adamvs_bilinear_sample", n_ptr=4, n_int=8)


@functools.cache
def _bwd_entry():
    lib = build.load_library("bilinear_sample")
    return lib, build.bind(lib, "adamvs_bilinear_sample_bwd", n_ptr=4, n_int=8)


def _check_coords(B: int, u: torch.Tensor, v: torch.Tensor, device) -> None:
    if u.ndim != 4 or u.shape[0] != B or u.shape != v.shape:
        raise ValueError(f"u and v must be [B,N,h,w] alike, got {tuple(u.shape)} {tuple(v.shape)}")
    if u.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(f"u and v must be float32, got {u.dtype} {v.dtype}")
    for t in (u, v):
        if t.device != device or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous and on one device")


def _launch(feat: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    """K6/K7 on CUDA tensors; raises on what the kernel does not take."""
    B, H, W, C = feat.shape
    Cp = sample_width(C)
    code = _SAMPLE_CODE.get((feat.dtype, out_dtype))
    if code is None:
        raise ValueError(f"feat must be float32/bfloat16 [B,H,W,C] sampled into its own dtype "
                         f"or bfloat16 into float32, got {feat.dtype} {tuple(feat.shape)} into "
                         f"{out_dtype}")
    _check_coords(B, u, v, feat.device)
    if not feat.is_contiguous():
        raise ValueError("kernel inputs must be contiguous and on one device")
    if feat.data_ptr() % 16:
        raise ValueError("feat must be 16-byte aligned (its rows are read as 16-byte vectors)")
    N, h, w = u.shape[1:]
    feat = pad_channels(feat, Cp)
    out = torch.empty((B, N, h, w, Cp), dtype=out_dtype, device=feat.device)
    lib, fn = _entry()
    err = fn(code, B, N, h, w, H, W, Cp, feat.data_ptr(), u.data_ptr(),
             v.data_ptr(), out.data_ptr(), torch.cuda.current_stream(feat.device).cuda_stream)
    build.check(lib, err, "sample_bilinear")
    sample_bilinear.launches += 1
    return out if Cp == C else out[..., :C].contiguous()


def sample_bilinear_bwd(dout: torch.Tensor, u: torch.Tensor, v: torch.Tensor, H: int,
                        W: int) -> torch.Tensor:
    """K6/K7-bwd: the gradient [B,H,W,C] of ``sample_bilinear`` with respect
    to its features, in the dtype of ``dout`` [B,N,h,w,C] (see
    ``sample_bilinear_bwd_ref``). The kernel sums into a zeroed float32 map
    with atomics; a ``dout`` that is no multiple of 8 channels wide is
    zero-padded and the padding's gradient dropped."""
    if dout.device.type == "cpu":
        return sample_bilinear_bwd_ref(dout, u, v, H, W)
    if dout.device.type != "cuda":
        raise ValueError(f"sample_bilinear_bwd takes CUDA tensors, got {dout.device}")
    if dout.dtype not in _DTYPE_CODE or dout.ndim != 5:
        raise ValueError(f"dout must be float32/bfloat16 [B,N,h,w,C], got {dout.dtype} "
                         f"{tuple(dout.shape)}")
    B, N, h, w, C = dout.shape
    _check_coords(B, u, v, dout.device)
    if u.shape[1:] != (N, h, w):
        raise ValueError(f"u {tuple(u.shape)} does not match dout {tuple(dout.shape)}")
    Cp = sample_width(C)
    dout = pad_channels(dout.contiguous(), Cp)
    dfeat = torch.zeros((B, H, W, Cp), dtype=torch.float32, device=dout.device)
    lib, fn = _bwd_entry()
    err = fn(_DTYPE_CODE[dout.dtype], B, N, h, w, H, W, Cp, dout.data_ptr(), u.data_ptr(),
             v.data_ptr(), dfeat.data_ptr(), torch.cuda.current_stream(dout.device).cuda_stream)
    build.check(lib, err, "sample_bilinear_bwd")
    sample_bilinear_bwd.launches += 1
    dfeat = dfeat if Cp == C else dfeat[..., :C]
    return dfeat.to(dout.dtype)


sample_bilinear_bwd.launches = 0


class _SampleBilinear(torch.autograd.Function):
    """K6/K7 forward, K6/K7-bwd backward; no gradient for the coordinates."""

    @staticmethod
    def forward(ctx, feat, u, v, out_dtype):
        ctx.save_for_backward(u, v)
        ctx.hw, ctx.dtype = feat.shape[1:3], feat.dtype
        return _launch(feat.contiguous(), u, v, out_dtype)

    @staticmethod
    def backward(ctx, dout):
        u, v = ctx.saved_tensors
        # the bf16-in, float32-out form's gradient is its float32 instance, rounded once
        return sample_bilinear_bwd(dout, u, v, *ctx.hw).to(ctx.dtype), None, None, None


def sample_bilinear(feat: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """K6/K7: [B,N,h,w,C] in ``out_dtype``, the feature dtype unless given
    (see ``sample_bilinear_ref``; on the card a bf16 map samples into bf16 or
    float32, a float32 map into float32), differentiable with respect to
    ``feat`` (K6/K7-bwd on the card)."""
    out_dtype = out_dtype or feat.dtype
    if feat.device.type == "cpu":
        return sample_bilinear_ref(feat, u.detach(), v.detach(), out_dtype)
    if feat.device.type != "cuda":
        raise ValueError(f"sample_bilinear takes CUDA tensors, got {feat.device}")
    if torch.is_grad_enabled() and feat.requires_grad:
        return _SampleBilinear.apply(feat, u.detach(), v.detach(), out_dtype)
    return _launch(feat, u, v, out_dtype)


sample_bilinear.launches = 0


def plane_sweep_warp_sampled(src, src_proj, ref_proj, depth, grid_hw=None,
                             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``ops/warp.py::plane_sweep_warp`` with the sampling through K6/K7:
    the coordinates in plain PyTorch, as the JAX wrappers compute them in XLA
    (warp_pallas2.py:339-342). Returns [B,D,H,W,C] in ``out_dtype``, the
    feature dtype unless given."""
    return sample_bilinear(src, *sweep_coords(src, src_proj, ref_proj, depth, grid_hw),
                           out_dtype=out_dtype)
