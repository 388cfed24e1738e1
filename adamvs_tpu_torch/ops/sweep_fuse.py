"""Plane-sweep cost volumes: kernels K1 (corr), K2 (fused) and K4 (var), their
training forms with the backward kernel K5, and their plain versions.

Counterpart of ``adamvs_tpu/ops/sweep_fuse.py``. The JAX package builds these
volumes with one Pallas kernel (``_sweep_kernel``); here they are the CUDA
kernels of ``csrc/sweep_fuse.cu`` (see the note there). The
plain versions are built from ``ops/warp.py::plane_sweep_warp`` and compute in
float32, like the exact forms ``_xla_corr_volume``, ``_xla_fused_volume`` and
``_xla_var_volume`` they mirror.

Layouts: features are NHWC at this boundary, as in the JAX package (ref
[B,h,w,C], sources [Vs,B,h,w,C]); the corr volume is [Vs,B,D,h,w] (depth as
channels, what the stage-1 ``CostRegNet2D`` reads); the fused and variance
volumes are [D,B,C,h,w] (what the K3 regulariser and MS-REDNet's ``RedCell``
read one depth slice at a time). Visibility weights are [B,Vs,h,w].

The training forms ``corr_sweep_volume_t``, ``fused_sweep_volume_t`` and
``var_sweep_volume_t`` (``adamvs_tpu/ops/sweep_fuse.py:786-908``) are
autograd Functions: forward through K1/K2/K4, backward through K5
(``csrc/sweep_bwd.cu``), whose plain version is the autograd VJP of the
plain forms, the JAX "recompute-by-gather". Gradients reach ref, the sources
and the weights; the projections, ``lo`` and ``step`` get none, as the
sample positions carry no gradient (JAX gives them zeros).

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
    return fused_volume_wn(ref, srcs, normalize_weights(weights), src_projs, ref_proj, lo, step,
                           num_depth, block)


def fused_volume_wn(ref, srcs, wn, src_projs, ref_proj, lo, step, num_depth: int,
                    block: int = 8):
    """``fused_volume_ref`` on weights ``wn`` [B,Vs,h,w] that are normalised
    already."""
    Vs, B = srcs.shape[:2]
    h, w, C = ref.shape[1:4]
    ref32 = ref.float()
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
        "fused": build.bind(lib, "adamvs_fused_sweep", n_ptr=8, n_int=9),
        "var": build.bind(lib, "adamvs_var_sweep", n_ptr=7, n_int=9),
    }


@functools.cache
def _bwd_entries():
    lib = build.load_library("sweep_bwd")
    return lib, {
        "corr": build.bind(lib, "adamvs_corr_sweep_bwd", n_ptr=8, n_int=9),
        "fused": build.bind(lib, "adamvs_fused_sweep_bwd", n_ptr=10, n_int=9),
        "var": build.bind(lib, "adamvs_var_sweep_bwd", n_ptr=8, n_int=9),
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
    if ref.data_ptr() % 16 or srcs.data_ptr() % 16:
        raise ValueError("features must start on a 16-byte boundary (16-byte vector loads)")
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


def fused_sweep_volume(ref, srcs, weights, src_projs, ref_proj, lo, step, num_depth: int,
                       stats: torch.Tensor | None = None) -> torch.Tensor:
    """K2: [D,B,C,h,w] visibility-weighted volume in the feature dtype (see
    ``fused_volume_ref``). ``stats`` (see ``_stats_ptr``) counts the kernel's
    source windows."""
    return _fused_sweep(ref, srcs, normalize_weights(weights), src_projs, ref_proj, lo, step,
                        num_depth, stats)


fused_sweep_volume.launches = 0


def _check_weights(wn, Vs, B, h, w, device):
    if Vs > _MAX_VIEWS or tuple(wn.shape) != (B, Vs, h, w) or wn.device != device:
        raise ValueError(f"weights must be [B,Vs,h,w] with Vs <= {_MAX_VIEWS} on the features' "
                         f"device, got {tuple(wn.shape)} on {wn.device}")
    if wn.dtype != torch.float32:
        raise ValueError(f"normalised weights must be float32, got {wn.dtype}")


def _stats_ptr(stats, device) -> int:
    """The pointer of an optional int32 [2] CUDA tensor to which a K2 or K4
    launch adds, per (block, source view), 1 to ``stats[0]`` and, where the
    view's source window exceeded the block's shared memory and its taps were
    gathered from device memory, 1 to ``stats[1]``; 0 (none) for None."""
    if stats is None:
        return 0
    if stats.dtype != torch.int32 or tuple(stats.shape) != (2,) or stats.device != device:
        raise ValueError(f"stats must be int32 [2] on {device}")
    return stats.data_ptr()


def _fused_sweep(ref, srcs, wn, src_projs, ref_proj, lo, step, num_depth: int,
                 stats: torch.Tensor | None = None) -> torch.Tensor:
    """K2 on normalised weights ``wn`` [B,Vs,h,w] float32."""
    if ref.device.type == "cpu":
        return fused_volume_wn(ref, srcs, wn, src_projs, ref_proj, lo, step, num_depth)
    Vs, B, H, W, C, h, w = _check_inputs(ref, srcs, src_projs, ref_proj, lo, step)
    _check_weights(wn, Vs, B, h, w, ref.device)
    geom = sweep_geometry(src_projs, ref_proj)
    wn = wn.contiguous()
    out = torch.empty((num_depth, B, C, h, w), dtype=ref.dtype, device=ref.device)
    lib, fns = _entries()
    err = fns["fused"](_DTYPE_CODE[ref.dtype], Vs, B, h, w, H, W, C, num_depth,
                       ref.data_ptr(), srcs.data_ptr(), geom.data_ptr(), lo.data_ptr(),
                       step.data_ptr(), wn.data_ptr(), out.data_ptr(),
                       _stats_ptr(stats, ref.device),
                       torch.cuda.current_stream(ref.device).cuda_stream)
    build.check(lib, err, "fused_sweep_volume")
    fused_sweep_volume.launches += 1
    return out


def var_sweep_volume(ref, srcs, src_projs, ref_proj, lo, step, num_depth: int,
                     stats: torch.Tensor | None = None) -> torch.Tensor:
    """K4: [D,B,C,h,w] variance volume in the feature dtype (see
    ``var_volume_ref``). ``stats`` as for K2 (``_stats_ptr``)."""
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
                     step.data_ptr(), out.data_ptr(), _stats_ptr(stats, ref.device),
                     torch.cuda.current_stream(ref.device).cuda_stream)
    build.check(lib, err, "var_sweep_volume")
    var_sweep_volume.launches += 1
    return out


var_sweep_volume.launches = 0


# --- K5: the training forms ----------------------------------------------------

def _vjp(fn, g, *inputs):
    """Gradients of ``sum(fn(*inputs) * g)`` with respect to ``inputs``: the
    plain K5 backward, autograd through a plain form recomputed at the
    inputs' values in float32, each gradient rounded once to its input's
    dtype at the end."""
    with torch.enable_grad():
        xs = [x.detach().float().requires_grad_() for x in inputs]
        out = fn(*xs)
        grads = torch.autograd.grad(out, xs, g.to(out.dtype))
    return tuple(d.to(x.dtype) for d, x in zip(grads, inputs))


def corr_volume_vjp(g, ref, srcs, src_projs, ref_proj, lo, step):
    """Plain K5, corr: (d ref, d srcs) for the cotangent ``g`` [Vs,B,D,h,w]
    of ``corr_volume_ref``."""
    return _vjp(lambda r, s: corr_volume_ref(r, s, src_projs, ref_proj, lo, step, g.shape[2]),
                g, ref, srcs)


def fused_volume_vjp(g, ref, srcs, wn, src_projs, ref_proj, lo, step):
    """Plain K5, fused: (d ref, d srcs, d wn) for the cotangent ``g``
    [D,B,C,h,w] of ``fused_volume_wn``."""
    return _vjp(lambda r, s, w: fused_volume_wn(r, s, w, src_projs, ref_proj, lo, step,
                                                g.shape[0]),
                g, ref, srcs, wn)


def var_volume_vjp(g, ref, srcs, src_projs, ref_proj, lo, step):
    """Plain K5, var: (d ref, d srcs) for the cotangent ``g`` [D,B,C,h,w] of
    ``var_volume_ref``."""
    return _vjp(lambda r, s: var_volume_ref(r, s, src_projs, ref_proj, lo, step, g.shape[0]),
                g, ref, srcs)


def _check_cotangent(g, shape, device):
    if tuple(g.shape) != tuple(shape) or g.device != device:
        raise ValueError(f"cotangent must be {tuple(shape)} on {device}, got "
                         f"{tuple(g.shape)} on {g.device}")


def _launch_bwd(mode, ref, srcs, src_projs, ref_proj, lo, step, g, D, *extra):
    """Run the K5 kernel of ``mode`` on zeroed float32 gradients; returns
    them: d ref [B,h,w,C], (d wn [B,Vs,h,w] for fused,) d srcs."""
    Vs, B, H, W, C, h, w = _check_inputs(ref, srcs, src_projs, ref_proj, lo, step)
    dev = ref.device
    geom = sweep_geometry(src_projs, ref_proj)
    dref = torch.zeros((B, h, w, C), dtype=torch.float32, device=dev)
    dsrc = torch.zeros((Vs, B, H, W, C), dtype=torch.float32, device=dev)
    outs = [dref, torch.zeros((B, Vs, h, w), dtype=torch.float32, device=dev)] if extra else [dref]
    lib, fns = _bwd_entries()
    err = fns[mode](_DTYPE_CODE[ref.dtype], Vs, B, h, w, H, W, C, D, g.data_ptr(),
                    ref.data_ptr(), srcs.data_ptr(), geom.data_ptr(), lo.data_ptr(),
                    step.data_ptr(), *(t.data_ptr() for t in extra),
                    *(t.data_ptr() for t in outs), dsrc.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, f"{mode}_sweep_volume_bwd")
    return (*outs, dsrc)


def corr_sweep_volume_bwd(g, ref, srcs, src_projs, ref_proj, lo, step):
    """K5, corr: (d ref, d srcs) in the primals' dtypes for the cotangent
    ``g`` [Vs,B,D,h,w] of ``corr_sweep_volume`` (see ``corr_volume_vjp``)."""
    if ref.device.type == "cpu":
        return corr_volume_vjp(g, ref, srcs, src_projs, ref_proj, lo, step)
    Vs, B, D, h, w = g.shape
    _check_cotangent(g, (srcs.shape[0], ref.shape[0], D) + tuple(ref.shape[1:3]), ref.device)
    dref, dsrc = _launch_bwd("corr", ref, srcs, src_projs, ref_proj, lo, step,
                             g.float().contiguous(), D)
    corr_sweep_volume_bwd.launches += 1
    return dref.to(ref.dtype), dsrc.to(srcs.dtype)


corr_sweep_volume_bwd.launches = 0


def fused_sweep_volume_bwd(g, ref, srcs, wn, src_projs, ref_proj, lo, step):
    """K5, fused: (d ref, d srcs, d wn) in the primals' dtypes for the
    cotangent ``g`` [D,B,C,h,w] of ``fused_sweep_volume`` on normalised
    weights ``wn`` (see ``fused_volume_vjp``)."""
    if ref.device.type == "cpu":
        return fused_volume_vjp(g, ref, srcs, wn, src_projs, ref_proj, lo, step)
    D = g.shape[0]
    B, h, w, C = ref.shape
    _check_cotangent(g, (D, B, C, h, w), ref.device)
    _check_weights(wn, srcs.shape[0], B, h, w, ref.device)
    dref, dwn, dsrc = _launch_bwd("fused", ref, srcs, src_projs, ref_proj, lo, step,
                                  g.to(ref.dtype).contiguous(), D, wn.contiguous())
    fused_sweep_volume_bwd.launches += 1
    return dref.to(ref.dtype), dsrc.to(srcs.dtype), dwn


fused_sweep_volume_bwd.launches = 0


def var_sweep_volume_bwd(g, ref, srcs, src_projs, ref_proj, lo, step):
    """K5, var: (d ref, d srcs) in the primals' dtypes for the cotangent ``g``
    [D,B,C,h,w] of ``var_sweep_volume`` (see ``var_volume_vjp``)."""
    if ref.device.type == "cpu":
        return var_volume_vjp(g, ref, srcs, src_projs, ref_proj, lo, step)
    D = g.shape[0]
    B, h, w, C = ref.shape
    _check_cotangent(g, (D, B, C, h, w), ref.device)
    if srcs.shape[0] > _MAX_VIEWS:
        raise ValueError(f"var_sweep_volume_bwd takes at most {_MAX_VIEWS} source views")
    dref, dsrc = _launch_bwd("var", ref, srcs, src_projs, ref_proj, lo, step,
                             g.to(ref.dtype).contiguous(), D)
    var_sweep_volume_bwd.launches += 1
    return dref.to(ref.dtype), dsrc.to(srcs.dtype)


var_sweep_volume_bwd.launches = 0


class _CorrSweepT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ref, srcs, src_projs, ref_proj, lo, step, num_depth):
        ctx.save_for_backward(ref, srcs, src_projs, ref_proj, lo, step)
        return corr_sweep_volume(ref, srcs, src_projs, ref_proj, lo, step, num_depth)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        dref, dsrcs = corr_sweep_volume_bwd(g, *ctx.saved_tensors)
        return dref, dsrcs, None, None, None, None, None


class _FusedSweepT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ref, srcs, wn, src_projs, ref_proj, lo, step, num_depth):
        ctx.save_for_backward(ref, srcs, wn, src_projs, ref_proj, lo, step)
        return _fused_sweep(ref, srcs, wn, src_projs, ref_proj, lo, step, num_depth)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        dref, dsrcs, dwn = fused_sweep_volume_bwd(g, *ctx.saved_tensors)
        return dref, dsrcs, dwn, None, None, None, None, None


class _VarSweepT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ref, srcs, src_projs, ref_proj, lo, step, num_depth):
        ctx.save_for_backward(ref, srcs, src_projs, ref_proj, lo, step)
        return var_sweep_volume(ref, srcs, src_projs, ref_proj, lo, step, num_depth)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        dref, dsrcs = var_sweep_volume_bwd(g, *ctx.saved_tensors)
        return dref, dsrcs, None, None, None, None, None


def corr_sweep_volume_t(ref, srcs, src_projs, ref_proj, lo, step, num_depth: int):
    """Differentiable ``corr_sweep_volume`` (K1 forward, K5 backward)."""
    return _CorrSweepT.apply(ref, srcs, src_projs, ref_proj, lo, step, num_depth)


def fused_sweep_volume_t(ref, srcs, weights, src_projs, ref_proj, lo, step, num_depth: int):
    """Differentiable ``fused_sweep_volume`` (K2 forward, K5 backward). The
    weight normalisation stays in plain autograd, so the gradient reaches the
    raw ``weights`` [B,Vs,h,w]."""
    return _FusedSweepT.apply(ref, srcs, normalize_weights(weights), src_projs, ref_proj, lo,
                              step, num_depth)


def var_sweep_volume_t(ref, srcs, src_projs, ref_proj, lo, step, num_depth: int):
    """Differentiable ``var_sweep_volume`` (K4 forward, K5 backward)."""
    return _VarSweepT.apply(ref, srcs, src_projs, ref_proj, lo, step, num_depth)
