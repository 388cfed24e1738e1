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

The training forms compute the kernels' geometry (``sweep_geometry``, a
batched 4x4 inverse that waits for the card) once per forward and hand it to
the backward (the ``geom`` argument of the wrappers).

Widths: the sweeps take every C with ``128 % C == 0``, as the JAX package's
do. A launch takes 8, 16 or 32 channels, so the CUDA path pads narrower
features with zeros and runs wider ones as channel groups of 32, one launch
each (``sweep_plan``, ``run_groups``, ``merge_volumes``, ``merge_gradients``);
at the models' widths 8, 16 and 32 that is one launch on the tensors as given.

A wrapper takes the plain version for CPU tensors. For CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from ..kernels import build
from .warp import pad_channels, plane_sweep_warp, warp_transform

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_VIEWS = 16
# The channel widths the sweeps take, as JAX's merge_sources (128 % C == 0).
SWEEP_WIDTHS = (1, 2, 4, 8, 16, 32, 64, 128)
# The widest kernel launch: the kernels have instances at C 8, 16 and 32.
_LAUNCH_WIDTH = 32


def check_sweep_width(C: int) -> None:
    """Raise ``ValueError`` unless the sweeps take ``C`` channels."""
    if C not in SWEEP_WIDTHS:
        raise ValueError(f"the sweeps take C in {SWEEP_WIDTHS} (128 % C == 0, as the JAX "
                         f"package's), got C {C}")


def sweep_plan(C: int) -> tuple[int, int]:
    """(padded width, group width) of a sweep at ``C`` channels: below 8 the
    features are zero-padded to 8; past the widest launch they run as channel
    groups of that width. The kernels then launch once per group."""
    check_sweep_width(C)
    Cp = max(C, 8)
    return Cp, min(Cp, _LAUNCH_WIDTH)


def split_channels(x: torch.Tensor, Cp: int, G: int, dim: int = -1) -> list[torch.Tensor]:
    """``x`` zero-padded along ``dim`` to ``Cp`` channels and cut into
    contiguous groups of ``G``; ``[x]`` itself when it is one group already."""
    if x.shape[dim] == Cp == G:
        return [x]
    return [t.contiguous() for t in pad_channels(x, Cp, dim).split(G, dim=dim)]


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


def bind_sweeps(lib):
    """(lib, {mode: C entry}) of a library built from ``csrc/sweep_fuse.cu``."""
    return lib, {
        "corr": build.bind(lib, "adamvs_corr_sweep", n_ptr=7, n_int=9),
        "fused": build.bind(lib, "adamvs_fused_sweep", n_ptr=8, n_int=9),
        "var": build.bind(lib, "adamvs_var_sweep", n_ptr=7, n_int=9),
    }


def bind_sweep_bwd(lib):
    """(lib, {mode: C entry}) of a library built from ``csrc/sweep_bwd.cu``."""
    return lib, {
        "corr": build.bind(lib, "adamvs_corr_sweep_bwd", n_ptr=9, n_int=9),
        "fused": build.bind(lib, "adamvs_fused_sweep_bwd", n_ptr=11, n_int=9),
        "var": build.bind(lib, "adamvs_var_sweep_bwd", n_ptr=9, n_int=9),
    }


@functools.cache
def _entries():
    return bind_sweeps(build.load_library("sweep_fuse"))


@functools.cache
def _bwd_entries():
    return bind_sweep_bwd(build.load_library("sweep_bwd"))


def _check_inputs(ref, srcs, src_projs, ref_proj, lo, step):
    if ref.device.type != "cuda":
        raise ValueError(f"the sweep kernels take CUDA tensors, got {ref.device}")
    Vs, B, H, W, C = srcs.shape
    if ref.dtype not in _DTYPE_CODE or srcs.dtype != ref.dtype:
        raise ValueError(f"features must be float32 or bfloat16 and alike, "
                         f"got {ref.dtype}/{srcs.dtype}")
    check_sweep_width(C)
    if ref.shape[0] != B or ref.shape[3] != C:
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


def _geometry(geom, src_projs, ref_proj, Vs, B, device) -> torch.Tensor:
    """``geom`` [Vs*B,12] float32 as ``sweep_geometry`` packs it, checked, or
    ``sweep_geometry`` of the projections when it is None."""
    if geom is None:
        return sweep_geometry(src_projs, ref_proj)
    if (geom.dtype != torch.float32 or tuple(geom.shape) != (Vs * B, 12) or geom.device != device
            or not geom.is_contiguous()):
        raise ValueError(f"geom must be contiguous float32 [{Vs * B},12] on {device}, got "
                         f"{geom.dtype} {tuple(geom.shape)} on {geom.device}")
    return geom


def run_groups(mode: str, ref, srcs, launch, g=None, g_dim: int = 2) -> tuple[list, int]:
    """``launch(ref_i, srcs_i, g_i)`` on each launch group of
    ``sweep_plan(C)``: the features zero-padded and cut into contiguous
    groups, a cotangent ``g`` split along ``g_dim`` with them or, for corr,
    rescaled to the true channel mean (``true_mean_scale``). Returns (the
    launches' results, the group width)."""
    C = ref.shape[-1]
    Cp, G = sweep_plan(C)
    refs, srcss = split_channels(ref, Cp, G), split_channels(srcs, Cp, G)
    if g is None:
        gs = [None] * len(refs)
    elif mode == "corr":
        gs = [g if G == C else (g * true_mean_scale(C, G)).contiguous()] * len(refs)
    else:
        gs = split_channels(g, Cp, G, dim=g_dim)
    return [launch(r, s, gi) for r, s, gi in zip(refs, srcss, gs)], G


def merge_channels(parts: list[torch.Tensor], C: int, dim: int = -1) -> torch.Tensor:
    """The groups of per-channel results joined along ``dim`` and cut to the
    true ``C`` channels: padded channels (variance 0, gradients of zero
    features) are dropped."""
    if len(parts) == 1 and parts[0].shape[dim] == C:
        return parts[0]
    return torch.cat(parts, dim=dim).narrow(dim, 0, C).contiguous()


def true_mean_scale(C: int, G: int) -> float:
    """K1 and K5-corr divide by their launch's width ``G``; a channel mean
    over the true ``C`` is ``G / C`` times the sum of the groups' means, and
    a cotangent of it reaches each group as ``G / C`` times itself. Both are
    powers of two, so the rescaling is exact."""
    return G / C


def merge_volumes(mode: str, outs: list[torch.Tensor], C: int, G: int) -> torch.Tensor:
    """The volume at the true ``C`` from its launch groups' volumes: corr
    [Vs,B,D,h,w] the groups' means rescaled and summed, fused and var
    [D,B,G,h,w] joined along the channels and cut."""
    if mode != "corr":
        return merge_channels(outs, C, dim=2)
    if len(outs) == 1 and G == C:
        return outs[0]
    return sum(outs[1:], outs[0]) * true_mean_scale(C, G)


def merge_gradients(parts: list[tuple], C: int) -> tuple:
    """(d ref, d srcs[, d wn]) at the true ``C`` from the launch groups'
    (d ref, [d wn,] d srcs): the channels joined and cut, d wn summed."""
    out = (merge_channels([p[0] for p in parts], C), merge_channels([p[-1] for p in parts], C))
    if len(parts[0]) == 3:
        out += (sum((p[1] for p in parts[1:]), parts[0][1]),)
    return out


def _launch_sweep(wrapper, mode, ref, srcs, geom, lo, step, D, wn=None,
                  stats=None) -> torch.Tensor:
    """One K1/K2/K4 launch on one group's channels, counted on ``wrapper``."""
    Vs, B, H, W, C = srcs.shape
    h, w = ref.shape[1:3]
    if mode == "corr":
        out = torch.empty((Vs, B, D, h, w), dtype=torch.float32, device=ref.device)
    else:
        out = torch.empty((D, B, C, h, w), dtype=ref.dtype, device=ref.device)
    lib, fns = _entries()
    ptrs = [ref.data_ptr(), srcs.data_ptr(), geom.data_ptr(), lo.data_ptr(), step.data_ptr()]
    ptrs += [] if wn is None else [wn.data_ptr()]
    ptrs += [out.data_ptr(), _stats_ptr(stats, ref.device)]
    err = fns[mode](_DTYPE_CODE[ref.dtype], Vs, B, h, w, H, W, C, D, *ptrs,
                    torch.cuda.current_stream(ref.device).cuda_stream)
    build.check(lib, err, wrapper.__name__)
    wrapper.launches += 1
    return out


def corr_sweep_volume(ref, srcs, src_projs, ref_proj, lo, step, num_depth: int,
                      stats: torch.Tensor | None = None,
                      geom: torch.Tensor | None = None) -> torch.Tensor:
    """K1: [Vs,B,D,h,w] float32 correlation volumes (see ``corr_volume_ref``).
    ``stats`` counts the samples the kernel walked and its dot products
    (``_stats_ptr``); ``geom`` is ``sweep_geometry`` of the projections,
    computed when None."""
    if ref.device.type == "cpu":
        return corr_volume_ref(ref, srcs, src_projs, ref_proj, lo, step, num_depth)
    Vs, B = _check_inputs(ref, srcs, src_projs, ref_proj, lo, step)[:2]
    geom = _geometry(geom, src_projs, ref_proj, Vs, B, ref.device)
    outs, G = run_groups("corr", ref, srcs, lambda r, s, _: _launch_sweep(
        corr_sweep_volume, "corr", r, s, geom, lo, step, num_depth, stats=stats))
    return merge_volumes("corr", outs, ref.shape[-1], G)


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
    """The pointer of an optional int32 [2] CUDA tensor to which a launch
    adds its counts; 0 (none) for None. K2, K4, K5-fused and K5-var add, per
    (block, source window), 1 to ``stats[0]`` and, where the window exceeded
    the block's shared memory and its taps were gathered (and, for K5,
    scattered) in device memory, 1 to ``stats[1]``. K1 and K5-corr add the
    samples they walked to ``stats[0]`` and their C-wide dot products (K1) or
    flushes (K5-corr) to ``stats[1]``."""
    if stats is None:
        return 0
    if stats.dtype != torch.int32 or tuple(stats.shape) != (2,) or stats.device != device:
        raise ValueError(f"stats must be int32 [2] on {device}")
    return stats.data_ptr()


def _fused_sweep(ref, srcs, wn, src_projs, ref_proj, lo, step, num_depth: int,
                 stats: torch.Tensor | None = None,
                 geom: torch.Tensor | None = None) -> torch.Tensor:
    """K2 on normalised weights ``wn`` [B,Vs,h,w] float32."""
    if ref.device.type == "cpu":
        return fused_volume_wn(ref, srcs, wn, src_projs, ref_proj, lo, step, num_depth)
    Vs, B, H, W, C, h, w = _check_inputs(ref, srcs, src_projs, ref_proj, lo, step)
    _check_weights(wn, Vs, B, h, w, ref.device)
    geom = _geometry(geom, src_projs, ref_proj, Vs, B, ref.device)
    wn = wn.contiguous()
    outs, G = run_groups("fused", ref, srcs, lambda r, s, _: _launch_sweep(
        fused_sweep_volume, "fused", r, s, geom, lo, step, num_depth, wn, stats))
    return merge_volumes("fused", outs, C, G)


def var_sweep_volume(ref, srcs, src_projs, ref_proj, lo, step, num_depth: int,
                     stats: torch.Tensor | None = None,
                     geom: torch.Tensor | None = None) -> torch.Tensor:
    """K4: [D,B,C,h,w] variance volume in the feature dtype (see
    ``var_volume_ref``). ``stats`` and ``geom`` as for K1 and K2."""
    if ref.device.type == "cpu":
        return var_volume_ref(ref, srcs, src_projs, ref_proj, lo, step, num_depth)
    Vs, B, H, W, C, h, w = _check_inputs(ref, srcs, src_projs, ref_proj, lo, step)
    if Vs > _MAX_VIEWS:
        raise ValueError(f"var_sweep_volume takes at most {_MAX_VIEWS} source views, got {Vs}")
    geom = _geometry(geom, src_projs, ref_proj, Vs, B, ref.device)
    outs, G = run_groups("var", ref, srcs, lambda r, s, _: _launch_sweep(
        var_sweep_volume, "var", r, s, geom, lo, step, num_depth, stats=stats))
    return merge_volumes("var", outs, C, G)


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


def _launch_bwd(wrapper, mode, ref, srcs, geom, lo, step, g, D, wn=None, stats=None):
    """One K5 launch of ``mode`` on one group's channels, counted on
    ``wrapper``, into zeroed float32 gradients; returns them: d ref
    [B,h,w,C], (d wn [B,Vs,h,w] for fused,) d srcs."""
    Vs, B, H, W, C = srcs.shape
    h, w = ref.shape[1:3]
    dev = ref.device
    dref = torch.zeros((B, h, w, C), dtype=torch.float32, device=dev)
    dsrc = torch.zeros((Vs, B, H, W, C), dtype=torch.float32, device=dev)
    outs = [dref] if wn is None else [dref, torch.zeros((B, Vs, h, w), dtype=torch.float32,
                                                        device=dev)]
    lib, fns = _bwd_entries()
    err = fns[mode](_DTYPE_CODE[ref.dtype], Vs, B, h, w, H, W, C, D, g.data_ptr(),
                    ref.data_ptr(), srcs.data_ptr(), geom.data_ptr(), lo.data_ptr(),
                    step.data_ptr(), *([] if wn is None else [wn.data_ptr()]),
                    *(t.data_ptr() for t in outs), dsrc.data_ptr(), _stats_ptr(stats, dev),
                    torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, wrapper.__name__)
    wrapper.launches += 1
    return (*outs, dsrc)


def _sweep_bwd(wrapper, mode, g, ref, srcs, src_projs, ref_proj, lo, step, D, wn=None,
               stats=None, geom=None):
    """K5 of ``mode`` over its launch groups: (d ref, d srcs[, d wn]) in the
    primals' dtypes (d wn float32)."""
    Vs, B = _check_inputs(ref, srcs, src_projs, ref_proj, lo, step)[:2]
    geom = _geometry(geom, src_projs, ref_proj, Vs, B, ref.device)
    parts, _ = run_groups(mode, ref, srcs, lambda r, s, gi: _launch_bwd(
        wrapper, mode, r, s, geom, lo, step, gi, D, wn, stats), g)
    dref, dsrc, *dwn = merge_gradients(parts, ref.shape[-1])
    return (dref.to(ref.dtype), dsrc.to(srcs.dtype), *dwn)


def corr_sweep_volume_bwd(g, ref, srcs, src_projs, ref_proj, lo, step,
                          stats: torch.Tensor | None = None, geom: torch.Tensor | None = None):
    """K5, corr: (d ref, d srcs) in the primals' dtypes for the cotangent
    ``g`` [Vs,B,D,h,w] of ``corr_sweep_volume`` (see ``corr_volume_vjp``).
    ``stats`` counts the samples the kernel walked and its flushes
    (``_stats_ptr``); ``geom`` as for ``corr_sweep_volume``."""
    if ref.device.type == "cpu":
        return corr_volume_vjp(g, ref, srcs, src_projs, ref_proj, lo, step)
    Vs, B, D, h, w = g.shape
    _check_cotangent(g, (srcs.shape[0], ref.shape[0], D) + tuple(ref.shape[1:3]), ref.device)
    return _sweep_bwd(corr_sweep_volume_bwd, "corr", g.float().contiguous(), ref, srcs,
                      src_projs, ref_proj, lo, step, D, stats=stats, geom=geom)


corr_sweep_volume_bwd.launches = 0


def fused_sweep_volume_bwd(g, ref, srcs, wn, src_projs, ref_proj, lo, step,
                           stats: torch.Tensor | None = None, geom: torch.Tensor | None = None):
    """K5, fused: (d ref, d srcs, d wn) in the primals' dtypes for the
    cotangent ``g`` [D,B,C,h,w] of ``fused_sweep_volume`` on normalised
    weights ``wn`` (see ``fused_volume_vjp``). ``stats`` counts the kernel's
    windows (``_stats_ptr``), per (block, view); ``geom`` as for
    ``corr_sweep_volume``."""
    if ref.device.type == "cpu":
        return fused_volume_vjp(g, ref, srcs, wn, src_projs, ref_proj, lo, step)
    D = g.shape[0]
    B, h, w, C = ref.shape
    _check_cotangent(g, (D, B, C, h, w), ref.device)
    _check_weights(wn, srcs.shape[0], B, h, w, ref.device)
    return _sweep_bwd(fused_sweep_volume_bwd, "fused", g.to(ref.dtype).contiguous(), ref, srcs,
                      src_projs, ref_proj, lo, step, D, wn.contiguous(), stats, geom)


fused_sweep_volume_bwd.launches = 0


def var_sweep_volume_bwd(g, ref, srcs, src_projs, ref_proj, lo, step,
                         stats: torch.Tensor | None = None, geom: torch.Tensor | None = None):
    """K5, var: (d ref, d srcs) in the primals' dtypes for the cotangent ``g``
    [D,B,C,h,w] of ``var_sweep_volume`` (see ``var_volume_vjp``). ``stats``
    counts the kernel's windows (``_stats_ptr``), per (block, view, pass);
    ``geom`` as for ``corr_sweep_volume``."""
    if ref.device.type == "cpu":
        return var_volume_vjp(g, ref, srcs, src_projs, ref_proj, lo, step)
    D = g.shape[0]
    B, h, w, C = ref.shape
    _check_cotangent(g, (D, B, C, h, w), ref.device)
    if srcs.shape[0] > _MAX_VIEWS:
        raise ValueError(f"var_sweep_volume_bwd takes at most {_MAX_VIEWS} source views")
    return _sweep_bwd(var_sweep_volume_bwd, "var", g.to(ref.dtype).contiguous(), ref, srcs,
                      src_projs, ref_proj, lo, step, D, stats=stats, geom=geom)


var_sweep_volume_bwd.launches = 0


def _train_geometry(ref, src_projs, ref_proj):
    """The geometry a training form's forward hands to its backward: the
    kernels' (``sweep_geometry``) for CUDA features, None for CPU ones, whose
    plain versions compute their own."""
    return None if ref.device.type == "cpu" else sweep_geometry(src_projs, ref_proj)


class _CorrSweepT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ref, srcs, src_projs, ref_proj, lo, step, num_depth):
        geom = _train_geometry(ref, src_projs, ref_proj)
        ctx.save_for_backward(ref, srcs, src_projs, ref_proj, lo, step, geom)
        return corr_sweep_volume(ref, srcs, src_projs, ref_proj, lo, step, num_depth, geom=geom)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *inputs, geom = ctx.saved_tensors
        dref, dsrcs = corr_sweep_volume_bwd(g, *inputs, geom=geom)
        return dref, dsrcs, None, None, None, None, None


class _FusedSweepT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ref, srcs, wn, src_projs, ref_proj, lo, step, num_depth):
        geom = _train_geometry(ref, src_projs, ref_proj)
        ctx.save_for_backward(ref, srcs, wn, src_projs, ref_proj, lo, step, geom)
        return _fused_sweep(ref, srcs, wn, src_projs, ref_proj, lo, step, num_depth, geom=geom)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *inputs, geom = ctx.saved_tensors
        dref, dsrcs, dwn = fused_sweep_volume_bwd(g, *inputs, geom=geom)
        return dref, dsrcs, dwn, None, None, None, None, None


class _VarSweepT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ref, srcs, src_projs, ref_proj, lo, step, num_depth):
        geom = _train_geometry(ref, src_projs, ref_proj)
        ctx.save_for_backward(ref, srcs, src_projs, ref_proj, lo, step, geom)
        return var_sweep_volume(ref, srcs, src_projs, ref_proj, lo, step, num_depth, geom=geom)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *inputs, geom = ctx.saved_tensors
        dref, dsrcs = var_sweep_volume_bwd(g, *inputs, geom=geom)
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
