"""A CPU model of the tiled K5-fused and K5-var kernels
(``adamvs_tpu_torch/csrc/sweep_bwd.cu``, ``sweep_bwd_tile_kernel``).

The kernels cut the reference into K2/K4's 2-D tiles. Per (tile, hypothesis
chunk, source view) a block stages the ringed source window of its samples'
in-image taps and a float32 accumulator window of the same box and ring in
shared memory; every sample adds its row times each tap's weight at its four
taps there, and when the view is done the block adds each in-image window
pixel to d srcs once (the flush) and zeroes the window. The var mode runs two
passes over the views per chunk: the mean over {ref, X_1 .. X_Vs}, then the
scatter. A window past the block's budget is gathered and scattered against
the whole source instead. This model does the same in plain PyTorch at small
sizes, through the CUDA path's own width helpers, and is held to the plain
VJPs (``fused_volume_vjp``, ``var_volume_vjp``) and to ``jax.grad`` of the
exact JAX forms (``_xla_fused_volume``, ``_xla_var_volume``). The card runs
the kernels themselves against the plain VJPs (``chip_smoke.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adamvs_tpu.ops.sweep_fuse import _xla_fused_volume, _xla_var_volume
from adamvs_tpu_torch.ops import sweep_fuse as tsweep
from adamvs_tpu_torch.ops.warp import sweep_coords
from tests.test_torch_import_msrednet import _real_cameras

torch.set_num_threads(2)

# the kernels' constants (csrc/sweep_bwd.cu: kTileThreads, kTileW, kWindowBytes,
# kAccBytes, BwdTile::kD, BwdTile::kRotShift)
THREADS, TILE_W, WINDOW_BYTES, ACC_BYTES = 256, 32, 36 * 1024, 36 * 1024
CHUNK = {"fused": 8, "var": 4}


def tile_rows(C: int) -> int:
    """Rows of a tile: 256 threads, C/8 of them per pixel, 32 pixels a row."""
    return THREADS // (C // 8) // TILE_W


def rot_shift(C: int) -> int:
    """``BwdTile::kRotShift``: accumulator pixel q holds channel c in slot
    (c + (q >> shift)) mod C."""
    return 0 if C >= 32 else (1 if C == 16 else 2)


def _taps(u, v, H, W):
    """The four bilinear taps of ``ops/warp.py::bilinear_sample``: per tap
    (x, y, weight, counts)."""
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    out = []
    for xi, yi, wt in ((u0, v0, (1 - du) * (1 - dv)), (u0 + 1, v0, du * (1 - dv)),
                       (u0, v0 + 1, (1 - du) * dv), (u0 + 1, v0 + 1, du * dv)):
        ok = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        out.append((xi, yi, wt, ok))
    return out


class Window:
    """One (tile, chunk, view) window: the box (x0, y0, x1, y1) of the
    in-image taps (None when there is none), whether it is staged (source and
    accumulator within their budgets at ``elem`` bytes per source element),
    and the ringed source window [h+2, w+2, C], zero outside the image."""

    def __init__(self, src, taps, C, budgets, elem):
        self.box, self.staged = None, True
        if any(bool(ok.any()) for *_, ok in taps):
            self.box = (int(min(xi[ok].min() for xi, _, _, ok in taps if ok.any())),
                        int(min(yi[ok].min() for _, yi, _, ok in taps if ok.any())),
                        int(max(xi[ok].max() for xi, _, _, ok in taps if ok.any())),
                        int(max(yi[ok].max() for _, yi, _, ok in taps if ok.any())))
            x0, y0, x1, y1 = self.box
            self.w, self.h = x1 - x0 + 3, y1 - y0 + 3
            n = self.w * self.h
            slots = (C * elem // 16) | 1
            self.staged = n * slots * 16 <= budgets[0] and n * C * 4 <= budgets[1]
            pad = F.pad(src.permute(2, 0, 1), (1, 1, 1, 1)).permute(1, 2, 0)  # pixel (0,0) = (-1,-1)
            self.src = pad[y0:y1 + 3, x0:x1 + 3]

    def local(self, xi, yi):
        """Window-local pixel indices of source positions (x, y)."""
        x0, y0, _, _ = self.box
        return ((yi - y0 + 1) * self.w + (xi - x0 + 1)).long()


def _sample(win, src, taps):
    """Bilinear samples [..., C] of the window's taps: from the staged window
    (all four taps of a sample with some tap in the image, those outside it
    reading the ring's zeros), or from the whole source (the in-image taps)."""
    H, W, C = src.shape
    acc = 0.0
    if win.staged:
        some = sum(ok for *_, ok in taps) > 0
        flat = win.src.reshape(-1, C)
        for xi, yi, wt, _ in taps:
            idx = torch.where(some, win.local(xi, yi), 0)
            acc = acc + flat[idx] * (wt * some)[..., None]
    else:
        flat = src.reshape(H * W, C)
        for xi, yi, wt, ok in taps:
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
            acc = acc + flat[idx] * (wt * ok)[..., None]
    return acc


def _scatter(win, dsrc, taps, row, check):
    """d srcs [H,W,C] += the samples' ``row`` [..., C] times each tap's weight.
    Staged: into a zeroed accumulator window at window-local indices (every
    tap of a sample with some tap in the image, those outside the image on
    the ring), then each in-image window pixel added once (the flush).
    Direct: the in-image taps straight into d srcs."""
    H, W, C = dsrc.shape
    if not win.staged:
        flat = dsrc.view(H * W, C)
        for xi, yi, wt, ok in taps:
            idx = (yi * W + xi)[ok].long()
            flat.index_add_(0, idx, wt[ok][:, None] * row[ok])
        return
    some = sum(ok for *_, ok in taps) > 0
    acc = torch.zeros((win.h * win.w, C))
    for xi, yi, wt, _ in taps:
        idx = win.local(xi, yi)[some]
        check["taps"] += idx.numel()
        assert bool(((idx >= 0) & (idx < acc.shape[0])).all())  # every tap in its window
        acc.index_add_(0, idx, wt[some][:, None] * row[some])
    acc = acc.view(win.h, win.w, C)
    x0, y0, x1, y1 = win.box
    ys = torch.arange(y0 - 1, y1 + 2)[:, None].expand(win.h, win.w)
    xs = torch.arange(x0 - 1, x1 + 2)[None, :].expand(win.h, win.w)
    inside = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    in_box = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    # in-image taps lie in the box: an in-image pixel of the ring takes nothing
    assert not acc[inside & ~in_box].any()
    check["ring"] += int(acc[~inside].abs().sum() > 0)
    dsrc[y0:y1 + 1, x0:x1 + 1] += acc[1:-1, 1:-1]  # the flush: in-image pixels once


def tiled_vjp(mode, g, ref, srcs, wn, src_projs, ref_proj, lo, step,
              budgets=(WINDOW_BYTES, ACC_BYTES), elem=4, check=None):
    """K5-fused (on normalised weights ``wn`` [B,Vs,h,w]) or K5-var at one
    launch width (C 8, 16 or 32), as the tiled kernel computes it, float32: (d ref,
    [d wn,] d srcs) as a launch returns them. ``check`` counts the staged
    taps, the windows whose ring took a contribution, and the staged and
    direct windows."""
    check = {"taps": 0, "ring": 0, "staged": 0, "direct": 0} if check is None else check
    B, h, w, C = ref.shape
    Vs, _, H, W, _ = srcs.shape
    D = g.shape[0]
    TH, KD = tile_rows(C), CHUNK[mode]
    nv = Vs + 1
    k2 = 2.0 / nv
    hyp = tsweep._hyp(lo, step, 0, D)  # [B,D,h,w]
    uv = [sweep_coords(srcs[v], src_projs[v], ref_proj, hyp) for v in range(Vs)]
    dref = torch.zeros((B, h, w, C))
    dwn = torch.zeros((B, Vs, h, w))
    dsrc = torch.zeros((Vs, B, H, W, C))
    for b in range(B):
        for ty in range(0, h, TH):
            for tx in range(0, w, TILE_W):
                ys, xs = slice(ty, min(h, ty + TH)), slice(tx, min(w, tx + TILE_W))
                r = ref[b, ys, xs]  # [th,tw,C]
                for d0 in range(0, D, KD):
                    ds = slice(d0, min(D, d0 + KD))
                    gt = g[ds, b, :, ys, xs].permute(0, 2, 3, 1)  # [kd,th,tw,C]
                    s = r[None].expand(gt.shape).clone()
                    for st in range(2 * Vs if mode == "var" else Vs):
                        v = st % Vs
                        taps = _taps(uv[v][0][b, ds, ys, xs], uv[v][1][b, ds, ys, xs], H, W)
                        win = Window(srcs[v, b], taps, C, budgets, elem)
                        check["staged" if win.staged else "direct"] += 1
                        if win.box is None:  # no tap in the image: the view adds nothing
                            x = torch.zeros_like(gt)
                        else:
                            x = _sample(win, srcs[v, b], taps)
                        if mode == "var" and st < Vs:  # the mean pass
                            s = s + x
                            if st == Vs - 1:
                                m = s / nv
                                dref[b, ys, xs] += (k2 * gt * (r - m)).sum(0)
                            continue
                        if mode == "fused":
                            wt = wn[b, v, ys, xs][None, :, :, None]
                            dwn[b, v, ys, xs] += (gt * r * x).sum((0, 3))
                            dref[b, ys, xs] += (gt * wt * x).sum(0)
                            row = gt * r * wt
                        else:
                            row = k2 * gt * (x - m)
                        if win.box is not None:
                            _scatter(win, dsrc[v, b], taps, row, check)
    return (dref, dwn, dsrc) if mode == "fused" else (dref, dsrc)


def _case(seed, C, B=2, Vs=3, h=11, w=37, blocky=True):
    """Rotated views with x-baselines, random features and cotangent, and a
    blocky (nearest-upsampled) depth window whose lowest depths lie behind
    the camera and whose near samples leave the image."""
    rng = np.random.RandomState(seed)
    ref = rng.randn(B, h, w, C).astype(np.float32)
    srcs = rng.randn(Vs, B, h, w, C).astype(np.float32)
    proj = _real_cameras(B, Vs + 1, h, w, f=30.0, baseline=1.0)
    proj[:, 1:, :3, :3] += 0.02 * rng.randn(B, Vs, 3, 3).astype(np.float32)
    weights = rng.rand(B, h, w, Vs).astype(np.float32)
    if blocky:
        coarse = torch.from_numpy((-2.0 + 30.0 * rng.rand(B, 1, 3, 5)).astype(np.float32))
        coarse[:, :, 0, 0] = -3.0  # a block whose first hypotheses lie behind the camera
        lo = F.interpolate(coarse, size=(h, w), mode="nearest")[:, 0].numpy()
        step = (0.5 + rng.rand(B, h, w)).astype(np.float32)
    else:
        lo = np.full((B, h, w), 20.0, np.float32)
        step = np.full((B, h, w), 0.3, np.float32)
    return (ref, srcs, weights, np.ascontiguousarray(proj[:, 1:].transpose(1, 0, 2, 3)),
            proj[:, 0], np.ascontiguousarray(lo), step)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _model(mode, case, probe, **kw):
    """The tiled model through the CUDA path's width helpers (C 4 runs padded
    to 8): (d ref, d srcs[, d wn]) at the true width."""
    ref, srcs, weights, src_projs, ref_proj, lo, step = (_t(x) for x in case)
    wn = tsweep.normalize_weights(weights.permute(0, 3, 1, 2))
    g = _t(probe).permute(0, 1, 4, 2, 3).contiguous()  # [D,B,C,h,w]
    parts, _ = tsweep.run_groups(mode, ref, srcs, lambda r, s, gi: tiled_vjp(
        mode, gi, r, s, wn, src_projs, ref_proj, lo, step, **kw), g)
    return tsweep.merge_gradients(parts, ref.shape[-1])


def _plain(mode, case, probe):
    ref, srcs, weights, src_projs, ref_proj, lo, step = (_t(x) for x in case)
    g = _t(probe).permute(0, 1, 4, 2, 3)
    if mode == "fused":
        wn = tsweep.normalize_weights(weights.permute(0, 3, 1, 2))
        dref, dsrc, dwn = tsweep.fused_volume_vjp(g, ref, srcs, wn, src_projs, ref_proj, lo, step)
        return dref, dsrc, dwn
    return tsweep.var_volume_vjp(g, ref, srcs, src_projs, ref_proj, lo, step)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("mode", ["fused", "var"])
@pytest.mark.parametrize("C", [4, 8, 16, 32, 64])
def test_tiled_vjp_matches_plain_and_jax(mode, C):
    """Ragged 11x37 (no multiple of any tile), batch 2, D 9 (a partial last
    chunk), rotated views, samples behind the camera and out of the image, a
    blocky window straddling depth edges. d ref, d srcs and d weights held to
    the plain VJP within 1e-6 of its largest value and to jax.grad of the
    exact JAX form within 1e-5 (d weights through the weight normalisation)."""
    D = 9
    case = _case(C + (mode == "var"), C)
    rng = np.random.RandomState(C)
    B, h, w, _ = case[0].shape
    probe = rng.randn(D, B, h, w, C).astype(np.float32)  # JAX layout [D,B,h,w,C]
    got = _model(mode, case, probe)
    for a, b in zip(got, _plain(mode, case, probe)):
        assert a.shape == b.shape and _rel(a, b) <= 1e-6
    ref, srcs, weights, src_projs, ref_proj, lo, step = (jnp.asarray(x) for x in case)
    geo = (src_projs, ref_proj, lo, step)
    if mode == "fused":
        want = jax.grad(lambda r, s, wt: jnp.sum(_xla_fused_volume(r, s, wt, *geo, D) * probe),
                        argnums=(0, 1, 2))(ref, srcs, weights)
        tw = _t(case[2]).permute(0, 3, 1, 2).contiguous().requires_grad_()
        (draw,) = torch.autograd.grad(tsweep.normalize_weights(tw), tw, got[2])
        assert _rel(draw.permute(0, 2, 3, 1), want[2]) <= 1e-5
    else:
        want = jax.grad(lambda r, s: jnp.sum(_xla_var_volume(r, s, *geo, D) * probe),
                        argnums=(0, 1))(ref, srcs)
    assert _rel(got[0], want[0]) <= 1e-5
    assert _rel(got[1], want[1]) <= 1e-5


@pytest.mark.parametrize("mode", ["fused", "var"])
@pytest.mark.parametrize("C", [8, 32])
def test_windows_past_the_budget_take_the_direct_branch(mode, C):
    """With budgets that the median window exceeds, some windows are staged
    and some gathered and scattered against the whole source; the gradients
    are those of the all-staged run (to the order of the float32 sums)."""
    D = 7
    case = _case(2 * C + (mode == "var"), C)
    B, h, w, _ = case[0].shape
    probe = np.random.RandomState(C + 1).randn(D, B, h, w, C).astype(np.float32)
    staged = _model(mode, case, probe)
    sizes = []
    ref, srcs, weights, src_projs, ref_proj, lo, step = (_t(x) for x in case)
    hyp = tsweep._hyp(lo, step, 0, D)
    for v in range(srcs.shape[0]):
        u, vv = sweep_coords(srcs[v], src_projs[v], ref_proj, hyp)
        for b in range(B):
            for ty in range(0, h, tile_rows(C)):
                taps = _taps(u[b, :CHUNK[mode], ty:ty + tile_rows(C), :TILE_W],
                             vv[b, :CHUNK[mode], ty:ty + tile_rows(C), :TILE_W], h, w)
                win = Window(srcs[v, b], taps, C, (WINDOW_BYTES, ACC_BYTES), 4)
                if win.box is not None:
                    sizes.append(win.w * win.h * C * 4)
    budget = sorted(sizes)[len(sizes) // 2]
    check = {"taps": 0, "ring": 0, "staged": 0, "direct": 0}
    mixed = _model(mode, case, probe, budgets=(WINDOW_BYTES, budget), check=check)
    assert check["staged"] > 0 and check["direct"] > 0
    for a, b in zip(mixed, staged):
        assert _rel(a, b) <= 1e-6


def test_every_tap_lies_inside_its_window_and_the_ring_is_dropped():
    """The model asserts, per staged (tile, chunk, view), that every tap of a
    sample with some tap in the image lies in the accumulator window and that
    no in-image pixel of the ring takes a contribution; here some taps land
    on the ring outside the image, which the flush drops."""
    C, D = 16, 9
    case = _case(7, C)
    B, h, w, _ = case[0].shape
    probe = np.random.RandomState(3).randn(D, B, h, w, C).astype(np.float32)
    check = {"taps": 0, "ring": 0, "staged": 0, "direct": 0}
    ref, srcs, weights, src_projs, ref_proj, lo, step = (_t(x) for x in case)
    wn = tsweep.normalize_weights(weights.permute(0, 3, 1, 2))
    tiled_vjp("fused", _t(probe).permute(0, 1, 4, 2, 3), ref, srcs, wn, src_projs, ref_proj, lo,
              step, check=check)
    assert check["taps"] > 0 and check["ring"] > 0 and check["direct"] == 0


@pytest.mark.parametrize("C", [8, 16, 32])
def test_accumulator_slots_spread_a_channel_over_the_banks(C):
    """Channel c of 32 consecutive accumulator pixels (a warp's atomic, its
    lanes on neighbouring pixels) lies in 32 different 4-byte banks, and each
    pixel's C slots are a permutation of its channels, whole float4s of which
    the flush reads."""
    for q0 in range(0, 200, 7):
        for c in range(C):
            banks = {((q0 + i) * C + ((c + ((q0 + i) >> rot_shift(C))) % C)) % 32
                     for i in range(32)}
            assert len(banks) == 32
    for q in range(64):
        assert sorted((c + (q >> rot_shift(C))) % C for c in range(C)) == list(range(C))
