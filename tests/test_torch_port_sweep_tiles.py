"""A CPU model of the tiled K2/K4 kernels (``adamvs_tpu_torch/csrc/sweep_fuse.cu``).

The kernels cut the reference into 2-D tiles. Per (tile, hypothesis chunk,
source view) a block stages the bounding box of its samples' in-image taps,
with a ring of one pixel that is zero outside the image (the window), in
shared memory, and reads all four taps of every sample there; when the window
exceeds the block's budget, it gathers the in-image taps from the whole
source instead. This model does the same in plain PyTorch at small sizes:
positions from the plain coordinate code (``ops/warp.py``), taps read at
window-local indices or from the source past the budget, sums in the
kernels' order. It is held to the plain volumes (``fused_volume_wn``,
``var_volume_ref``) and to the exact JAX forms (``_xla_fused_volume``,
``_xla_var_volume``). The card runs the kernels themselves against the plain
volumes (``chip_smoke.py``).
"""

from __future__ import annotations

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

# the kernels' constants (csrc/sweep_fuse.cu: kTileThreads, kTileW, kWindowBytes, Tile::kD)
THREADS, TILE_W, WINDOW_BYTES = 256, 32, 36 * 1024
CHUNK = {"fused": 8, "var": 4}


def tile_rows(C: int) -> int:
    """Rows of a tile: 256 threads, C/8 of them per pixel, 32 pixels a row."""
    return THREADS // (C // 8) // TILE_W


def pixel_slots(C: int, elem: int) -> int:
    """``Tile::kStride``: the 16-byte slots of a staged pixel, C channels of
    ``elem`` bytes rounded up to an odd count."""
    return (C * elem // 16) | 1


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


def _gather(src, taps):
    """Bilinear samples [..., C] of ``src`` [H,W,C] from the whole source:
    the in-image taps, in order (the kernels' direct branch)."""
    H, W, C = src.shape
    flat = src.reshape(H * W, C)
    acc = 0.0
    for xi, yi, wt, ok in taps:
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        acc = acc + flat[idx] * (wt * ok)[..., None]
    return acc


def _staged(src, box, taps):
    """The same samples from the staged window of ``box`` (x0, y0, x1, y1):
    the box and a ring of one pixel, zero outside the image. A sample with
    some tap in the image reads all four at window-local indices; one with
    none reads the window's corner with weight 0."""
    H, W, C = src.shape
    x0, y0, x1, y1 = box
    win = F.pad(src.permute(2, 0, 1), (1, 1, 1, 1)).permute(1, 2, 0)  # [H+2,W+2,C], zero ring
    win = win[y0:y1 + 3, x0:x1 + 3]  # pixel (0, 0) is source pixel (x0-1, y0-1)
    ww = win.shape[1]
    flat = win.reshape(-1, C)
    some = sum(ok for *_, ok in taps) > 0
    acc = 0.0
    for xi, yi, wt, _ in taps:
        idx = torch.where(some, (yi - y0 + 1) * ww + (xi - x0 + 1), 0).long()
        assert bool(((idx >= 0) & (idx < flat.shape[0])).all())
        acc = acc + flat[idx] * (wt * some)[..., None]
    return acc


def tiled_volume(kind, ref, srcs, wn, src_projs, ref_proj, lo, step, D, budget=WINDOW_BYTES,
                 elem=4):
    """The K2 (``kind`` "fused", on normalised weights ``wn`` [B,Vs,h,w]) or
    K4 ("var") volume [D,B,C,h,w] as the tiled kernels build it, float32.
    Returns (volume, windows): one entry per (batch, tile, chunk, view) with
    the tile's slices, the box of the in-image taps (x0, y0, x1, y1) or None
    when there is none, and whether its window was staged (within ``budget``
    bytes at ``elem`` bytes per element)."""
    B, h, w, C = ref.shape
    Vs, _, H, W, _ = srcs.shape
    TH, KD = tile_rows(C), CHUNK[kind]
    hyp = tsweep._hyp(lo, step, 0, D)  # [B,D,h,w]
    uv = [sweep_coords(srcs[v], src_projs[v], ref_proj, hyp) for v in range(Vs)]
    out = torch.zeros((D, B, C, h, w))
    windows = []
    for b in range(B):
        for ty in range(0, h, TH):
            for tx in range(0, w, TILE_W):
                ys, xs = slice(ty, min(h, ty + TH)), slice(tx, min(w, tx + TILE_W))
                r = ref[b, ys, xs]  # [th,tw,C]
                for d0 in range(0, D, KD):
                    ds = slice(d0, min(D, d0 + KD))
                    if kind == "fused":
                        acc = 0.0
                    else:
                        s = r[None].expand((ds.stop - d0,) + r.shape)
                        sq = s * s
                    for v in range(Vs):
                        taps = _taps(uv[v][0][b, ds, ys, xs], uv[v][1][b, ds, ys, xs], H, W)
                        box, staged = None, True
                        if any(bool(ok.any()) for *_, ok in taps):
                            box = (int(min(xi[ok].min() for xi, _, _, ok in taps if ok.any())),
                                   int(min(yi[ok].min() for _, yi, _, ok in taps if ok.any())),
                                   int(max(xi[ok].max() for xi, _, _, ok in taps if ok.any())),
                                   int(max(yi[ok].max() for _, yi, _, ok in taps if ok.any())))
                            nbytes = ((box[2] - box[0] + 3) * (box[3] - box[1] + 3)
                                      * pixel_slots(C, elem) * 16)
                            staged = nbytes <= budget
                        windows.append({"b": b, "ys": ys, "xs": xs, "ds": ds, "view": v,
                                        "box": box, "staged": staged})
                        if box is None:  # no tap in the image: the view adds zeros
                            warped = torch.zeros((ds.stop - d0,) + r.shape)
                        elif staged:
                            warped = _staged(srcs[v, b], box, taps)
                        else:
                            warped = _gather(srcs[v, b], taps)
                        if kind == "fused":
                            acc = acc + (r[None] * warped) * wn[b, v, ys, xs][None, :, :, None]
                        else:
                            s = s + warped
                            sq = sq + warped * warped
                    if kind == "var":
                        m = s / (Vs + 1)
                        acc = sq / (Vs + 1) - m * m
                    out[ds, b, :, ys, xs] = acc.permute(0, 3, 1, 2)
    return out, windows


def _case(seed, C, B=2, Vs=3, h=13, w=45, blocky=True):
    """Rotated views with x-baselines, random features, and a blocky
    (nearest-upsampled) depth window whose lowest depths lie behind the
    camera and whose near samples leave the image."""
    rng = np.random.RandomState(seed)
    ref = rng.randn(B, h, w, C).astype(np.float32)
    srcs = rng.randn(Vs, B, h, w, C).astype(np.float32)
    proj = _real_cameras(B, Vs + 1, h, w, f=30.0, baseline=1.0)
    proj[:, 1:, :3, :3] += 0.02 * rng.randn(B, Vs, 3, 3).astype(np.float32)
    ref_proj = proj[:, 0]
    src_projs = np.ascontiguousarray(proj[:, 1:].transpose(1, 0, 2, 3))
    weights = rng.rand(B, h, w, Vs).astype(np.float32)
    if blocky:
        coarse = torch.from_numpy((-2.0 + 30.0 * rng.rand(B, 1, 3, 5)).astype(np.float32))
        coarse[:, :, 0, 0] = -3.0  # a block whose first hypotheses lie behind the camera
        lo = F.interpolate(coarse, size=(h, w), mode="nearest")[:, 0].numpy()
        step = (0.5 + rng.rand(B, h, w)).astype(np.float32)
    else:
        lo = np.full((B, h, w), 20.0, np.float32)
        step = np.full((B, h, w), 0.3, np.float32)
    return ref, srcs, src_projs, ref_proj, weights, np.ascontiguousarray(lo), step


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _model(kind, case, D, **kw):
    ref, srcs, src_projs, ref_proj, weights, lo, step = (_t(x) for x in case)
    wn = tsweep.normalize_weights(weights.permute(0, 3, 1, 2))
    return tiled_volume(kind, ref, srcs, wn, src_projs, ref_proj, lo, step, D, **kw)


def _plain(kind, case, D):
    ref, srcs, src_projs, ref_proj, weights, lo, step = (_t(x) for x in case)
    if kind == "fused":
        wn = tsweep.normalize_weights(weights.permute(0, 3, 1, 2))
        return tsweep.fused_volume_wn(ref, srcs, wn, src_projs, ref_proj, lo, step, D)
    return tsweep.var_volume_ref(ref, srcs, src_projs, ref_proj, lo, step, D)


def _jax(kind, case, D):
    ref, srcs, src_projs, ref_proj, weights, lo, step = (jnp.asarray(x) for x in case)
    if kind == "fused":
        out = _xla_fused_volume(ref, srcs, weights, src_projs, ref_proj, lo, step, D)
    else:
        out = _xla_var_volume(ref, srcs, src_projs, ref_proj, lo, step, D)
    return torch.from_numpy(np.asarray(out)).permute(0, 1, 4, 2, 3)  # [D,B,C,h,w]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("kind", ["fused", "var"])
@pytest.mark.parametrize("C", [8, 16, 32])
def test_tiled_model_matches_plain_and_jax(kind, C):
    """Ragged 13x45 (no multiple of any tile), batch 2, D 11 (a partial last
    chunk), rotated views, samples behind the camera and out of the image,
    a blocky window straddling depth edges. Held to the plain volume to 1e-6
    of its largest value and to the exact JAX form."""
    D = 11
    case = _case(C + (kind == "var"), C)
    got, _ = _model(kind, case, D)
    u, _ = sweep_coords(_t(case[1][0]), _t(case[2][0]), _t(case[3]),
                        tsweep._hyp(_t(case[5]), _t(case[6]), 0, D))
    assert (u == -1e9).any() and (u > 45).any()  # behind the camera and past the border
    assert _rel(got, _plain(kind, case, D)) <= 1e-6
    # the variance's cancellation, sq/nv - (s/nv)^2, puts the float32 plain forms of
    # PyTorch and XLA up to 1.14e-5 apart here (C 32); the fused volume within 1e-5
    assert _rel(got, _jax(kind, case, D)) <= (2e-5 if kind == "var" else 1e-5)


@pytest.mark.parametrize("kind", ["fused", "var"])
@pytest.mark.parametrize("C", [8, 16, 32])
def test_windows_past_the_budget_take_the_direct_gather(kind, C):
    """With a budget that the median window exceeds, some windows are staged
    and some gathered from the whole source; the volume is the same, bit for
    bit."""
    case = _case(2 * C + (kind == "var"), C)
    staged, windows = _model(kind, case, 7)
    sizes = sorted((w["box"][2] - w["box"][0] + 3) * (w["box"][3] - w["box"][1] + 3)
                   * pixel_slots(C, 4) * 16 for w in windows if w["box"] is not None)
    mixed, windows = _model(kind, case, 7, budget=sizes[len(sizes) // 2])
    kinds = {w["staged"] for w in windows if w["box"] is not None}
    assert kinds == {True, False}
    assert torch.equal(mixed, staged)
    assert _rel(mixed, _plain(kind, case, 7)) <= 1e-6


@pytest.mark.parametrize("C", [8, 16, 32])
def test_every_tap_lies_inside_its_window(C):
    """Each tap of every sample of a (tile, chunk, view), computed again from
    the plain coordinates of the whole frame: an in-image tap lies in the box,
    and every tap of a sample with some tap in the image lies in the window
    (the box and its ring), outside the image only on the ring."""
    D = 9
    case = _case(3 * C, C)
    _, windows = _model("var", case, D)
    ref, srcs, src_projs, ref_proj, _, lo, step = (_t(x) for x in case)
    H, W = srcs.shape[2:4]
    hyp = tsweep._hyp(lo, step, 0, D)
    n = ring = 0
    for win in windows:
        u, v = sweep_coords(srcs[win["view"]], src_projs[win["view"]], ref_proj, hyp)
        b, ds, ys, xs = win["b"], win["ds"], win["ys"], win["xs"]
        taps = _taps(u[b, ds, ys, xs], v[b, ds, ys, xs], H, W)
        some = sum(ok for *_, ok in taps) > 0
        if win["box"] is None:
            assert not some.any()
            continue
        x0, y0, x1, y1 = win["box"]
        for xi, yi, _, ok in taps:
            assert ((xi[ok] >= x0) & (xi[ok] <= x1) & (yi[ok] >= y0) & (yi[ok] <= y1)).all()
            xs_, ys_ = xi[some], yi[some]
            assert ((xs_ >= x0 - 1) & (xs_ <= x1 + 1) & (ys_ >= y0 - 1) & (ys_ <= y1 + 1)).all()
            n += int(ok.sum())
            ring += int((some & ~ok).sum())
    assert n > 0 and ring > 0  # in-image taps, and taps on the ring


def test_smooth_geometry_windows_are_a_few_pixels_past_the_tile():
    """Under the bench's kind of geometry (x-baselines, a smooth window) every
    window is staged and spans the tile plus a few pixels."""
    C, D = 32, 8
    case = _case(5, C, B=1, h=16, w=64, blocky=False)
    _, windows = _model("fused", case, D, elem=2)
    for win in windows:
        x0, y0, x1, y1 = win["box"]
        assert win["staged"]
        assert x1 - x0 + 1 <= TILE_W + 8 and y1 - y0 + 1 <= tile_rows(C) + 2


@pytest.mark.parametrize("C,elem", [(8, 2), (16, 2), (32, 2), (8, 4), (16, 4), (32, 4)])
def test_window_slots_spread_a_chunk_over_the_banks(C, elem):
    """A staged pixel's odd slot count puts one 16-byte chunk of any 8
    neighbouring pixels in 8 different groups of 4 banks, so a quarter warp's
    16-byte loads take one shared-memory wavefront."""
    K = pixel_slots(C, elem)
    assert K % 2 == 1 and K * 16 >= C * elem
    for q0 in range(64):
        for c in range(C * elem // 16):
            assert len({((q0 + i) * K + c) % 8 for i in range(8)}) == 8
