"""A CPU model of the corr walks, K1 and K5-corr (``adamvs_tpu_torch/csrc/
sweep_fuse.cu::corr_walk_kernel``, ``csrc/sweep_bwd.cu::corr_walk_bwd_kernel``).

The corr volume is one scalar per sample, ``sum_k w_k (ref . s_k) / C``, so
its C-wide work is one dot product per source pixel that a tap touches. A
kernel thread owns one (view, batch, reference pixel) and a run of hypotheses
(``RUN_K1``, ``RUN_K5``), walks them in order, and holds the 2x2 tap set of the last
sample: its corner and, per tap, the dot product (K1) or the coefficient
``a_q`` summed so far (K5-corr). A tap of the new set that was in the held
set (the corner moved by at most one pixel in x and y) reuses it; a tap that
counts (in the image, weight not 0) and was not held costs a dot product
(K1); a held tap that leaves the set, and every held tap at the end of the
run or at a sample with no tap in the image, is flushed (K5-corr):
``d src_q += a_q ref`` and ``d ref += a_q s_q``. This model does the same in
plain PyTorch at small sizes, through the CUDA path's width helpers, and is
held to the plain versions (``corr_volume_ref``, ``corr_volume_vjp``) and to
the exact JAX form (``_xla_corr_volume``) and ``jax.vjp`` of it. It also
counts the dot products and flushes. The card runs the kernels themselves
against the plain versions (``chip_smoke.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adamvs_tpu.ops.sweep_fuse import _xla_corr_volume
from adamvs_tpu_torch.ops import sweep_fuse as tsweep
from adamvs_tpu_torch.ops.warp import sweep_coords
from tests.test_torch_import_msrednet import _real_cameras

torch.set_num_threads(2)

# the kernels' run lengths (kRun of csrc/sweep_fuse.cu and of csrc/sweep_bwd.cu)
RUN_K1, RUN_K5 = 48, 16


def _tap_grid(u, v, H, W):
    """``common.cuh::bilinear_tap_grid`` of positions [N] (``sweep_position``:
    -1e9 behind the camera): (whether each tap lies in the image [N,4], x0,
    y0, the four tap weights [N,4]); x0 and y0 are clamped to [-1, W-1] and
    [-1, H-1], NaN to -1, as ``fmaxf``/``fminf`` clamp them."""
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    eu, ev = 1 - du, 1 - dv
    w = torch.stack([eu * ev, du * ev, eu * dv, du * dv], dim=1)
    xok = [(x >= 0) & (x <= W - 1) for x in (u0, u0 + 1)]
    yok = [(y >= 0) & (y <= H - 1) for y in (v0, v0 + 1)]
    ok = torch.stack([xok[k & 1] & yok[k >> 1] for k in range(4)], dim=1)
    x0 = torch.nan_to_num(u0, nan=-1.0).clamp(-1, W - 1).long()
    y0 = torch.nan_to_num(v0, nan=-1.0).clamp(-1, H - 1).long()
    return ok, x0, y0, w


def _walk_taps(ok, w):
    """``common.cuh::walk_taps``: the taps that lie in the image and weigh
    not 0, as bits k [N]."""
    bits = torch.zeros(ok.shape[0], dtype=torch.long)
    for k in range(4):
        bits = bits | ((ok[:, k] & (w[:, k] != 0)).long() << k)
    return bits


def _staying(ddx, ddy):
    """``common.cuh::staying``: the held taps (bits j) that stay in the set
    when its corner moves by (ddx, ddy)."""
    def side(dd, one, minus):
        return torch.where(dd == 0, 0xF, torch.where(dd == 1, one, torch.where(dd == -1, minus, 0)))
    return side(ddx, 0xA, 0x5) & side(ddy, 0xC, 0x3)


def _move_bits(bits, ddx, ddy):
    """``common.cuh::move_bits``: bits from the held index to the new one."""
    bits = torch.where(ddx == 1, (bits >> 1) & 0x5, torch.where(ddx == -1, (bits << 1) & 0xA, bits))
    return torch.where(ddy == 1, (bits >> 2) & 0x3, torch.where(ddy == -1, (bits << 2) & 0xC, bits))


def _move_values(v, ddx, ddy):
    """``common.cuh::move_values``: values [N,4] from the held index to the
    new one."""
    a0, a1 = torch.where(ddx == 1, v[:, 1], v[:, 0]), torch.where(ddx == -1, v[:, 0], v[:, 1])
    a2, a3 = torch.where(ddx == 1, v[:, 3], v[:, 2]), torch.where(ddx == -1, v[:, 2], v[:, 3])
    return torch.stack([torch.where(ddy == 1, a2, a0), torch.where(ddy == 1, a3, a1),
                        torch.where(ddy == -1, a0, a2), torch.where(ddy == -1, a1, a3)], dim=1)


def _bit(bits, k):
    return (bits >> k) & 1 == 1


def _pairs(ref, srcs, src_projs, ref_proj, lo, step, D):
    """Per view: (positions u, v [N,D], the view's source rows [B*H*W, C],
    the offset of each pair's batch in them [N], ref rows [N,C]) over the
    N = B*h*w (batch, reference pixel) pairs."""
    B, h, w, C = ref.shape
    H, W = srcs.shape[2:4]
    hyp = tsweep._hyp(lo, step, 0, D)
    base = torch.arange(B).repeat_interleave(h * w) * (H * W)
    for v in range(srcs.shape[0]):
        u, vv = sweep_coords(srcs[v], src_projs[v], ref_proj, hyp)  # [B,D,h,w]
        yield (u.permute(0, 2, 3, 1).reshape(-1, D), vv.permute(0, 2, 3, 1).reshape(-1, D),
               srcs[v].reshape(-1, C), base, ref.reshape(-1, C))


def walk_volume(ref, srcs, src_projs, ref_proj, lo, step, D, run=RUN_K1, counts=None):
    """K1 at one launch width as the walk computes it: [Vs,B,D,h,w] float32.
    ``counts`` gets the samples walked and the dot products computed."""
    counts = {"samples": 0, "dots": 0} if counts is None else counts
    B, h, w, C = ref.shape
    Vs, _, H, W, _ = srcs.shape
    out = torch.zeros((Vs, B, D, h, w))
    for v, (U, V, rows, base, r) in enumerate(_pairs(ref, srcs, src_projs, ref_proj, lo, step,
                                                      D)):
        N = r.shape[0]
        for d0 in range(0, D, run):
            hx = hy = held = torch.zeros(N, dtype=torch.long)
            dot = torch.zeros((N, 4))
            for d in range(d0, min(D, d0 + run)):
                ok, x0, y0, wt = _tap_grid(U[:, d], V[:, d], H, W)
                some = ok.any(1)
                ddx, ddy = x0 - hx, y0 - hy
                held = torch.where(some, _move_bits(held & _staying(ddx, ddy), ddx, ddy), 0)
                dot = _move_values(dot, ddx, ddy)
                taps = _walk_taps(ok, wt)
                need = taps & ~held
                acc = torch.zeros(N)
                for k in range(4):
                    q = (y0 + (k >> 1)).clamp(0, H - 1) * W + (x0 + (k & 1)).clamp(0, W - 1)
                    fresh = (r * rows[base + q]).sum(-1)
                    # a held tap is the same source pixel: its dot product is this one
                    reused = _bit(held, k) & _bit(taps, k)
                    assert torch.equal(dot[reused, k], fresh[reused])
                    dot[:, k] = torch.where(_bit(need, k), fresh, dot[:, k])
                    acc = acc + torch.where(_bit(taps, k), wt[:, k] * dot[:, k], 0.0)
                    counts["dots"] += int(_bit(need, k).sum())
                held = held | need
                hx, hy = torch.where(some, x0, hx), torch.where(some, y0, hy)
                counts["samples"] += N
                out[v, :, d] = (acc / C).reshape(B, h, w)
    return out


def walk_vjp(g, ref, srcs, src_projs, ref_proj, lo, step, run=RUN_K5, counts=None):
    """K5-corr at one launch width as the walk computes it, float32: (d ref
    [B,h,w,C], d srcs [Vs,B,H,W,C]) for the cotangent ``g`` [Vs,B,D,h,w].
    ``counts`` gets the samples walked and the flushes."""
    counts = {"samples": 0, "flushes": 0} if counts is None else counts
    B, h, w, C = ref.shape
    Vs, _, H, W, _ = srcs.shape
    D = g.shape[2]
    dref = torch.zeros((B * h * w, C))
    dsrc = torch.zeros((Vs, B * H * W, C))
    for v, (U, V, rows, base, r) in enumerate(_pairs(ref, srcs, src_projs, ref_proj, lo, step,
                                                      D)):
        N = r.shape[0]
        n = torch.arange(N)
        G = g[v].permute(0, 2, 3, 1).reshape(N, D) / C
        for d0 in range(0, D, run):
            d1 = min(D, d0 + run)
            hx = hy = torch.zeros(N, dtype=torch.long)
            coef = torch.zeros((N, 4))
            for d in range(d0, d1 + 1):  # one step past the run flushes what is held
                past = torch.full((N,), -1e9)  # past the run: no tap
                ok, x0, y0, wt = _tap_grid(U[:, d] if d < d1 else past,
                                           V[:, d] if d < d1 else past, H, W)
                some = ok.any(1)
                ddx = torch.where(some, x0 - hx, 0)
                ddy = torch.where(some, y0 - hy, 0)
                stay = torch.where(some, _staying(ddx, ddy), 0)
                for j in range(4):
                    f = ~_bit(stay, j) & (coef[:, j] != 0)
                    qx, qy = hx[f] + (j & 1), hy[f] + (j >> 1)
                    # a tap with a coefficient lay in the image
                    assert bool(((qx >= 0) & (qx < W) & (qy >= 0) & (qy < H)).all())
                    q = base[f] + qy * W + qx
                    a = coef[f, j, None]
                    dsrc[v].index_add_(0, q, a * r[f])
                    dref.index_add_(0, n[f], a * rows[q])
                    counts["flushes"] += int(f.sum())
                coef = _move_values(coef, ddx, ddy)
                kept = _move_bits(stay, ddx, ddy)
                taps = _walk_taps(ok, wt)
                for k in range(4):
                    ck = torch.where(_bit(kept, k), coef[:, k], 0.0)
                    coef[:, k] = torch.where(_bit(taps, k), ck + wt[:, k] * G[:, min(d, D - 1)], ck)
                if d < d1:
                    counts["samples"] += N
                hx, hy = x0, y0
    return dref.reshape(B, h, w, C), dsrc.reshape(Vs, B, H, W, C)


# --- cases -----------------------------------------------------------------------

def bench_case(seed, C, h=6, w=128, B=1, Vs=4, D=48):
    """The bench's stage-1 camera (``chip_smoke.py::bench_projs``): f 550,
    an x-baseline of 10 m per view, depths 300-500 in D steps; a crop wide
    enough that the far views' taps (11-73 px off) stay in the image for
    some pixels. How far the taps move per hypothesis depends on these, not on
    the frame size."""
    rng = np.random.RandomState(seed)
    proj = _real_cameras(B, Vs + 1, h, w, f=550.0, baseline=10.0)
    lo = np.full((B, h, w), 300.0, np.float32)
    step = np.full((B, h, w), 200.0 / (D - 1), np.float32)
    return (rng.randn(B, h, w, C).astype(np.float32),
            rng.randn(Vs, B, h, w, C).astype(np.float32),
            np.ascontiguousarray(proj[:, 1:].transpose(1, 0, 2, 3)), proj[:, 0], lo, step), D


def tile_case(seed, C, B=2, Vs=3, h=13, w=45, D=19):
    """The tile tests' case (``test_torch_port_sweep_tiles.py::_case``):
    perturbed rotations, so that rows change; a blocky window with a block
    behind the camera; near samples leaving the image; steps of 0.5-1.5 in
    depth that make taps jump; D 19, a whole run and a partial one."""
    rng = np.random.RandomState(seed)
    ref = rng.randn(B, h, w, C).astype(np.float32)
    srcs = rng.randn(Vs, B, h, w, C).astype(np.float32)
    proj = _real_cameras(B, Vs + 1, h, w, f=30.0, baseline=1.0)
    proj[:, 1:, :3, :3] += 0.02 * rng.randn(B, Vs, 3, 3).astype(np.float32)
    rng.rand(B, h, w, Vs)  # the tile tests' weights, unused here
    coarse = torch.from_numpy((-2.0 + 30.0 * rng.rand(B, 1, 3, 5)).astype(np.float32))
    coarse[:, :, 0, 0] = -3.0
    lo = F.interpolate(coarse, size=(h, w), mode="nearest")[:, 0].numpy()
    step = (0.5 + rng.rand(B, h, w)).astype(np.float32)
    return (ref, srcs, np.ascontiguousarray(proj[:, 1:].transpose(1, 0, 2, 3)), proj[:, 0],
            np.ascontiguousarray(lo), step), D


def sides_case(seed, C, B=1, h=7, w=48, D=24):
    """Two source views on either side of the reference: over the
    hypotheses (depths 8 to 16), one view's taps move 8 px left and the
    other's 8 px right, a third of a pixel per hypothesis."""
    rng = np.random.RandomState(seed)
    proj = _real_cameras(B, 3, h, w, f=40.0, baseline=3.2)
    proj[:, 2, 0, 3] = -proj[:, 1, 0, 3]  # the second source view on the other side
    lo = np.full((B, h, w), 8.0, np.float32)
    step = np.full((B, h, w), 8.0 / (D - 1), np.float32)
    return (rng.randn(B, h, w, C).astype(np.float32),
            rng.randn(2, B, h, w, C).astype(np.float32),
            np.ascontiguousarray(proj[:, 1:].transpose(1, 0, 2, 3)), proj[:, 0], lo, step), D


CASES = {"bench": bench_case, "tiles": tile_case, "sides": sides_case}
# tolerance against the exact JAX form, relative to its largest value
JAX_TOL = {"bench": 3e-5, "tiles": 1e-5, "sides": 1e-5}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _model_volume(case, D, run=RUN_K1, counts=None):
    """The walk through the CUDA path's width helpers (C 1-4 padded to 8,
    C 64/128 as groups of 32), at the true width."""
    ref, srcs, src_projs, ref_proj, lo, step = (_t(x) for x in case)
    outs, G = tsweep.run_groups("corr", ref, srcs, lambda r, s, _: walk_volume(
        r, s, src_projs, ref_proj, lo, step, D, run, counts))
    return tsweep.merge_volumes("corr", outs, ref.shape[-1], G)


def _model_vjp(case, g, run=RUN_K5, counts=None):
    ref, srcs, src_projs, ref_proj, lo, step = (_t(x) for x in case)
    parts, _ = tsweep.run_groups("corr", ref, srcs, lambda r, s, gi: walk_vjp(
        gi, r, s, src_projs, ref_proj, lo, step, run, counts), g)
    return tsweep.merge_gradients(parts, ref.shape[-1])


def _probe(case, D, seed):
    """A cotangent in JAX's layout [Vs,B,h,w,D]."""
    Vs = case[1].shape[0]
    B, h, w = case[0].shape[:3]
    return np.random.RandomState(seed).randn(Vs, B, h, w, D).astype(np.float32)


@pytest.mark.parametrize("kind", ["bench", "tiles", "sides"])
@pytest.mark.parametrize("C", [1, 4, 8, 32, 128])
def test_walk_volume_matches_plain_and_jax(kind, C):
    """K1's walk against the plain volume (1e-6 of its largest value: only
    the order of the float32 sums differs) and the exact JAX form (1e-5; at
    the bench camera 3e-5, as its taps lie 11-73 px off their pixels and the
    plain forms of PyTorch and XLA round those positions apart: they differ
    by up to 2.1e-5 there themselves)."""
    case, D = CASES[kind](C + len(kind), C)
    got = _model_volume(case, D)
    ref, srcs, src_projs, ref_proj, lo, step = (_t(x) for x in case)
    assert _rel(got, tsweep.corr_volume_ref(ref, srcs, src_projs, ref_proj, lo, step, D)) <= 1e-6
    want = _xla_corr_volume(*(jnp.asarray(x) for x in case), D)  # [Vs,B,h,w,D]
    assert _rel(got, np.moveaxis(np.asarray(want), -1, 2)) <= JAX_TOL[kind]


@pytest.mark.parametrize("kind", ["bench", "tiles", "sides"])
@pytest.mark.parametrize("C", [1, 4, 8, 32, 128])
def test_walk_vjp_matches_plain_and_jax(kind, C):
    """K5-corr's walk: d ref and d srcs against the plain VJP (1e-6 of its
    largest value) and jax.vjp of the exact JAX form (``JAX_TOL``)."""
    case, D = CASES[kind](2 * C + len(kind), C)
    probe = _probe(case, D, C)
    g = _t(probe).permute(0, 1, 4, 2, 3).contiguous()  # [Vs,B,D,h,w]
    got = _model_vjp(case, g)
    ref, srcs, src_projs, ref_proj, lo, step = (_t(x) for x in case)
    plain = tsweep.corr_volume_vjp(g, ref, srcs, src_projs, ref_proj, lo, step)
    _, vjp = jax.vjp(lambda r, s: _xla_corr_volume(r, s, *(jnp.asarray(x) for x in case[2:]), D),
                     jnp.asarray(case[0]), jnp.asarray(case[1]))
    want = vjp(jnp.asarray(probe))
    for a, b, c in zip(got, plain, want):
        assert a.shape == b.shape and _rel(a, b) <= 1e-6
        assert _rel(a, c) <= JAX_TOL[kind]


@pytest.mark.parametrize("kind", ["tiles", "sides"])
def test_runs_of_one_recompute_every_tap(kind):
    """With runs of one hypothesis nothing is held: every tap that counts
    costs a dot product and a flush, and the results are those of the
    plain versions all the same."""
    C = 8
    case, D = CASES[kind](3, C)
    ref, srcs, src_projs, ref_proj, lo, step = (_t(x) for x in case)
    counts = {"samples": 0, "dots": 0}
    got = _model_volume(case, D, run=1, counts=counts)
    assert _rel(got, tsweep.corr_volume_ref(ref, srcs, src_projs, ref_proj, lo, step, D)) <= 1e-6
    taps = 0
    for U, V, *_ in _pairs(ref, srcs, src_projs, ref_proj, lo, step, D):
        for d in range(D):
            ok, _, _, wt = _tap_grid(U[:, d], V[:, d], *srcs.shape[2:4])
            bits = _walk_taps(ok, wt)
            taps += sum(int(_bit(bits, k).sum()) for k in range(4))
    assert counts["dots"] == taps > 0
    g = _t(_probe(case, D, 5)).permute(0, 1, 4, 2, 3).contiguous()
    bwd = {"samples": 0, "flushes": 0}
    got = _model_vjp(case, g, run=1, counts=bwd)
    plain = tsweep.corr_volume_vjp(g, ref, srcs, src_projs, ref_proj, lo, step)
    assert all(_rel(a, b) <= 1e-6 for a, b in zip(got, plain))
    assert bwd["flushes"] == taps


def test_taps_moving_right_and_left_are_reused():
    """In both directions of travel along the epipolar line a sample costs
    well under one dot product, and the held taps give the same volume as
    computing every tap (runs of one)."""
    C = 8
    case, D = sides_case(11, C)
    ref, srcs, src_projs, ref_proj, lo, step = (_t(x) for x in case)
    U = [u[:, -1] - u[:, 0] for u, *_ in _pairs(ref, srcs, src_projs, ref_proj, lo, step, D)]
    assert (U[0] < -7).all() and (U[1] > 7).all()  # view 1's taps move left, view 2's right
    per_view = []
    for v in range(2):
        one = tuple(x[v:v + 1] if i in (1, 2) else x for i, x in enumerate(case))
        counts = {"samples": 0, "dots": 0}
        walked = _model_volume(one, D, counts=counts)
        assert torch.equal(walked, _model_volume(one, D, run=1))
        per_view.append(counts["dots"] / counts["samples"])
    assert all(0.0 < p < 0.5 for p in per_view), per_view


def test_the_volume_does_not_depend_on_the_run_length():
    """A held dot product is the one a fresh tap would compute, so runs of
    any length give the same volume, bit for bit."""
    case, D = tile_case(9, 8)
    want = _model_volume(case, D, run=1)
    for run in (3, RUN_K5, RUN_K1):
        assert torch.equal(_model_volume(case, D, run=run), want)


def test_dots_per_sample_at_the_bench_camera():
    """At the bench's stage-1 camera over its whole training frame (96x192,
    4 source views, D 48): K1's runs of 48 hypotheses cost 0.473 dot
    products per sample, and K5-corr's runs of 16 0.522 flushes (as many as
    K1 would compute dot products at that run length), against 4 taps per
    sample without the walk."""
    C = 1  # the counts do not depend on the features
    case, D = bench_case(0, C, h=96, w=192)
    ref, srcs, src_projs, ref_proj, lo, step = (_t(x) for x in case)
    fwd = {"samples": 0, "dots": 0}
    walk_volume(ref, srcs, src_projs, ref_proj, lo, step, D, counts=fwd)
    assert fwd["samples"] == 4 * 96 * 192 * 48
    assert 0.45 < fwd["dots"] / fwd["samples"] < 0.5, fwd
    short = {"samples": 0, "dots": 0}
    walk_volume(ref, srcs, src_projs, ref_proj, lo, step, D, run=RUN_K5, counts=short)
    assert 0.5 < short["dots"] / short["samples"] < 0.55, short
    g = torch.randn((4, 1, D, 96, 192), generator=torch.Generator().manual_seed(0))
    bwd = {"samples": 0, "flushes": 0}
    walk_vjp(g, ref, srcs, src_projs, ref_proj, lo, step, counts=bwd)
    assert bwd["samples"] == fwd["samples"] and bwd["flushes"] == short["dots"]
