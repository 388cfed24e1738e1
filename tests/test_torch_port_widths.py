"""The channel widths of the port's sweeps and sampler, on the CPU.

On the card a sweep launch takes 8, 16 or 32 channels and the sampler a
multiple of 8. The CUDA wrappers reach every width the JAX package takes by
zero-padding narrower features, cutting wider ones into channel groups, and
merging the launches' results at the true width
(``ops/sweep_fuse.py::sweep_plan``, ``run_groups``, ``merge_volumes``,
``merge_gradients``; ``ops/warp_sample.py::sample_width``). Here those same
helpers run with the plain versions in place of the kernels, and are held to
the plain forms at the true width and to the exact JAX forms
(``_xla_corr_volume``, ``_xla_fused_volume``, ``_xla_var_volume``,
``ops/warp.py::bilinear_sample``). The card runs the kernels themselves at
these widths (``chip_smoke.py::phase_edges``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adamvs_tpu.ops import warp as jwarp
from adamvs_tpu.ops.sweep_fuse import _xla_corr_volume, _xla_fused_volume, _xla_var_volume
from adamvs_tpu_torch.ops import sweep_fuse as tsweep
from adamvs_tpu_torch.ops import warp as twarp
from adamvs_tpu_torch.ops import warp_sample as tsample
from tests.test_torch_import_msrednet import _real_cameras

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _case(seed, C, B=2, Vs=3, h=9, w=13):
    """x-baselines with one rotated view, per-pixel windows of which a third
    start behind the camera, near depths sending taps out of the image."""
    rng = np.random.RandomState(seed)
    ref = rng.randn(B, h, w, C).astype(np.float32)
    srcs = rng.randn(Vs, B, h, w, C).astype(np.float32)
    proj = _real_cameras(B, Vs + 1, h, w, f=40.0, baseline=0.6)
    proj[:, 2, :3, :3] += (0.03 * rng.randn(B, 3, 3)).astype(np.float32)
    weights = rng.rand(B, h, w, Vs).astype(np.float32)
    lo = (20.0 + 3.0 * rng.randn(B, h, w)).astype(np.float32)
    lo[:, :, : w // 3] -= 24.0
    step = (0.9 + 0.1 * rng.rand(B, h, w)).astype(np.float32)
    return (ref, srcs, weights, np.ascontiguousarray(proj[:, 1:].transpose(1, 0, 2, 3)),
            proj[:, 0], lo, step)


def _plain_volume(mode, ref, srcs, wn, geo, D):
    if mode == "corr":
        return tsweep.corr_volume_ref(ref, srcs, *geo, D)
    if mode == "fused":
        return tsweep.fused_volume_wn(ref, srcs, wn, *geo, D)
    return tsweep.var_volume_ref(ref, srcs, *geo, D)


def _plain_vjp(mode, g, ref, srcs, wn, geo):
    """The plain VJP as a launch returns it: (d ref, [d wn,] d srcs)."""
    if mode == "corr":
        return tsweep.corr_volume_vjp(g, ref, srcs, *geo)
    if mode == "fused":
        dref, dsrc, dwn = tsweep.fused_volume_vjp(g, ref, srcs, wn, *geo)
        return dref, dwn, dsrc
    return tsweep.var_volume_vjp(g, ref, srcs, *geo)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("mode", ["corr", "fused", "var"])
@pytest.mark.parametrize("C", [1, 2, 4, 64, 128])
def test_grouped_volume_matches_plain_and_jax(mode, C):
    """The volume through the CUDA path's padding, groups and merge, with
    the plain volume as each launch, equals the plain volume at the true
    width (1e-6 of its largest value: corr's groups sum in another order)
    and the exact JAX form (1e-5)."""
    D = 5
    ref, srcs, weights, src_projs, ref_proj, lo, step = _case(C + len(mode), C)
    geo = tuple(_t(x) for x in (src_projs, ref_proj, lo, step))
    wn = tsweep.normalize_weights(_t(weights).permute(0, 3, 1, 2))
    outs, G = tsweep.run_groups(mode, _t(ref), _t(srcs), lambda r, s, _: _plain_volume(
        mode, r, s, wn, geo, D))
    Cp, _ = tsweep.sweep_plan(C)
    assert len(outs) == Cp // G
    got = tsweep.merge_volumes(mode, outs, C, G)
    want = _plain_volume(mode, _t(ref), _t(srcs), wn, geo, D)
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-6
    jgeo = [jnp.asarray(x) for x in (src_projs, ref_proj, lo, step)]
    if mode == "corr":
        jax_vol = _xla_corr_volume(jnp.asarray(ref), jnp.asarray(srcs), *jgeo, D)
        jax_vol = _t(np.asarray(jax_vol)).permute(0, 1, 4, 2, 3)  # [Vs,B,D,h,w]
    elif mode == "fused":
        jax_vol = _xla_fused_volume(jnp.asarray(ref), jnp.asarray(srcs), jnp.asarray(weights),
                                    *jgeo, D)
        jax_vol = _t(np.asarray(jax_vol)).permute(0, 1, 4, 2, 3)  # [D,B,C,h,w]
    else:
        jax_vol = _xla_var_volume(jnp.asarray(ref), jnp.asarray(srcs), *jgeo, D)
        jax_vol = _t(np.asarray(jax_vol)).permute(0, 1, 4, 2, 3)
    assert _rel(got, jax_vol) <= 1e-5


@pytest.mark.parametrize("mode", ["corr", "fused", "var"])
@pytest.mark.parametrize("C", [1, 2, 4, 64, 128])
def test_grouped_vjp_matches_plain_and_jax(mode, C):
    """d ref, d srcs (and d weights) through the CUDA path's groups, with the
    plain VJP as each launch, equal the plain VJP at the true width (1e-6)
    and jax.grad of the exact JAX form (1e-5, d weights through the weight
    normalisation)."""
    D = 5
    ref, srcs, weights, src_projs, ref_proj, lo, step = _case(3 * C + len(mode), C)
    B, h, w, _ = ref.shape
    Vs = srcs.shape[0]
    geo = tuple(_t(x) for x in (src_projs, ref_proj, lo, step))
    tw = _t(weights).permute(0, 3, 1, 2).contiguous().requires_grad_()
    wn = tsweep.normalize_weights(tw)
    rng = np.random.RandomState(C)
    if mode == "corr":
        probe = rng.randn(Vs, B, h, w, D).astype(np.float32)  # JAX layout [Vs,B,h,w,D]
    else:
        probe = rng.randn(D, B, h, w, C).astype(np.float32)  # JAX layout [D,B,h,w,C]
    g = _t(probe).permute(0, 1, 4, 2, 3).contiguous()
    parts, _ = tsweep.run_groups(mode, _t(ref), _t(srcs), lambda r, s, gi: _plain_vjp(
        mode, gi, r, s, wn.detach(), geo), g)
    got = tsweep.merge_gradients(parts, C)
    want = _plain_vjp(mode, g, _t(ref), _t(srcs), wn.detach(), geo)
    want = (want[0], want[-1]) + ((want[1],) if mode == "fused" else ())
    for a, b, name in zip(got, want, ("ref", "srcs", "wn")):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= 1e-6, name

    jgeo = [jnp.asarray(x) for x in (src_projs, ref_proj, lo, step)]
    if mode == "corr":
        jgrads = jax.grad(lambda r, s: jnp.sum(_xla_corr_volume(r, s, *jgeo, D) * probe),
                          argnums=(0, 1))(jnp.asarray(ref), jnp.asarray(srcs))
    elif mode == "fused":
        jgrads = jax.grad(lambda r, s, wt: jnp.sum(_xla_fused_volume(r, s, wt, *jgeo, D) * probe),
                          argnums=(0, 1, 2))(jnp.asarray(ref), jnp.asarray(srcs),
                                             jnp.asarray(weights))
    else:
        jgrads = jax.grad(lambda r, s: jnp.sum(_xla_var_volume(r, s, *jgeo, D) * probe),
                          argnums=(0, 1))(jnp.asarray(ref), jnp.asarray(srcs))
    assert _rel(got[0], jgrads[0]) <= 1e-5
    assert _rel(got[1], jgrads[1]) <= 1e-5
    if mode == "fused":  # d wn back through w / (1e-5 + sum w) to the raw weights
        (draw,) = torch.autograd.grad(wn, tw, got[2])
        assert _rel(draw.permute(0, 2, 3, 1), jgrads[2]) <= 1e-5


@pytest.mark.parametrize("C", [3, 12])
def test_sampler_padding_matches_plain_and_jax(C):
    """The sampler's padding to a multiple of 8, sampled by the plain
    version and cut, equals the plain sampler and JAX's at the true width."""
    rng = np.random.RandomState(C)
    B, H, W, N, h, w = 2, 11, 14, 3, 7, 9
    feat = rng.randn(B, H, W, C).astype(np.float32)
    u = (-3.0 + (W + 6.0) * rng.rand(B, N, h, w)).astype(np.float32)
    v = (-3.0 + (H + 6.0) * rng.rand(B, N, h, w)).astype(np.float32)
    u[:, 0, :2] = -1e9
    Cp = tsample.sample_width(C)
    assert Cp % 8 == 0 and Cp - 8 < C <= Cp
    padded = twarp.pad_channels(_t(feat), Cp)
    assert padded.shape[-1] == Cp and not padded[..., C:].any()
    got = tsample.sample_bilinear_ref(padded, _t(u), _t(v))[..., :C]
    torch.testing.assert_close(got, tsample.sample_bilinear_ref(_t(feat), _t(u), _t(v)),
                               rtol=0, atol=0)
    want = np.asarray(jwarp.bilinear_sample(jnp.asarray(feat), jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_width_rules():
    """The sweeps take every C with 128 % C == 0, as the JAX package's, and
    no other; the plan pads below 8 and groups past the widest launch, 32. The sampler takes any C >= 1."""
    for C in range(1, 260):
        if 128 % C == 0:
            tsweep.check_sweep_width(C)
            Cp, G = tsweep.sweep_plan(C)
            assert Cp == max(C, 8) and G == min(Cp, 32) and Cp % G == 0
        else:
            with pytest.raises(ValueError, match="128 % C == 0"):
                tsweep.check_sweep_width(C)
        assert tsample.sample_width(C) == 8 * ((C + 7) // 8)
    with pytest.raises(ValueError, match="C >= 1"):
        tsample.sample_width(0)
