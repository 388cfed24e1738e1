"""Port ops against the JAX package: the warp, samplers, resize and softmax
regression, the plain versions of kernels K1 (corr volume), K2 (fused volume)
and K4 (variance volume) against the exact forms the Pallas kernels are held
to (``_xla_corr_volume``, ``_xla_fused_volume``, ``_xla_var_volume``), and the
plain K6/K7 bilinear sampler against the JAX gather and both Pallas samplers
in interpret mode. Also the port's ground rules: no JAX import anywhere in
the port, CUDA by default, no kernel build on a CPU call. Everything here
runs on the CPU at float32."""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adamvs_tpu.ops import regression as jreg
from adamvs_tpu.ops import sampling as jsamp
from adamvs_tpu.ops import warp as jwarp
from adamvs_tpu.ops.sweep_fuse import _xla_corr_volume, _xla_fused_volume, _xla_var_volume
from adamvs_tpu.ops.warp_pallas import banded_bilinear_sample_pallas
from adamvs_tpu.ops.warp_pallas2 import banded_bilinear_sample_pallas2
from adamvs_tpu_torch.kernels import build
from adamvs_tpu_torch.ops import red_scan as tred
from adamvs_tpu_torch.ops import regression as treg
from adamvs_tpu_torch.ops import sampling as tsamp
from adamvs_tpu_torch.ops import sweep_fuse as tsweep
from adamvs_tpu_torch.ops import warp as twarp
from adamvs_tpu_torch.ops import warp_sample as tsample
from tests.test_torch_import_msrednet import _real_cameras

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _sweep_case(seed, B, Vs, h, w, C, windowed):
    """Realistic cameras (x-baselines), random features, and either the
    uniform stage-1 hypotheses or a per-pixel window."""
    rng = np.random.RandomState(seed)
    ref = rng.randn(B, h, w, C).astype(np.float32)
    srcs = rng.randn(Vs, B, h, w, C).astype(np.float32)
    proj = _real_cameras(B, Vs + 1, h, w, f=40.0, baseline=1.5)
    ref_proj = proj[:, 0]
    src_projs = np.ascontiguousarray(proj[:, 1:].transpose(1, 0, 2, 3))
    weights = rng.rand(B, h, w, Vs).astype(np.float32)
    if windowed:
        lo = (20.0 + 3.0 * rng.randn(B, h, w)).astype(np.float32)
        step = (0.9 + 0.1 * rng.rand(B, h, w)).astype(np.float32)
    else:
        lo = np.full((B, h, w), 10.0, np.float32)
        step = np.full((B, h, w), 2.5, np.float32)
    return ref, srcs, src_projs, ref_proj, weights, lo, step


# --- warp -----------------------------------------------------------------

@pytest.mark.parametrize("per_pixel", [False, True])
def test_plane_sweep_warp_matches_jax(per_pixel):
    """Covers behind-camera samples (negative depths: z <= 1e-6) and taps
    leaving the image (a wide baseline at near depths)."""
    rng = np.random.RandomState(0)
    B, H, W, C, D = 2, 12, 16, 5, 6
    feat = rng.randn(B, H, W, C).astype(np.float32)
    proj = _real_cameras(B, 2, H, W, f=20.0, baseline=3.0)
    proj[1, 1, :3, :3] += 0.05 * rng.randn(3, 3).astype(np.float32)  # a rotated view
    depth = np.linspace(-4.0, 30.0, D, dtype=np.float32)[None].repeat(B, 0)  # [B,D]
    if per_pixel:
        depth = depth[:, :, None, None] + rng.rand(B, D, H, W).astype(np.float32)
    want = np.asarray(jwarp.plane_sweep_warp(
        jnp.asarray(feat), jnp.asarray(proj[:, 1]), jnp.asarray(proj[:, 0]), jnp.asarray(depth),
        grid_hw=(H, W)))
    got = twarp.plane_sweep_warp(_t(feat), _t(proj[:, 1]), _t(proj[:, 0]), _t(depth),
                                 grid_hw=(H, W)).numpy()
    assert np.all(want[:, 0] == 0.0)  # the behind-camera plane is all zeros
    u, _ = twarp._source_coords(*twarp.warp_transform(_t(proj[:, 1]), _t(proj[:, 0])),
                                _t(depth), H, W)
    assert (u.numpy() > W).any() and (u.numpy() == -1e9).any()  # both edge cases occur
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# --- samplers, resize, softmax ----------------------------------------------

def test_depth_samplers_match_jax():
    rng = np.random.RandomState(1)
    dr = np.array([[300.0, 500.0], [10.0, 20.0]], np.float32)
    np.testing.assert_allclose(tsamp.uniform_depth_samples(_t(dr), 48).numpy(),
                               np.asarray(jsamp.uniform_depth_samples(jnp.asarray(dr), 48)),
                               rtol=1e-6)
    prev = (400.0 + 10 * rng.randn(2, 8, 9)).astype(np.float32)
    interval = np.array([2.5, 1.0], np.float32)[:, None, None]
    want = jsamp.window_min_and_interval(jnp.asarray(prev), 32, jnp.asarray(interval))
    got = tsamp.window_min_and_interval(_t(prev), 32, _t(interval))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("factor", [2, 4])
def test_resize_bilinear_matches_jax(factor):
    x = np.random.RandomState(factor).randn(2, 3, 7, 9).astype(np.float32)
    want = np.asarray(jreg.resize_bilinear(jnp.asarray(x), 7 * factor, 9 * factor))
    got = treg.resize_bilinear(_t(x), 7 * factor, 9 * factor).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_softmax_regression_matches_jax_online():
    """The port's online softmax and its full-softmax tail both match the
    JAX online softmax over the same cost slices and hypotheses."""
    rng = np.random.RandomState(3)
    D, B, h, w = 7, 2, 5, 6
    cost = (3.0 * rng.randn(D, B, h, w)).astype(np.float32)
    lo = (100 + rng.randn(B, h, w)).astype(np.float32)
    step = (1 + 0.1 * rng.rand(B, h, w)).astype(np.float32)
    jstate = jreg.online_softmax_init((B, h, w))
    tstate = treg.online_softmax_init((B, h, w))
    for d in range(D):
        hyp = lo + d * step
        jstate = jreg.online_softmax_update(jstate, jnp.asarray(cost[d]), jnp.asarray(hyp))
        tstate = treg.online_softmax_update(tstate, _t(cost[d]), _t(hyp))
    want = [np.asarray(x) for x in jreg.online_softmax_finalize(jstate)]
    online = [x.numpy() for x in treg.online_softmax_finalize(tstate)]
    full = [x.numpy() for x in treg.softmax_regression(_t(cost), _t(lo), _t(step))]
    for got in (online, full):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


# --- plain K1 / K2 against the exact JAX forms --------------------------------

@pytest.mark.parametrize("C,Vs,D,windowed", [(8, 2, 6, False), (16, 3, 5, True), (32, 4, 8, True)])
def test_corr_volume_ref_matches_xla(C, Vs, D, windowed):
    ref, srcs, src_projs, ref_proj, _, lo, step = _sweep_case(C + Vs, 1, Vs, 12, 20, C, windowed)
    want = np.asarray(_xla_corr_volume(
        jnp.asarray(ref), jnp.asarray(srcs), jnp.asarray(src_projs), jnp.asarray(ref_proj),
        jnp.asarray(lo), jnp.asarray(step), D))  # [Vs,B,h,w,D]
    got = tsweep.corr_sweep_volume(_t(ref), _t(srcs), _t(src_projs), _t(ref_proj), _t(lo),
                                   _t(step), D)  # [Vs,B,D,h,w], plain path on the CPU
    assert (np.abs(want) > 0).mean() > 0.5
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C,B,Vs,D,windowed", [(8, 2, 2, 4, True), (16, 1, 4, 6, False),
                                               (32, 1, 3, 3, True)])
def test_fused_volume_ref_matches_xla(C, B, Vs, D, windowed):
    ref, srcs, src_projs, ref_proj, weights, lo, step = _sweep_case(
        C * B + Vs, B, Vs, 10, 16, C, windowed)
    want = np.asarray(_xla_fused_volume(
        jnp.asarray(ref), jnp.asarray(srcs), jnp.asarray(weights), jnp.asarray(src_projs),
        jnp.asarray(ref_proj), jnp.asarray(lo), jnp.asarray(step), D))  # [D,B,h,w,C]
    got = tsweep.fused_sweep_volume(
        _t(ref), _t(srcs), _t(weights).permute(0, 3, 1, 2), _t(src_projs), _t(ref_proj),
        _t(lo), _t(step), D)  # [D,B,C,h,w]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C,B,Vs,D", [(8, 2, 2, 5), (16, 1, 4, 8), (32, 1, 3, 3)])
def test_var_volume_ref_matches_xla(C, B, Vs, D):
    """Plain K4 (and the K4 wrapper on CPU tensors) against the exact JAX
    form, with a third of the pixels' windows starting behind the camera and
    taps leaving the image."""
    ref, srcs, src_projs, ref_proj, _, lo, step = _sweep_case(C + B + Vs, B, Vs, 10, 18, C, True)
    lo[:, :, :6] -= 24.0
    want = np.asarray(_xla_var_volume(
        jnp.asarray(ref), jnp.asarray(srcs), jnp.asarray(src_projs), jnp.asarray(ref_proj),
        jnp.asarray(lo), jnp.asarray(step), D))  # [D,B,h,w,C]
    got = tsweep.var_sweep_volume(_t(ref), _t(srcs), _t(src_projs), _t(ref_proj), _t(lo),
                                  _t(step), D)  # [D,B,C,h,w]
    assert got.dtype == torch.float32 and got.shape == (D, B, C, 10, 18)
    u, _ = twarp.sweep_coords(_t(srcs[0]), _t(src_projs[-1]), _t(ref_proj),
                              tsweep._hyp(_t(lo), _t(step), 0, D))
    assert (u.numpy() == -1e9).any() and (u.numpy() > 18).any()  # both edge cases occur
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        got, tsweep.var_volume_ref(_t(ref), _t(srcs), _t(src_projs), _t(ref_proj), _t(lo),
                                   _t(step), D, block=3), rtol=0, atol=0)


# --- plain K6/K7 against the JAX samplers ----------------------------------------

def _sample_case(seed, B, N, H, W, C, h, w, lo=-4.0):
    """Features and sample coordinates over and past every border, some at
    -1e9 (behind the camera)."""
    rng = np.random.RandomState(seed)
    feat = rng.randn(B, H, W, C).astype(np.float32)
    u = rng.uniform(lo, W + 3, (B, N, h, w)).astype(np.float32)
    v = rng.uniform(lo, H + 3, (B, N, h, w)).astype(np.float32)
    u[:, :, 0, :3] = v[:, :, 0, :3] = -1e9
    return feat, u, v


@pytest.mark.parametrize("C,B,N", [(8, 2, 3), (16, 1, 1), (32, 2, 1)])
def test_sample_bilinear_matches_jax_gather(C, B, N):
    feat, u, v = _sample_case(C + N, B, N, 13, 21, C, 9, 11)
    want = np.asarray(jwarp.bilinear_sample(jnp.asarray(feat), jnp.asarray(u), jnp.asarray(v)))
    got = tsample.sample_bilinear(_t(feat), _t(u), _t(v))
    assert got.dtype == torch.float32 and got.shape == (B, N, 9, 11, C)
    assert (want == 0).all(axis=-1).any() and (want != 0).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # bf16 features: sampled from their bf16 values in float32, one rounding
    bf = _t(feat).bfloat16()
    got16 = tsample.sample_bilinear(bf, _t(u), _t(v))
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(got16, twarp.bilinear_sample(bf.float(), _t(u), _t(v)).bfloat16(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("kernel", ["pallas2", "pallas"])
def test_sample_bilinear_matches_pallas_interpret(kernel):
    """K6 (merged-lane) and K7 (v1) in interpret mode, with bands that cover
    every sample (their band truncation is a TPU artefact the port does not
    copy)."""
    feat, u, v = _sample_case(7, 2, 2, 32, 64, 8, 16, 32, lo=-2.0)
    args = (jnp.asarray(feat), jnp.asarray(u), jnp.asarray(v))
    if kernel == "pallas2":
        want = banded_bilinear_sample_pallas2(*args, tile_h=8, tile_w=16, row_band=40,
                                              col_band=120, interpret=True)
    else:
        want = banded_bilinear_sample_pallas(*args, tile_h=8, tile_w=16, row_band=32,
                                             col_band=64, interpret=True)
    got = tsample.sample_bilinear(_t(feat), _t(u), _t(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plane_sweep_warp_sampled_matches_jax_warp():
    """The scan form's warp: coordinates in plain PyTorch, sampling through
    the K6/K7 wrapper, per-pixel depth with planes behind the camera."""
    rng = np.random.RandomState(8)
    B, H, W, C = 2, 12, 16, 8
    feat = rng.randn(B, H, W, C).astype(np.float32)
    proj = _real_cameras(B, 2, H, W, f=20.0, baseline=3.0)
    depth = (np.linspace(-4.0, 30.0, 3, dtype=np.float32)[None, :, None, None]
             + rng.rand(B, 3, H, W).astype(np.float32))
    want = np.asarray(jwarp.plane_sweep_warp(
        jnp.asarray(feat), jnp.asarray(proj[:, 1]), jnp.asarray(proj[:, 0]), jnp.asarray(depth)))
    got = tsample.plane_sweep_warp_sampled(_t(feat), _t(proj[:, 1]), _t(proj[:, 0]), _t(depth))
    assert np.all(want[:, 0] == 0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_sweep_geometry_is_the_warp_transform():
    _, _, src_projs, ref_proj, _, _, _ = _sweep_case(0, 2, 3, 8, 8, 8, False)
    geom = tsweep.sweep_geometry(_t(src_projs), _t(ref_proj)).numpy().reshape(3, 2, 12)
    for v in range(3):
        rot, trans = jwarp.warp_transform(jnp.asarray(src_projs[v]), jnp.asarray(ref_proj))
        np.testing.assert_allclose(geom[v, :, :9], np.asarray(rot).reshape(2, 9), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(geom[v, :, 9:], np.asarray(trans), rtol=1e-5, atol=1e-3)


def test_handed_geometry_is_checked_and_used_as_given():
    """The wrappers' ``geom`` argument (the training forms hand the
    forward's geometry to the backward): None computes ``sweep_geometry``, a
    geometry of the right kind is taken as given, any other raises."""
    _, _, src_projs, ref_proj, _, _, _ = _sweep_case(0, 2, 3, 8, 8, 8, False)
    sp, rp = _t(src_projs), _t(ref_proj)
    want = tsweep.sweep_geometry(sp, rp)
    assert torch.equal(tsweep._geometry(None, sp, rp, 3, 2, torch.device("cpu")), want)
    assert tsweep._geometry(want, sp, rp, 3, 2, torch.device("cpu")) is want
    for bad in (want[:5], want.double(), want.t().contiguous().t()):
        with pytest.raises(ValueError, match="geom"):
            tsweep._geometry(bad, sp, rp, 3, 2, torch.device("cpu"))


# --- ground rules ---------------------------------------------------------------

def _port_files():
    root = os.path.join(REPO, "adamvs_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(root):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _forbidden(name: str) -> bool:
    return any(name == p or name.startswith(p + ".") for p in ("jax", "flax", "adamvs_tpu"))


def test_port_imports_no_jax():
    bad = []
    files = _port_files()
    assert len(files) > 10 and os.path.exists(files[0])
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _forbidden(node.module or ""):
                    bad.append((path, node.module))
    assert not bad, bad


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from adamvs_tpu_torch.models import AdaMVS, build_model, model_loss
    from adamvs_tpu_torch.predict.engine import PredictEngine
    from adamvs_tpu_torch.train.loop import Trainer
    from adamvs_tpu_torch.train.state import create_train_state, make_optimizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = AdaMVS(ndepths=(8, 4, 4), base=4, cr_base=(4, 4, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PredictEngine(model, num_depth=32, device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(ndepths=(8, 4, 4), base=4, cr_base=(4, 4, 4))
    state = create_train_state(model, make_optimizer(model.parameters()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(state, model_loss("adamvs"), str(tmp_path / "logs"))
    assert PredictEngine(model, num_depth=32, device="cpu").device.type == "cpu"
    assert Trainer(state, model_loss("adamvs"), str(tmp_path / "logs"),
                   device="cpu").device.type == "cpu"


def test_cpu_calls_take_the_plain_path_without_a_build(monkeypatch):
    """Each kernel module imports without nvcc; a CPU call never builds or
    launches a kernel."""
    def no_build(name):
        raise AssertionError(f"kernel {name} built on a CPU call")

    monkeypatch.setattr(build, "load_library", no_build)
    from adamvs_tpu_torch.nn.costreg import AdaRedCell

    ref, srcs, src_projs, ref_proj, weights, lo, step = _sweep_case(5, 1, 2, 8, 8, 8, True)
    wrappers = (tsweep.corr_sweep_volume, tsweep.fused_sweep_volume, tsweep.var_sweep_volume,
                tred.red_scan, tsample.sample_bilinear, tsweep.corr_sweep_volume_bwd,
                tsweep.fused_sweep_volume_bwd, tsweep.var_sweep_volume_bwd)
    before = [fn.launches for fn in wrappers]
    corr = tsweep.corr_sweep_volume(_t(ref), _t(srcs), _t(src_projs), _t(ref_proj), _t(lo),
                                    _t(step), 4)
    tref = _t(ref).requires_grad_()
    geo = (_t(src_projs), _t(ref_proj), _t(lo), _t(step), 4)
    (tsweep.corr_sweep_volume_t(tref, _t(srcs), *geo).sum()
     + tsweep.fused_sweep_volume_t(tref, _t(srcs), _t(weights).permute(0, 3, 1, 2), *geo).sum()
     + tsweep.var_sweep_volume_t(tref, _t(srcs), *geo).sum()).backward()
    assert tref.grad.shape == tref.shape
    fused = tsweep.fused_sweep_volume(_t(ref), _t(srcs), _t(weights).permute(0, 3, 1, 2),
                                      _t(src_projs), _t(ref_proj), _t(lo), _t(step), 4)
    var = tsweep.var_sweep_volume(_t(ref), _t(srcs), _t(src_projs), _t(ref_proj), _t(lo),
                                  _t(step), 4)
    cost = tred.red_scan(AdaRedCell(8, 4, up=True), fused)
    warped = tsample.plane_sweep_warp_sampled(_t(srcs[0]), _t(src_projs[0]), _t(ref_proj),
                                              _t(lo)[:, None])
    assert corr.shape == (2, 1, 4, 8, 8) and fused.shape == var.shape == (4, 1, 8, 8, 8)
    assert cost.shape == (4, 1, 16, 16) and warped.shape == (1, 1, 8, 8, 8)
    assert [fn.launches for fn in wrappers] == before
    assert build.sources() == ["bilinear_sample", "red_scan", "sweep_bwd", "sweep_fuse"]


def test_wrappers_reject_non_cuda_devices():
    meta = torch.empty((1, 8, 8, 8), device="meta")
    lo = torch.empty((1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tsweep.corr_sweep_volume(meta, meta[None], torch.eye(4)[None, None],
                                 torch.eye(4)[None], lo, lo, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tsweep.var_sweep_volume(meta, meta[None], torch.eye(4)[None, None],
                                torch.eye(4)[None], lo, lo, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tsample.sample_bilinear(meta, lo[:, None], lo[:, None])
    with pytest.raises(ValueError, match="CUDA"):
        tsweep.var_sweep_volume_bwd(torch.empty((4, 1, 8, 8, 8), device="meta"), meta,
                                    meta[None], torch.eye(4)[None, None], torch.eye(4)[None],
                                    lo, lo)


def test_build_runs_nvcc_per_source_and_raises_on_failure(tmp_path, monkeypatch):
    """The build with a stand-in nvcc: one compiler run per source, a failed
    source raises with the compiler's output, a built source is not rebuilt."""
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(
        '#!/bin/sh\n'
        'while [ $# -gt 1 ]; do [ "$1" = "-o" ] && out=$2; shift; done\n'
        'echo "$1" >> "$(dirname "$0")/calls"\n'
        'case "$1" in *red_scan.cu) [ -e "$(dirname "$0")/fixed" ] || '
        '{ echo "error: boom"; exit 2; } ;; esac\n'
        'echo "ptxas info : Used 1 registers" && echo lib > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))

    with pytest.raises(RuntimeError, match="boom"):
        build.build_all()
    for name in ("sweep_fuse", "sweep_bwd", "bilinear_sample"):
        assert os.path.exists(build._lib_path(name))
    assert not os.path.exists(build._lib_path("red_scan"))
    (cuda / "bin" / "fixed").write_text("")
    reports = build.build_all()
    assert list(reports) == ["red_scan"] and "Used 1 registers" in reports["red_scan"]
    calls = (cuda / "bin" / "calls").read_text().split()
    assert sorted(os.path.basename(c) for c in calls) == [
        "bilinear_sample.cu", "red_scan.cu", "red_scan.cu", "sweep_bwd.cu", "sweep_fuse.cu"]
    assert sorted(os.listdir(tmp_path / "_build")) == sorted(
        os.path.basename(build._lib_path(n)) for n in build.sources())
