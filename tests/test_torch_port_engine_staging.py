"""The engine's staged frame upload (``predict/engine.py``) on the CPU, where
the host buffer is not page-locked and the same staging code runs.

- The staged cast gives the bits of ``torch.from_numpy(x).to(dtype)`` on
  rounding ties, NaN, infinities, subnormals and values past bf16's largest,
  in chunks that split frames, with the pad rows and columns zero.
- ``predict_batch``'s outputs equal the model called directly with the
  float32 frames (padded with ``np.pad``), exactly: bf16 and float32
  AdaMVS, bf16 MS-REDNet, frames that need padding and frames that do not,
  batches of 1 and 2, the feature-cache path and row bands; a second
  request leaves the first one's outputs as they were.
- One buffer: a request of the same shape reuses it, a new shape replaces
  it; ``staged_uploads`` counts the staged uploads."""

import types

import numpy as np
import pytest
import torch

from adamvs_tpu_torch.data.pipeline import center_image
from adamvs_tpu_torch.data.synthetic import make_scene
from adamvs_tpu_torch.geom.camera import proj_matrix, stage_proj_matrices
from adamvs_tpu_torch.models import build_model
from adamvs_tpu_torch.predict import engine as engine_mod
from adamvs_tpu_torch.predict.engine import PredictEngine
from adamvs_tpu_torch.predict.tiled import tiled_forward

torch.set_num_threads(2)

TINY = dict(ndepths=(8, 4), depth_intervals_ratio=(4.0, 2.0), base=4, cr_base=(4, 4))
NUM_DEPTH = 16
MODELS = {"adamvs_bf16": ("adamvs", torch.bfloat16, dict(sweep_impl="fused", reg_impl="pallas")),
          "adamvs_f32": ("adamvs", torch.float32, dict(sweep_impl="fused", reg_impl="pallas")),
          "msrednet_bf16": ("msrednet", torch.bfloat16, dict(sweep_impl="fused"))}


@pytest.fixture(scope="module")
def scene():
    return make_scene(num_views=4, height=128, width=64, seed=0)


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    """Chunks of a few rows, so every frame spans several of them."""
    monkeypatch.setattr(engine_mod, "STAGE_CHUNK_BYTES", 5000)


def _sample(scene, order, rows, cols, view_ids=()):
    """A predict sample of the scene's views in ``order``, cropped to
    ``rows`` x ``cols``, as the loader hands it (numpy float32)."""
    views = [scene.views[i] for i in order]
    proj = np.stack([proj_matrix(v.camera) for v in views])
    imgs = np.stack([center_image(v.image) for v in views]).astype(np.float32)
    return types.SimpleNamespace(
        imgs=np.ascontiguousarray(imgs[:, :rows, :cols]),
        proj_matrices=stage_proj_matrices(proj),
        depth_values=np.array([scene.depth_start, scene.depth_end], np.float32),
        view_ids=view_ids)


def _padded(imgs):
    """[..., H, W, 3] zero-padded bottom/right to multiples of 32 (the
    engine's former ``np.pad``)."""
    H, W = imgs.shape[-3:-1]
    pad = [(0, 0)] * (imgs.ndim - 3) + [(0, (-H) % 32), (0, (-W) % 32), (0, 0)]
    return np.pad(imgs, pad)


def _inputs(samples):
    projs = {k: torch.from_numpy(np.stack([s.proj_matrices[k] for s in samples]))
             for k in samples[0].proj_matrices}
    dv = torch.from_numpy(np.stack([s.depth_values for s in samples]))
    return projs, dv


def _direct(model, samples, tiles=1, halo=None):
    """(depth, confidence) per sample: the model called with the padded
    float32 frames, cropped back."""
    imgs = torch.from_numpy(np.stack([_padded(s.imgs) for s in samples]))
    projs, dv = _inputs(samples)
    if tiles > 1:
        depth, conf = tiled_forward(model, imgs, projs, dv, tiles, num_depth=NUM_DEPTH,
                                    halo=halo)
    else:
        out = model(imgs, projs, dv, num_depth=NUM_DEPTH)
        depth, conf = out["depth"], out["photometric_confidence"]
    return _cropped(samples, depth, conf)


def _direct_cached(model, samples):
    """As ``_direct``, with each view's pyramid computed alone from its
    padded float32 frame (the feature-cache path)."""
    dtype = next(model.parameters()).dtype
    per_sample = []
    for s in samples:
        views = [model.feature_module()(torch.from_numpy(_padded(img)).permute(2, 0, 1)[None]
                                        .to(dtype)) for img in s.imgs]
        per_sample.append({k: torch.cat([v[k] for v in views]) for k in views[0]})
    features = {k: torch.stack([f[k] for f in per_sample]) for k in per_sample[0]}
    projs, dv = _inputs(samples)
    out = model(None, projs, dv, num_depth=NUM_DEPTH, features=features)
    return _cropped(samples, out["depth"], out["photometric_confidence"])


def _cropped(samples, depth, conf):
    H, W = samples[0].imgs.shape[1:3]
    return [(depth[i, :H, :W].float().numpy(), conf[i, :H, :W].float().numpy())
            for i in range(len(samples))]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for (gd, gc), (wd, wc) in zip(got, want):
        assert np.array_equal(gd, wd, equal_nan=True)
        assert np.array_equal(gc, wc, equal_nan=True)


def _model(name, **extra):
    family, dtype, opts = MODELS[name]
    return build_model(family, seed=0, device="cpu", dtype=dtype, **TINY, **{**opts, **extra})


def _special_values() -> np.ndarray:
    """float32 values whose bf16 rounding is a corner case, and random ones."""
    f32 = lambda bits: np.array(bits, np.uint32).view(np.float32)  # noqa: E731
    ties = f32([0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000,  # exactly halfway, even and odd
                0x3F807FFF, 0x3F808001, 0x7F7F8000, 0x00018000, 0x00008000])
    subnormals = f32([0x00000001, 0x0000FFFF, 0x00010000, 0x007FFFFF, 0x807FFFFF, 0x80000001])
    big = np.array([3.3895314e38, 3.3961776e38, 3.4028235e38, -3.4028235e38, 3.39e38, 1e38],
                   np.float32)  # around bf16's largest: some round to infinity
    nan = f32([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FBFFFFF, 0xFF800001])
    rest = np.array([np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 1.17549435e-38], np.float32)
    rng = np.random.default_rng(0)
    rand = rng.standard_normal(4096).astype(np.float32) * np.float32(10.0) ** rng.integers(
        -40, 39, 4096).astype(np.float32)
    return np.concatenate([ties, subnormals, big, nan, rest, rand])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hw", [(64, 32), (61, 45)], ids=["no_pad", "pad"])
def test_staged_cast_is_torchs_cast(dtype, hw):
    H, W = hw
    vals = _special_values()
    n = 2 * H * W * 3
    frames = np.resize(vals, n).reshape(2, H, W, 3)
    frames[1] = np.roll(frames[1], 7)  # the corner values at other chunk offsets
    engine = PredictEngine(_model("adamvs_f32"), num_depth=NUM_DEPTH, device="cpu")
    got = engine._upload_frames(list(frames), dtype)
    want = torch.from_numpy(_padded(frames)).to(dtype)
    assert got.shape == want.shape == (2, 64, 64 if W > 32 else 32, 3)
    assert got.dtype == dtype and got.is_contiguous()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    if dtype == torch.bfloat16:  # the corner cases are there
        assert torch.isnan(got).any() and torch.isinf(got).any()
        assert ((got != 0) & (got.abs() < torch.finfo(torch.bfloat16).tiny)).any()
    assert engine.staged_uploads == 1


@pytest.mark.parametrize("hw", [(128, 64), (122, 53)], ids=["no_pad", "pad"])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_predict_batch_matches_the_model(scene, name, batch, hw):
    model = _model(name)
    engine = PredictEngine(model, num_depth=NUM_DEPTH, device="cpu")
    orders = [(0, 1, 2), (2, 3, 1), (1, 0, 3), (3, 2, 0)]
    first = [_sample(scene, o, *hw) for o in orders[:batch]]
    second = [_sample(scene, o, *hw) for o in orders[batch:2 * batch]]
    got = engine.predict_batch(first)
    kept = [(d.copy(), c.copy()) for d, c in got]
    _assert_equal(got, _direct(model, first))
    _assert_equal(engine.predict_batch(second), _direct(model, second))
    _assert_equal(got, kept)  # the first request's arrays are the caller's
    assert engine.staged_uploads == 2


@pytest.mark.parametrize("name", ["adamvs_bf16", "msrednet_bf16"])
def test_feature_cache_path_matches_the_model(scene, name):
    model = _model(name)
    engine = PredictEngine(model, num_depth=NUM_DEPTH, device="cpu", feature_cache=8)
    a = _sample(scene, (0, 1, 2), 122, 53, view_ids=(10, 11, 12))
    b = _sample(scene, (1, 2, 3), 122, 53, view_ids=(11, 12, 13))
    c = _sample(scene, (3, 0, 2), 122, 53, view_ids=(13, 10, 12))
    _assert_equal(engine.predict_batch([a]), _direct_cached(model, [a]))
    _assert_equal(engine.predict_batch([b, c]), _direct_cached(model, [b, c]))
    assert (engine.cache_misses, engine.cache_hits) == (4, 5)
    assert engine.staged_uploads == 4  # one per missed view; the projections go plain


@pytest.mark.parametrize("feature_cache", [0, 8])
def test_row_bands_match_the_model(scene, feature_cache):
    model = _model("adamvs_bf16", reg_impl="scan")
    engine = PredictEngine(model, num_depth=NUM_DEPTH, device="cpu", tiles=2, halo=16,
                           feature_cache=feature_cache)
    samples = [_sample(scene, (0, 1, 2), 122, 53, view_ids=(0, 1, 2)),
               _sample(scene, (1, 2, 3), 122, 53, view_ids=(1, 2, 3))]
    got = engine.predict_batch(samples)
    if feature_cache:
        want = []
        for s in samples:  # the bands over each sample's views' pyramids
            dtype = next(model.parameters()).dtype
            views = [model.feature_module()(torch.from_numpy(_padded(img)).permute(2, 0, 1)[None]
                                            .to(dtype)) for img in s.imgs]
            features = {k: torch.stack([v[k][0] for v in views])[None] for k in views[0]}
            projs, dv = _inputs([s])
            depth, conf = tiled_forward(model, None, projs, dv, 2, num_depth=NUM_DEPTH, halo=16,
                                        features=features)
            want += _cropped([s], depth, conf)
        assert engine.staged_uploads == 4
    else:
        want = [_direct(model, [s], tiles=2, halo=16)[0] for s in samples]
        assert engine.staged_uploads == 2
    _assert_equal(got, want)


def test_one_buffer_reused_while_the_shape_stays(scene):
    engine = PredictEngine(_model("adamvs_bf16"), num_depth=NUM_DEPTH, device="cpu")
    a, b = _sample(scene, (0, 1, 2), 128, 64), _sample(scene, (2, 1, 0), 128, 64)
    engine.predict_batch([a])
    buf = engine._staging
    assert buf.shape == (3, 128, 64, 3) and buf.dtype == torch.bfloat16
    assert not buf.is_pinned()  # page-locked only for a CUDA device
    engine.predict_batch([b])
    assert engine._staging is buf and engine._staging.data_ptr() == buf.data_ptr()
    # frames of other sizes that pad to the same shape reuse it too, pad zeroed
    engine.predict_batch([_sample(scene, (0, 1, 2), 122, 53)])
    assert engine._staging is buf and not buf[:, 122:].any() and not buf[:, :, 53:].any()
    engine.predict_batch([a, b])  # a new shape replaces it
    assert engine._staging.shape == (6, 128, 64, 3)
    engine.predict_batch([_sample(scene, (0, 1, 2), 96, 64)])
    assert engine._staging.shape == (3, 96, 64, 3)
    assert engine.staged_uploads == 5


def test_float32_model_stages_float32(scene):
    engine = PredictEngine(_model("adamvs_f32"), num_depth=NUM_DEPTH, device="cpu")
    engine.predict_batch([_sample(scene, (0, 1, 2), 128, 64)])
    assert engine._staging.dtype == torch.float32


def test_a_batch_pads_to_one_shape(scene):
    engine = PredictEngine(_model("adamvs_bf16"), num_depth=NUM_DEPTH, device="cpu")
    with pytest.raises(ValueError, match="pad to one shape"):
        engine.predict_batch([_sample(scene, (0, 1, 2), 128, 64),
                              _sample(scene, (0, 1, 2), 96, 64)])
    with pytest.raises(ValueError, match="pad to one shape"):
        engine.predict_batch([_sample(scene, (0, 1, 2), 128, 64),
                              _sample(scene, (0, 1, 2, 3), 128, 64)])
