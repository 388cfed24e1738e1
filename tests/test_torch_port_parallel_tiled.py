"""Row-band prediction on the CPU (the port's counterpart of
tests/test_tiled.py):

- the tuple form of ``features=`` (reference band, full source frames) of
  both port models against the JAX models' on the same band and weights;
- ``predict/tiled.py::tiled_forward`` against the port's unbanded forward,
  both families, scan and fused forms: with a halo over the receptive field
  (max < 1e-2, median < 1e-4) and with a small halo (the interior rows of
  tests/test_tiled.py: median < 1e-3, 97 % within 1e-2), also through the
  engine's feature cache;
- ``band_geometry`` and ``band_ref_proj`` against JAX's ``tiled_forward`` on
  an 8-device CPU mesh, exactly.

MS-REDNet's cells normalise with GroupNorm(1), whose statistics span the
whole map: a band narrower than the frame changes them, in JAX as in the
port, so its small-halo case runs at JAX's test frame (96x128), where the
bands span the frame as JAX's do; the tuple-form test holds it on a real
band, and the ``slow`` test holds the port's bands to JAX's at 256 rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from adamvs_tpu.data.synthetic import make_scene
from adamvs_tpu.models import AdaMVS as JAdaMVS
from adamvs_tpu.models import MSREDNet as JMSREDNet
from adamvs_tpu.predict.tiled import _band_ref_proj as jband_ref_proj
from adamvs_tpu.predict.tiled import tiled_forward as jtiled_forward
from adamvs_tpu.train.torch_import import import_adamvs_state_dict, import_msrednet_state_dict
from adamvs_tpu_torch.models import build_model
from adamvs_tpu_torch.predict.engine import PredictEngine
from adamvs_tpu_torch.predict.tiled import band_geometry, band_ref_proj, tiled_forward
from tests.test_models import scene_batch
from tests.test_torch_port_model import _projs

CFG = dict(ndepths=(8, 4, 4), depth_intervals_ratio=(4.0, 2.0, 1.0), base=4, cr_base=(4, 4, 4))
NUM_DEPTH = 32
DMIN, DMAX = 300.0, 500.0
FAMILIES = {"adamvs": (JAdaMVS, import_adamvs_state_dict),
            "msrednet": (JMSREDNet, import_msrednet_state_dict)}
FORMS = {("adamvs", "scan"): dict(sweep_impl="scan", reg_impl="scan"),
         ("adamvs", "fused"): dict(sweep_impl="fused", reg_impl="scan"),
         ("msrednet", "scan"): dict(sweep_impl="scan"),
         ("msrednet", "fused"): dict(sweep_impl="fused")}


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(height, width):
    imgs, projs, dv = scene_batch(make_scene(num_views=4, height=height, width=width, seed=0))
    return _t(imgs), {k: _t(v) for k, v in projs.items()}, _t(dv)[:, :2].contiguous()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tuple_form_matches_jax(family):
    """A 128x64 frame, band 1 of 4 with a 16-row halo (rows 16-79 of 128;
    the stage-1 reference holds 16 of 32 rows), random features: the port's
    ``forward(features={stageK: (band, sources)})`` against JAX's
    ``apply(features=...)`` with the port's weights carried across."""
    jcls, importer = FAMILIES[family]
    port = build_model(family, seed=0, device="cpu", **CFG, **FORMS[family, "scan"])
    rng = np.random.RandomState(5)
    H, W = 128, 64
    start, band_h, _ = band_geometry(1, 4, H, halo=16)
    assert (start, band_h) == (16, 64)
    chans = port.chans
    full = {f"stage{k + 1}": rng.randn(1, 3, H >> (2 - k), W >> (2 - k), c).astype(np.float32)
            for k, c in enumerate(chans)}
    projs = _projs(1, 3, H, W)
    feats, bprojs = {}, {}
    for k in range(3):
        key, s = f"stage{k + 1}", 2 ** (2 - k)
        r0 = start // s
        feats[key] = (full[key][:, 0, r0:r0 + band_h // s], np.moveaxis(full[key][:, 1:], 1, 0))
        bprojs[key] = band_ref_proj(_t(projs[key]), r0).numpy()
    dv = np.array([[DMIN, DMAX]], np.float32)
    got = port(None, {k: _t(v) for k, v in bprojs.items()}, _t(dv), num_depth=NUM_DEPTH,
               features={k: (_t(a), _t(b)) for k, (a, b) in feats.items()})

    jmodel = jcls(**CFG)
    imgs = np.zeros((1, 3, H, W, 3), np.float32)
    abstract = jax.eval_shape(lambda k: jmodel.init(k, imgs, projs, dv, num_depth=NUM_DEPTH),
                              jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract)
    variables, _ = importer(port.state_dict(), zeros)
    want = jax.jit(lambda v, p, d, f: jmodel.apply(v, None, p, d, train=False,
                                                   num_depth=NUM_DEPTH, features=f))(
        variables, bprojs, dv, {k: (jnp.asarray(a), jnp.asarray(b)) for k, (a, b) in feats.items()})
    assert tuple(got["depth"].shape) == (1, band_h, W)
    for key in ("stage1", "stage2", "stage3"):
        gd, wd = got[key]["depth"].numpy(), np.asarray(want[key]["depth"])
        assert gd.shape == wd.shape, key
        assert np.abs(gd - wd).max() / (DMAX - DMIN) < 1e-4, key
        np.testing.assert_allclose(got[key]["photometric_confidence"].numpy(),
                                   np.asarray(want[key]["photometric_confidence"]), atol=1e-3,
                                   err_msg=key)


def _check_bands(depth, conf, want, count, large):
    """tests/test_tiled.py's bars against the unbanded ``want``."""
    ref_depth = want["depth"].numpy()
    depth, conf = depth.numpy(), conf.numpy()
    assert depth.shape == ref_depth.shape
    err = np.abs(depth - ref_depth)
    if large:
        assert err.max() < 1e-2 and np.median(err) < 1e-4, (err.max(), np.median(err))
        return
    H = depth.shape[1]
    rows = H // count
    interior = np.ones(H, bool)
    for b in range(1, count):
        interior[b * rows - 2: b * rows + 2] = False
    err = err[:, interior]
    assert np.median(err) < 1e-3 and (err < 1e-2).mean() > 0.97, (np.median(err),
                                                                  (err < 1e-2).mean())
    cerr = np.abs(conf - want["photometric_confidence"].numpy())[:, interior]
    assert np.median(cerr) < 1e-3


# (family, form, frame height, frame width, bands, halo, halo covers the receptive field)
BAND_CASES = [
    ("adamvs", "scan", 256, 96, 4, 32, False),   # 128-row bands
    ("adamvs", "fused", 256, 96, 4, 32, False),
    ("adamvs", "scan", 256, 96, 2, 128, True),   # the band spans the frame
    ("adamvs", "fused", 96, 128, 2, 44, True),   # tests/test_tiled.py's large-halo case
    ("msrednet", "scan", 96, 128, 4, 32, False),  # tests/test_tiled.py's case
    ("msrednet", "fused", 96, 128, 4, 32, False),
    ("msrednet", "scan", 256, 96, 4, 96, True),
]


@pytest.mark.parametrize("family,form,height,width,count,halo,large", BAND_CASES)
def test_tiled_forward_matches_unbanded(family, form, height, width, count, halo, large):
    imgs, projs, dv = _scene(height, width)
    model = build_model(family, seed=0, device="cpu", **CFG, **FORMS[family, form])
    want = model(imgs, projs, dv, num_depth=NUM_DEPTH)
    depth, conf = tiled_forward(model, imgs, projs, dv, count, num_depth=NUM_DEPTH, halo=halo)
    _check_bands(depth, conf, want, count, large)
    if not large and height == 256:  # real bands: some rows must differ, or no band ran
        assert band_geometry(0, count, height, halo)[1] < height


def test_engine_bands_with_the_feature_cache():
    """``PredictEngine(tiles=4)`` with and without the feature cache against
    the unbanded engine, on one sample of the 256x96 scene."""
    imgs, projs, dv = _scene(256, 96)
    sample = type("S", (), dict(imgs=imgs[0].numpy(), view_ids=(10, 11, 12),
                                proj_matrices={k: v[0].numpy() for k, v in projs.items()},
                                depth_values=dv[0].numpy()))
    model = build_model("adamvs", seed=0, device="cpu", **CFG, **FORMS["adamvs", "scan"])
    want = PredictEngine(model, num_depth=NUM_DEPTH, device="cpu").predict_sample(sample)
    plain = PredictEngine(model, num_depth=NUM_DEPTH, device="cpu", tiles=4, halo=32)
    cached = PredictEngine(model, num_depth=NUM_DEPTH, device="cpu", tiles=4, halo=32,
                           feature_cache=8)
    got = plain.predict_sample(sample)
    for _ in range(2):
        got_c = cached.predict_sample(sample)
    assert cached.cache_hits == 3 and cached.cache_misses == 3
    np.testing.assert_array_equal(got_c[0], got[0])
    np.testing.assert_array_equal(got_c[1], got[1])
    _check_bands(torch.from_numpy(got[0])[None], torch.from_numpy(got[1])[None],
                 {"depth": torch.from_numpy(want[0])[None],
                  "photometric_confidence": torch.from_numpy(want[1])[None]}, 4, False)


@pytest.mark.parametrize("reg_impl", ["pallas", "precomp"])
def test_bands_refuse_the_packed_regularisers(reg_impl):
    model = build_model("adamvs", seed=0, device="cpu", **CFG, sweep_impl="fused",
                        reg_impl=reg_impl)
    with pytest.raises(ValueError, match=f"reg_impl='{reg_impl}'"):
        PredictEngine(model, num_depth=NUM_DEPTH, device="cpu", tiles=2)


class _Probe:
    """A stand-in model for JAX's ``tiled_forward``: its depth is the global
    row of each band row (stage 3's feature holds the row index), and the
    first row of its confidence carries ``band_h`` and every stage's shifted
    reference row ``P'[1,:]``, so the output shows where JAX put each band."""

    ndepths = (4, 4, 4)

    @staticmethod
    def apply(variables, imgs, projs, dv, train, num_depth, features):
        ref3 = features["stage3"][0]  # [B,band_h,W,1], the global row index
        depth = ref3[..., 0]
        info = [jnp.full((1,), ref3.shape[1], jnp.float32)]
        info += [projs[f"stage{k}"][0, 0, 1, :] for k in (1, 2, 3)]
        info = jnp.concatenate(info)
        conf = jnp.zeros_like(depth).at[:, :, : info.shape[0]].set(info)
        return {"depth": depth, "photometric_confidence": conf}


@pytest.mark.parametrize("H,count,halo", [(256, 4, 32), (256, 8, 24), (256, 2, 200), (96, 4, 32)])
def test_band_geometry_matches_jax(H, count, halo):
    """JAX's ``tiled_forward`` over ``count`` CPU devices on the probe: each
    output row's source row in the band gives ``start + offset``, its first
    row gives ``band_h`` and the shifted projections; the port's
    ``band_geometry`` and ``band_ref_proj`` must give the same, exactly."""
    W = 16
    mesh = Mesh(np.array(jax.devices()[:count]).reshape(1, count), ("data", "tile"))
    rng = np.random.RandomState(H + count)
    projs = {f"stage{k}": rng.randn(1, 3, 4, 4).astype(np.float32) for k in (1, 2, 3)}
    feats = {f"stage{k}": np.zeros((1, 3, H >> (3 - k), W >> (3 - k), 1), np.float32)
             for k in (1, 2, 3)}
    feats["stage3"][..., 0] = np.arange(H, dtype=np.float32)[None, None, :, None]
    depth, conf = jtiled_forward(_Probe, {}, None, projs, np.zeros((1, 2), np.float32), mesh,
                                 halo=halo, features=feats)
    depth, conf = np.asarray(depth)[0], np.asarray(conf)[0]
    rows = H // count
    for b in range(count):
        start, band_h, off = band_geometry(b, count, H, halo)
        np.testing.assert_array_equal(depth[b * rows:(b + 1) * rows, 0],
                                      start + off + np.arange(rows, dtype=np.float32))
        info = conf[b * rows]
        assert info[0] == band_h
        for k in (1, 2, 3):
            r0 = start // 2 ** (3 - k)
            want = np.asarray(jband_ref_proj(jnp.asarray(projs[f"stage{k}"]), r0))
            got = band_ref_proj(_t(projs[f"stage{k}"]), r0).numpy()
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(info[1 + 4 * (k - 1): 1 + 4 * k], want[0, 0, 1])


@pytest.mark.slow
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tiled_forward_matches_jax_tiled(family):
    """The port's bands against JAX's ``tiled_forward`` (4 CPU devices) on
    the 256x96 scene with 32-row halos and the same weights: the bands are
    narrower than the frame, so for MS-REDNet both differ from the unbanded
    forward (GroupNorm over the band) and must agree with each other."""
    jcls, importer = FAMILIES[family]
    imgs, projs, dv = _scene(256, 96)
    port = build_model(family, seed=0, device="cpu", **CFG, **FORMS[family, "scan"])
    jmodel = jcls(**CFG)
    abstract = jax.eval_shape(lambda k: jmodel.init(k, imgs.numpy(), {
        k: v.numpy() for k, v in projs.items()}, dv.numpy(), num_depth=NUM_DEPTH),
        jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract)
    variables, _ = importer(port.state_dict(), zeros)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "tile"))
    jd, jc = jtiled_forward(jmodel, variables, imgs.numpy(), {k: v.numpy() for k, v in
                                                             projs.items()},
                            dv.numpy(), mesh, num_depth=NUM_DEPTH, halo=32)
    gd, gc = tiled_forward(port, imgs, projs, dv, 4, num_depth=NUM_DEPTH, halo=32)
    assert np.abs(gd.numpy() - np.asarray(jd)).max() / (DMAX - DMIN) < 1e-4
    np.testing.assert_allclose(gc.numpy(), np.asarray(jc), atol=1e-3)
