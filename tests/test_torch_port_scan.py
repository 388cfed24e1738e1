"""The port's AdaMVS scan form (``sweep_impl="scan"``, ``reg_impl="scan"``,
the JAX CLI's default) and its fused + ``reg_impl="scan"`` form against the
JAX model's scan form at float32 on the CPU, the stage-1
``correlation_volume`` against JAX's, the scan form against the stored
golden (``tests/goldens/adamvs_predict_golden.npz``, the weights of
``tools/make_golden.py::golden_forward`` carried across), and the
``features=`` input of both port models against their own forward."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adamvs_tpu.data.synthetic import make_scene
from adamvs_tpu.models import AdaMVS as JAdaMVS
from adamvs_tpu.models.adamvs import correlation_volume as jcorrelation_volume
from adamvs_tpu_torch.models import AdaMVS, MSREDNet
from adamvs_tpu_torch.models.adamvs import correlation_volume, stage_features
from adamvs_tpu_torch.train.jax_import import from_jax_variables
from tests.test_models import scene_batch
from tests.test_torch_import_msrednet import _real_cameras
from tests.test_torch_port_model import CFG, DMAX, DMIN, NUM_DEPTH, _projs
from tests.test_torch_port_nn import _randomize_bn

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "adamvs_predict_golden.npz")
FORMS = {"scan": dict(sweep_impl="scan", reg_impl="scan"),
         "fused_regscan": dict(sweep_impl="fused", reg_impl="scan")}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def case():
    """64x64, V=3, ndepths 8/4/4: the JAX scan form's outputs and its
    variables (random BatchNorm statistics)."""
    rng = np.random.RandomState(21)
    imgs = rng.randn(1, 3, 64, 64, 3).astype(np.float32)
    projs = _projs(1, 3, 64, 64)
    dv = np.array([[DMIN, DMAX]], np.float32)
    jmodel = JAdaMVS(**CFG)
    variables = jax.jit(lambda k, i, p, d: jmodel.init(k, i, p, d, num_depth=NUM_DEPTH))(
        jax.random.PRNGKey(3), imgs, projs, dv)
    variables = _randomize_bn(variables, 22)
    want = jax.jit(lambda v, i, p, d: jmodel.apply(v, i, p, d, train=False, num_depth=NUM_DEPTH))(
        variables, imgs, projs, dv)
    return dict(imgs=imgs, projs=projs, dv=dv, variables=variables,
                want=jax.tree_util.tree_map(np.asarray, want))


def _port(variables, **form):
    model = AdaMVS(**CFG, **form).eval()
    model.load_state_dict(from_jax_variables(variables))
    return model


@pytest.mark.parametrize("form", sorted(FORMS))
def test_adamvs_form_matches_jax_scan(case, form):
    got = _port(case["variables"], **FORMS[form])(
        _t(case["imgs"]), {k: _t(v) for k, v in case["projs"].items()}, _t(case["dv"]),
        num_depth=NUM_DEPTH)
    want = case["want"]
    for key in ("stage1", "stage2", "stage3"):
        g, w = got[key], want[key]
        err = np.abs(g["depth"].numpy() - w["depth"]).max() / (DMAX - DMIN)
        assert err < 1e-4, f"{form} {key} depth err {err:.2e} of the range"
        np.testing.assert_allclose(g["photometric_confidence"].numpy(),
                                   w["photometric_confidence"], atol=1e-3, err_msg=key)
        np.testing.assert_allclose(g["pair_confidence"].numpy(), w["pair_confidence"],
                                   atol=1e-3, err_msg=key)
    for g, w in zip(got["stage1"]["pair_result"], want["stage1"]["pair_result"]):
        assert np.abs(g.numpy() - w).max() / (DMAX - DMIN) < 1e-4
    # the windows of stages 2 and 3 follow a depth with structure
    assert want["stage1"]["depth"].std() > 1e-3 * (DMAX - DMIN)


@pytest.mark.parametrize("D,C", [(32, 8), (12, 5)])
def test_correlation_volume_matches_jax(D, C):
    rng = np.random.RandomState(D)
    B, h, w = 2, 16, 24
    ref = rng.randn(B, h, w, C).astype(np.float32)
    src = rng.randn(B, h, w, C).astype(np.float32)
    proj = _real_cameras(B, 2, h, w, f=20.0, baseline=20.0)
    hyp = np.stack([np.linspace(DMIN, DMAX, D), np.linspace(DMIN + 10, DMAX - 10, D)])
    hyp = hyp.astype(np.float32)
    want = np.asarray(jcorrelation_volume(
        jnp.asarray(ref), jnp.asarray(src), jnp.asarray(proj[:, 1]), jnp.asarray(proj[:, 0]),
        jnp.asarray(hyp)))
    got = correlation_volume(_t(ref), _t(src), _t(proj[:, 1]), _t(proj[:, 0]), _t(hyp))
    assert got.shape == want.shape == (B, h, w, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert (want == 0).mean() < 0.5  # most samples land in the source


def test_scan_form_matches_golden():
    """tools/make_golden.py::golden_forward's model (seed-0 init, parameters
    x4) carried across to the port's scan form: within the golden's own
    tolerance (tests/test_golden.py:44-47)."""
    scene = make_scene(num_views=4, height=96, width=128, seed=0)
    imgs, projs, dv = scene_batch(scene)
    jmodel = JAdaMVS(ndepths=(8, 4), depth_intervals_ratio=(4.0, 2.0), base=4, cr_base=(4, 4),
                     warp_impl="gather")
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), imgs, projs, dv)
    variables = {"params": jax.tree_util.tree_map(lambda x: x * 4.0, variables["params"]),
                 "batch_stats": variables["batch_stats"]}
    model = AdaMVS(ndepths=(8, 4), depth_intervals_ratio=(4.0, 2.0), base=4, cr_base=(4, 4),
                   sweep_impl="scan", reg_impl="scan").eval()
    model.load_state_dict(from_jax_variables(variables))
    out = model(_t(imgs), {k: _t(v) for k, v in projs.items()}, _t(dv))
    depth = out["depth"].numpy()
    conf = out["photometric_confidence"].numpy()
    g = np.load(GOLDEN)
    interval = float(g["interval"])
    assert depth.shape == g["depth"].shape
    assert float(g["depth"].std()) > 1.0
    mae = float(np.mean(np.abs(depth - g["depth"])))
    assert mae < 0.05 * interval, f"depth MAE vs golden {mae} (interval {interval})"
    assert float(np.max(np.abs(conf - g["conf"]))) < 0.05


MODELS = {
    "adamvs_fused": lambda: AdaMVS(**CFG),
    "adamvs_scan": lambda: AdaMVS(**CFG, **FORMS["scan"]),
    "msrednet_fused": lambda: MSREDNet(**CFG, sweep_impl="fused"),
    "msrednet_scan": lambda: MSREDNet(**CFG, sweep_impl="scan"),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_features_input_equals_forward(name):
    """``forward(None, ..., features=...)``, in either layout, gives the
    forward's outputs when the features are the model's own pyramid."""
    torch.manual_seed(0)
    model = MODELS[name]().eval()
    rng = np.random.RandomState(7)
    B, V, H, W = 2, 3, 64, 64
    imgs = _t(rng.randn(B, V, H, W, 3).astype(np.float32))
    projs = {k: _t(np.repeat(v, B, 0)) for k, v in _projs(1, V, H, W).items()}
    dv = _t(np.array([[DMIN, DMAX]] * B, np.float32))
    want = model(imgs, projs, dv, num_depth=NUM_DEPTH)
    with torch.no_grad():
        pyramid = model.feature_module()(imgs.reshape(B * V, H, W, 3).permute(0, 3, 1, 2))
    first = {k: v.reshape((B, V) + v.shape[1:]) for k, v in pyramid.items()}
    last = {k: v.permute(0, 1, 3, 4, 2) for k, v in first.items()}
    for features in (first, last):
        got = model(None, projs, dv, num_depth=NUM_DEPTH, features=features)
        for key in ("stage1", "stage2", "stage3"):
            assert torch.equal(got[key]["depth"], want[key]["depth"]), key
            assert torch.equal(got[key]["photometric_confidence"],
                               want[key]["photometric_confidence"]), key


def test_stage_features_layouts_and_errors():
    chans = (32, 16, 8)
    first = {f"stage{i + 1}": torch.randn(1, 2, c, 4 * 2 ** i, 6 * 2 ** i)
             for i, c in enumerate(chans)}
    last = {k: v.permute(0, 1, 3, 4, 2) for k, v in first.items()}
    for f in (first, last):
        got, B, V = stage_features(f, chans)
        assert (B, V) == (1, 2)
        for k in first:
            assert torch.equal(got[k], first[k].reshape((2,) + first[k].shape[2:]))
    with pytest.raises(ValueError, match="channels"):
        stage_features({k: v[:, :, :3] for k, v in first.items()}, chans)
    with pytest.raises(ValueError, match=r"\[B,V,C,h,w\]"):
        stage_features({k: v[0] for k, v in first.items()}, chans)


def test_form_arguments_are_checked():
    with pytest.raises(ValueError, match="needs sweep_impl='fused'"):
        AdaMVS(**CFG, sweep_impl="scan", reg_impl="pallas")
    with pytest.raises(ValueError, match="sweep_impl"):
        AdaMVS(**CFG, sweep_impl="fusedf32")
    with pytest.raises(ValueError, match="reg_impl"):
        AdaMVS(**CFG, reg_impl="precomp")
    # the scan form trains (tests/test_torch_port_scan_train.py), in train mode only
    model = AdaMVS(**CFG, **FORMS["scan"]).eval()
    imgs = torch.zeros(1, 3, 64, 64, 3)
    projs = {k: _t(v) for k, v in _projs(1, 3, 64, 64).items()}
    with pytest.raises(ValueError, match="needs the module in train mode"):
        model(imgs, projs, torch.tensor([[DMIN, DMAX, 1.0]]), train=True)
