"""The port's whole AdaMVS cascade against the JAX model at float32 on the
CPU, both prediction engines on one frame whose size is not a multiple of 32,
and the weight bridge's exact round trip through the JAX package's importer.

The JAX side runs ``sweep_impl="scan"``, ``reg_impl="scan"``: the exact
streaming form that the JAX package's own tests hold its fused Pallas branch
to (test_sweep_fuse.py::test_model_fused_sweep_matches_scan). One
module-scoped fixture holds the JAX init and outputs, kept small (64x64,
V=3, ndepths 8/4/4) because flax init and apply dominate the run time."""

import jax
import numpy as np
import pytest
import torch

from adamvs_tpu.data.pipeline import PredictSample
from adamvs_tpu.models import AdaMVS as JAdaMVS
from adamvs_tpu.predict.engine import PredictEngine as JPredictEngine
from adamvs_tpu.train.torch_import import import_adamvs_state_dict
from adamvs_tpu_torch.models import AdaMVS
from adamvs_tpu_torch.predict.engine import PredictEngine
from adamvs_tpu_torch.train.jax_import import from_jax_variables
from tests.test_torch_import_msrednet import _real_cameras
from tests.test_torch_port_nn import _randomize_bn

torch.set_num_threads(2)

CFG = dict(ndepths=(8, 4, 4), depth_intervals_ratio=(4.0, 2.0, 1.0), base=8, cr_base=(8, 8, 8))
NUM_DEPTH = 32
DMIN, DMAX = 300.0, 500.0


def _projs(B, V, H, W):
    out = {}
    for k, s in (("stage1", 4), ("stage2", 2), ("stage3", 1)):
        p = _real_cameras(B, V, H, W, f=80.0, baseline=40.0)  # 2-10 px of disparity at stage 1
        p[:, :, :2, :] /= s
        out[k] = p
    return out


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(11)
    B, V, H, W = 1, 3, 64, 64
    imgs = rng.randn(B, V, H, W, 3).astype(np.float32)
    projs = _projs(B, V, H, W)
    dv = np.array([[DMIN, DMAX]], np.float32)
    jmodel = JAdaMVS(**CFG)
    variables = jax.jit(lambda k, i, p, d: jmodel.init(k, i, p, d, num_depth=NUM_DEPTH))(
        jax.random.PRNGKey(0), imgs, projs, dv)
    variables = _randomize_bn(variables, 12)
    want = jax.jit(lambda v, i, p, d: jmodel.apply(v, i, p, d, train=False, num_depth=NUM_DEPTH))(
        variables, imgs, projs, dv)
    port = AdaMVS(**CFG).eval()
    port.load_state_dict(from_jax_variables(variables))
    return dict(imgs=imgs, projs=projs, dv=dv, jmodel=jmodel, variables=variables,
                want=jax.tree_util.tree_map(np.asarray, want), port=port)


def test_full_cascade_matches_jax(case):
    got = case["port"](torch.from_numpy(case["imgs"]),
                       {k: torch.from_numpy(v) for k, v in case["projs"].items()},
                       torch.from_numpy(case["dv"]), num_depth=NUM_DEPTH)
    want = case["want"]
    for key, hw in (("stage1", 32), ("stage2", 64), ("stage3", 64)):
        g, w = got[key], want[key]
        assert g["depth"].shape == (1, hw, hw)
        err = np.abs(g["depth"].numpy() - w["depth"]).max() / (DMAX - DMIN)
        assert err < 1e-4, f"{key} depth rel err {err:.2e}"
        np.testing.assert_allclose(g["photometric_confidence"].numpy(),
                                   w["photometric_confidence"], atol=1e-3, err_msg=key)
        np.testing.assert_allclose(g["pair_confidence"].numpy(), w["pair_confidence"],
                                   atol=1e-3, err_msg=key)
    for g, w in zip(got["stage1"]["pair_result"], want["stage1"]["pair_result"]):
        assert np.abs(g.numpy() - w).max() / (DMAX - DMIN) < 1e-4
    assert torch.equal(got["depth"], got["stage3"]["depth"])
    # the test exercises a non-trivial visibility estimate
    assert want["stage1"]["pair_confidence"].max() > 2.0 / CFG["ndepths"][0]


def test_predict_engines_agree_on_padded_frame(case):
    H, W = 60, 56  # padded to 64x64 by both engines
    sample = PredictSample(
        imgs=case["imgs"][0, :, :H, :W], depth_values=case["dv"][0],
        proj_matrices={k: v[0] for k, v in case["projs"].items()},
        out_image=None, out_cam=None, ref_image_path="", name="f0", vid="0")
    jdepth, jprob = JPredictEngine(case["jmodel"], case["variables"], num_depth=NUM_DEPTH,
                                   log_fn=lambda s: None).predict_sample(sample)
    engine = PredictEngine(case["port"], num_depth=NUM_DEPTH, device="cpu")
    depth, prob = engine.predict_sample(sample)
    assert depth.shape == prob.shape == jdepth.shape == (H, W)
    assert np.abs(depth - jdepth).max() / (DMAX - DMIN) < 1e-4
    np.testing.assert_allclose(prob, jprob, atol=1e-3)
    (bd, bp), (bd2, _) = engine.predict_batch([sample, sample])
    np.testing.assert_allclose(bd, depth, rtol=1e-6)
    np.testing.assert_allclose(bp, prob, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(bd, bd2)


def _flatten(tree, prefix=""):
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def test_weight_round_trip_is_exact(case):
    """JAX variables -> port state_dict -> the JAX package's importer gives
    back the original variables bit for bit."""
    sd = case["port"].state_dict()
    assert not [k for k in sd if k.startswith(("DepthNet.1.reg.", "DepthNet.2.reg."))]
    back, skipped = import_adamvs_state_dict(sd, case["variables"])
    assert skipped == []
    want, got = _flatten(case["variables"]), _flatten(back)
    assert want.keys() == got.keys() and len(want) > 100
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
