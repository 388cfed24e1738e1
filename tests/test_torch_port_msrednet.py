"""The port's MS-REDNet against the JAX package at float32 on the CPU: its new
blocks (``ConvTransReLU``, ``GNConvGRUCell``), ``RedFeatureNet``, ``RedCell``
stepped over depth, the whole cascade in both sweep forms, the prediction
engine on a padded frame, the factory, and the weight bridge's exact round
trip through the JAX package's importer.

Weights come from a jitted JAX init (BatchNorm statistics and GroupNorm
scale/bias randomised so a swapped mapping cannot cancel out), carried over
by the port's own inverse weight tables. The JAX cascade runs
``sweep_impl="scan"``, ``warp_impl="gather"``: the exact streaming form, with
no Pallas kernel. One module-scoped fixture holds the JAX init and outputs,
kept small (64x64, V=3, ndepths 8/4/4) because flax init and apply dominate
the run time."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adamvs_tpu.models import MSREDNet as JMSREDNet
from adamvs_tpu.nn.blocks import ConvTransReLU as JConvTransReLU
from adamvs_tpu.nn.blocks import GNConvGRUCell as JGNConvGRUCell
from adamvs_tpu.nn.costreg import RedCell as JRedCell
from adamvs_tpu.nn.featurenet import RedFeatureNet as JRedFeatureNet
from adamvs_tpu.train.torch_import import import_msrednet_state_dict, jax_to_mutable
from adamvs_tpu_torch.models import MSREDNet, build_model
from adamvs_tpu_torch.nn.blocks import ConvTransReLU, GNConvGRUCell, group_norm1
from adamvs_tpu_torch.nn.costreg import RedCell
from adamvs_tpu_torch.nn.featurenet import RedFeatureNet
from adamvs_tpu_torch.predict.engine import PredictEngine
from adamvs_tpu_torch.train import jax_import
from tests.test_torch_import_msrednet import TCascadeREDNet
from tests.test_torch_port_model import _flatten, _projs
from tests.test_torch_port_nn import _randomize_bn

torch.set_num_threads(2)

CFG = dict(ndepths=(8, 4, 4), depth_intervals_ratio=(4.0, 2.0, 1.0), base=8, cr_base=(8, 8, 8))
NUM_DEPTH = 32
DMIN, DMAX = 300.0, 500.0
TOL = dict(rtol=1e-4, atol=1e-4)


def _randomize_norms(variables, seed):
    """Random BatchNorm parameters and statistics and GroupNorm scale/bias."""
    rng = np.random.RandomState(seed)
    v = _randomize_bn(jax_to_mutable(variables), seed)

    def walk(params):
        for k, node in params.items():
            if k.startswith("GroupNorm"):
                node["scale"] = (1 + 0.3 * rng.randn(*node["scale"].shape)).astype(np.float32)
                node["bias"] = (0.3 * rng.randn(*node["bias"].shape)).astype(np.float32)
            elif hasattr(node, "items"):
                walk(node)

    walk(v["params"])
    return v


def _port_state(params, stats, plan, strip=""):
    sd = {}
    jax_import._apply_plan(params, stats, "", [(t, f.removeprefix(strip), k) for t, f, k in plan],
                           sd)
    return sd


def _nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# --- blocks --------------------------------------------------------------------

def test_conv_trans_relu_matches_jax():
    x = np.random.RandomState(0).randn(2, 6, 7, 16).astype(np.float32)
    jblock = JConvTransReLU(8)
    variables = jax.jit(jblock.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jax.jit(jblock.apply)(variables, jnp.asarray(x)))
    block = ConvTransReLU(16, 8).eval()
    block.load_state_dict(_port_state(variables["params"], {},
                                      [("conv", "FastConvTranspose_0", "convt")]))
    with torch.no_grad():
        got = block(_nchw(x))
    assert got.shape == (2, 8, 12, 14)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 8, 13, 17), (1, 64, 3, 5)])
def test_group_norm1_is_the_module(shape):
    norm = torch.nn.GroupNorm(1, shape[1], eps=1e-5)
    gen = torch.Generator().manual_seed(shape[1])
    with torch.no_grad():
        norm.weight.copy_(1 + 0.3 * torch.randn(shape[1], generator=gen))
        norm.bias.copy_(0.3 * torch.randn(shape[1], generator=gen))
        x = 2.0 + 3.0 * torch.randn(shape, generator=gen)
        torch.testing.assert_close(group_norm1(x, norm), norm(x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,hidden", [(8, 8), (16, 32)])
def test_gn_conv_gru_cell_matches_jax(cin, hidden):
    rng = np.random.RandomState(cin + hidden)
    B, h, w = 2, 10, 12
    x = rng.randn(B, h, w, cin).astype(np.float32)
    st = rng.randn(B, h, w, hidden).astype(np.float32)
    jcell = JGNConvGRUCell(hidden)
    variables = _randomize_norms(
        jax.jit(jcell.init)(jax.random.PRNGKey(1), jnp.asarray(st), jnp.asarray(x)), 2)
    out, new = jax.jit(jcell.apply)(variables, jnp.asarray(st), jnp.asarray(x))
    assert np.array_equal(np.asarray(out), np.asarray(new))
    cell = GNConvGRUCell(cin, hidden).eval()
    plan = [(t.removeprefix("conv_gru1."), f.removeprefix("cell/GNConvGRUCell_3/"), k)
            for t, f, k in jax_import._red_reg_plan() if t.startswith("conv_gru1.")]
    cell.load_state_dict(_port_state(variables["params"], {}, plan))
    with torch.no_grad():
        got = cell(_nchw(st), _nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(new), rtol=1e-5, atol=1e-5)


def test_red_feature_net_matches_jax():
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    jnet = JRedFeatureNet(8)
    init = jax.jit(jnet.init, static_argnums=2)
    variables = _randomize_norms(init(jax.random.PRNGKey(2), jnp.asarray(x), False), 4)
    want = jax.jit(jnet.apply, static_argnums=2)(variables, jnp.asarray(x), False)
    net = RedFeatureNet(8).eval()
    net.load_state_dict(_port_state(variables["params"], variables["batch_stats"],
                                    jax_import._red_feature_plan()))
    with torch.no_grad():
        got = net(_nchw(x))
    for k, c, s in (("stage1", 32, 16), ("stage2", 16, 32), ("stage3", 8, 64)):
        assert got[k].shape == (2, c, s, s)
        np.testing.assert_allclose(_nhwc(got[k]), np.asarray(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("cin", [32, 8])
def test_red_cell_steps_match_jax(cin):
    """``RedCell`` stepped over D=4 with all four states carried, against the
    JAX cell applied step by step with the same carry."""
    B, h, w, b = 1, 16, 24, 8
    jcell = JRedCell(b)
    carry = jcell.init_carry(B, h, w)
    rng = np.random.RandomState(cin)
    vol = rng.randn(4, B, h, w, cin).astype(np.float32)
    variables = _randomize_norms(
        jax.jit(jcell.init)(jax.random.PRNGKey(3), carry, jnp.asarray(vol[0])), 5)
    cell = RedCell(cin, b).eval()
    cell.load_state_dict(_port_state(variables["params"], {}, jax_import._red_reg_plan(),
                                     strip="cell/"))
    state = cell.init_state(B, h, w, torch.float32, "cpu")
    assert [tuple(s.shape) for s in state] == [(1, 8, 16, 24), (1, 16, 8, 12), (1, 32, 4, 6),
                                              (1, 64, 2, 3)]
    step = jax.jit(jcell.apply)
    for d in range(4):
        carry, want = step(variables, carry, jnp.asarray(vol[d]))
        with torch.no_grad():
            state, got = cell(state, _nchw(vol[d]))
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), err_msg=f"step {d}", **TOL)
        for s, c in zip(state, carry):
            np.testing.assert_allclose(_nhwc(s), np.asarray(c), err_msg=f"step {d}", **TOL)


# --- the cascade -------------------------------------------------------------------

@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(21)
    B, V, H, W = 1, 3, 64, 64
    imgs = rng.randn(B, V, H, W, 3).astype(np.float32)
    projs = _projs(B, V, H, W)
    dv = np.array([[DMIN, DMAX]], np.float32)
    jmodel = JMSREDNet(**CFG, sweep_impl="scan", warp_impl="gather")
    variables = jax.jit(lambda k, i, p, d: jmodel.init(k, i, p, d, num_depth=NUM_DEPTH))(
        jax.random.PRNGKey(0), imgs, projs, dv)
    variables = _randomize_norms(variables, 22)
    want = jax.jit(lambda v, i, p, d: jmodel.apply(v, i, p, d, train=False, num_depth=NUM_DEPTH))(
        variables, imgs, projs, dv)
    sd = jax_import.from_jax_msrednet_variables(variables)
    return dict(imgs=imgs, projs=projs, dv=dv, variables=variables, sd=sd,
                want=jax.tree_util.tree_map(np.asarray, want))


@pytest.mark.parametrize("sweep_impl", ["fused", "scan"])
def test_full_cascade_matches_jax(case, sweep_impl):
    port = MSREDNet(**CFG, sweep_impl=sweep_impl).eval()
    port.load_state_dict(case["sd"])
    got = port(torch.from_numpy(case["imgs"]),
               {k: torch.from_numpy(v) for k, v in case["projs"].items()},
               torch.from_numpy(case["dv"]), num_depth=NUM_DEPTH)
    want = case["want"]
    for key, hw in (("stage1", 16), ("stage2", 32), ("stage3", 64)):
        g, w = got[key], want[key]
        assert g["depth"].shape == (1, hw, hw)
        err = np.abs(g["depth"].numpy() - w["depth"]).max() / (DMAX - DMIN)
        assert err < 1e-4, f"{key} depth rel err {err:.2e}"
        np.testing.assert_allclose(g["photometric_confidence"].numpy(),
                                   w["photometric_confidence"], atol=1e-3, err_msg=key)
    assert torch.equal(got["depth"], got["stage3"]["depth"])
    # the regularised costs are not flat: confidence well above uniform
    assert want["stage1"]["photometric_confidence"].max() > 2.0 / CFG["ndepths"][0]


def test_weight_round_trip_is_exact(case):
    """JAX variables -> port state_dict -> the JAX package's importer gives
    back the original variables bit for bit."""
    port = MSREDNet(**CFG).eval()
    port.load_state_dict(case["sd"])
    back, skipped = import_msrednet_state_dict(port.state_dict(), case["variables"])
    assert skipped == []
    want, got = _flatten(case["variables"]), _flatten(back)
    assert want.keys() == got.keys() and len(want) > 100
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_state_dict_names_are_the_reference_ones():
    assert set(MSREDNet().state_dict()) == set(TCascadeREDNet().state_dict())


def test_engine_crops_the_padded_frame():
    """A 60x56 frame is zero-padded to 64x64; the engine's outputs are the
    model's outputs on the padded frame, cropped back."""
    model = build_model("msrednet", seed=3, device="cpu", **CFG)
    assert isinstance(model, MSREDNet)
    rng = np.random.RandomState(4)
    H, W = 60, 56
    projs = {k: v[0] for k, v in _projs(1, 3, 64, 64).items()}
    sample = types.SimpleNamespace(imgs=rng.randn(3, H, W, 3).astype(np.float32),
                                   proj_matrices=projs, depth_values=np.array([DMIN, DMAX],
                                                                              np.float32))
    depth, conf = PredictEngine(model, num_depth=NUM_DEPTH, device="cpu").predict_sample(sample)
    assert depth.shape == conf.shape == (H, W)
    padded = np.zeros((1, 3, 64, 64, 3), np.float32)
    padded[0, :, :H, :W] = sample.imgs
    out = model(torch.from_numpy(padded), {k: torch.from_numpy(v[None]) for k, v in projs.items()},
                torch.tensor([[DMIN, DMAX]]), num_depth=NUM_DEPTH)
    np.testing.assert_array_equal(depth, out["depth"][0, :H, :W].numpy())
    np.testing.assert_array_equal(conf, out["photometric_confidence"][0, :H, :W].numpy())


@pytest.mark.parametrize("name", ["msrednet ", "cascade", ""])
def test_build_model_rejects_unknown_names(name):
    with pytest.raises(ValueError, match="unknown model"):
        build_model(name, device="cpu")
