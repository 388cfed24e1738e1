"""The last single-card flags of the port against the JAX package, float32 on
the CPU:

- AdaMVS ``reg_impl="precomp"``: ``models/adamvs.py::ada_precomp_depth``
  against JAX ``ada_precomp_depth`` with the same AdaRedCell weights, in one
  chunk and in two, both heads; the port's precomp cascade against its
  stepped fused form; ``ModelConfig`` builds it;
- MS-REDNet's ``fpn`` feature net: ``RedFeatureNet(arch_mode="fpn")``
  against JAX's, its weights carried by ``from_jax_msrednet_variables``
  (JAX -> port only: the JAX importer has no fpn plan), alone and in the
  whole scan-form cascade;
- ``warp_impl="pallas2bf16"`` on a float32 model: the plain bf16-in,
  float32-out sampler against the exact JAX gather form on bf16-rounded
  features, and the scan forms of both families against the JAX model with
  ``warp_impl="pallas2bf16"`` (its Pallas sampler in interpret mode) and
  against the port's float32 model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adamvs_tpu.models import AdaMVS as JAdaMVS
from adamvs_tpu.models import MSREDNet as JMSREDNet
from adamvs_tpu.models.adamvs import ada_precomp_depth as jada_precomp_depth
from adamvs_tpu.nn.featurenet import RedFeatureNet as JRedFeatureNet
from adamvs_tpu.ops.warp import bilinear_sample as jbilinear_sample
from adamvs_tpu_torch.config import ModelConfig
from adamvs_tpu_torch.models import AdaMVS, MSREDNet
from adamvs_tpu_torch.models.adamvs import ada_precomp_depth
from adamvs_tpu_torch.nn.blocks import init_parameters
from adamvs_tpu_torch.nn.featurenet import RedFeatureNet
from adamvs_tpu_torch.ops.warp_sample import sample_bilinear, sample_bilinear_bwd
from adamvs_tpu_torch.train.jax_import import from_jax_msrednet_variables, from_jax_variables
from tests.test_torch_port_model import _projs
from tests.test_torch_port_msrednet import _randomize_norms
from tests.test_torch_port_nn import _cell_pair
from tests.test_torch_port_bf16_train import two_threads  # noqa: F401  (autouse)
from tests.test_torch_port_train import randomize_norms

DMIN, DMAX = 300.0, 500.0
SMALL = dict(ndepths=(8, 4, 4), depth_intervals_ratio=(4.0, 2.0, 1.0), base=8, cr_base=(8, 8, 8))


def _inputs(B=1, V=3, H=64, W=64, seed=2):
    rng = np.random.RandomState(seed)
    imgs = rng.randn(B, V, H, W, 3).astype(np.float32)
    return imgs, _projs(B, V, H, W), np.array([[DMIN, DMAX]] * B, np.float32)


def _torch_inputs(imgs, projs, dv):
    return (torch.from_numpy(imgs), {k: torch.from_numpy(v) for k, v in projs.items()},
            torch.from_numpy(dv))


# --- AdaMVS reg_impl="precomp" -----------------------------------------------------------

@pytest.mark.parametrize("D,up", [(5, True), (16, True), (16, False)],
                         ids=["one_chunk_up", "two_chunks_up", "two_chunks_head"])
def test_ada_precomp_depth_matches_jax(D, up):
    """Depth within 1e-5 of the hypothesis range and confidence within 1e-5
    of JAX ``ada_precomp_depth`` (float32)."""
    cin, base, B, h, w = 16, 4, 1, 12, 16
    jcell, variables, cell = _cell_pair(cin, base, up, h, w, seed=D)
    rng = np.random.RandomState(D + up)
    vol = rng.randn(D, B, h, w, cin).astype(np.float32)
    oh, ow = (2 * h, 2 * w) if up else (h, w)
    lo = rng.uniform(300, 320, (B, oh, ow)).astype(np.float32)
    step = rng.uniform(4, 6, (B, oh, ow)).astype(np.float32)
    jdepth, jconf = jax.jit(lambda p, v, a, s: jada_precomp_depth(p, v, base, up, a, s))(
        variables["params"], vol, lo, step)
    with torch.no_grad():
        depth, conf = ada_precomp_depth(cell, torch.from_numpy(vol).permute(0, 1, 4, 2, 3),
                                        torch.from_numpy(lo), torch.from_numpy(step))
    assert depth.shape == conf.shape == (B, oh, ow)
    span = float((step * (D - 1)).max())
    assert np.abs(depth.numpy() - np.asarray(jdepth)).max() / span < 1e-5
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), atol=1e-5)
    assert float(np.asarray(jconf).max()) > 1.1 / D  # the costs are not flat


def test_adamvs_precomp_cascade_matches_the_stepped_form():
    """The port's precomp AdaMVS (D 16/8/5: two chunks, one of 8, one of 5)
    against the same weights with the cell stepped (``reg_impl="scan"``) and
    through K3's plain version (``reg_impl="pallas"``): depth within 1e-4 of
    the depth range, confidence within 1e-3 per stage."""
    kw = dict(ndepths=(16, 8, 5), depth_intervals_ratio=(4.0, 2.0, 1.0), base=4,
              cr_base=(4, 4, 4), sweep_impl="fused")
    forms = {r: AdaMVS(**kw, reg_impl=r).eval() for r in ("precomp", "scan", "pallas")}
    init_parameters(forms["scan"], torch.Generator().manual_seed(3))
    randomize_norms(forms["scan"], 5)
    for m in forms.values():
        m.load_state_dict(forms["scan"].state_dict())
    args = _torch_inputs(*_inputs())
    out = {r: m(*args, num_depth=64) for r, m in forms.items()}
    for ref in ("scan", "pallas"):
        for key in ("stage1", "stage2", "stage3"):
            g, w = out["precomp"][key], out[ref][key]
            err = (g["depth"] - w["depth"]).abs().max().item() / (DMAX - DMIN)
            cerr = (g["photometric_confidence"] - w["photometric_confidence"]).abs().max().item()
            assert err < 1e-4 and cerr < 1e-3, (ref, key, err, cerr)


def test_model_config_builds_the_last_flags():
    """``ModelConfig`` no longer refuses AdaMVS precomp or pallas2bf16 on a
    float32 model; the latter samples bf16 sources, a bf16 model samples its
    own."""
    m = ModelConfig(model="adamvs", sweep_impl="fused", reg_impl="precomp").build(device="cpu")
    assert m.reg_impl == "precomp"
    m = ModelConfig(dtype="f32", warp_impl="pallas2bf16").build(device="cpu")
    assert m.sample_dtype == torch.bfloat16 and m.feature.out1.weight.dtype == torch.float32
    m = ModelConfig(dtype="bf16", warp_impl="pallas2bf16").build(device="cpu")
    assert m.sample_dtype is None and m.feature.out1.weight.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="sweep_impl"):
        AdaMVS(sweep_impl="scan", reg_impl="precomp")


# --- the fpn feature net ---------------------------------------------------------------

def test_fpn_feature_net_matches_jax():
    """``RedFeatureNet(arch_mode="fpn")`` with JAX's weights (random
    BatchNorm statistics) within 1e-4 of JAX's, eval and train mode; the
    submodules carry the reference FPN's names."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 48, 3).astype(np.float32)
    jnet = JRedFeatureNet(4, arch_mode="fpn")
    variables = _randomize_norms(jax.jit(jnet.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.asarray(x), False), 1)
    sd = from_jax_msrednet_variables({"params": {"feature": variables["params"]},
                                      "batch_stats": {"feature": variables["batch_stats"]}})
    net = RedFeatureNet(4, arch_mode="fpn")
    net.load_state_dict({k.removeprefix("feature."): v for k, v in sd.items()})
    assert {"inner1.weight", "inner1.bias", "inner2.weight", "out2.weight",
            "out3.weight"} <= set(net.state_dict())
    assert not any(k.startswith("deconv") for k in net.state_dict())
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    for train in (False, True):
        if train:
            want = jax.jit(lambda v, a: jnet.apply(v, a, True, mutable=["batch_stats"])[0])(
                variables, jnp.asarray(x))
        else:
            want = jax.jit(lambda v, a: jnet.apply(v, a, False))(variables, jnp.asarray(x))
        with torch.no_grad():
            got = net.train(train)(tx)
        for k in ("stage1", "stage2", "stage3"):
            np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=f"{k} train={train}")
    assert [got[k].shape[1] for k in sorted(got)] == [16, 8, 4]


def test_fpn_msrednet_cascade_matches_jax():
    """The whole MS-REDNet with the fpn feature net (scan form, the weights
    from a JAX init through ``from_jax_msrednet_variables``): depth within
    1e-4 of the depth range and confidence within 1e-3 per stage of JAX's."""
    imgs, projs, dv = _inputs()
    jm = JMSREDNet(**SMALL, arch_mode="fpn")
    variables = _randomize_norms(jax.jit(lambda k: jm.init(k, imgs, projs, dv, num_depth=64))(
        jax.random.PRNGKey(4)), 2)
    want = jax.jit(lambda v: jm.apply(v, imgs, projs, dv, num_depth=64))(variables)
    port = MSREDNet(**SMALL, sweep_impl="scan", arch_mode="fpn").eval()
    port.load_state_dict(from_jax_msrednet_variables(variables))
    got = port(*_torch_inputs(imgs, projs, dv), num_depth=64)
    for key in ("stage1", "stage2", "stage3"):
        err = np.abs(got[key]["depth"].numpy() - np.asarray(want[key]["depth"])).max()
        cerr = np.abs(got[key]["photometric_confidence"].numpy()
                      - np.asarray(want[key]["photometric_confidence"])).max()
        assert err / (DMAX - DMIN) < 1e-4 and cerr < 1e-3, (key, err, cerr)


# --- pallas2bf16 on a float32 model ------------------------------------------------------

@pytest.mark.parametrize("B,N,h,w,H,W,C", [(1, 1, 7, 9, 11, 13, 8), (2, 4, 5, 6, 9, 7, 3),
                                            (2, 16, 4, 5, 6, 8, 32)])
def test_bf16_to_float32_sampler_matches_jax_gather(B, N, h, w, H, W, C):
    """The plain K6/K7 on a bf16 map into float32 equals JAX's exact gather
    form on the bf16-rounded map (float32 sums in the same order), and its
    gradient, rounded once to bf16, is the float32 gradient's rounding."""
    rng = np.random.RandomState(C + N)
    feat = np.asarray(jnp.asarray(rng.randn(B, H, W, C), jnp.bfloat16).astype(jnp.float32))
    u = rng.uniform(-2.0, W + 1.0, (B, N, h, w)).astype(np.float32)
    v = rng.uniform(-2.0, H + 1.0, (B, N, h, w)).astype(np.float32)
    u[:, :, 0] = -1e9  # behind the camera
    want = np.asarray(jbilinear_sample(feat, u, v))
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    tf = torch.from_numpy(feat).bfloat16().requires_grad_()
    got = sample_bilinear(tf, tu, tv, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (B, N, h, w, C)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    dout = rng.randn(B, N, h, w, C).astype(np.float32)
    (got * torch.from_numpy(dout)).sum().backward()
    wgrad = np.asarray(jax.grad(lambda f: jnp.sum(jbilinear_sample(f, u, v) * dout))(feat))
    assert tf.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(tf.grad.float().numpy(),
                               torch.from_numpy(wgrad).bfloat16().float().numpy(),
                               rtol=1e-2, atol=1e-5)
    bwd = sample_bilinear_bwd(torch.from_numpy(dout), tu, tv, H, W).bfloat16()
    assert bwd.dtype == torch.bfloat16 and torch.equal(bwd, tf.grad)


@pytest.mark.parametrize("name", ["adamvs", "msrednet"])
def test_pallas2bf16_float32_model_matches_jax(name):
    """The scan form of a float32 model with ``warp_impl="pallas2bf16"``
    (sources rounded to bf16, sampled into float32) against the JAX model
    with the same flag (its Pallas sampler interpreted) and the port's
    float32 model with exact sampling. JAX's kernel also rounds its hat
    weights to bf16 inside its matmul, a TPU artefact the port does not copy,
    so the port lies closer to the exact model than JAX does: per stage its
    depth moves from the exact model's by more than 0 and at most as far as
    JAX's, and lies within twice that distance of JAX's (depth range
    units)."""
    imgs, projs, dv = _inputs(seed=5)
    jcls, pcls, conv = ((JAdaMVS, AdaMVS, from_jax_variables) if name == "adamvs"
                        else (JMSREDNet, MSREDNet, from_jax_msrednet_variables))
    jm = jcls(**SMALL, warp_impl="pallas2bf16", use_remat=False)  # remat takes no callbacks
    variables = jax.jit(lambda k: jm.init(k, imgs, projs, dv, num_depth=64))(
        jax.random.PRNGKey(6))
    with pltpu.force_tpu_interpret_mode():
        want = jm.apply(variables, imgs, projs, dv, num_depth=64)
    cfg = ModelConfig(model=name, ndepths=SMALL["ndepths"], cr_base_chs=SMALL["cr_base"],
                      base_channels=SMALL["base"], warp_impl="pallas2bf16")
    port = cfg.build(device="cpu")
    assert port.sample_dtype == torch.bfloat16
    port.load_state_dict(conv(variables))
    exact = pcls(**SMALL, sweep_impl="scan", **({"reg_impl": "scan"} if name == "adamvs" else {}))
    exact.load_state_dict(port.state_dict())
    args = _torch_inputs(imgs, projs, dv)
    got, ref = port(*args, num_depth=64), exact.eval()(*args, num_depth=64)
    span = DMAX - DMIN
    for key in ("stage1", "stage2", "stage3"):
        d, j, e = (np.asarray(t, np.float64) for t in (got[key]["depth"], want[key]["depth"],
                                                        ref[key]["depth"]))
        moved, jmoved, err = (np.abs(a - b).max() / span for a, b in ((d, e), (j, e), (d, j)))
        print(f"{name} {key}: the port moves {moved:.2e} from the exact model, JAX {jmoved:.2e}; "
              f"port vs JAX {err:.2e}")
        assert got[key]["depth"].dtype == torch.float32
        assert 0.0 < moved <= jmoved and err <= 2 * jmoved, (key, moved, jmoved, err)


# --- the predict command with the new flags ------------------------------------------------

@pytest.mark.parametrize("flags,base_flags,limit", [
    (["--sweep_impl", "fused", "--reg_impl", "precomp"],
     ["--sweep_impl", "fused", "--reg_impl", "scan"], 1e-4),
    (["--warp_impl", "pallas2bf16"], [], 1e-2),
], ids=["adamvs_precomp", "pallas2bf16_f32"])
def test_predict_command_with_the_new_flags(tmp_path, flags, base_flags, limit):
    """``predict`` with AdaMVS ``--reg_impl precomp`` (against the stepped
    fused form: maps within 1e-4 of the depth range) and with
    ``--warp_impl pallas2bf16`` on the float32 default form (against exact
    sampling: within 1e-2, the bf16 rounding of the sources) writes the
    same files; confidences within 1e-3 and 1e-2."""
    import os

    from adamvs_tpu_torch.cli import main
    from adamvs_tpu_torch.data.synthetic import make_scene, write_predict_source_tree
    from adamvs_tpu_torch.io.pfm import read_pfm

    scene = make_scene(num_views=4, height=96, width=128, seed=0)
    tree = write_predict_source_tree(str(tmp_path / "source"), scene)
    outs = {}
    for run, extra in (("base", base_flags), ("flag", flags)):
        out = str(tmp_path / run)
        main(["predict", "--view_num", "3", "--ndepths", "16,8,5", "--depth_inter_r", "4,2,1",
              "--cr_base_chs", "4,4,4", "--numdepth", "32", "--data_folder", tree,
              "--output_folder", out, "--device", "cpu", "--display", "false", *extra])
        outs[run] = {os.path.relpath(os.path.join(d, f), out): os.path.join(d, f)
                     for d, _, fs in os.walk(out) for f in fs}
    assert outs["base"].keys() == outs["flag"].keys()
    pfms = [k for k in outs["base"] if k.endswith(".pfm")]
    assert len(pfms) == 8
    span = scene.depth_end - scene.depth_start
    for k in pfms:
        a, b = read_pfm(outs["base"][k])[0], read_pfm(outs["flag"][k])[0]
        assert a.shape == b.shape and np.isfinite(b).all(), k
        err = np.abs(a - b).max()
        assert err < (10 * limit if k.endswith("_prob.pfm") else limit * span), (k, err)
