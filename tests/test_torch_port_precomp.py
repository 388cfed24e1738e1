"""MS-REDNet ``reg_impl="precomp"`` in the port, float32 on the CPU.

- ``models/msrednet.py::red_precomp_depth`` against JAX ``red_precomp_depth``
  with the same RedCell weights (random GroupNorm parameters), in one chunk
  (D=5, which 8 does not divide) and in two chunks of 8 (D=16);
- the port's precomp ``MSREDNet`` against its own stepped fused form on a
  three-stage cascade (depth within 1e-4 of the depth range, confidence
  within 1e-3);
- the predict command with ``--reg_impl precomp`` against the same command
  with the stepped regulariser."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adamvs_tpu.models.msrednet import red_precomp_depth as jred_precomp_depth
from adamvs_tpu.nn.costreg import RedCell as JRedCell
from adamvs_tpu_torch.cli import main
from adamvs_tpu_torch.data.synthetic import make_scene, write_predict_source_tree
from adamvs_tpu_torch.io.pfm import read_pfm
from adamvs_tpu_torch.models import MSREDNet
from adamvs_tpu_torch.models.msrednet import red_precomp_depth
from adamvs_tpu_torch.nn.blocks import init_parameters
from adamvs_tpu_torch.nn.costreg import RedCell
from adamvs_tpu_torch.train import jax_import
from tests.test_torch_port_model import _projs
from tests.test_torch_port_msrednet import _port_state, _randomize_norms
from tests.test_torch_port_train import randomize_norms

torch.set_num_threads(2)

DMIN, DMAX = 300.0, 500.0


@pytest.mark.parametrize("D", [5, 16], ids=["one_chunk", "two_chunks"])
def test_red_precomp_depth_matches_jax(D):
    """Depth within 1e-5 of the hypothesis range and confidence within 1e-5
    (float32; the x- and h-side convolutions are summed in the same order
    on both sides)."""
    B, h, w, C, b = 1, 16, 24, 16, 4
    rng = np.random.RandomState(D)
    jcell = JRedCell(b)
    vol = rng.randn(D, B, h, w, C).astype(np.float32)
    variables = _randomize_norms(
        jax.jit(jcell.init)(jax.random.PRNGKey(7), jcell.init_carry(B, h, w), jnp.asarray(vol[0])),
        8)
    lo = rng.uniform(300, 320, (B, h, w)).astype(np.float32)
    step = rng.uniform(4, 6, (B, h, w)).astype(np.float32)
    jdepth, jconf = jax.jit(lambda p, v, a, s: jred_precomp_depth(p, v, b, a, s))(
        variables["params"], vol, lo, step)

    cell = RedCell(C, b).eval()
    cell.load_state_dict(_port_state(variables["params"], {}, jax_import._red_reg_plan(),
                                     strip="cell/"))
    with torch.no_grad():
        depth, conf = red_precomp_depth(cell, torch.from_numpy(vol).permute(0, 1, 4, 2, 3),
                                        torch.from_numpy(lo), torch.from_numpy(step))
    span = float((step * (D - 1)).max())
    assert depth.shape == (B, h, w) and conf.shape == (B, h, w)
    assert np.abs(depth.numpy() - np.asarray(jdepth)).max() / span < 1e-5
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), atol=1e-5)
    # the regularised costs are not flat
    assert float(np.asarray(jconf).max()) > 2.0 / D


def _pair(**kw):
    """The stepped fused model and its precomp twin, same weights (seed 3,
    random GroupNorm parameters)."""
    stepped = MSREDNet(**kw, sweep_impl="fused").eval()
    init_parameters(stepped, torch.Generator().manual_seed(3))
    randomize_norms(stepped, 5)
    precomp = MSREDNet(**kw, sweep_impl="fused", reg_impl="precomp").eval()
    precomp.load_state_dict(stepped.state_dict())
    return stepped, precomp


def test_precomp_cascade_matches_the_stepped_form():
    """Three stages (D 16/8/5: two chunks, one chunk of 8, one of 5), depth
    within 1e-4 of the depth range and confidence within 1e-3 per stage."""
    stepped, precomp = _pair(ndepths=(16, 8, 5), depth_intervals_ratio=(4.0, 2.0, 1.0), base=4,
                             cr_base=(4, 4, 4))
    rng = np.random.RandomState(2)
    imgs = torch.from_numpy(rng.randn(1, 3, 64, 64, 3).astype(np.float32))
    projs = {k: torch.from_numpy(v) for k, v in _projs(1, 3, 64, 64).items()}
    dv = torch.tensor([[DMIN, DMAX]])
    want = stepped(imgs, projs, dv, num_depth=64)
    got = precomp(imgs, projs, dv, num_depth=64)
    for key in ("stage1", "stage2", "stage3"):
        g, w = got[key], want[key]
        assert g["depth"].shape == w["depth"].shape
        err = (g["depth"] - w["depth"]).abs().max().item() / (DMAX - DMIN)
        assert err < 1e-4, f"{key} depth err {err:.2e}"
        cerr = (g["photometric_confidence"] - w["photometric_confidence"]).abs().max().item()
        assert cerr < 1e-3, f"{key} confidence err {cerr:.2e}"
    assert torch.equal(got["depth"], got["stage3"]["depth"])


def test_precomp_is_inference_only_and_fused_only():
    with pytest.raises(ValueError, match="needs sweep_impl='fused'"):
        MSREDNet(sweep_impl="scan", reg_impl="precomp")
    with pytest.raises(ValueError, match="reg_impl"):
        MSREDNet(reg_impl="pallas")


def test_predict_command_with_precomp(tmp_path):
    """``predict --model msrednet --sweep_impl fused --reg_impl precomp`` on
    the CPU writes the same files as the stepped form, maps within 1e-4 of
    the depth range and 1e-3 of confidence."""
    scene = make_scene(num_views=4, height=96, width=128, seed=0)
    tree = write_predict_source_tree(str(tmp_path / "source"), scene)
    outs = {}
    for reg in ("scan", "precomp"):
        out = str(tmp_path / reg)
        main(["predict", "--model", "msrednet", "--sweep_impl", "fused", "--reg_impl", reg,
              "--view_num", "3", "--ndepths", "16,8,5", "--depth_inter_r", "4,2,1",
              "--cr_base_chs", "4,4,4", "--numdepth", "32", "--data_folder", tree,
              "--output_folder", out, "--device", "cpu", "--display", "false"])
        outs[reg] = {os.path.relpath(os.path.join(d, f), out): os.path.join(d, f)
                     for d, _, fs in os.walk(out) for f in fs}
    assert outs["scan"].keys() == outs["precomp"].keys()
    pfms = [k for k in outs["scan"] if k.endswith(".pfm")]
    assert len(pfms) == 8
    span = scene.depth_end - scene.depth_start
    for k in pfms:
        a, b = read_pfm(outs["scan"][k])[0], read_pfm(outs["precomp"][k])[0]
        assert a.shape == b.shape == (48, 64) and np.isfinite(b).all(), k
        limit = 1e-3 if k.endswith("_prob.pfm") else 1e-4 * span
        assert np.abs(a - b).max() < limit, k
