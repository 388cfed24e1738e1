"""The port's ``predict`` command on the CPU against the JAX package's
``PredictEngine.run`` on the same JAX-written tree and the same weights: the
file layout, the depth and probability maps, the camera text and the
reference image. Also the feature cache (alone and with ``--predict_batch``)
against the uncached run, every inference form through the command, and the
flag combinations the port refuses.

The JAX side runs its exact scan form. The port's ``--sweep_impl fused
--reg_impl scan`` is held to it too: the JAX fused sweep contracts its bands
in bf16, the port's sweep samples exactly, as the scan form does."""

import os

import jax
import numpy as np
import pytest
import torch

from adamvs_tpu.data.lists import build_predict_list as jbuild_predict_list
from adamvs_tpu.data.synthetic import make_scene, write_predict_source_tree
from adamvs_tpu.models import AdaMVS as JAdaMVS
from adamvs_tpu.predict.engine import PredictEngine as JPredictEngine
from adamvs_tpu_torch.cli import main
from adamvs_tpu_torch.io.pfm import read_pfm
from adamvs_tpu_torch.models import AdaMVS
from adamvs_tpu_torch.train.checkpoint import save_checkpoint
from adamvs_tpu_torch.train.jax_import import from_jax_variables
from adamvs_tpu_torch.train.state import create_train_state, make_optimizer

torch.set_num_threads(2)

TINY = ["--view_num", "3", "--ndepths", "8,4", "--depth_inter_r", "4,2", "--cr_base_chs", "4,4",
        "--numdepth", "32"]
JCFG = dict(ndepths=(8, 4), depth_intervals_ratio=(4.0, 2.0), cr_base=(4, 4))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A JAX-written 96x128 tree, JAX variables (seed-0 init, parameters x4
    for depth maps with structure), the same weights as a port ``.ckpt``, and
    the JAX engine's outputs at the CLI's defaults."""
    root = tmp_path_factory.mktemp("predict")
    scene = make_scene(num_views=4, height=96, width=128, seed=0)
    tree = write_predict_source_tree(str(root / "source"), scene)
    jmodel = JAdaMVS(**JCFG)
    imgs = np.zeros((1, 3, 64, 64, 3), np.float32)
    projs = {k: np.tile(np.eye(4, dtype=np.float32), (1, 3, 1, 1)) for k in ("stage1", "stage2")}
    variables = jax.jit(lambda k: jmodel.init(k, imgs, projs, np.array([[100.0, 200.0]],
                                                                        np.float32),
                                              num_depth=32))(jax.random.PRNGKey(0))
    variables = {"params": jax.tree_util.tree_map(lambda x: x * 4.0, variables["params"]),
                 "batch_stats": variables["batch_stats"]}
    model = AdaMVS(**JCFG)
    model.load_state_dict(from_jax_variables(variables))
    ckpt = save_checkpoint(str(root), create_train_state(model, make_optimizer(
        model.parameters())), epoch=0)
    jout = str(root / "jax_out")
    JPredictEngine(jmodel, variables, num_depth=32, log_fn=lambda s: None).run(
        jbuild_predict_list(tree, 3), jout,
        load_kwargs=dict(resize_scale=0.5, max_h=5504, max_w=3712, sample_scale=1.0))
    return dict(tree=tree, ckpt=ckpt, jout=jout, root=root,
                depth_range=scene.depth_end - scene.depth_start)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def _run(case, name, *flags):
    out = str(case["root"] / name)
    engine = main(["predict", *TINY, "--data_folder", case["tree"], "--output_folder", out,
                   "--loadckpt", case["ckpt"], "--device", "cpu", *flags])
    return out, engine


@pytest.mark.parametrize("flags", [(), ("--sweep_impl", "fused", "--reg_impl", "scan")],
                         ids=["defaults", "fused_regscan"])
def test_cli_matches_jax_engine(case, flags):
    out, _ = _run(case, "out_" + "_".join(flags), *flags)
    jout = case["jout"]
    files = _files(jout)
    assert files == _files(out) and len(files) == 4 * 6
    for rel in files:
        got, want = os.path.join(out, rel), os.path.join(jout, rel)
        if rel.endswith(".pfm"):
            g, w = read_pfm(got)[0], read_pfm(want)[0]
            assert g.shape == w.shape == (48, 64)
            if rel.endswith("_init.pfm"):
                err = np.abs(g - w).max() / case["depth_range"]
                assert err < 1e-4, f"{rel}: depth err {err:.2e} of the range"
                assert w.std() > 1e-3 * case["depth_range"]
            else:
                np.testing.assert_allclose(g, w, atol=1e-3, err_msg=rel)
        elif rel.endswith((".txt", ".jpg")):
            assert open(got, "rb").read() == open(want, "rb").read(), rel


def _depths(root):
    return {rel: read_pfm(os.path.join(root, rel))[0] for rel in _files(root)
            if rel.endswith(".pfm")}


def test_feature_cache_and_batch_match_uncached(case):
    plain, _ = _run(case, "plain", "--display", "false")
    want = _depths(plain)
    assert len(want) == 8
    for flags in (("--feature_cache", "8"), ("--feature_cache", "8", "--predict_batch", "2")):
        out, engine = _run(case, "cache_" + "_".join(flags), "--display", "false", *flags)
        # 4 work items of 3 views over 4 images: each image is computed once
        assert (engine.cache_hits, engine.cache_misses) == (8, 4), flags
        got = _depths(out)
        assert got.keys() == want.keys()
        for rel, w in want.items():
            np.testing.assert_allclose(got[rel], w, rtol=1e-6, atol=1e-6, err_msg=f"{flags} {rel}")


@pytest.mark.parametrize("flags", [
    ("--sweep_impl", "fused", "--reg_impl", "pallas"),
    ("--sweep_impl", "fusedf32", "--reg_impl", "pallas", "--warp_impl", "pallas2"),
    ("--model", "msrednet", "--sweep_impl", "fused"),
    ("--model", "msrednet"),
], ids=["adamvs_fused_pallas", "adamvs_fusedf32", "msrednet_fused", "msrednet_scan"])
def test_cli_runs_every_form(case, tmp_path, flags):
    """Three stages, so MS-REDNet's last stage runs at the full frame too."""
    out = str(tmp_path / "out")
    main(["predict", "--view_num", "3", "--ndepths", "8,4,4", "--depth_inter_r", "4,2,1",
          "--cr_base_chs", "4,4,4", "--numdepth", "32", "--data_folder", case["tree"],
          "--output_folder", out, "--device", "cpu", "--predict_batch", "2", *flags])
    depths = _depths(out)
    assert len(depths) == 8
    for rel, d in depths.items():
        assert d.shape == (48, 64) and np.isfinite(d).all(), rel
        if rel.endswith("_prob.pfm"):
            assert d.min() > 0 and d.max() <= 1, rel


@pytest.mark.parametrize("flags,item", [
    # AdaMVS precomp and pallas2bf16 on a float32 model run (tests/test_torch_port_flags.py);
    # row bands and several hosts do not
    (("--sweep_impl", "fused", "--reg_impl", "precomp", "--tiles", "2"), "parallel paths"),
    # MS-REDNet precomp runs (tests/test_torch_port_precomp.py); row bands do not
    (("--model", "msrednet", "--sweep_impl", "fused", "--reg_impl", "precomp", "--tiles", "2"),
     "parallel paths"),
    (("--warp_impl", "pallas2bf16", "--distributed"), "parallel paths"),
    (("--tiles", "2"), "parallel paths"),
    (("--distributed",), "parallel paths"),
], ids=["adamvs_precomp", "msrednet_precomp", "pallas2bf16_f32", "tiles", "distributed"])
def test_unported_flags_raise_naming_their_roadmap_item(tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1") as err:
        main(["predict", "--data_folder", str(tmp_path), "--output_folder", str(tmp_path),
              "--device", "cpu", *flags])
    assert item in str(err.value)


@pytest.mark.parametrize("flags", [
    ("--reg_impl", "pallas"),
    ("--model", "msrednet", "--sweep_impl", "fused", "--reg_impl", "pallas"),
])
def test_invalid_pairings_raise(tmp_path, flags):
    with pytest.raises(ValueError, match="reg_impl"):
        main(["predict", "--data_folder", str(tmp_path), "--output_folder", str(tmp_path),
              "--device", "cpu", *flags])
