"""Training with image rows sharded over a tile axis: one ``Trainer`` step
of the port over a (data=1, tile=2) mesh of two gloo processes on the CPU
against one process on the global batch, and against JAX's own row-sharded
step (``Trainer(mesh=make_mesh(data=1, tile=2))`` on the 8-device virtual
CPU mesh of tests/conftest.py).

Each rank holds one row band of the 64x64 frames (``shard_batch``: 32 rows
of the images, 8/16/32 of the stages' GT and masks); convolutions and
resizes exchange halo rows, the sources are gathered per stage, and
BatchNorm, GroupNorm and the masked means take their statistics over the
mesh (``parallel/halo.py``). So the step must be one process's step on the
whole frame: the loss within 1e-5 relative, the gradient within 1e-3
relative L2, the parameters by RMSprop's rule, the BatchNorm statistics
within 1e-5, and every stage's depth, at every row, within 1e-5 of the depth
range, for AdaMVS in the scan and the fused training forms and MS-REDNet in
both. The mask is zero over a block that straddles the bands' border, so
per-band masked means would differ; rank 1 starts from other weights, which
the Trainer must replace with rank 0's."""

import os

import pytest
import torch

from adamvs_tpu.models import AdaMVS as JAdaMVS
from adamvs_tpu.models import MSREDNet as JMSREDNet
from adamvs_tpu.models import cas_mvs_vis_loss as jcas_mvs_vis_loss
from adamvs_tpu.models import cas_rednet_loss as jcas_rednet_loss
from adamvs_tpu.parallel.mesh import make_mesh as jmake_mesh
from adamvs_tpu.train import Trainer as JTrainer
from adamvs_tpu.train import create_train_state as jcreate_train_state
from adamvs_tpu.train import make_optimizer as jmake_optimizer
from adamvs_tpu.train.torch_import import import_adamvs_state_dict, import_msrednet_state_dict
from adamvs_tpu_torch.models import build_model, model_loss
from adamvs_tpu_torch.nn.blocks import init_parameters
from adamvs_tpu_torch.parallel.dryrun import free_port
from adamvs_tpu_torch.parallel.mesh import Mesh, shard_batch
from adamvs_tpu_torch.train.loop import Trainer, to_device
from adamvs_tpu_torch.train.state import create_train_state, make_optimizer
from tests.test_torch_port_parallel_train import GLOO_TIMEOUT, REPO, results, run_workers
from tests.test_torch_port_train import (DMAX, DMIN, _scene, _to_jax_variables, randomize_norms,
                                         relu_margin)

CFG = dict(ndepths=(8, 4, 4), depth_intervals_ratio=(4.0, 2.0, 1.0), base=4, cr_base=(4, 4, 4))
DLOSSW = (0.5, 1.0, 2.0)
# form: (family, the model's options)
FORMS = {"adamvs_scan": ("adamvs", {"sweep_impl": "scan", "reg_impl": "scan"}),
         "adamvs_fused": ("adamvs", {"sweep_impl": "fused"}),
         "msrednet_fused": ("msrednet", {"sweep_impl": "fused"}),
         "msrednet_scan": ("msrednet", {"sweep_impl": "scan"})}
TILES = 2


def tile_batch() -> dict:
    """``_scene`` (1 sample, 3 views, 64x64, real cameras) with its masks
    zero over rows 24-39, columns 0-31 of the frame, across the bands'
    border at row 32."""
    batch = _scene()
    for m in batch["mask"].values():
        s = 64 // m.shape[1]
        m[:, 24 // s:40 // s, :32 // s] = 0.0
    return batch


# weight seeds whose ReLU decisions keep clear of float32 rounding here (``relu_margin``
# moves the gradient by 0 and 8.3e-7; MS-REDNet's seed 1 moves it by 6.2e-4)
SEEDS = {"adamvs": 1, "msrednet": 4}


def port_model(form: str, other: bool = False):
    """The form's model on the CPU: seeded conv weights and random norms as
    in tests/test_torch_port_train.py, from the family's seed in ``SEEDS``,
    or with ``other`` from another seed."""
    family, opts = FORMS[form]
    seed = SEEDS[family] + (10 if other else 0)
    model = build_model(family, seed=0, device="cpu", **CFG, **opts)
    init_parameters(model, torch.Generator().manual_seed(seed))
    randomize_norms(model, 3 + seed)
    return model


def _result(model, loss, depth, eval_metrics) -> dict:
    return {"loss": loss, "depth": depth, "eval": eval_metrics,
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def run_step(form: str, model, batch, logdir: str, mesh=None) -> dict:
    """One Trainer step and one eval epoch of ``model`` on ``batch`` (this
    rank's part of it with a ``mesh``): the loss, every stage's depth of the
    train step's forward, the eval metrics, gradients and state."""
    depth = {}

    def keep_depth(module, args, out):
        if not depth:  # the train step's forward; the eval step's comes after
            depth.update({k: out[k]["depth"].detach().clone() for k in ("stage1", "stage2",
                                                                        "stage3")})

    hook = model.register_forward_hook(keep_depth)
    state = create_train_state(model, make_optimizer(model.parameters(), lr=1e-3))
    tr = Trainer(state, model_loss(FORMS[form][0]), logdir, dlossw=DLOSSW, num_stages=3,
                 summary_freq=1, ckpt_step_freq=0, log_fn=lambda m: None, device="cpu",
                 mesh=mesh)
    part = batch if mesh is None else shard_batch(batch, mesh)
    loss = tr.train_epoch(0, [part])["loss"]
    metrics = tr.eval_epoch(0, [part])
    tr.close()
    hook.remove()
    return _result(model, loss, depth, metrics)


WORKER = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from adamvs_tpu_torch.parallel import initialize_distributed, make_mesh
from tests.test_torch_port_tile_train import FORMS, port_model, run_step, tile_batch

rank = int(sys.argv[1])
initialize_distributed({coord!r}, {tiles}, rank, backend="gloo", timeout_s={gloo})
out = {{}}
for form in FORMS:
    mesh = make_mesh(data=1, tile={tiles})
    model = port_model(form, other=rank > 0)
    out[form] = run_step(form, model, tile_batch(), {out!r} + f"/{{form}}{{rank}}", mesh)
torch.save(out, {out!r} + f"/rank{{rank}}.pt")
print("RESULT" + json.dumps({{"pid": rank, "loss": {{f: r["loss"] for f, r in out.items()}}}}))
"""


@pytest.fixture(scope="module")
def tile_case(tmp_path_factory):
    """Per form: the two ranks' results and one process's on the global batch."""
    root = tmp_path_factory.mktemp("tile")
    script = WORKER.format(repo=REPO, coord=f"localhost:{free_port()}", tiles=TILES,
                           gloo=GLOO_TIMEOUT, out=str(root))
    losses = results(run_workers(script, TILES, REPO))
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt")) for r in range(TILES)]
    for r in range(TILES):
        assert losses[r]["loss"] == {f: ranks[r][f]["loss"] for f in FORMS}
    batch = tile_batch()
    one = {form: run_step(form, port_model(form), batch, str(root / f"{form}_one"))
           for form in FORMS}
    return {"ranks": ranks, "one": one, "root": root}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_tile_loss_matches_one_process(tile_case, form):
    want = tile_case["one"][form]["loss"]
    for r, got in enumerate(tile_case["ranks"]):
        assert abs(got[form]["loss"] - want) <= 1e-5 * abs(want), (r, got[form]["loss"], want)


def _rel_l2(got: dict, want: dict) -> float:
    g = torch.cat([got[k].flatten() for k in want])
    w = torch.cat([want[k].flatten() for k in want])
    return float((g - w).norm() / w.norm())


@pytest.mark.parametrize("form", sorted(FORMS))
def test_tile_gradient_matches_one_process(tile_case, form):
    """Each rank's averaged gradient as one process's, within 1e-3 relative
    L2 (test_data_parallel_gradient_matches_one_process's bar), from weights
    whose ReLU decisions near float32 rounding move the gradient by less
    than 5e-5 (``relu_margin``): the bands' convolutions round apart from
    the whole frame's. A gradient not divided by the 2 ranks lies 1.0 from
    it; one whose halo or gathered-source gradients stayed on the wrong rank
    lies far from it."""
    want = tile_case["one"][form]["grads"]
    near, change = relu_margin(port_model(form), to_device(tile_batch(), torch.device("cpu")),
                               FORMS[form][0])
    assert change < 5e-5, (form, near, change)
    for r, got in enumerate(tile_case["ranks"]):
        assert got[form]["grads"].keys() == want.keys()
        rel = _rel_l2(got[form]["grads"], want)
        assert rel < 1e-3, f"rank {r}: gradient rel L2 {rel:.2e}"


@pytest.mark.parametrize("form", sorted(FORMS))
def test_tile_parameters_match_one_process(tile_case, form):
    """Each rank's parameters less one process's equal RMSprop's first step
    of the rank's gradient less that of one process's, within 1e-6
    (tests/test_torch_port_parallel_train.py's rule), and the BatchNorm
    statistics within 1e-5."""
    one = tile_case["one"][form]

    def step(g):
        return -1e-3 * g / ((0.1 * g * g).sqrt() + 1e-8)

    for r, got in enumerate(tile_case["ranks"]):
        state, grads = got[form]["state"], got[form]["grads"]
        for k, v in one["state"].items():
            if k in one["grads"]:
                expect = step(grads[k]) - step(one["grads"][k])
                torch.testing.assert_close(state[k] - v, expect, rtol=0, atol=1e-6,
                                           msg=lambda m: f"rank {r} {k}: {m}")
            elif v.is_floating_point():
                torch.testing.assert_close(state[k], v, rtol=1e-5, atol=1e-5,
                                           msg=lambda m: f"rank {r} {k}: {m}")
            else:
                assert torch.equal(state[k], v), (r, k)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_tile_depth_matches_one_process(tile_case, form):
    """Every stage's depth of the train step, the two bands' rows together,
    as one process's at every row within 1e-5 of the depth range: a
    convolution or resize that missed its halo would show at the bands'
    border."""
    want = tile_case["one"][form]["depth"]
    for key, w in want.items():
        got = torch.cat([r[form]["depth"][key] for r in tile_case["ranks"]], dim=1)
        assert got.shape == w.shape, (key, got.shape, w.shape)
        err = float((got - w).abs().max()) / (DMAX - DMIN)
        assert err < 1e-5, (form, key, err)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_tile_eval_matches_one_process(tile_case, form):
    """``eval_epoch`` on the row bands (their rows gathered, the unbanded
    inference form on every rank) as one process's, within 1e-5 relative."""
    want = tile_case["one"][form]["eval"]
    for r, got in enumerate(tile_case["ranks"]):
        assert got[form]["eval"].keys() == want.keys()
        for k, v in want.items():
            assert abs(got[form]["eval"][k] - v) <= 1e-5 * max(abs(v), 1e-3), (r, k)


JAX_FAMILIES = {"adamvs": (JAdaMVS, jcas_mvs_vis_loss, import_adamvs_state_dict),
                "msrednet": (JMSREDNet, jcas_rednet_loss, import_msrednet_state_dict)}


@pytest.mark.parametrize("form", [
    "adamvs_scan", pytest.param("msrednet_scan", marks=pytest.mark.slow)])
def test_tile_loss_matches_jax_row_sharded_trainer(tile_case, form, tmp_path):
    """The ranks' loss against JAX's ``Trainer`` over a (data=1, tile=2)
    mesh on the same batch and weights, which shards the image rows over
    ``tile`` itself (JAX's models run the scan form by default), within
    1e-5 relative."""
    family = FORMS[form][0]
    jcls, jloss_fn, importer = JAX_FAMILIES[family]
    batch = tile_batch()
    jmodel = jcls(**CFG)
    variables = _to_jax_variables(port_model(form), jmodel, importer, batch)
    jtr = JTrainer(jmodel, jloss_fn, jcreate_train_state(jmodel, variables,
                                                         jmake_optimizer(lr=1e-3)),
                   str(tmp_path / "jax"), dlossw=DLOSSW, num_stages=3, log_fn=lambda *a: None,
                   ckpt_step_freq=0, mesh=jmake_mesh(data=1, tile=TILES))
    jloss = jtr.train_epoch(0, [batch])["loss"]
    for r, got in enumerate(tile_case["ranks"]):
        assert abs(got[form]["loss"] - jloss) <= 1e-5 * abs(jloss), (r, got[form]["loss"], jloss)


def test_tile_records_on_rank_zero_only(tile_case):
    """Rank 0 writes the records (its images gathered from both bands);
    rank 1 writes none."""
    root = tile_case["root"]
    assert os.path.exists(root / "adamvs_scan0" / "metrics.jsonl")
    assert not os.path.exists(root / "adamvs_scan1" / "metrics.jsonl")


def test_shard_batch_needs_bands_of_32_rows():
    """H/tile must be a multiple of 32: the cascade halves a band's rows
    five times."""
    batch = tile_batch()
    with pytest.raises(ValueError, match="multiple of 32"):
        shard_batch(batch, Mesh(1, 4))
    cut = shard_batch(batch, Mesh(1, 2))
    assert cut["imgs"].shape[2] == 32 and cut["depth"]["stage1"].shape[1] == 8
