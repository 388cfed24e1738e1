"""The plain reference against the port at a small size on the CPU, with one
state dict drawn from the seed for both: depth and confidence of both
families, then one float32 train step's loss and gradients. On the CPU the
port runs its kernels' plain versions, so the two sides differ only in the
order of float32 sums (and in a ReLU input within rounding of 0, which
these seeds keep away)."""

import copy

import numpy as np
import pytest
import torch

from mvsbench import check, program
from mvsbench.reference.train import RMSprop, train_step
from mvsbench.scene import Strip, predict_items, train_batches
from mvsbench.tests.tiny import tiny_cell

SEED = 2147483659


def _f32(cell):
    tr = copy.deepcopy(cell.traffic)
    tr["dtype"] = "f32"
    return tr


@pytest.mark.parametrize("config", ["adamvs", "msrednet"])
def test_predict_matches_port(config):
    cell = tiny_cell("adamvs-predict-bf16", config=config)
    cfg, tr = cell.config, _f32(cell)
    item = predict_items(Strip(tr["scene"], SEED + 1, "cpu"), 1, cfg["views"])[0]
    dv = np.array(tr["depth_range"], np.float32)
    port = program.port_model(cfg, tr, program.draw_weights(cfg, SEED, "cpu"), "cpu")
    with torch.no_grad():
        out = port(torch.from_numpy(item["imgs"])[None],
                   {k: torch.from_numpy(v)[None] for k, v in item["proj_matrices"].items()},
                   torch.from_numpy(dv)[None], num_depth=cfg["num_depth"])
    depth, conf = check.reference_maps(check.reference_model(cfg, SEED, "cpu"), cfg, item, dv,
                                       "cpu")
    interval = float(dv[1] - dv[0]) / cfg["num_depth"]
    assert np.abs(out["depth"][0].numpy() - depth).max() < 1e-4 * interval * cfg["num_depth"]
    assert np.abs(out["photometric_confidence"][0].numpy() - conf).max() < 1e-4
    # the seeded weights give a map that follows its costs, not the flat middle of the range
    assert depth.std() > 1.0


def test_train_step_matches_port():
    from adamvs_tpu_torch.models import model_loss

    cell = tiny_cell("adamvs-train-f32-b4")
    cfg, tr = cell.config, cell.traffic
    batch = train_batches(Strip(tr["scene"], SEED + 1, "cpu"), 1, tr["batch"], cfg["views"],
                          *tr["crop"], tr["depth_range"], cfg["num_depth"], SEED)[0]
    tb = check.to_tensors(batch, "cpu")
    port = program.port_model(cfg, tr, program.draw_weights(cfg, SEED, "cpu"), "cpu",
                              train=True).train()
    out = port(tb["imgs"], tb["proj_matrices"], tb["depth_values"], train=True)
    loss, _ = model_loss(cfg["model"])(out, tb["depth"], tb["mask"], tuple(cfg["dlossw"]))
    loss.backward()
    ref = check.reference_model(cfg, SEED, "cpu")
    ref_loss, grads, _ = train_step(ref, RMSprop(ref.parameters()), tb, cfg["dlossw"])
    assert abs(float(loss.detach()) - ref_loss) < 1e-5 * abs(ref_loss)
    g_port = torch.cat([p.grad.flatten() for _, p in port.named_parameters()])
    g_ref = torch.cat([grads[k].flatten() for k, _ in port.named_parameters()])
    assert float((g_port - g_ref).norm() / g_ref.norm()) < 1e-3
    # train-mode BatchNorm moved both sides' running statistics alike
    for k, v in port.state_dict().items():
        if k.endswith("running_var"):
            torch.testing.assert_close(v, ref.state_dict()[k], rtol=1e-4, atol=1e-6)


def test_leaf_look_names_the_leaves():
    """``calibrate.look`` follows the program's first steps and the
    reference's leaf by leaf. On the CPU the port runs its kernels' plain
    versions and TF32 does not exist, so the two sides differ by the order of
    float32 sums alone, and the witness is the reference itself: the first
    gradient and the worst leaf's first step agree to that order (its change
    over three steps need not: RMSprop's steps amplify it)."""
    from mvsbench import calibrate

    out = calibrate.look(tiny_cell("adamvs-train-f32-b4"), SEED, torch.device("cpu"))
    assert 0 < out["moving"] <= out["leaves"]
    assert out["grad_gap"] < 1e-3
    assert out["witness_change_gap"] == 0 and out["witness_grad_gap"] == 0
    assert out["witness_first_step_against"][0] == 0
    worst = out["change_leaves"][0]
    assert worst["gap"] == out["change_gap"] and worst["elements"] > 0
    assert worst["first_step_gap"] < 1e-3
    assert out["grad_leaves"][0]["gap"] == out["grad_gap"]
