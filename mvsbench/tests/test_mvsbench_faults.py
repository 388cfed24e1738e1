"""The check sees a broken program. Each test drives a whole run of a cell at
a CPU's size (``tests/tiny.py``), the harness's look for a card skipped, once
sound and once with the timed path broken underneath, and reads ``correct``
from the result line: an answer altered where it is produced (prediction);
a step that returns its state unchanged, and half of each batch left out
with the mean taken over the rest (training); the exchange between ranks
left out (data-parallel training, 2 gloo ranks, over the four-card mix
``traffic/train-fused-f32-dp4.json`` and its limits, which no cell of
``BENCHMARK.json`` names at present). The cells' own limits
hold: the CPU runs their sound program in float32 (training) and bf16
(prediction), within them."""

import contextlib
import json
import os

import pytest

from mvsbench import harness, run
from mvsbench.tests.tiny import tiny_cell

SEED = 2147483693
DP4 = {"name": "adamvs-train-f32-dp4", "config": "adamvs", "traffic": "train-fused-f32-dp4",
       "chips": 4, "why": "the one-card training mix data-parallel over 4 ranks"}


def alter_answer():
    """The engine's answer altered where produced: depth moved by one depth
    interval, confidence scaled by 0.9."""
    from adamvs_tpu_torch.predict import engine

    forward = engine.PredictEngine._forward

    def altered(self, *a, **kw):
        depth, conf = forward(self, *a, **kw)
        return depth + (500.0 - 300.0) / self.num_depth, 0.9 * conf

    engine.PredictEngine._forward = altered


def state_unchanged():
    """The optimizer's update skipped: every step returns the state as it was."""
    from adamvs_tpu_torch.train import loop

    def skipped(state, loss):
        state.step += 1
        return True

    loop.apply_updates_if_finite = skipped


def half_batch():
    """Half of each batch left out, the loss's means taken over the rest."""
    from adamvs_tpu_torch.train import loop

    to_device = loop.to_device

    def first_half(batch, device):
        if isinstance(batch, dict):
            return {k: first_half(v, device) for k, v in batch.items()}
        return to_device(batch[: max(1, len(batch) // 2)], device)

    loop.to_device = first_half


def no_exchange():
    """No statistic, loss mean or gradient exchanged between the ranks."""
    from adamvs_tpu_torch.train import loop

    loop.data_parallel = lambda group: contextlib.nullcontext()
    loop.average_gradients = lambda model, group: None


def _run(name, capsys, plant=None, ranks=None, spec=None):
    cell = tiny_cell(name, spec=spec)
    if ranks is not None:
        cell.traffic["ranks"] = ranks
    rc = run.main(["--workload", name, "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                  cell=cell, device="cpu", plant=plant)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == 0
    return json.loads(out)


@pytest.mark.parametrize("plant", [None, alter_answer])
def test_predict(plant, capsys, monkeypatch):
    from adamvs_tpu_torch.predict import engine

    monkeypatch.setattr(engine.PredictEngine, "_forward", engine.PredictEngine._forward)
    res = _run("adamvs-predict-bf16", capsys, plant)
    assert res["correct"] is (plant is None)
    assert list(res)[-1] == "checks" and res["attempted"] > 0


@pytest.mark.parametrize("plant", [None, state_unchanged, half_batch])
def test_train(plant, capsys, monkeypatch):
    from adamvs_tpu_torch.train import loop

    monkeypatch.setattr(loop, "apply_updates_if_finite", loop.apply_updates_if_finite)
    monkeypatch.setattr(loop, "to_device", loop.to_device)
    res = _run("adamvs-train-f32-b4", capsys, plant)
    assert res["correct"] is (plant is None)


@pytest.mark.parametrize("plant", [None, no_exchange])
def test_data_parallel(plant, capsys):
    spec = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    spec["workloads"].append(DP4)
    res = _run("adamvs-train-f32-dp4", capsys, plant, ranks=2, spec=spec)
    assert res["correct"] is (plant is None)
    assert res["device"]["count"] == 2
