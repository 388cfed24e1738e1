"""On the card, at each one-card cell's own sizes, on three seeds: the
control (the reference one precision below the configuration's) and every
fault of the program that a training cell can have fail the cell's limits,
so the check can tell a lower-precision or broken program from a sound one.
``mvsbench/calibrate.py`` prints the same readings."""

import pytest
import torch

from mvsbench import calibrate, harness
from mvsbench.check import judge

SEEDS = (9001, 9002, 9003)
CELLS = [w["name"] for w in harness.load_json(f"{harness.ROOT}/BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail(name, card):
    cell = harness.resolve(name)
    fn = (calibrate.predict_readings if cell.traffic["kind"] == "predict"
          else calibrate.train_readings)
    for seed in SEEDS:
        readings = fn(cell, seed, card)
        for kind, numbers in readings.items():
            if kind == "witness":
                continue
            _, ok = judge(numbers, cell.limits)
            assert not ok, f"{name} seed {seed}: {kind} passes {numbers}"
        torch.cuda.empty_cache()
