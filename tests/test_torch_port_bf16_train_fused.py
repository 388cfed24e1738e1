"""bf16 mixed-precision training of the fused forms with the port against the
JAX package on the CPU: one train step of AdaMVS (K1/K2 forward, K5
backward) and of MS-REDNet (K4 forward, K5 backward), float32 parameters and
bf16 compute, against JAX ``value_and_grad`` of the JAX fused training form
(``sweep_impl="fused"``, its Pallas forwards in interpret mode) with
``dtype=bf16``: loss, per-stage depth, BatchNorm statistics and the gradient
per top-level module, calibrated against both frameworks' bf16 noise as in
``test_torch_port_bf16_train.py``, whose machinery this file shares. The
port's K5 plain backward sums the sources' gradient in float32 and rounds it
once, where JAX's gather transpose scatters into a bf16 buffer: the
tolerances take that in."""

import pytest

from tests.test_torch_port_bf16_train import (
    bf16_step_case,
    check_float32_master,
    check_gradient,
    check_loss_depth_statistics,
    two_threads,  # noqa: F401  (autouse)
)

FUSED = {"adamvs": {"sweep_impl": "fused", "reg_impl": "pallas"},
         "msrednet": {"sweep_impl": "fused"}}


@pytest.fixture(scope="module", params=sorted(FUSED))
def fused_case(request):
    return bf16_step_case(request.param, FUSED[request.param], fused=True)


def test_bf16_fused_step_loss_depth_and_statistics_match_jax(fused_case):
    check_loss_depth_statistics(fused_case)


def test_bf16_fused_step_gradient_matches_jax(fused_case):
    check_gradient(fused_case)


def test_bf16_fused_step_keeps_float32_master_weights(fused_case):
    check_float32_master(fused_case)
