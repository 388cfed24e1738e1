"""Scan-form training with the port against the JAX package at float32 on
the CPU.

- K6/K7-bwd's plain version (``sample_bilinear_bwd_ref``, and autograd of
  ``sample_bilinear`` on CPU tensors) against ``jax.grad`` of
  ``adamvs_tpu/ops/warp.py::bilinear_sample`` with respect to the features,
  at ragged shapes with samples outside the image and behind the camera;
- one scan-form train step of AdaMVS and of MS-REDNet (``sweep_impl="scan"``,
  every sample through ``sample_bilinear``) against JAX ``value_and_grad`` of
  the JAX scan form with ``warp_impl="gather"``: loss and per-stage depth, the
  whole gradient at 1e-4 relative L2 and the BatchNorm statistics, from
  weights whose ReLU decisions near float32 rounding are harmless
  (``relu_margin``, see tests/test_torch_port_train.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adamvs_tpu.ops.warp import bilinear_sample as jbilinear_sample
from adamvs_tpu_torch.ops.warp_sample import (
    sample_bilinear,
    sample_bilinear_bwd,
    sample_bilinear_bwd_ref,
)
from tests.test_torch_port_train import _train_step_case
from tests.test_torch_port_train import (
    test_train_step_batchnorm_statistics_match_jax as check_batchnorm_statistics,
)
from tests.test_torch_port_train import test_train_step_gradient_matches_jax as check_gradient
from tests.test_torch_port_train import (
    test_train_step_loss_and_depth_match_jax as check_loss_and_depth,
)

torch.set_num_threads(2)

SCAN = {"adamvs": {"sweep_impl": "scan", "reg_impl": "scan"}, "msrednet": {"sweep_impl": "scan"}}


@pytest.mark.parametrize("B,N,h,w,H,W,C", [(1, 1, 7, 9, 11, 13, 8), (2, 4, 5, 6, 9, 7, 3),
                                            (2, 16, 4, 5, 6, 8, 32)])
def test_plain_sampler_gradient_matches_jax(B, N, h, w, H, W, C):
    """Within 1e-6 relative L2 (float32 sums in another order)."""
    rng = np.random.RandomState(C)
    feat = rng.randn(B, H, W, C).astype(np.float32)
    u = rng.uniform(-2.0, W + 1.0, (B, N, h, w)).astype(np.float32)
    v = rng.uniform(-2.0, H + 1.0, (B, N, h, w)).astype(np.float32)
    u[:, :, 0] = -1e9  # behind the camera
    u[:, :, 1, :2] = np.floor(u[:, :, 1, :2])  # on the pixel grid
    dout = rng.randn(B, N, h, w, C).astype(np.float32)
    want = np.asarray(jax.grad(lambda f: jnp.sum(jbilinear_sample(f, u, v) * dout))(feat))
    tu, tv, tdout = (torch.from_numpy(a) for a in (u, v, dout))
    for got in (sample_bilinear_bwd_ref(tdout, tu, tv, H, W),
                sample_bilinear_bwd(tdout, tu, tv, H, W)):
        assert got.shape == (B, H, W, C) and got.dtype == torch.float32
        assert np.linalg.norm(got.numpy() - want) <= 1e-6 * np.linalg.norm(want)
    f = torch.from_numpy(feat).requires_grad_()
    (sample_bilinear(f, tu, tv) * tdout).sum().backward()
    assert np.linalg.norm(f.grad.numpy() - want) <= 1e-6 * np.linalg.norm(want)


def test_plain_sampler_gradient_keeps_the_cotangent_dtype():
    dout = torch.randn(1, 2, 3, 4, 8).to(torch.bfloat16)
    u = torch.rand(1, 2, 3, 4) * 4
    got = sample_bilinear_bwd_ref(dout, u, u, 5, 5)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 5, 5, 8)


@pytest.fixture(scope="module", params=sorted(SCAN))
def scan_step_case(request):
    return _train_step_case(request.param, SCAN[request.param])


def test_scan_train_step_loss_and_depth_match_jax(scan_step_case):
    check_loss_and_depth(scan_step_case)


def test_scan_train_step_gradient_matches_jax(scan_step_case):
    check_gradient(scan_step_case)


def test_scan_train_step_batchnorm_statistics_match_jax(scan_step_case):
    check_batchnorm_statistics(scan_step_case)
