"""The yardstick's frozen work formulas: pinned at each cell's shapes, and the
model FLOPs' convolution count checked against the multiply-adds that the
plain reference's convolutions perform, counted as they run at a small
shape."""

import numpy as np
import pytest
import torch

from mvsbench import harness, work
from mvsbench.reference import models as ref_models
from mvsbench.tests.tiny import tiny_cell

FULL = (2752, 1856)
CROP = (384, 768)
# (model FLOPs of a full-frame map, of a training crop's forward)
PINNED = {"adamvs": (2330143322112.0, 134539149312.0),
          "msrednet": (3851945250816.0, 222405820416.0)}
# per stage of a full-frame map, bf16: K2 (bytes, operations), K3 (bytes, operations)
STAGES = [(688, 464, 32, 48), (1376, 928, 16, 32), (2752, 1856, 8, 8)]
K2 = [(1090496512, 17575636992), (1542529024, 25313820672), (1184989184, 14710210560)]
K3 = [(1103265792, 302294827008.0), (1634467840, 711974191104.0),
      (735510528, 664901517312.0)]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_model_flops_pinned(name):
    cfg = harness.load_json(f"{harness.BENCH}/configs/{name}.json")
    assert work.model_forward_flops(cfg, *FULL) == PINNED[name][0]
    assert work.model_forward_flops(cfg, *CROP) == PINNED[name][1]
    assert work.model_forward_flops(cfg, *CROP, batch=4) == 4 * PINNED[name][1]


@pytest.mark.parametrize("si", range(3))
def test_kernel_work_pinned(si):
    h, w, c, d = STAGES[si]
    assert work.k2_work(4, h, w, c, d, 2) == K2[si]
    assert work.k3_work(8, c, h, w, d, si < 2, 2) == K3[si]


def test_k2_k3_bounds_at_the_map():
    """A full-frame bf16 map's least K2 and K3 time: 1.14 ms of bytes and
    1.72 ms of bf16 tensor-core operations."""
    k2 = sum(work.bound_s(*k, work.F32_FLOPS) for k in K2)
    k3 = sum(work.bound_s(*k, work.PEAK_FLOPS["bf16"]) for k in K3)
    assert k2 == pytest.approx(1.1397e-3, rel=1e-3)
    assert k3 == pytest.approx(1.7215e-3, rel=1e-3)


@pytest.mark.parametrize("config", ["adamvs", "msrednet"])
def test_conv_count_matches_reference(config, monkeypatch):
    cell = tiny_cell("adamvs-predict-bf16", config=config)
    cfg = cell.config
    counted = [0]
    conv, deconv = ref_models.conv, ref_models.deconv

    def counting_conv(m, x, nx):
        y = conv(m, x, nx)
        counted[0] += y.numel() * m.in_channels * m.kernel_size[0] * m.kernel_size[1]
        return y

    def counting_deconv(m, x, nx):
        counted[0] += x.numel() * m.out_channels * m.kernel_size[0] * m.kernel_size[1]
        return deconv(m, x, nx)

    monkeypatch.setattr(ref_models, "conv", counting_conv)
    monkeypatch.setattr(ref_models, "deconv", counting_deconv)
    h, w = 64, 96
    model = ref_models.MODELS[cfg["model"]](cfg["ndepths"], cfg["depth_inter_r"], cfg["base"],
                                            cfg["cr_base_chs"]).eval()
    V = cfg["views"]
    projs = np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1))
    projs[..., 0, 0] = projs[..., 1, 1] = 80.0
    projs[0, :, 0, 3] = 10.0 * np.arange(V)
    with torch.no_grad():
        model(torch.randn(1, V, h, w, 3),
              {f"stage{k}": torch.from_numpy(projs.copy()) for k in (1, 2, 3)},
              torch.tensor([[300.0, 500.0]]), num_depth=cfg["num_depth"])
    assert counted[0] == work.model_forward_work(cfg, h, w)[0]
