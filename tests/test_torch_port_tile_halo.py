"""The row-band ops of ``adamvs_tpu_torch/parallel/halo.py`` on 2 and 4
gloo processes against the unbanded op in one process, float64.

Each rank takes its band of rows ``[t·H/n, (t+1)·H/n)`` of a seeded input,
runs the op under ``tile_rows`` and back-propagates its band of a seeded
cotangent; the bands of the output and of the input gradient must equal the
unbanded op's rows, and the ranks' weight gradients must sum to the unbanded
op's, within float64 rounding. The cases are every (kernel, stride,
padding) of a convolution and transposed convolution that the models run
(``nn/featurenet.py``, ``nn/costreg.py``, ``nn/blocks.py``), the bilinear
resizes by 2/4/8 up and 2/4 down, GroupNorm(1) over the tile group and the
gathered sources. One spawn of the ranks per rank count runs all cases."""

import os

import pytest
import torch

from adamvs_tpu_torch.nn.blocks import Conv2d, ConvTranspose2d, group_norm1
from adamvs_tpu_torch.parallel.dryrun import free_port
from adamvs_tpu_torch.parallel.halo import (conv_halo, conv_transpose_halo, exchange_rows,
                                            gather_rows, halo_conv2d, halo_conv_transpose2d,
                                            halo_resize_bilinear)
from adamvs_tpu_torch.ops.regression import resize_bilinear
from tests.test_torch_port_parallel_train import GLOO_TIMEOUT, REPO, run_workers

H, W = 32, 12

# name: (module, its arguments): the convs' k/s/p as the models use them, then the transposed ones
CONVS = {
    "conv3x3_s1": (Conv2d, dict(in_channels=3, out_channels=4, kernel_size=3, padding=1)),
    "conv3x3_s2": (Conv2d, dict(in_channels=3, out_channels=4, kernel_size=3, stride=2,
                                padding=1)),
    "conv5x5_s2": (Conv2d, dict(in_channels=3, out_channels=4, kernel_size=5, stride=2,
                                padding=2)),
    "conv1x1": (Conv2d, dict(in_channels=3, out_channels=4, kernel_size=1, bias=False)),
    "deconv3x3_s2": (ConvTranspose2d, dict(in_channels=3, out_channels=4, kernel_size=3,
                                           stride=2, padding=1, output_padding=1, bias=False)),
    "deconv3x3_s1": (ConvTranspose2d, dict(in_channels=3, out_channels=4, kernel_size=3,
                                           padding=1)),
}
RESIZES = {"resize_up2": 2, "resize_up4": 4, "resize_up8": 8, "resize_down2": 0.5,
           "resize_down4": 0.25}
CASES = sorted(CONVS) + sorted(RESIZES) + ["group_norm1", "gather_rows"]
RANKS = (2, 4)


def build(name: str):
    """(op on NCHW float64, its parameters, the input, the unbanded
    reference op) of case ``name``, seeded alike in every process."""
    gen = torch.Generator().manual_seed(CASES.index(name))
    x = torch.randn((2, 3, H, W), generator=gen, dtype=torch.float64)
    if name in CONVS:
        cls, kw = CONVS[name]
        torch.manual_seed(CASES.index(name))
        m = cls(**kw).double()
        return m, list(m.parameters()), x, m
    if name in RESIZES:
        f = RESIZES[name]

        def resize(t):
            return resize_bilinear(t, int(t.shape[2] * f), int(W * f))

        return resize, [], x, resize
    if name == "group_norm1":
        norm = torch.nn.GroupNorm(1, 3).double()
        with torch.no_grad():
            norm.weight.copy_(1 + torch.randn(3, generator=gen, dtype=torch.float64))
            norm.bias.copy_(torch.randn(3, generator=gen, dtype=torch.float64))
        # a mean far from 0 against the spread, where one pass of squares in float32
        # would cancel (a relative error of ~1e-4 in the variance)
        # held to float64 GroupNorm: group_norm1 computes in float32
        return (lambda t: group_norm1(t, norm)), list(norm.parameters()), x * 0.1 + 5.0, (
            lambda t: torch.nn.functional.group_norm(t, 1, norm.weight, norm.bias, norm.eps))

    def square(t):
        return gather_rows(t, dim=2) ** 2

    return square, [], x, square


def unbanded(name: str) -> dict:
    """The op on the whole frame in this process: output, input gradient
    and parameter gradients of sum(out * cotangent)."""
    _, params, x, op = build(name)
    x = x.clone().requires_grad_()
    y = op(x)
    cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(99), dtype=y.dtype)
    (y * cot).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dp": [p.grad for p in params]}


WORKER = """
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from adamvs_tpu_torch.parallel import initialize_distributed, make_mesh
from adamvs_tpu_torch.parallel.halo import tile_rows
from tests.test_torch_port_tile_halo import CASES, H, build

rank, n = int(sys.argv[1]), {ranks}
initialize_distributed({coord!r}, n, rank, backend="gloo", timeout_s={gloo})
mesh = make_mesh(data=1, tile=n)
out = {{}}
for name in CASES:
    op, params, x, _ = build(name)
    h = H // n
    xb = x[:, :, rank * h:(rank + 1) * h].clone().requires_grad_()
    with tile_rows(mesh.tile_group):
        y = op(xb)
    full = list(y.shape)
    if name != "gather_rows":  # a band of the output: the whole frame's rows are n times
        full[2] *= n
    cot = torch.randn(full, generator=torch.Generator().manual_seed(99), dtype=y.dtype)
    if name != "gather_rows":
        cot = cot[:, :, rank * y.shape[2]:(rank + 1) * y.shape[2]]
    else:  # every rank holds the whole frame: its share of the unbanded sum
        cot = cot / n
    (y * cot).sum().backward()
    out[name] = {{"y": y.detach(), "dx": xb.grad, "dp": [p.grad for p in params]}}
torch.save(out, {out!r} + f"/rank{{rank}}.pt")
print("RESULT{{}}")
"""


@pytest.fixture(scope="module")
def banded(tmp_path_factory):
    """Each rank count's per-rank results of every case."""
    got = {}
    for n in RANKS:
        root = tmp_path_factory.mktemp(f"halo{n}")
        script = WORKER.format(repo=REPO, ranks=n, coord=f"localhost:{free_port()}",
                               gloo=GLOO_TIMEOUT, out=str(root))
        run_workers(script, n, REPO)
        got[n] = [torch.load(os.path.join(root, f"rank{r}.pt")) for r in range(n)]
    return got


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", CASES)
def test_band_op_matches_unbanded(banded, name, n):
    """The bands' outputs and input gradients, concatenated along the rows,
    and the sum of the ranks' parameter gradients, as the unbanded op's
    within float64 rounding (the gathered frame is whole on every rank).
    GroupNorm computes in float32 whatever its input, as ``group_norm1``
    does: it is held to float64 ``F.group_norm`` within 1e-5 of each
    tensor's largest value."""
    want = unbanded(name)
    ranks = [r[name] for r in banded[n]]

    def close(got, exp):
        eps = 1e-5 if name == "group_norm1" else 1e-12
        torch.testing.assert_close(got, exp, rtol=eps, atol=eps * float(exp.abs().max()))

    if name == "gather_rows":
        for r in ranks:
            close(r["y"], want["y"])
    else:
        close(torch.cat([r["y"] for r in ranks], dim=2), want["y"])
    close(torch.cat([r["dx"] for r in ranks], dim=2), want["dx"])
    for i, dp in enumerate(want["dp"]):
        close(sum(r["dp"][i] for r in ranks), dp)


@pytest.mark.parametrize("kind,k,s,p,halo", [
    ("conv", 3, 1, 1, (1, 1)), ("conv", 3, 2, 1, (1, 0)), ("conv", 5, 2, 2, (2, 1)),
    ("conv", 1, 1, 0, (0, 0)), ("deconv", 3, 2, 1, (0, 1)), ("deconv", 3, 1, 1, (1, 1)),
])
def test_halo_rows_of_each_model_conv(kind, k, s, p, halo):
    """The rows above and below a band that each convolution of the models
    reads: 3x3 at stride 1 and 2, the trunk's 5x5 at stride 2, 1x1 none;
    the stride-2 transposed 3x3 (padding 1, output padding 1) 0 above and 1
    below, MS-REDNet's stride-1 transposed 3x3 1 and 1."""
    assert (conv_halo if kind == "conv" else conv_transpose_halo)(k, s, p) == halo


def test_band_ops_without_tile_rows_are_the_plain_ops():
    """Outside ``tile_rows`` the halo is the frame's own padding: the ops
    equal ``F.conv2d``, ``F.conv_transpose2d`` and ``F.interpolate``, and the
    gather returns its input."""
    x = torch.randn((2, 3, 16, 10), dtype=torch.float64)
    w = torch.randn((4, 3, 5, 5), dtype=torch.float64)
    torch.testing.assert_close(halo_conv2d(x, w, None, (2, 2), (2, 2)),
                               torch.nn.functional.conv2d(x, w, None, 2, 2))
    wt = torch.randn((3, 4, 3, 3), dtype=torch.float64)
    torch.testing.assert_close(halo_conv_transpose2d(x, wt, None, (2, 2), (1, 1), (1, 1)),
                               torch.nn.functional.conv_transpose2d(x, wt, None, 2, 1, 1))
    torch.testing.assert_close(halo_resize_bilinear(x, 64, 40), torch.nn.functional.interpolate(
        x, size=(64, 40), mode="bilinear", align_corners=False))
    assert gather_rows(x, 2) is x
    e = exchange_rows(x, 2, 1, edge=True)
    assert torch.equal(e[:, :, :2], x[:, :, :1].expand(-1, -1, 2, -1))
    assert torch.equal(e[:, :, -1], x[:, :, -1])
    with pytest.raises(ValueError, match="integer factors"):
        halo_resize_bilinear(x, 24, 10)
