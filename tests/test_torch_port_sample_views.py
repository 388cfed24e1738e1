"""The scan forms' sampler calls with every source view of a hypothesis slice
in one call (the views in the batch axis), on the CPU:

- the stacked call against per-view calls of ``sample_bilinear_ref``: the
  forward exactly, the gradient of the source stack within 1e-6 relative L2
  (float32 sums in another order), float32 and bf16, ragged C, B = 2, Vs = 4,
  one and 16 hypotheses;
- ``view_transforms`` against per-view ``warp_transform`` calls, and
  ``fused_slice``, ``variance_slice`` and ``correlation_volumes`` against the
  per-view forms they replace, written out here: exactly (``torch.equal``);
- the sampler calls of one tiny scan-form forward and backward of each
  family: one per hypothesis slice plus one per stage-1 block, and one
  gradient per call."""

import numpy as np
import pytest
import torch

from adamvs_tpu_torch.models import AdaMVS, MSREDNet
from adamvs_tpu_torch.models.adamvs import CORR_BLOCK, correlation_volumes, fused_slice
from adamvs_tpu_torch.models.msrednet import variance_slice
from adamvs_tpu_torch.ops import warp_sample
from adamvs_tpu_torch.ops.warp import _source_coords, view_transforms, warp_transform
from adamvs_tpu_torch.ops.warp_sample import (
    plane_sweep_warp_sampled,
    sample_bilinear,
    sample_bilinear_bwd,
    sample_bilinear_bwd_ref,
    sample_bilinear_ref,
)
from tests.test_torch_port_model import DMAX, DMIN, _projs

torch.set_num_threads(2)

B, VS, H, W = 2, 4, 12, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _geometry(seed: int, h: int = H, w: int = W):
    """Projections [Vs,B,4,4] and [B,4,4] of a real camera rig at stage 3 of
    an h x w frame, per-pixel hypotheses [B,h,w], some behind the camera."""
    rng = np.random.RandomState(seed)
    projs = _projs(B, VS + 1, h, w)["stage3"]
    projs[:, 1:, :3, :3] += 0.01 * rng.randn(B, VS, 3, 3).astype(np.float32)
    hyp = rng.uniform(0.5 * DMIN, DMAX, (B, h, w)).astype(np.float32)
    hyp[:, 0, :3] = -5.0  # behind the camera
    return _t(projs[:, 1:]).transpose(0, 1).contiguous(), _t(projs[:, 0]), _t(hyp)


def _err(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 16])
def test_stacked_sampler_call_equals_per_view_calls(dtype, N):
    rng = np.random.RandomState(N)
    C = 12
    srcs = _t(rng.randn(VS, B, H, W, C).astype(np.float32)).to(dtype)
    u = _t(rng.uniform(-2.0, W + 1.0, (VS, B, N, H, W)).astype(np.float32))
    v = _t(rng.uniform(-2.0, H + 1.0, (VS, B, N, H, W)).astype(np.float32))
    u[:, :, :, 0] = -1e9  # behind the camera
    dout = _t(rng.randn(VS, B, N, H, W, C).astype(np.float32)).to(dtype)
    want = torch.stack([sample_bilinear_ref(srcs[i], u[i], v[i]) for i in range(VS)])
    stack = srcs.clone().requires_grad_()
    got = sample_bilinear(stack.flatten(0, 1), u.flatten(0, 1), v.flatten(0, 1))
    assert got.dtype == dtype and torch.equal(got.unflatten(0, (VS, B)), want)
    # the gradient of the stack: autograd of the stacked call, and the wrapper
    got.backward(dout.flatten(0, 1))
    grad = torch.stack([sample_bilinear_bwd_ref(dout[i], u[i], v[i], H, W) for i in range(VS)])
    assert stack.grad.dtype == dtype and _err(stack.grad, grad) <= 1e-6
    direct = sample_bilinear_bwd(dout.flatten(0, 1), u.flatten(0, 1), v.flatten(0, 1), H, W)
    assert direct.dtype == dtype and _err(direct.unflatten(0, (VS, B)), grad) <= 1e-6


def test_view_transforms_equal_per_view_calls():
    src_projs, ref_proj, _ = _geometry(0)
    rot, trans = view_transforms(src_projs, ref_proj)
    assert rot.shape == (VS * B, 3, 3) and trans.shape == (VS * B, 3)
    for i in range(VS):
        r, t = warp_transform(src_projs[i], ref_proj)
        assert torch.equal(rot[i * B:(i + 1) * B], r) and torch.equal(trans[i * B:(i + 1) * B], t)


def _per_view_fused_slice(ref, srcs, src_projs, ref_proj, weights, hyp):
    """The per-view form ``fused_slice`` replaces: one sampler call per
    source view."""
    h, w = hyp.shape[2:]
    ref32 = ref.float()[:, None]
    vsum = wsum = None
    for v in range(srcs.shape[0]):
        u, vv = _source_coords(*warp_transform(src_projs[v], ref_proj), hyp, h, w)
        warped = sample_bilinear(srcs[v], u, vv, out_dtype=ref.dtype).float()
        w_v = weights[:, v, None, :, :, None].float()
        term = ref32 * warped * w_v
        vsum = term if vsum is None else vsum + term
        wsum = 1e-5 + w_v if wsum is None else wsum + w_v
    return vsum / wsum


def _per_view_variance_slice(ref, srcs, src_projs, ref_proj, hyp):
    """The per-view form ``variance_slice`` replaces."""
    nv = srcs.shape[0] + 1
    s = ref.float()
    sq = s * s
    for v in range(srcs.shape[0]):
        warped = plane_sweep_warp_sampled(srcs[v], src_projs[v], ref_proj, hyp[:, None],
                                          out_dtype=ref.dtype)[:, 0].float()
        s = s + warped
        sq = sq + warped * warped
    m = s / nv
    return (sq / nv - m * m).to(ref.dtype).permute(0, 3, 1, 2).contiguous()


def _per_view_correlation(ref, srcs, src_projs, ref_proj, hyp, block):
    """The per-view form ``correlation_volumes`` replaces, [Vs,B,D,h,w]."""
    h, w = ref.shape[1:3]
    vols = []
    for v in range(srcs.shape[0]):
        out = [(ref.float()[:, None] * plane_sweep_warp_sampled(
            srcs[v], src_projs[v], ref_proj, hyp[:, d0:d0 + block], grid_hw=(h, w),
            out_dtype=ref.dtype).float()).mean(dim=-1) for d0 in range(0, hyp.shape[1], block)]
        vols.append(torch.cat(out, dim=1))
    return torch.stack(vols)


@pytest.mark.parametrize("dtype,sample_dtype", [(torch.float32, None),
                                                (torch.float32, torch.bfloat16),
                                                (torch.bfloat16, None)])
def test_slices_equal_their_per_view_forms(dtype, sample_dtype):
    rng = np.random.RandomState(3)
    src_projs, ref_proj, hyp = _geometry(1)
    C = 12
    ref = _t(rng.randn(B, H, W, C).astype(np.float32)).to(dtype)
    srcs = _t(rng.randn(VS, B, H, W, C).astype(np.float32)).to(sample_dtype or dtype)
    weights = _t(rng.rand(B, VS, H, W).astype(np.float32)).to(dtype)
    transforms = view_transforms(src_projs, ref_proj)
    hyps = torch.stack([hyp, hyp + 7.0, hyp * 1.1], dim=1)  # [B,3,h,w]
    assert torch.equal(fused_slice(ref, srcs, transforms, weights, hyps),
                       _per_view_fused_slice(ref, srcs, src_projs, ref_proj, weights, hyps))
    assert torch.equal(variance_slice(ref, srcs, transforms, hyp),
                       _per_view_variance_slice(ref, srcs, src_projs, ref_proj, hyp))
    planes = torch.linspace(DMIN, DMAX, 2 * CORR_BLOCK)[None].repeat(B, 1)  # [B,D]
    for block in (CORR_BLOCK, 2 * CORR_BLOCK):
        got = correlation_volumes(ref, srcs, transforms, planes, block)
        assert got.shape == (VS, B, 2 * CORR_BLOCK, H, W)
        assert torch.equal(got, _per_view_correlation(ref, srcs, src_projs, ref_proj, planes,
                                                      block))


def _counting(monkeypatch):
    """Count the sampler calls of ``ops/warp_sample.py::sample_views`` and
    the gradients they receive."""
    counts = {"calls": 0, "grads": 0, "views": set()}

    def wrapped(feat, u, v, out_dtype=None):
        out = sample_bilinear(feat, u, v, out_dtype=out_dtype)
        counts["calls"] += 1
        counts["views"].add(feat.shape[0])
        if out.requires_grad:
            out.register_hook(lambda g: counts.__setitem__("grads", counts["grads"] + 1))
        return out

    monkeypatch.setattr(warp_sample, "sample_bilinear", wrapped)
    return counts


@pytest.mark.parametrize("name", ["adamvs", "msrednet"])
def test_scan_forms_sample_every_view_per_call(monkeypatch, name):
    """One tiny scan-form train forward and backward: one sampler call per
    hypothesis slice (and per stage-1 block of AdaMVS), each sampling all
    Vs·B views and receiving one gradient."""
    ndepths, Bt, V, Ht, Wt = (2 * CORR_BLOCK, 4), 1, VS + 1, 64, 64
    cfg = dict(ndepths=ndepths, depth_intervals_ratio=(4.0, 2.0), base=4, cr_base=(4, 4))
    torch.manual_seed(0)
    if name == "adamvs":
        model = AdaMVS(**cfg, sweep_impl="scan", reg_impl="scan")
        want = sum(ndepths) + ndepths[0] // CORR_BLOCK
    else:
        model = MSREDNet(**cfg, sweep_impl="scan")
        want = sum(ndepths)
    counts = _counting(monkeypatch)
    rng = np.random.RandomState(5)
    imgs = _t(rng.randn(Bt, V, Ht, Wt, 3).astype(np.float32))
    projs = {k: _t(p) for k, p in _projs(Bt, V, Ht, Wt).items() if k != "stage3"}
    dv = _t(np.array([[DMIN, DMAX]], np.float32))
    out = model.train()(imgs, projs, dv, num_depth=64, train=True)
    assert counts["calls"] == want and counts["views"] == {VS * Bt}
    out["depth"].sum().backward()
    assert counts["grads"] == want
