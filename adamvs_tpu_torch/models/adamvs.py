"""Ada-MVS (counterpart of adamvs_tpu/models/adamvs.py).

Inference computes what the JAX model's inference branches compute
(adamvs.py:548-816), in three forms chosen by ``sweep_impl`` and
``reg_impl``, with one set of parameters:

- ``sweep_impl="fused"``, ``reg_impl="pallas"`` (the bench's form): stage 1
  builds one correlation volume per source view (K1); every stage builds the
  visibility-weighted fused volume (K2), runs the AdaRedCell recurrence over
  it (K3) and regresses depth and confidence by a full softmax over the cost;
- ``sweep_impl="fused"``, ``reg_impl="scan"`` (JAX ``_AdaRegIdxStreamCell``):
  K1 and K2 as above, then the cell stepped over the volume's depth slices
  (``red_scan_ref``'s stepping) into an online softmax;
- ``sweep_impl="fused"``, ``reg_impl="precomp"`` (JAX ``ada_precomp_depth``):
  K1 and K2 as above, then the recurrence restructured over chunks of depths
  (``ada_precomp_depth``) into an online softmax;
- ``sweep_impl="scan"``, ``reg_impl="scan"`` (the JAX CLI's default,
  ``correlation_volume`` and ``_AdaFuseStreamCell``): stage 1's correlation
  in depth blocks and every stage's per-hypothesis visibility-weighted mean
  sample the sources through K6/K7 (``ops/warp_sample.py``); each hypothesis
  takes one cell step and one online-softmax update, and no [D,...] volume
  is held.

In every form the feature net runs on all B·V views (or the caller hands in
``features``); stage 1's ``CostRegNet2D`` and softmax give the per-view
confidence (max probability) and depth (soft argmax); stages 2 and 3 take
those confidences, bilinearly resized, as visibility weights, and a
per-pixel window around the previous depth. Stages 1 and 2 emit their cost
at 2x resolution (``up``), so the depth of stage k lands at the resolution
of stage k+1. The JAX ``warp_impl`` choices all compute the exact bilinear
sample, which K6/K7 computes; they differ only outside their band.

Training (``train=True``) runs under autograd with BatchNorm in train mode
(the caller's ``model.train()``), stage 1's ``CostRegNet2D`` once per source
view (each view's batch statistics, as JAX calls it), in two forms:

- ``sweep_impl="fused"`` (the JAX ``use_fused_t`` branch): the volumes
  through the differentiable ``corr_sweep_volume_t`` and
  ``fused_sweep_volume_t`` (K1/K2 forward, K5 backward), and each stage's
  ``AdaRedCell`` stepped over D in PyTorch, not K3, which has no backward;
- ``sweep_impl="scan"`` (the JAX CLI's default, ``correlation_volume`` and
  ``_AdaFuseStreamCell`` under ``nn.scan``): the scan form above, with
  every sampler call differentiable (K6/K7 forward, K6/K7-bwd backward,
  ``ops/warp_sample.py``). JAX recomputes each cell step in the backward
  (``nn.remat``); here autograd keeps the steps' activations.

The gradient reaches the previous stage's depth through the regression's
hypotheses and the visibility weights through the fused volume or the
weighted mean; only the sample positions carry none.

The compute dtype ``compute_dtype`` is flax's ``dtype``, one rule whatever
the parameters' dtype: with float32 parameters and ``compute_dtype=torch.bfloat16`` the
model trains as the JAX model with ``dtype=bf16`` does (every layer in bf16
from float32 parameters, float32 gradients; ``nn/blocks.py``), while the
softmaxes, depths, confidences and the scan forms' sums stay float32.
``sample_dtype`` (JAX ``warp_impl="pallas2bf16"`` on a float32 model): the
scan forms round the source features to it once per stage and sample them
into float32 (K6/K7's bf16-in, float32-out form).

Module names follow the reference PyTorch model (``feature``,
``DepthNet.{i}.reg``, ``DepthNet.{i}.reg_fuse``), so a reference state_dict
loads with ``load_state_dict``. Only stage 1 has a ``reg``: the reference's
stage-2/3 ``CostRegNet2D`` weights are never used and are not instantiated.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.costreg import AdaRedCell, CostRegNet2D
from ..nn.featurenet import AdaFeatureNet
from ..ops.red_scan import red_scan, red_scan_ref
from ..ops.regression import (
    online_softmax_finalize,
    online_softmax_init,
    online_softmax_update,
    resize_bilinear,
    softmax_regression,
)
from ..ops.sampling import uniform_depth_samples, window_min_and_interval
from ..ops.sweep_fuse import (
    corr_sweep_volume,
    corr_sweep_volume_t,
    fused_sweep_volume,
    fused_sweep_volume_t,
)
from ..ops.warp import _source_coords, warp_transform
from ..ops.warp_sample import plane_sweep_warp_sampled, sample_bilinear

# cost up-sampling by stage: stages 1 and 2 emit at 2x, stage 3 does not
_UP_BY_STAGE = (True, True, False)
SWEEP_IMPLS = ("fused", "scan")
REG_IMPLS = ("pallas", "scan", "precomp")
# depths per chunk of ada_precomp_depth (the JAX default)
PRECOMP_CHUNK = 8
# hypotheses per sampler launch of the scan form's stage-1 correlation (the JAX
# model's default warp_block)
CORR_BLOCK = 16


def parse_depth_values(depth_values: torch.Tensor, num_depth: int | None):
    """(dmin [B], dmax [B], interval [B]) from the training form [B,3] =
    [min,max,interval], or from the prediction form [B,2] = [min,max] with
    interval = (max-min)/num_depth."""
    if depth_values.ndim != 2 or depth_values.shape[-1] not in (2, 3):
        raise ValueError(f"depth_values must be [B,2] or [B,3], got {tuple(depth_values.shape)}")
    dmin, dmax = depth_values[:, 0], depth_values[:, 1]
    if depth_values.shape[-1] == 3:
        return dmin, dmax, depth_values[:, 2]
    if num_depth is None:
        raise ValueError("depth_values [B,2] needs num_depth")
    return dmin, dmax, (dmax - dmin) / num_depth


def stage_features(features: dict, chans: tuple) -> tuple[dict, int, int]:
    """A caller's feature pyramid {"stageK": [B,V,C,h,w] or [B,V,h,w,C]} as
    {"stageK": [B·V,C,h,w]}, with B and V. The layout is channels-last when
    every stage's last axis holds that stage's channels ``chans[k]`` and its
    third does not: across stages the width doubles while the channels halve,
    so only a one-stage pyramid of square ``C x C`` maps can read both ways
    (it is then taken as [B,V,C,h,w])."""
    keys = [f"stage{i + 1}" for i in range(len(chans))]
    shapes = [features[k].shape for k in keys]
    for k, shape in zip(keys, shapes):
        if len(shape) != 5:
            raise ValueError(f"features[{k!r}] must be [B,V,C,h,w] or [B,V,h,w,C], got "
                             f"{tuple(shape)}")
    last = all(s[-1] == c for s, c in zip(shapes, chans))
    first = all(s[2] == c for s, c in zip(shapes, chans))
    if not (first or last):
        raise ValueError(f"features must hold {chans} channels by stage, got "
                         f"{[tuple(s) for s in shapes]}")
    B, V = shapes[0][:2]
    out = {}
    for k in keys:
        f = features[k]
        if last and not first:
            f = f.permute(0, 1, 4, 2, 3)
        out[k] = f.reshape((B * V,) + tuple(f.shape[2:]))
    return out, B, V


def correlation_volume(ref_feat: torch.Tensor, src_feat: torch.Tensor, src_proj: torch.Tensor,
                       ref_proj: torch.Tensor, hyp: torch.Tensor,
                       block: int = CORR_BLOCK) -> torch.Tensor:
    """Channel-mean correlation volume [B,h,w,D] of ``ref_feat`` [B,h,w,C]
    against ``src_feat`` [B,h,w,C] warped to the fronto-parallel planes
    ``hyp`` [B,D], built ``block`` hypotheses at a time (one K6/K7 launch
    each) so the [B,D,h,w,C] warp never exists at full D; float32. The
    samples come in the dtype of ``ref_feat`` (``src_feat`` may be held in
    another, ``AdaMVS.sample_dtype``)."""
    B, h, w, _ = ref_feat.shape
    D = hyp.shape[1]
    if D % block != 0:
        block = D
    ref = ref_feat.float()[:, None]
    out = [(ref * plane_sweep_warp_sampled(src_feat, src_proj, ref_proj, hyp[:, d0:d0 + block],
                                            grid_hw=(h, w), out_dtype=ref_feat.dtype).float()
            ).mean(dim=-1)
           for d0 in range(0, D, block)]  # [B,block,h,w] each
    return torch.cat(out, dim=1).permute(0, 2, 3, 1)


def fused_slice(ref: torch.Tensor, srcs: torch.Tensor, transforms: list, weights: torch.Tensor,
                hyp: torch.Tensor) -> torch.Tensor:
    """The scan form's visibility-weighted mean at one hypothesis map ``hyp``
    [B,h,w] (``_AdaFuseStreamCell``): ``sum_v ref * warped_v * w_v / (1e-5 +
    sum_v w_v)`` over the sources ``srcs`` [Vs,B,h,w,C], each warped through
    K6/K7 with its ``warp_transform`` (rot, trans) from ``transforms``;
    ``weights`` [B,Vs,h,w]. The samples come in the dtype of ``ref`` (``srcs``
    may be held in another, ``AdaMVS.sample_dtype``). Float32 [B,h,w,C]."""
    h, w = hyp.shape[1:]
    ref32 = ref.float()
    vsum = wsum = None
    for v, (rot, trans) in enumerate(transforms):
        u, vv = _source_coords(rot, trans, hyp.detach()[:, None], h, w)
        warped = sample_bilinear(srcs[v], u, vv, out_dtype=ref.dtype)[:, 0].float()
        w_v = weights[:, v, :, :, None].float()
        term = ref32 * warped * w_v
        vsum = term if vsum is None else vsum + term
        wsum = 1e-5 + w_v if wsum is None else wsum + w_v
    return vsum / wsum


def ada_precomp_depth(cell: AdaRedCell, fused: torch.Tensor, lo_acc: torch.Tensor,
                      step_acc: torch.Tensor, chunk: int = PRECOMP_CHUNK) -> tuple:
    """The ``AdaRedCell`` recurrence over K2's volume ``fused`` [D,B,C,h,w]
    into the online softmax over ``lo_acc + d·step_acc`` (the hypotheses at
    the cost's resolution), restructured as JAX ``ada_precomp_depth``
    (adamvs_tpu/models/adamvs.py:218-330): per chunk of K depths (``chunk`` if
    it divides D, else K = D) the entry conv and the x-halves of GRU1's gate
    and candidate convolutions (biases included) run once over the K·B
    slices; each depth step runs GRU1's h-side convolutions and cell math,
    the stride-2 conv and GRU2; then the up-deconv with the skip and the head
    run once over the chunk's K·B states before their costs fold into the
    softmax. GRU1's convolutions take concat(x, h), so their x-halves are the
    first ``b`` input channels of the weight. Inference only. Returns (depth,
    confidence), each float32 at the cost's resolution."""
    D, B, C, h, w = fused.shape
    K = chunk if D % chunk == 0 else D
    b = cell.base
    g1 = cell.conv_gru1
    dt = fused.dtype
    kg, kc = g1.conv_gates[0].weight.to(dt), g1.convc[0].weight.to(dt)
    bg, bc = g1.conv_gates[0].bias.to(dt), g1.convc[0].bias.to(dt)
    kgx, kgh = kg[:, :b], kg[:, b:].contiguous()
    kcx, kch = kc[:, :b], kc[:, b:].contiguous()
    h1, h2 = cell.init_state(B, h, w, dt, fused.device)
    acc = online_softmax_init(tuple(lo_acc.shape), device=fused.device)
    for d0 in range(0, D, K):
        c1 = cell.conv1(fused[d0:d0 + K].reshape(K * B, C, h, w))
        g1x = F.conv2d(c1, kgx, bg, padding=1)
        c1x = F.conv2d(c1, kcx, bc, padding=1)
        del c1
        r1s, r2s = [], []
        for k in range(K):
            gates = g1x[k * B:(k + 1) * B] + F.conv2d(h1, kgh, padding=1)
            r, u = torch.sigmoid(gates[:, :b]), torch.sigmoid(gates[:, b:])
            cand = torch.tanh(c1x[k * B:(k + 1) * B] + F.conv2d(r * h1, kch, padding=1))
            h1 = u * h1 + (1 - u) * cand
            h2 = cell.conv_gru2(h2, cell.conv2(h1))
            r1s.append(h1)
            r2s.append(h2)
        del g1x, c1x
        u1 = F.relu(cell.upconv1(torch.cat(r2s)) + torch.cat(r1s))
        cost = cell.upconv2d(u1)[:, 0].float()  # [K*B,oh,ow]
        del r1s, r2s, u1
        for k in range(K):
            acc = online_softmax_update(acc, cost[k * B:(k + 1) * B],
                                        lo_acc + float(d0 + k) * step_acc)
    return online_softmax_finalize(acc)


class _DepthNet(nn.Module):
    def __init__(self, cin: int, cr_base: int, up: bool, reg_depths: int | None):
        super().__init__()
        if reg_depths is not None:
            self.reg = CostRegNet2D(reg_depths)
        self.reg_fuse = AdaRedCell(cin, cr_base, up)


class AdaMVS(nn.Module):
    """Ada-MVS cascade, inference and training, computing in ``compute_dtype``
    (``build_model(dtype=torch.bfloat16)`` casts the parameters too, for
    inference); ``sample_dtype`` rounds the scan forms' sources before
    sampling (module docstring). ``sweep_impl`` and ``reg_impl`` choose the
    inference form; the pairs ("scan", "pallas") and ("scan", "precomp") do
    not exist, as in the JAX model."""

    def __init__(self, ndepths=(48, 32, 8), depth_intervals_ratio=(4.0, 2.0, 1.0),
                 base: int = 8, cr_base=(8, 8, 8), sweep_impl: str = "fused",
                 reg_impl: str = "pallas", compute_dtype: torch.dtype = torch.float32,
                 sample_dtype: torch.dtype | None = None):
        super().__init__()
        if sweep_impl not in SWEEP_IMPLS:
            raise ValueError(f"sweep_impl must be one of {SWEEP_IMPLS}, got {sweep_impl!r}")
        if reg_impl not in REG_IMPLS:
            raise ValueError(f"reg_impl must be one of {REG_IMPLS}, got {reg_impl!r}")
        if reg_impl != "scan" and sweep_impl != "fused":
            raise ValueError(f"reg_impl={reg_impl!r} runs over the fused sweep's volume and "
                             f"needs sweep_impl='fused' (got {sweep_impl!r})")
        self.compute_dtype = compute_dtype
        self.sample_dtype = sample_dtype
        self.ndepths = tuple(ndepths)
        self.depth_intervals_ratio = tuple(depth_intervals_ratio)
        self.sweep_impl = sweep_impl
        self.reg_impl = reg_impl
        n = len(self.ndepths)
        self.feature = AdaFeatureNet(base, num_stages=n)
        self.chans = (4 * base, 2 * base, base)[:n]
        self.DepthNet = nn.ModuleList(
            _DepthNet(self.chans[i], cr_base[i], _UP_BY_STAGE[i],
                      self.ndepths[0] if i == 0 else None)
            for i in range(n)
        )

    def feature_module(self) -> nn.Module:
        """The feature net, NCHW in and {"stageK": [N,C,h,w]} out: the pyramid
        that ``forward(features=...)`` takes, computed apart (the prediction
        engine's feature cache)."""
        return self.feature

    def forward(self, imgs, proj_matrices, depth_values, num_depth: int | None = None,
                train: bool = False, features: dict | None = None) -> dict:
        """``imgs`` [B,V,H,W,3], ``proj_matrices`` {"stageK": [B,V,4,4]},
        ``depth_values`` [B,3] = [min,max,interval] or [B,2] = [min,max]
        split into ``num_depth`` intervals. ``features`` (optional)
        {"stageK": [B,V,C,h,w] or [B,V,h,w,C]} replaces the feature net
        (``imgs`` may then be None). Returns the JAX model's outputs
        dict: per stage ``depth`` and ``photometric_confidence`` [B,h,w],
        ``pair_result`` (per source view [B,h1,w1], stage 1 only) and
        ``pair_confidence`` [B,h1,w1,V-1]; the last stage's entries also at
        the top level. ``train=True`` runs the training form under autograd
        and needs the module in train mode; otherwise the inference form runs
        without gradients."""
        if not train:
            with torch.no_grad():
                return self._cascade(imgs, proj_matrices, depth_values, num_depth, False,
                                     features)
        if not self.training:
            raise ValueError("train=True needs the module in train mode (model.train())")
        return self._cascade(imgs, proj_matrices, depth_values, num_depth, True, features)

    def _cascade(self, imgs, proj_matrices, depth_values, num_depth, train: bool,
                 features) -> dict:
        dtype = self.compute_dtype
        dmin, dmax, interval = parse_depth_values(depth_values.float(), num_depth)
        if features is None:
            B, V = imgs.shape[:2]
            feats = self.feature(
                imgs.reshape((B * V,) + imgs.shape[2:]).permute(0, 3, 1, 2).to(dtype))
        else:
            feats, B, V = stage_features(features, self.chans)
        Vs = V - 1
        scan = self.sweep_impl == "scan"
        corr_fn = corr_sweep_volume_t if train else corr_sweep_volume
        fused_fn = fused_sweep_volume_t if train else fused_sweep_volume

        outputs: dict = {}
        prev_depth = pair_conf = None
        for si, D in enumerate(self.ndepths):
            key = f"stage{si + 1}"
            net = self.DepthNet[si]
            f = feats[key].to(dtype)
            C, h, w = f.shape[1:]
            f = f.reshape(B, V, C, h, w).permute(0, 1, 3, 4, 2)  # [B,V,h,w,C]
            ref = f[:, 0].contiguous()
            srcs = f[:, 1:].transpose(0, 1).contiguous()  # [Vs,B,h,w,C]
            # the scan form's sources, rounded once per stage (JAX prepare_warp_sources)
            srcs_w = srcs.to(self.sample_dtype) if scan and self.sample_dtype else srcs
            projs = proj_matrices[key].float()
            ref_proj, src_projs = projs[:, 0], projs[:, 1:].transpose(0, 1)

            pair_results: tuple = ()
            if si == 0:
                lo = dmin[:, None, None].expand(B, h, w).contiguous()
                step = ((dmax - dmin) / (D - 1))[:, None, None].expand(B, h, w).contiguous()
                hyp0 = uniform_depth_samples(torch.stack([dmin, dmax], dim=1), D)  # [B,D]
                if scan:
                    corr = torch.stack([
                        correlation_volume(ref, srcs_w[v], src_projs[v], ref_proj, hyp0,
                                           CORR_BLOCK).permute(0, 3, 1, 2)
                        for v in range(Vs)]).to(dtype)
                else:
                    corr = corr_fn(ref, srcs, src_projs, ref_proj, lo, step, D).to(dtype)
                if train:  # per view, so BatchNorm takes each view's batch statistics
                    logits = torch.cat([net.reg(corr[v]) for v in range(Vs)])
                else:
                    logits = net.reg(corr.reshape(Vs * B, D, h, w))
                # in the compute dtype, as JAX's softmax of the bf16 logits; the
                # confidences stay in it (the visibility weights), the depth is float32
                prob = torch.softmax(logits, dim=1)  # rows v*B + b
                conf = prob.amax(dim=1).reshape(Vs, B, h, w)
                pdepth = (prob.float() * hyp0.repeat(Vs, 1)[:, :, None, None]).sum(dim=1)
                pair_conf = conf.transpose(0, 1).contiguous()  # [B,Vs,h,w]
                pair_results = tuple(pdepth.reshape(Vs, B, h, w))
                weights = pair_conf
            else:
                weights = F.interpolate(pair_conf, size=(h, w), mode="bilinear",
                                        align_corners=False)
                ratio = self.depth_intervals_ratio[si]
                lo, step = window_min_and_interval(prev_depth, D, (ratio * interval)[:, None, None])

            cell = net.reg_fuse
            if scan:
                depth, conf = self._scan_stage(cell, ref, srcs_w, src_projs, ref_proj, weights,
                                               lo, step, D)
            else:
                fused = fused_fn(ref, srcs, weights, src_projs, ref_proj, lo, step, D)
                if train or self.reg_impl == "pallas":
                    # K3 has no backward: training steps the cell under autograd
                    cost = (red_scan_ref if train else red_scan)(cell, fused)
                    oh, ow = cost.shape[2:]  # [D,B,oh,ow]
                    depth, conf = softmax_regression(
                        cost, resize_bilinear(lo, oh, ow), resize_bilinear(step, oh, ow))
                elif self.reg_impl == "precomp":
                    oh, ow = (2 * h, 2 * w) if cell.up else (h, w)
                    depth, conf = ada_precomp_depth(cell, fused, resize_bilinear(lo, oh, ow),
                                                    resize_bilinear(step, oh, ow))
                else:
                    depth, conf = self._stepped_stage(cell, fused, lo, step)
            outputs[key] = {
                "depth": depth,
                "photometric_confidence": conf,
                "pair_result": pair_results,
                "pair_confidence": pair_conf.permute(0, 2, 3, 1),
            }
            prev_depth = depth

        outputs.update(outputs[f"stage{len(self.ndepths)}"])
        return outputs

    @staticmethod
    def _stepped_stage(cell: AdaRedCell, fused: torch.Tensor, lo, step):
        """``reg_impl="scan"`` over K2's volume [D,B,C,h,w]: the cell stepped
        per depth slice into an online softmax over ``lo + d·step`` resized
        to the cost's resolution (JAX ``_AdaRegIdxStreamCell``)."""
        D, B, _, h, w = fused.shape
        oh, ow = (2 * h, 2 * w) if cell.up else (h, w)
        lo_acc, step_acc = resize_bilinear(lo, oh, ow), resize_bilinear(step, oh, ow)
        state = cell.init_state(B, h, w, fused.dtype, fused.device)
        acc = online_softmax_init((B, oh, ow), device=fused.device)
        for d in range(D):
            state, cost = cell(state, fused[d])
            acc = online_softmax_update(acc, cost[:, 0].float(), lo_acc + float(d) * step_acc)
        return online_softmax_finalize(acc)

    @staticmethod
    def _scan_stage(cell: AdaRedCell, ref, srcs, src_projs, ref_proj, weights, lo, step, D: int):
        """``sweep_impl="scan"``: per hypothesis ``lo + d·step``, the sources
        sampled through K6/K7 into the visibility-weighted mean
        (``fused_slice``), one cell step in the model's dtype and one
        online-softmax update at the cost's resolution (JAX
        ``_AdaFuseStreamCell``)."""
        B, h, w, _ = ref.shape
        oh, ow = (2 * h, 2 * w) if cell.up else (h, w)
        transforms = [warp_transform(src_projs[v], ref_proj) for v in range(srcs.shape[0])]
        dtype = ref.dtype
        state = cell.init_state(B, h, w, dtype, ref.device)
        acc = online_softmax_init((B, oh, ow), device=ref.device)
        for d in range(D):
            hyp = lo + float(d) * step
            x = fused_slice(ref, srcs, transforms, weights, hyp)
            state, cost = cell(state, x.to(dtype).permute(0, 3, 1, 2).contiguous())
            acc = online_softmax_update(acc, cost[:, 0].float(), resize_bilinear(hyp, oh, ow))
        return online_softmax_finalize(acc)
