#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (adamvs_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:

1. device: the card's name and power limit;
2. build: every kernel under adamvs_tpu_torch/csrc/, one nvcc per source,
   and the host library (csrc/host/*.cc, g++ with OpenMP and zlib);
   registers and spills of each sweep and K5 instance (no instance may
   spill); the atomics in the sweep_bwd library's
   SASS (information); the tensor-core instructions (HMMA, HGMMA) of K3's
   bf16 and float32 phase kernels in the red_scan library's SASS: the bf16
   kernels must have some and the float32 ones TF32 mma only (3xTF32),
   with the float32 kernels' registers and spills;
3. kernels: K1 (corr sweep), K2 (fused sweep), K3 (red-scan recurrence), K4
   (variance sweep) and K6/K7 (bilinear sampler, one hypothesis slice per
   source view) against their plain PyTorch versions at every stage shape
   of the inference paths (2752x1856 frames, V=5, ndepths 48/32/8, base 8),
   in float32 with TF32 off and in bfloat16, with their times (CUDA events,
   median) and, for K6/K7, F.grid_sample's; for K1 also the kernel's own
   time (a trace) and the dot products per sample its walk computed; for
   K6/K7 also its bf16-in, float32-out form (pallas2bf16 on a float32
   model), compared and timed per scan map; for K3
   its TFLOP/s, the bytes its phases move, the card's time in each phase (a
   trace) and its bf16 error against the float32 plain version
   (information); K3's float32 form (3xTF32) at the eval step's shapes
   (384x768 crop) and at the full frame's, with each phase's grid, tile,
   shared memory and blocks per SM and its FMA and 3xTF32 roofs; then K5, the backward of the sweeps in its three modes
   (corr, fused, var), against the autograd VJP of the plain volumes at the
   training stage shapes (384x768 crop), float32 and bfloat16, timed in
   both with the forward's geometry handed in, as the training forms
   call it, and with its own, beside the kernel's own time, the geometry's
   and the zeroing's (K5-corr also its flushes per sample); then all of them again at
   small ragged shapes (batch 2, rotated views, samples behind the camera
   and outside the image), float32, then the sweeps and K5 at the widths
   they take by padding or channel groups (C 1, 2, 4, 64, 128) and the
   sampler and its backward at C 1, 3, 4, 12, 64, 128, float32 and bfloat16
   (the backward also through the autograd Function, from a strided view),
   and its bf16-in, float32-out form with its gradient there; K6/K7-bwd's
   in-kernel paths (a magnifying warp, a footprint past the shared box,
   samples behind the camera and outside the image, walks on one tap set
   and across taps) at B 2 with Vs 4, C 8/12/32, float32 and bfloat16,
   with the kernel's own counts; and K3 at every
   input width, base, head kind, D 1 and 5, 38x54 and 6x10, float32 and
   bfloat16; K2, K4, K5-fused and K5-var in float32 and bfloat16 under a
   blocky hypothesis window and where their source windows exceed shared
   memory (the direct branch, which the kernels' own counts must show); K2
   and K4 are timed over 10 runs, with the
   share of windows gathered directly and their times under rotated views
   and a blocky window as information; K6/K7-bwd, the sampler's gradient,
   against its plain version (relative L2) at the training stage shapes of
   the scan form (all 4 source views a call: 96x192 C32 with 16 and 1
   hypotheses per call, 192x384 C16, 384x768 C8), float32 and bfloat16,
   with one train step's calls
   timed on the card, alone, by CUDA events and under autograd, beside the
   bound and the input gradient of F.grid_sample; then K1, K2, K4 and K6/K7
   at the shapes of ``predict --tiles 4`` (band 1 of 4, halo 256: 1216 of
   2752 reference rows, the sources at the full frame, the reference
   projection shifted to the band), float32 and bfloat16 (``phase_bands``);
4. reference: AdaMVS (fused form with K3 and with the cell stepped,
   precomp on the card against the stepped form on the CPU, scan form, and
   the scan form with bf16 sampling of a float32 model) and MS-REDNet
   (fused, scan, precomp on the card against the stepped fused form on the
   CPU, and the fused form with the fpn feature net) on a small frame at
   base 8 and base 4 (stage 3 at C 4; the forms of BASE8_ONLY at base 8), kernels
   on the card against the plain path on the CPU, float32; then one float32
   train step of each model in its fused and its scan form on that frame,
   card against CPU (loss, gradient, BatchNorm statistics); then one bf16
   train step (float32 master weights) of each model in its fused form,
   card against CPU, each module's gradient within twice its noise on the
   CPU under a jitter of the weights by about 4 float32 steps;
   then the blocks of nn/extras.py, the float64 warp grid and
   depth_regression, card against CPU at 128x160 (forward and every
   gradient), timed at the full frame's stage-1 shapes on the card alone,
   and the float64 grid against the float32 one there (``phase_extras``);
5. main paths, each with every launch counter set to 0 just before it and
   read just after: PredictEngine with seeded random weights in bfloat16 at
   full width on AdaMVS (3 requests: K1 1, K2 3, K3 3 launches per map; then
   the same fused form in float32, adamvs_f32, K3's float32 form), on
   MS-REDNet in its fused form and with the precomp regulariser (3 requests
   each: K4 3 per map; its recurrence timed per stage beside the stepped
   one, which the fused path times with the layers around it) and in its scan
   form (2 requests: the sampler 48+32+8 = 88 per map, each call all 4
   source views), and in float32 on AdaMVS in its scan form, the predict
   CLI's default (2 requests: the sampler 88 + 3 for stage 1's correlation
   blocks); AdaMVS
   with reg_impl="precomp" (3 requests) and with the cell stepped (2), bf16,
   K1 1 and K2 3 per map; the AdaMVS scan form in float32 with
   warp_impl="pallas2bf16" (2 requests: the sampler's bf16-in, float32-out
   form 91 per map); the first request of each is a warm-up; outputs must be finite with confidence in
   (0, 1]; one more request, after the counts are read, is traced with
   torch.profiler for the card's busy time; then each model's layers are
   timed alone. Then the Trainer on the bench's training batch (384x768,
   V=5, float32) for AdaMVS (per train step K1 1, K2 3, K5-corr 1, K5-fused
   3) and MS-REDNet (K4 3, K5-var 3), and for both in the scan form (K6/K7
   and K6/K7-bwd 91 per AdaMVS step, 88 per MS-REDNet step); then the
   same four in bf16 with float32 master weights (bench.py --mode train's
   defaults for the fused forms; the MS-REDNet scan form times 3 steps): a
   warm-up and 5 timed steps with finite losses and no skipped update,
   parameters and BatchNorm statistics moved, parameters and optimizer
   state still float32, one eval_epoch (AdaMVS: K1 1, K2 3, K3 3;
   MS-REDNet: K4 3; the scan forms K6/K7 91 and 88), and one more traced
   step for the card's busy time and its top kernels; then one step timed
   by phase (upload, forward, backward, update); then the parallel paths:
   ``predict --tiles 4`` through PredictEngine for the AdaMVS scan form
   (float32), fused AdaMVS with the cell stepped and fused MS-REDNet (bf16)
   against their unbanded maps (``phase_tiled``), AdaMVS with 4 depth
   blocks against the unsharded scan form (``phase_depth_shards``), and the
   Trainer in data-parallel mode, over nccl at world size 1 and over 2 gloo
   ranks in 2 processes sharing the card, against one process on the
   global batch (``phase_data_parallel``);
6. host_io and cli: the host library on the fixture's frames first (PNG
   decode against PIL, EXR against the Python codec, centring and resizing,
   ``phase_host_io``); then the port's predict command in this process on
   that synthetic tree of 6 aerial frames at 5504x3712 (PNG, decoded by the
   host library), each the reference of one work item of
   5 views: at the JAX CLI's defaults (AdaMVS scan form, float32), in the
   fused bf16 form (K1 1, K2 3, K3 3 per forward), and in that form with the
   feature cache and batches of 2; the output files, their maps and camera
   text, the cached run against the uncached one and the cache's hits are
   checked, and the per-item infer and save times logged; then the train,
   test and profile commands at their defaults (AdaMVS scan form, float32)
   on a WHU_OMVS tree of 6 views at 384x768 written by the port's writer:
   train 1 epoch, train to 2 epochs with --resume (it must resume and run
   epoch 1 only), test (export files, finite PFMs at the GT's resolution),
   profile (a trace file), and MS-REDNet train 1 epoch; then train 1 epoch
   with --compute_dtype bf16 (a float32 checkpoint), and test on it with
   --compute_dtype bf16 and in float32; launches per command, per-step
   seconds and the loader's share, the records
   (metrics.jsonl, train_record.txt, checkpoints, TensorBoard events where
   tensorboardX imports);
7. the kernels line (JSON; launches summed over phases 5 and 6; with the
   ``host_io`` and ``extras`` figures), the card line, and the final JSON
   line.

``python3 chip_smoke.py --ablate [sweep_fuse] [sweep_bwd] [corr] [corr_bwd] [sample_bwd]``
instead times K2 and K4 (csrc/sweep_fuse.cu), K5-fused and K5-var
(csrc/sweep_bwd.cu), K1 (csrc/sweep_fuse.cu), K5-corr (csrc/sweep_bwd.cu)
and K6/K7-bwd (csrc/bilinear_sample.cu) at their stage shapes as built and
with parts of their work left out or their tiles reshaped (``ablate``). ``python3 chip_smoke.py --k3-f32 [TREE]`` instead times K3's float32 form of the
port in TREE (a checkout's root) at both sets of shapes, as built and with
its kernels emptied (for the direct kernels of PR 1 also without their weight
loads; for the three-phase kernels also with one TF32 product of the three,
and with the operands unsplit), the fused AdaMVS eval step and the float32
fused map
(``k3_f32_probe``), to compare two versions in one call.
``python3 chip_smoke.py --cli-ab TREE`` instead runs the predict command's
runs of ``phase_cli`` in TREE and in this checkout in turns on one fixture
(``cli_ab``), an A/B of the command in one call.
``python3 chip_smoke.py --probe-parallel [1] [2] [3] [4] [5]``
instead measures what the parallel paths' checks and costs rest on
(``probe_parallel``).
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

H, W, V = 2752, 1856, 5
NDEPTHS = (48, 32, 8)
RATIOS = (4.0, 2.0, 1.0)
NUM_DEPTH = 192
BASE = 8
DMIN, DMAX = 300.0, 500.0
FOCAL = 2200.0
DEV = "cuda"
# training crop of bench.py --mode train (bench.py:191-212, 447-464), float32
TRAIN_H, TRAIN_W = 384, 768
DP_PAIRS = 6  # alternating plain and data-parallel train steps timed by probe_parallel
DLOSSW = (0.5, 1.0, 2.0)
REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 rate, float32 outside the tensor cores,
# dense bf16 and TF32 tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
TF32_TC_FLOPS = 495e12

# tolerance on max|kernel - plain| relative to max|plain|
TOL = {
    ("K1", torch.float32): 1e-5, ("K1", torch.bfloat16): 1e-5,  # float32 output
    ("K2", torch.float32): 1e-5, ("K2", torch.bfloat16): 8e-3,  # one bf16 rounding of the output
    ("K3", torch.float32): 1e-4, ("K3", torch.bfloat16): 5e-2,  # bf16 stores of every GRU step
    ("K4", torch.float32): 1e-5, ("K4", torch.bfloat16): 8e-3,  # one bf16 rounding of the output
    ("K6/7", torch.float32): 1e-5, ("K6/7", torch.bfloat16): 8e-3,  # the same
    # bf16 features sampled into float32 (pallas2bf16 on a float32 model): float32 output
    ("K6/7", "bf16->f32"): 1e-5,
    # K6/7-bwd, relative L2: float32 atomic sums in varying order; bf16: one rounding
    ("K6/7-bwd", torch.float32): 1e-5, ("K6/7-bwd", torch.bfloat16): 8e-3,
    # the bf16->f32 form's gradient: the float32 cotangent's, rounded once to bf16
    ("K6/7-bwd", "bf16->f32"): 8e-3,
    # K5: float32 sums, atomics in varying order; bf16: one rounding of the gradient
    ("K5-corr", torch.float32): 1e-5, ("K5-corr", torch.bfloat16): 8e-3,
    ("K5-fused", torch.float32): 1e-5, ("K5-fused", torch.bfloat16): 8e-3,
    ("K5-var", torch.float32): 1e-5, ("K5-var", torch.bfloat16): 8e-3,
}
K5 = ("K5-corr", "K5-fused", "K5-var")
SWEEP_REPS = 10  # K2 and K4 move by up to 25 % between runs of 3
KERNELS = ("K1", "K2", "K3", "K4", "K6/7") + K5 + ("K6/7-bwd",)
# the dtype of the path a kernel serves, whose times and errors the kernels line reports
MAIN_DTYPE = {"K5-corr": "f32", "K5-fused": "f32", "K5-var": "f32", "K6/7-bwd": "f32"}
REPLACES = {
    "K1": ("corr_sweep", "adamvs_tpu_torch/csrc/sweep_fuse.cu", "adamvs_tpu/ops/sweep_fuse.py:611"),
    "K2": ("fused_sweep", "adamvs_tpu_torch/csrc/sweep_fuse.cu", "adamvs_tpu/ops/sweep_fuse.py:418"),
    "K3": ("red_scan", "adamvs_tpu_torch/csrc/red_scan.cu", "adamvs_tpu/ops/red_scan.py:542"),
    "K4": ("var_sweep", "adamvs_tpu_torch/csrc/sweep_fuse.cu", "adamvs_tpu/ops/sweep_fuse.py:515"),
    "K6/7": ("bilinear_sample", "adamvs_tpu_torch/csrc/bilinear_sample.cu",
             "adamvs_tpu/ops/warp_pallas2.py:178 (K6), adamvs_tpu/ops/warp_pallas.py:89 (K7)"),
    "K5-corr": ("corr_sweep_bwd", "adamvs_tpu_torch/csrc/sweep_bwd.cu",
                "adamvs_tpu/ops/sweep_fuse.py:874"),
    "K5-fused": ("fused_sweep_bwd", "adamvs_tpu_torch/csrc/sweep_bwd.cu",
                 "adamvs_tpu/ops/sweep_fuse.py:786"),
    "K5-var": ("var_sweep_bwd", "adamvs_tpu_torch/csrc/sweep_bwd.cu",
               "adamvs_tpu/ops/sweep_fuse.py:832"),
    # JAX has no Pallas backward of K6/K7: it differentiates the gather warp
    "K6/7-bwd": ("bilinear_sample_bwd", "adamvs_tpu_torch/csrc/bilinear_sample.cu",
                 "the gradient of adamvs_tpu/ops/warp_pallas2.py:178 (K6) and "
                 "adamvs_tpu/ops/warp_pallas.py:89 (K7); JAX differentiates the gather warp, "
                 "adamvs_tpu/ops/warp.py:134"),
}
# stage 1 of the AdaMVS scan form samples its correlation volume in blocks of 16
# hypotheses, one sampler launch per block for all source views
CORR_BLOCKS = NDEPTHS[0] // 16
# per depth map and train step of the scan forms: every sampler call (one per hypothesis
# slice, every source view in the batch axis) and its backward
SCAN_STEP = {"adamvs": sum(NDEPTHS) + CORR_BLOCKS, "msrednet": sum(NDEPTHS)}
# (path, model, model options, requests, launches per depth map)
PATHS = (
    ("adamvs", "adamvs", {}, 3, {"K1": 1, "K2": 3, "K3": 3}),
    # the same fused form in float32 (predict --sweep_impl fused --reg_impl pallas at the
    # CLI's default dtype): K3's float32 form at the full frame
    ("adamvs_f32", "adamvs", {}, 3, {"K1": 1, "K2": 3, "K3": 3}),
    ("msrednet_fused", "msrednet", {"sweep_impl": "fused"}, 3, {"K4": 3}),
    ("msrednet_precomp", "msrednet", {"sweep_impl": "fused", "reg_impl": "precomp"}, 3,
     {"K4": 3}),
    ("msrednet_scan", "msrednet", {"sweep_impl": "scan"}, 2, {"K6/7": SCAN_STEP["msrednet"]}),
    ("adamvs_scan", "adamvs", {"sweep_impl": "scan", "reg_impl": "scan"}, 2,
     {"K6/7": SCAN_STEP["adamvs"]}),
    # AdaMVS reg_impl="precomp", beside the fused form with K3 (adamvs) and with the cell
    # stepped (adamvs_fused_regscan), bf16
    ("adamvs_precomp", "adamvs", {"sweep_impl": "fused", "reg_impl": "precomp"}, 3,
     {"K1": 1, "K2": 3}),
    ("adamvs_fused_regscan", "adamvs", {"sweep_impl": "fused", "reg_impl": "scan"}, 2,
     {"K1": 1, "K2": 3}),
    # the AdaMVS scan form in float32 with warp_impl="pallas2bf16": the sources rounded to
    # bf16 and sampled into float32 (K6/K7's bf16-in, float32-out form)
    ("adamvs_scan_pallas2bf16", "adamvs",
     {"sweep_impl": "scan", "reg_impl": "scan", "sample_dtype": torch.bfloat16}, 2,
     {"K6/7": SCAN_STEP["adamvs"]}),
)
# paths held card against CPU at base 8 only (phase_reference)
BASE8_ONLY = ("adamvs_precomp", "adamvs_scan_pallas2bf16", "adamvs_f32")
# forms held card against CPU beside the paths: MS-REDNet with the fpn feature net
REFERENCE_FORMS = (("msrednet_fpn", "msrednet", {"sweep_impl": "fused", "arch_mode": "fpn"}),)
# the dtype of each path: bf16, but the AdaMVS scan forms at the predict CLI's default
PATH_DTYPE = {"adamvs_scan": torch.float32, "adamvs_scan_pallas2bf16": torch.float32,
              "adamvs_f32": torch.float32}
# (training path, model, model options, train steps, launches per train step, launches
# of the eval step); each path ends with one eval_epoch on the batch
TRAIN_PATHS = (
    ("train_adamvs", "adamvs", {}, 6, {"K1": 1, "K2": 3, "K5-corr": 1, "K5-fused": 3},
     {"K1": 1, "K2": 3, "K3": 3}),
    ("train_msrednet", "msrednet", {"sweep_impl": "fused"}, 6, {"K4": 3, "K5-var": 3},
     {"K4": 3}),
    ("train_adamvs_scan", "adamvs", {"sweep_impl": "scan", "reg_impl": "scan"}, 6,
     {"K6/7": SCAN_STEP["adamvs"], "K6/7-bwd": SCAN_STEP["adamvs"]},
     {"K6/7": SCAN_STEP["adamvs"]}),
    ("train_msrednet_scan", "msrednet", {"sweep_impl": "scan"}, 6,
     {"K6/7": SCAN_STEP["msrednet"], "K6/7-bwd": SCAN_STEP["msrednet"]},
     {"K6/7": SCAN_STEP["msrednet"]}),
    # bf16 mixed precision, float32 master weights: bench.py --mode train's defaults
    # (bench.py:397, 410: sweep_impl fused, dtype bf16), then the CLI's default form
    ("train_adamvs_bf16", "adamvs", {"compute_dtype": torch.bfloat16}, 6,
     {"K1": 1, "K2": 3, "K5-corr": 1, "K5-fused": 3}, {"K1": 1, "K2": 3, "K3": 3}),
    ("train_msrednet_bf16", "msrednet", {"sweep_impl": "fused", "compute_dtype": torch.bfloat16},
     6, {"K4": 3, "K5-var": 3}, {"K4": 3}),
    ("train_adamvs_scan_bf16", "adamvs",
     {"sweep_impl": "scan", "reg_impl": "scan", "compute_dtype": torch.bfloat16}, 6,
     {"K6/7": SCAN_STEP["adamvs"], "K6/7-bwd": SCAN_STEP["adamvs"]},
     {"K6/7": SCAN_STEP["adamvs"]}),
    ("train_msrednet_scan_bf16", "msrednet", {"sweep_impl": "scan", "compute_dtype": torch.bfloat16},
     4, {"K6/7": SCAN_STEP["msrednet"], "K6/7-bwd": SCAN_STEP["msrednet"]},
     {"K6/7": SCAN_STEP["msrednet"]}),
)
# the fused bf16 train paths held card against CPU with the noise-calibrated check
TRAIN_REFERENCE_BF16 = ("train_adamvs_bf16", "train_msrednet_bf16")
# K6/K7-bwd at the training stage shapes, as a scan-form train step calls it, all V-1
# source views in one call: (stage, hypotheses per call, calls per train step)
SAMPLE_BWD_CASES = ((0, 16, CORR_BLOCKS), (0, 1, NDEPTHS[0]), (1, 1, NDEPTHS[1]),
                    (2, 1, NDEPTHS[2]))


def wrappers() -> dict:
    """The kernel wrappers by kernel, each with its ``launches`` count."""
    from adamvs_tpu_torch.ops import red_scan as rs
    from adamvs_tpu_torch.ops import sweep_fuse as sf
    from adamvs_tpu_torch.ops import warp_sample as ws

    return {"K1": sf.corr_sweep_volume, "K2": sf.fused_sweep_volume, "K3": rs.red_scan,
            "K4": sf.var_sweep_volume, "K6/7": ws.sample_bilinear,
            "K5-corr": sf.corr_sweep_volume_bwd, "K5-fused": sf.fused_sweep_volume_bwd,
            "K5-var": sf.var_sweep_volume_bwd, "K6/7-bwd": ws.sample_bilinear_bwd}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_projs(height: int, width: int, views: int, focal: float) -> dict:
    """Aerial bench geometry: identical intrinsics, a 10 m x-baseline per
    view, projections scaled per stage (stage k at 1/2^(3-k))."""
    proj = np.tile(np.eye(4, dtype=np.float32), (views, 1, 1))
    for v in range(views):
        proj[v, 0, 0] = proj[v, 1, 1] = focal
        proj[v, 0, 2] = width / 2
        proj[v, 1, 2] = height / 2
        proj[v, 0, 3] = focal * 10.0 * v
    out = {}
    for k in (1, 2, 3):
        p = proj.copy()
        p[:, :2, :] /= 2 ** (3 - k)
        out[f"stage{k}"] = p
    return out


def time_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_busy_ms(fn) -> float:
    """Milliseconds the card spends in kernels and copies while ``fn`` runs:
    the sum of their durations in a torch.profiler trace of the device alone
    (one stream, so they do not overlap). Unlike CUDA events around ``fn``,
    this leaves out the gaps in which the card waits for the host."""
    return device_profile(fn)[0]


def device_profile(fn, top: int = 0) -> tuple[float, list]:
    """(``device_busy_ms`` of ``fn``, the ``top`` kernel names by their
    summed device time as [name, ms, launches]), from the profiler's raw
    device events (kernels, copies, fills): building its per-event Python
    records (``key_averages``) takes tens of seconds for the ~100k launches
    of a scan-form request or step. A trace that shows no device time at all
    (the profiler has returned such traces now and then) is taken again, up
    to 3 traces in all."""
    for attempt in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name: dict = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0:
                ms, n = by_name.get(e.name(), (0.0, 0))
                by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
        busy = sum(ms for ms, _ in by_name.values())
        if busy > 0.0:
            break
        log(f"[profile] trace {attempt + 1} of 3 showed no device time")
    else:
        fail("the profiler traced no device time")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return busy, [[name[:80], ms, n] for name, (ms, n) in ranked]


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from adamvs_tpu_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"[build] {sorted(reports)} built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    path, built = build.build_host()
    log(f"[build] host library csrc/host/ -> {os.path.relpath(path, REPO)} "
        f"{'built' if built else 'already built'} in {time.perf_counter() - t0:.1f} s "
        f"({build.CXX} {' '.join(build.HOST_FLAGS + build.HOST_LIBS)})")
    for name, text in sorted(reports.items()):
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", text)]
        log(f"[build] {name}: {len(regs)} kernels, registers max {max(regs, default=0)}, "
            f"spill stores max {max(spills, default=0)} bytes")
    # every instance of the sweeps (K1, K2, K4) and of K5 (corr, fused, var), each
    # at C 8, 16 and 32 in float32 and bf16, reported and free of spills
    for source, kinds in (("sweep_fuse", ("K1", "K2", "K4")),
                          ("sweep_bwd", ("K5-corr", "K5-fused", "K5-var"))):
        found = sweep_instances(reports.get(source, ""))
        for label, regs, spill, stack in found:
            log(f"[build] {source} {label}: {regs} registers, {spill} bytes spill stores, "
                f"{stack} bytes stack frame")
        spilled = [label for label, _, spill, _ in found if spill]
        if spilled or len(found) != 6 * len(kinds):
            fail(f"{source}: instances spill registers ({spilled}) or {len(found)} of "
                 f"{6 * len(kinds)} were reported")
    # how the tiled K5's shared-memory float adds compiled (information)
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build._lib_path("sweep_bwd")], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    ops = {}
    for op in re.findall(r"\b((?:ATOMS|ATOM|RED|ATOMG|REDG)\.[A-Z0-9_.]+)", sass):
        ops[op] = ops.get(op, 0) + 1
    log(f"[build] sweep_bwd SASS atomics: " + ", ".join(f"{k} {n}" for k, n in sorted(ops.items())))
    # K6/K7-bwd's two kernels in both dtypes: registers and spills from ptxas, and
    # their SASS: no shared-memory atomics (ATOMS, compare-and-swap loops for
    # floats on sm_90), device-memory reductions and warp matches counted
    ptx = {}
    for block in reports.get("bilinear_sample", "").split("Compiling entry function")[1:]:
        m = re.search(r"(sample_bwd_(?:tile|walk)_kernel)I(f|13__nv_bfloat16)E", block)
        if m:
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            ptx[m.group(1), m.group(2)] = (int(regs.group(1)) if regs else -1,
                                           int(spill.group(1)) if spill else 0)
    sass = subprocess.run([cuobjdump, "-sass", build._lib_path("bilinear_sample")],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    for block in sass.split("Function : ")[1:]:
        m = re.match(r"\S*(sample_bwd_(?:tile|walk)_kernel)I(f|13__nv_bfloat16)E", block)
        if not m:
            continue
        ops = {}
        for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED|MATCH)\.[A-Z0-9_.]+)", block):
            ops[op] = ops.get(op, 0) + 1
        regs, spill = ptx.get((m.group(1), m.group(2)), (-1, -1))
        tn = "f32" if m.group(2) == "f" else "bf16"
        log(f"[build] bilinear_sample {m.group(1)} {tn}: {regs} registers, {spill} bytes spill "
            f"stores; SASS " + (", ".join(f"{k} {n}" for k, n in sorted(ops.items())) or "none"))
        if spill or any(k.startswith("ATOMS") for k in ops):
            fail(f"bilinear_sample {m.group(1)} {tn} spills registers or has shared-memory "
                 f"atomics")
        ptx.pop((m.group(1), m.group(2)), None)
    if len(ptx) or "sample_bwd_tile_kernel" not in sass:
        fail(f"bilinear_sample: backward kernels missing from the SASS or ptxas report ({ptx})")
    # both K3 forms run on the tensor cores: count the matrix instructions of the bf16
    # kernels (namespace tc) and of the float32 ones (namespace f32, split TF32) in the
    # SASS; the float32 kernels' registers and spills from ptxas
    sass = subprocess.run([cuobjdump, "-sass", build._lib_path("red_scan")], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = {"bf16": {}, "f32": {}}
    for block in sass.split("Function : ")[1:]:
        m = re.match(r"\S*?(2tc|3f32)\d+phase_[abc]", block)
        if m:
            form = counts["bf16" if m.group(1) == "2tc" else "f32"]
            for op in re.findall(r"\b(HMMA\.[0-9A-Z.]+|HGMMA)", block):
                form[op] = form.get(op, 0) + 1
    for form, ops in counts.items():
        log(f"[build] red_scan SASS, {form} phase kernels: "
            + (", ".join(f"{k} {n}" for k, n in sorted(ops.items())) or "no tensor-core instructions"))
    for block in reports.get("red_scan", "").split("Compiling entry function")[1:]:
        m = re.search(r"3f32(\d+)(phase_[abc])I((?:Li\d+E)+)", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if m and regs:
            args = ",".join(re.findall(r"Li(\d+)E", m.group(3)))
            log(f"[build] red_scan f32 {m.group(2)}<{args}>: {regs.group(1)} registers, "
                f"{spill.group(1) if spill else 0} bytes spill stores")
    tf32 = sum(n for k, n in counts["f32"].items() if "TF32" in k)
    if not sum(counts["bf16"].values()) or not tf32 or tf32 != sum(counts["f32"].values()):
        fail("red_scan: the bf16 kernels must use the tensor cores and the float32 kernels TF32 "
             f"mma (3xTF32) only: {counts}")


def sweep_instances(report: str) -> list[tuple[str, int, int, int]]:
    """(label, registers, spill store bytes, stack frame bytes) of each
    kernel instance in the ptxas report of csrc/sweep_fuse.cu or
    csrc/sweep_bwd.cu; labels as "K2 bf16 C16" or "K5-var f32 C8"."""
    kinds = {("corr_walk_kernel", None): "K1", ("sweep_tile_kernel", "0"): "K2",
             ("sweep_tile_kernel", "1"): "K4", ("corr_walk_bwd_kernel", None): "K5-corr",
             ("sweep_bwd_tile_kernel", "0"): "K5-fused", ("sweep_bwd_tile_kernel", "1"): "K5-var"}
    out = []
    for block in report.split("Compiling entry function")[1:]:
        m = re.search(r"(corr_walk_kernel|sweep_tile_kernel|corr_walk_bwd_kernel"
                      r"|sweep_bwd_tile_kernel)"
                      r"I(f|13__nv_bfloat16)Li(\d+)E(Lb([01])E)?", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        stack = re.search(r"(\d+) bytes stack frame", block)
        if not (m and regs):
            continue
        kind = kinds[m.group(1), m.group(5)]
        dtype = "f32" if m.group(2) == "f" else "bf16"
        out.append((f"{kind} {dtype} C{m.group(3)}", int(regs.group(1)),
                    int(spill.group(1)) if spill else 0, int(stack.group(1)) if stack else 0))
    return sorted(out)


def rotation(ax: float, ay: float, az: float) -> np.ndarray:
    """The rotation by az, then ay, then ax radians about z, y and x."""
    cx, sx, cy, sy, cz, sz = np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay), np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (rx @ ry @ rz).astype(np.float32)


class StageInputs:
    """Seeded inputs of one stage at the main path's shapes: of a 2752x1856
    frame by default, of the training crop with ``height``/``width``. With
    ``rough``, the source views are rotated (0.3/0.2/0.5 degrees per view
    about x/y/z) and the hypothesis window of stages 2 and 3 follows a
    blocky depth (16x16 cells, nearest-upsampled, depths 320-480) with edges
    between the cells, instead of the bench's axis-aligned views and smooth
    depth."""

    def __init__(self, si: int, gen: torch.Generator, height: int = H, width: int = W,
                 rough: bool = False):
        dev = torch.device(DEV)
        self.taps = None  # (samples, distinct taps) of the corr sweep (corr_taps)
        s = 2 ** (2 - si)
        self.si, self.h, self.w = si, height // s, width // s
        self.C, self.D = (4, 2, 1)[si] * BASE, NDEPTHS[si]
        self.up = si < 2
        h, w, C = self.h, self.w, self.C
        projs = bench_projs(height, width, V, FOCAL)[f"stage{si + 1}"]
        if rough:
            for v in range(1, V):
                projs[v, :3, :3] = projs[v, :3, :3] @ rotation(*np.radians([0.3 * v, 0.2 * v, 0.5 * v]))
        projs = torch.from_numpy(projs).to(dev)
        self.ref_proj, self.src_projs = projs[None, 0], projs[1:, None]  # [1,4,4], [Vs,1,4,4]
        self.ref = torch.randn((1, h, w, C), generator=gen, device=dev)
        self.srcs = torch.randn((V - 1, 1, h, w, C), generator=gen, device=dev)
        self.weights = torch.rand((1, V - 1, h, w), generator=gen, device=dev)
        if si == 0:
            self.lo = torch.full((1, h, w), DMIN, device=dev)
            self.step = torch.full((1, h, w), (DMAX - DMIN) / (self.D - 1), device=dev)
        else:
            if rough:  # a window around a blocky random depth
                coarse = 320.0 + 160.0 * torch.rand((1, 1, 16, 16), generator=gen, device=dev)
                prev = F.interpolate(coarse, size=(h, w), mode="nearest")[:, 0]
            else:  # a smooth random window around a smooth random depth
                coarse = 400.0 + 30.0 * torch.randn((1, 1, 8, 8), generator=gen, device=dev)
                prev = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)[:, 0]
            interval = RATIOS[si] * (DMAX - DMIN) / NUM_DEPTH
            lo = prev - self.D / 2 * interval
            self.lo, self.step = lo.contiguous(), ((prev + self.D / 2 * interval - lo) / (self.D - 1)).contiguous()

    def feats(self, dtype):
        return self.ref.to(dtype), self.srcs.to(dtype)


def _bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def corr_taps(st: StageInputs) -> tuple[int, int]:
    """(samples, distinct taps) of the corr sweep on ``st``'s geometry: the
    Vs*D*h*w samples, and over them, per (view, reference pixel), the source
    pixels that some hypothesis's bilinear tap reaches in the image with a
    weight that is not 0, each counted once. A distinct tap is the least
    C-wide work of K1 (one dot product ref . s_q) and of K5-corr (one
    scatter a_q ref and one multiply-add a_q s_q): it depends on the data, so
    it is counted on this run's positions (the plain ``sweep_coords``)."""
    from adamvs_tpu_torch.ops.warp import sweep_coords

    if st.taps is None:
        hyp = st.lo[:, None] + torch.arange(st.D, device=DEV)[None, :, None, None] * st.step[:, None]
        distinct = 0
        for v in range(V - 1):
            u, vv = sweep_coords(st.srcs[v], st.src_projs[v], st.ref_proj, hyp)  # [1,D,h,w]
            u0, v0 = torch.floor(u), torch.floor(vv)
            du, dv = u - u0, vv - v0
            keys = []
            for ox, oy, wt in ((0, 0, (1 - du) * (1 - dv)), (1, 0, du * (1 - dv)),
                               (0, 1, (1 - du) * dv), (1, 1, du * dv)):
                x, y = u0 + ox, v0 + oy
                ok = (x >= 0) & (x <= st.w - 1) & (y >= 0) & (y <= st.h - 1) & (wt != 0)
                keys.append(torch.where(ok, y * st.w + x, -1.0).long())
            k = torch.cat(keys, dim=1)[0].flatten(1).t().sort(dim=1).values  # [h*w, 4D]
            distinct += int(((k[:, 1:] != k[:, :-1]) & (k[:, 1:] >= 0)).sum() + (k[:, 0] >= 0).sum())
            del u, vv, u0, v0, du, dv, keys, k
        st.taps = ((V - 1) * st.D * st.h * st.w, distinct)
    return st.taps


def _sweep_work(kind: str, st: StageInputs, dtype) -> tuple[float, float]:
    """(bytes, float32 operations) of the least work of a sweep volume,
    counting a multiply-add as 2.

    Coordinates: R.[x,y,1] per (view, pixel), 12; hyp = lo + d.step per
    (hypothesis, pixel), 2; per (view, hypothesis, pixel) p = R.[x,y,1].hyp + t
    (6), u and v (2 divisions), their floors (2), the fractions and their
    complements (4) and the four tap weights (4), 18 in all.
    K1: mean_C(ref * sum_k w_k s_k) = sum_k w_k (ref . s_k) / C: per sample
    the weighted sum of four dot products (8), and one length-C dot product
    (2C) per distinct tap (``corr_taps``), not per tap and sample. At the
    inference shape (bf16, 688x464 C32 D48, Vs 4, the bench geometry: 0.53
    distinct taps per sample) that is 0.056 ms of arithmetic against 0.104 ms
    of bytes (102 MB in, 245 MB of float32 volume out): K1 is bound by
    bytes.
    K2: sum_v w'_v (ref * sum_k w_k s_k) = ref * sum_v sum_k (w'_v w_k) s_k,
    four weight products (4) and four length-C multiply-adds (8C) per sample,
    then the product with ref (C) per (hypothesis, pixel).
    K4: the sample sum_k w_k s_k (8C) and its additions to s and sq (3C) per
    sample; per (hypothesis, pixel, channel) ref^2, s/nv, sq/nv, their square
    and difference (5)."""
    es = torch.tensor([], dtype=dtype).element_size()
    Vs, hw, C, D = V - 1, st.h * st.w, st.C, st.D
    nbytes = (1 + Vs) * hw * C * es + 2 * hw * 4
    flops = Vs * hw * 12 + D * hw * 2
    if kind == "K1":
        samples, distinct = corr_taps(st)
        nbytes += Vs * D * hw * 4
        flops += samples * (18 + 8) + distinct * 2 * C
    elif kind == "K2":
        nbytes += Vs * hw * 4 + D * hw * C * es
        flops += Vs * D * hw * (18 + 4 + 8 * C) + D * hw * C
    else:
        nbytes += D * hw * C * es
        flops += Vs * D * hw * (18 + 11 * C) + D * hw * C * 5
    return nbytes, flops


def sweep_bound(kind: str, st: StageInputs, dtype) -> tuple[float, str]:
    """The least time of a sweep volume (``_sweep_work``)."""
    return _bound(*_sweep_work(kind, st, dtype), F32_FLOPS)


def sweep_bwd_bound(kind: str, st: StageInputs, dtype) -> tuple[float, str]:
    """Least work of one K5 call, the backward of the sweep ``kind`` (K1, K2
    or K4). Bytes: the cotangent g, ref, the sources, lo, step (and the
    weights) read once; d ref (and d weights) and d srcs written once, in
    their primals' dtypes. Operations (K2, K4): the forward's tap arithmetic
    (``_sweep_work``), which the backward needs again for the samples it
    multiplies with g, plus one multiply-add per tap, channel and source view
    for the scatter into d srcs (8C per sample). K1: no sample is needed, only
    per sample its coordinates and the four taps' coefficients w_k g / C (26),
    and per distinct tap (``corr_taps``) the multiply-adds of the scatter
    d src_q += a_q ref (2C) and of d ref += a_q s_q (2C). At the training
    shape (float32, 96x192 C32 D48, Vs 4) the bytes, ~38 MB, bound it
    (0.011 ms); the arithmetic is less."""
    es = torch.tensor([], dtype=dtype).element_size()
    Vs, hw, C, D = V - 1, st.h * st.w, st.C, st.D
    if kind == "K1":
        samples, distinct = corr_taps(st)
        flops = Vs * hw * 12 + D * hw * 2 + samples * (18 + 8) + distinct * 4 * C
    else:
        flops = _sweep_work(kind, st, dtype)[1] + Vs * D * hw * 8 * C
    g_bytes = Vs * D * hw * 4 if kind == "K1" else D * hw * C * es
    nbytes = g_bytes + 2 * (1 + Vs) * hw * C * es + 2 * hw * 4
    if kind == "K2":
        nbytes += 2 * Vs * hw * 4
    return _bound(nbytes, flops, F32_FLOPS)


def sample_bound(st: StageInputs, dtype, out_dtype=None) -> tuple[float, str]:
    """Least work of one K6/K7 call (the V-1 source views of one stage in the
    batch axis, one hypothesis slice): the sources (in ``dtype``), u and v
    read once and the samples (in ``out_dtype``, ``dtype`` unless given)
    written once; per sample the floors (2), fractions and complements (4)
    and tap weights (4), and four length-C multiply-adds (8C)."""
    es = torch.tensor([], dtype=dtype).element_size()
    eo = torch.tensor([], dtype=out_dtype or dtype).element_size()
    hw, C = (V - 1) * st.h * st.w, st.C
    return _bound(hw * C * (es + eo) + 2 * hw * 4, hw * (10 + 8 * C), F32_FLOPS)


def sample_bwd_bound(st: StageInputs, N: int, dtype) -> tuple[float, str]:
    """Least work of one K6/K7-bwd call (the V-1 source views of one stage in
    the batch axis, N hypotheses): the cotangent, u and v read once and the
    feature gradient written once; per sample the tap weights (10) and four
    length-C multiply-adds (8C)."""
    es = torch.tensor([], dtype=dtype).element_size()
    hw, C = (V - 1) * st.h * st.w, st.C
    n = hw * N
    return _bound(n * C * es + 2 * n * 4 + hw * C * es, n * (10 + 8 * C), F32_FLOPS)


def red_scan_work(st: StageInputs, dtype) -> tuple[float, float, float]:
    """(bytes, operations, a model of the bytes the kernel's design moves) of
    one K3 call. The least bytes read the volume and write the cost once; the
    operations count every convolution's multiply-adds as 2. The model adds
    the carries of the bf16 kernel's three phases per step: phase A reads the
    volume slice and h1 and writes h1', phase B reads h1' and h2 and writes
    h2', phase C reads h2' and h1' and writes the cost, so per full-resolution
    pixel cin + 4b values in and 1.5b + the cost's out (tiles' halos, which L2
    mostly serves, left out)."""
    es = torch.tensor([], dtype=dtype).element_size()
    b, cin, h, w, D = BASE, st.C, st.h, st.w, st.D
    hw, qw = h * w, (h // 2) * (w // 2)
    macs = 9 * (hw * (cin * b + 2 * b * 2 * b + 2 * b * b)  # conv1, GRU1 gates, candidate
                + qw * (b * 2 * b + 4 * b * 4 * b + 4 * b * 2 * b)  # conv2, GRU2 gates, cand.
                + qw * 2 * b * b  # up-deconv (per input pixel)
                + hw * b)  # head
    oh, ow = (2 * h, 2 * w) if st.up else (h, w)
    nbytes = D * (cin * hw + oh * ow) * es
    moved = nbytes + D * (4 * b * hw + 6 * b * qw) * es
    return nbytes, 2 * macs * D, moved


def red_scan_bound(st: StageInputs, dtype, roof: str | None = None) -> tuple[float, str]:
    """The least time of one K3 call (``red_scan_work``): its bytes over the
    memory rate or its convolutions' operations over the rate of ``roof``,
    whichever is larger: "bf16" (the bf16 tensor cores, the bf16 form's),
    "3xtf32" (three TF32 products per float32 multiply-add on the tensor
    cores, the float32 form's) or "fma" (float32 FMAs on the CUDA cores, the
    roof of any design that stays off the tensor cores). By default the
    form's own roof."""
    nbytes, flops, _ = red_scan_work(st, dtype)
    roof = roof or ("bf16" if dtype == torch.bfloat16 else "3xtf32")
    peak = {"bf16": BF16_TC_FLOPS, "3xtf32": TF32_TC_FLOPS / 3, "fma": F32_FLOPS}[roof]
    return _bound(nbytes, flops, peak)


def _compare(tag: str, key, got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    if got.shape != want.shape:
        fail(f"{tag}: shape {tuple(got.shape)} vs plain {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{tag}: non-finite kernel output")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    rel = err / max(scale, 1e-30)
    ok = rel <= TOL[key]
    log(f"[kernels] {tag}: max_abs_err {err:.3e} (max|plain| {scale:.3e}, rel {rel:.3e}, "
        f"tol {TOL[key]:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{tag} disagrees with its plain version")
    return err, rel


def _compare_l2(tag: str, key, got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """``got`` against ``want`` by relative L2 (limit ``TOL[key]``); returns
    (max_abs_err, relative L2)."""
    if got.shape != want.shape:
        fail(f"{tag}: shape {tuple(got.shape)} vs plain {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{tag}: non-finite kernel output")
    d = got.float() - want.float()
    err = d.abs().max().item()
    rel = (d.norm() / want.float().norm().clamp(min=1e-30)).item()
    ok = rel <= TOL[key]
    log(f"[kernels] {tag}: max_abs_err {err:.3e}, rel L2 {rel:.3e} (tol {TOL[key]:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{tag} disagrees with its plain version")
    return err, rel


def _grid(u: torch.Tensor, v: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Pixel coordinates [B,1,h,w] -> F.grid_sample's align_corners=True grid
    [B,h,w,2] over an H x W source."""
    return torch.stack([u[:, 0] / ((W - 1) / 2) - 1, v[:, 0] / ((H - 1) / 2) - 1], dim=-1)


def _record_err(res: dict, k: str, tn: str, e: tuple) -> None:
    """Keep the largest (max_abs_err, rel) of kernel ``k`` in dtype or case ``tn``."""
    old = res[k]["err"].get(tn, (0.0, 0.0))
    res[k]["err"][tn] = (max(old[0], e[0]), max(old[1], e[1]))


def phase_kernels(reps: int = 3) -> dict:
    from adamvs_tpu_torch.nn.blocks import init_parameters
    from adamvs_tpu_torch.nn.costreg import AdaRedCell
    from adamvs_tpu_torch.ops import red_scan as rs
    from adamvs_tpu_torch.ops import sweep_fuse as sf
    from adamvs_tpu_torch.ops import warp_sample as ws
    from adamvs_tpu_torch.ops.warp import sweep_coords

    gen = torch.Generator(device=DEV).manual_seed(0)
    res = {k: {"err": {}, "stages": []} for k in KERNELS}

    for si in range(3):
        st = StageInputs(si, gen)
        cell32 = AdaRedCell(st.C, BASE, st.up)
        init_parameters(cell32, torch.Generator().manual_seed(10 + si))
        cell32 = cell32.to(DEV).eval()
        calls = st.D  # sampler calls of one depth map at this stage, V-1 views each
        for dtype in (torch.float32, torch.bfloat16):
            tn = "f32" if dtype == torch.float32 else "bf16"
            ref, srcs = st.feats(dtype)
            geo = (st.src_projs, st.ref_proj, st.lo, st.step, st.D)
            timing = {}
            with torch.no_grad():
                if si == 0:
                    k1 = lambda **kw: sf.corr_sweep_volume(ref, srcs, *geo, **kw)
                    p1 = lambda: sf.corr_volume_ref(ref, srcs, *geo)
                    _record_err(res, "K1", tn,
                                _compare(f"K1 stage1 {tn}", ("K1", dtype), k1(), p1()))
                    if dtype == torch.bfloat16:
                        timing["K1"] = (time_ms(k1, reps), time_ms(p1, 1), sweep_bound("K1", st, dtype))
                k2 = lambda **kw: sf.fused_sweep_volume(ref, srcs, st.weights, *geo, **kw)
                p2 = lambda: sf.fused_volume_ref(ref, srcs, st.weights, *geo)
                vol = k2()
                _record_err(res, "K2", tn,
                            _compare(f"K2 stage{si + 1} {tn}", ("K2", dtype), vol, p2()))
                cell = copy.deepcopy(cell32).to(dtype)
                k3 = lambda: rs.red_scan(cell, vol)
                p3 = lambda: rs.red_scan_ref(cell, vol)
                _record_err(res, "K3", tn,
                            _compare(f"K3 stage{si + 1} {tn}", ("K3", dtype), k3(), p3()))
                if dtype == torch.bfloat16:  # information only: the bf16 kernel against float32
                    got, want = k3().float(), rs.red_scan_ref(cell32, vol.float())
                    err, scale = (got - want).abs().max().item(), want.abs().max().item()
                    log(f"[kernels] K3 stage{si + 1} bf16 kernel against the float32 plain version "
                        f"on the same volume: max_abs_err {err:.3e} (max|plain| {scale:.3e}, rel "
                        f"{err / scale:.3e}; information, no limit)")
                    del got, want
                k4 = lambda **kw: sf.var_sweep_volume(ref, srcs, *geo, **kw)
                p4 = lambda: sf.var_volume_ref(ref, srcs, *geo)
                _record_err(res, "K4", tn,
                            _compare(f"K4 stage{si + 1} {tn}", ("K4", dtype), k4(), p4()))
                # K6/K7: one hypothesis slice (the middle one) of every source view in one
                # call, the views in the batch axis, as the scan forms call it
                hyp = (st.lo + (st.D // 2) * st.step)[:, None]
                uv = [sweep_coords(srcs[v], st.src_projs[v], st.ref_proj, hyp) for v in range(V - 1)]
                u6 = torch.cat([a for a, _ in uv])
                v6 = torch.cat([b for _, b in uv])
                del uv
                flat = srcs.flatten(0, 1)
                _record_err(res, "K6/7", tn, _compare(
                    f"K6/7 stage{si + 1} {tn} ({V - 1} views a call)", ("K6/7", dtype),
                    ws.sample_bilinear(flat, u6, v6), ws.sample_bilinear_ref(flat, u6, v6)))
                if dtype == torch.bfloat16:
                    timing["K2"] = (time_ms(k2, SWEEP_REPS), time_ms(p2, 1),
                                    sweep_bound("K2", st, dtype))
                    timing["K3"] = (time_ms(k3, reps), time_ms(p3, 1), red_scan_bound(st, dtype))
                    timing["K4"] = (time_ms(k4, SWEEP_REPS), time_ms(p4, 1),
                                    sweep_bound("K4", st, dtype))
                    shares = {"K2": direct_share(k2), "K4": direct_share(k4)}
                    # A stage's sampler calls run back to back, as the scan form issues them.
                    # A call takes tens of microseconds, about what the host needs to
                    # launch one, so CUDA events around the calls ("wall_ms") time the host
                    # too; the kernel's time ("ms") is the card's busy time in a trace.
                    # The library yardstick samples the float32 features: F.grid_sample takes
                    # its grid in the input's dtype, and a bf16 grid cannot hold pixel positions.
                    nchw = flat.float().permute(0, 3, 1, 2).contiguous()
                    grid = _grid(u6, v6, st.h, st.w)

                    def lib(n=calls):
                        for _ in range(n):
                            out = F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                                                align_corners=True)
                        return out

                    def k6():
                        for _ in range(calls):
                            ws.sample_bilinear(flat, u6, v6)

                    want6 = ws.sample_bilinear_ref(flat.float(), u6, v6)[:, 0]
                    lib_err = (lib(1).permute(0, 2, 3, 1) - want6).abs().max().item()
                    del want6
                    p6 = lambda: ws.sample_bilinear_ref(flat, u6, v6)
                    wall6, wlib6 = time_ms(k6, 3), time_ms(lib, 3)
                    ms6, lms6 = device_busy_ms(k6), device_busy_ms(lib)
                    pms6 = time_ms(p6, 1) * calls
                    bms6, by6 = sample_bound(st, dtype)
                    res["K6/7"]["stages"].append({
                        "stage": si + 1, "calls_per_map": calls, "ms_per_call": ms6 / calls,
                        "ms": ms6, "wall_ms": wall6, "plain_ms": pms6, "bound_ms": bms6 * calls,
                        "bound_by": by6, "library_ms": lms6, "library_wall_ms": wlib6})
                    log(f"[kernels] K6/7 stage{si + 1} bf16, {calls} calls of {V - 1} views back "
                        f"to back: {ms6:.3f} ms on the card, {ms6 / calls:.4f} ms per call, wall "
                        f"{wall6:.3f} ms (plain {pms6:.3f} ms, bound {bms6 * calls:.3f} ms by "
                        f"{by6}; F.grid_sample float32 {lms6:.3f} ms on the card, wall "
                        f"{wlib6:.3f} ms, its max_abs_err against the plain version "
                        f"{lib_err:.2e})")
                    del nchw, grid
                    # the bf16-in, float32-out form (pallas2bf16 on a float32 model): the same
                    # calls of one scan map, against the plain version on the same bf16 sources
                    f32 = torch.float32
                    _record_err(res, "K6/7", "bf16->f32", _compare(
                        f"K6/7 stage{si + 1} bf16->f32 ({V - 1} views a call)",
                        ("K6/7", "bf16->f32"), ws.sample_bilinear(flat, u6, v6, out_dtype=f32),
                        ws.sample_bilinear_ref(flat, u6, v6, out_dtype=f32)))

                    def k6f():
                        for _ in range(calls):
                            ws.sample_bilinear(flat, u6, v6, out_dtype=f32)

                    msf, wallf = device_busy_ms(k6f), time_ms(k6f, 3)
                    bmsf, byf = sample_bound(st, dtype, f32)
                    res["K6/7"]["stages"][-1].update(
                        bf16_to_f32_ms=msf, bf16_to_f32_wall_ms=wallf,
                        bf16_to_f32_bound_ms=bmsf * calls, bf16_to_f32_bound_by=byf)
                    log(f"[kernels] K6/7 stage{si + 1} bf16->f32, {calls} calls back to back: "
                        f"{msf:.3f} ms on the card, wall {wallf:.3f} ms (bound "
                        f"{bmsf * calls:.3f} ms by {byf})")
            for k, (ms, pms, (bms, by)) in timing.items():
                res[k]["stages"].append({"stage": si + 1, "ms": ms, "plain_ms": pms,
                                         "bound_ms": bms, "bound_by": by})
                log(f"[kernels] {k} stage{si + 1} bf16: {ms:.3f} ms (plain {pms:.3f} ms, "
                    f"bound {bms:.3f} ms by {by})")
                if k == "K1":
                    # the kernel's own time on the card (a trace of one call) and the dot
                    # products its walk computed per sample (the kernel's own count)
                    _, top = device_profile(k1, top=8)
                    kms = sum(t for n, t, _ in top if "corr_walk_kernel" in n)
                    per = walk_counts(k1)
                    samples, distinct = corr_taps(st)
                    res[k]["stages"][-1].update(kernel_ms=kms, dots_per_sample=per)
                    log(f"[kernels] K1 stage1 bf16: the kernel alone {kms:.3f} ms on the card; "
                        f"{per:.3f} dot products per sample walked (distinct taps "
                        f"{distinct / samples:.3f} per sample; information, no limit)")
                if k in shares:
                    res[k]["stages"][-1]["direct_share"] = shares[k]
                    log(f"[kernels] {k} stage{si + 1} bf16: {shares[k]:.2%} of the (block, view) "
                        f"windows gathered directly (information, no limit)")
                if k == "K3":
                    nbytes, flops, moved = red_scan_work(st, torch.bfloat16)
                    # the card's time in each of the three phase kernels over one call
                    _, top = device_profile(k3, top=6)
                    phases = {m.group(0): t for n, t, _ in top
                              if (m := re.search(r"phase_[abc]", n))}
                    res[k]["stages"][-1].update(tflops=flops / ms / 1e9, phases_ms=phases)
                    log(f"[kernels] K3 stage{si + 1} bf16 on the card by phase (ms): "
                        + ", ".join(f"{n} {t:.3f}" for n, t in sorted(phases.items())))
                    log(f"[kernels] K3 stage{si + 1} bf16: {flops / ms / 1e9:.2f} TFLOP/s of "
                        f"{BF16_TC_FLOPS / 1e12:.0f} ({flops / 1e12:.3f} TFLOP); the bound's bytes "
                        f"{nbytes / 1e9:.3f} GB; the design's traffic by its model, not measured "
                        f"(the tiles' halos left out): {moved / 1e9:.3f} GB")
            del ref, srcs, vol, u6, v6, flat
        rough_sweeps(res, si, gen)
        del st
        torch.cuda.empty_cache()
    return res


def phase_sample_bwd(res: dict, reps: int = 3) -> None:
    """K6/K7-bwd against its plain version (autograd of the plain sampler) at
    the training stage shapes as a scan-form train step calls it, the V-1
    source views of a hypothesis slice in one call (SAMPLE_BWD_CASES: 96x192
    C32 with 16 hypotheses per call and with 1, 192x384 C16, 384x768 C8), in
    float32 and bfloat16, relative L2; in float32 the calls of one train step
    back to back: the card's busy time (``ms``, the wrapper's zeroing and
    cast included), the kernel alone, the wall by CUDA events, the calls as
    autograd makes them in a train step, the plain version's, the bound, and
    the gradient of ``F.grid_sample`` (align_corners=False, zeros padding)
    with respect to its input (``aten.grid_sampler_2d_backward``, one call per
    K6/K7-bwd call); and the kernel's own counts (information): the walk's
    flushes per sample (N > 1), the share of tiles whose box exceeded shared
    memory (N = 1)."""
    from adamvs_tpu_torch.ops import warp_sample as ws
    from adamvs_tpu_torch.ops.warp import sweep_coords

    gen = torch.Generator(device=DEV).manual_seed(5)
    k = "K6/7-bwd"
    Vs = V - 1
    for si, N, calls in SAMPLE_BWD_CASES:
        st = StageInputs(si, gen, TRAIN_H, TRAIN_W)
        d0 = (st.D - N) // 2
        hyp = st.lo[:, None] + (d0 + torch.arange(N, device=DEV))[None, :, None, None] * st.step[:, None]
        uv = [sweep_coords(st.srcs[i], st.src_projs[i], st.ref_proj, hyp) for i in range(Vs)]
        u = torch.cat([a for a, _ in uv])  # [Vs,N,h,w], the views in the batch axis
        v = torch.cat([b for _, b in uv])
        del uv
        for dtype in (torch.float32, torch.bfloat16):
            tn = "f32" if dtype == torch.float32 else "bf16"
            dout = torch.randn((Vs, N, st.h, st.w, st.C), generator=gen, device=DEV).to(dtype)
            kern = lambda: ws.sample_bilinear_bwd(dout, u, v, st.h, st.w)
            plain = lambda: ws.sample_bilinear_bwd_ref(dout, u, v, st.h, st.w)
            e = _compare_l2(f"{k} stage{si + 1} N{N} {tn} ({Vs} views a call)", (k, dtype),
                            kern(), plain())
            _record_err(res, k, tn, e)
            if dtype != torch.float32:
                continue
            stats = torch.zeros(2, dtype=torch.int32, device=DEV)
            ws.sample_bilinear_bwd(dout, u, v, st.h, st.w, stats=stats)
            n0, n1 = stats.tolist()
            # the library's yardstick: F.grid_sample's input gradient, NCHW, its grid
            # normalised for align_corners=False and stacked over the N hypotheses
            gx = (2.0 * u + 1.0) / st.w - 1.0
            gy = (2.0 * v + 1.0) / st.h - 1.0
            grid = torch.stack([gx, gy], dim=-1).reshape(Vs, N * st.h, st.w, 2)
            gout = dout.permute(0, 4, 1, 2, 3).reshape(Vs, st.C, N * st.h, st.w).contiguous()
            x = torch.zeros((Vs, st.C, st.h, st.w), device=DEV)

            def lib():
                return torch.ops.aten.grid_sampler_2d_backward(gout, x, grid, 0, 0, False,
                                                                [True, False])[0]

            lib_err = (lib().permute(0, 2, 3, 1) - plain()).abs().max().item()

            def kcalls():
                for _ in range(calls):
                    kern()

            def lcalls():
                for _ in range(calls):
                    lib()

            wall = time_ms(kcalls, reps)
            busy, top = device_profile(kcalls, top=6)
            alone = sum(t for n, t, _ in top if "sample_bwd_" in n)
            lms = device_busy_ms(lcalls)
            pms = time_ms(plain, 1) * calls
            bms, by = sample_bwd_bound(st, N, dtype)
            # the same calls as autograd makes them in a train step: each forward samples
            # every view of the stacked sources at once, and the backward hands its gradient
            # back into the gradient of the stack, summed over the calls (the card's time of
            # that backward: the kernels, their zeroing and the sums)
            srcs = st.srcs.clone().requires_grad_()
            with torch.enable_grad():
                outs = [ws.sample_bilinear(srcs.flatten(0, 1), u, v) for _ in range(calls)]
            autograd_ms = device_busy_ms(lambda: torch.autograd.backward(
                outs, [dout] * calls, retain_graph=True))
            counts = ({"flushes_per_sample": n1 / max(n0, 1)} if N > 1
                      else {"direct_tile_share": n1 / max(n0, 1)})
            res[k]["stages"].append({
                "stage": si + 1, "N": N, "views_per_call": Vs, "calls_per_step": calls,
                "ms": busy, "kernel_ms": alone, "wall_ms": wall, "autograd_ms": autograd_ms,
                "plain_ms": pms, "bound_ms": bms * calls, "bound_by": by, "library_ms": lms,
                **counts})
            log(f"[kernels] {k} stage{si + 1} N{N} f32, {calls} calls of {Vs} views of a train "
                f"step back to back: {busy:.3f} ms on the card, the kernel alone {alone:.3f} ms, "
                f"wall {wall:.3f} ms, under autograd into one source stack {autograd_ms:.3f} ms on "
                f"the card (plain {pms:.3f} ms, bound {bms * calls:.3f} ms by {by}; F.grid_sample "
                f"backward {lms:.3f} ms on the card, its max_abs_err against the plain version "
                f"{lib_err:.2e}); the kernel's counts "
                + ", ".join(f"{name} {val:.4f}" for name, val in counts.items())
                + " (information, no limit)")
            del grid, gout, x, srcs, outs
        del st, u, v, hyp
        torch.cuda.empty_cache()


def walk_counts(call) -> float:
    """The C-wide dot products (K1) or flushes (K5-corr) per sample walked of
    a corr call, from the kernel's own count."""
    stats = torch.zeros(2, dtype=torch.int32, device=DEV)
    call(stats=stats)
    n, m = stats.tolist()
    return m / max(n, 1)


def direct_share(call) -> float:
    """The share of a K2/K4 call's (block, source view) windows that
    exceeded the block's shared memory and were gathered directly, from the
    kernel's own count."""
    stats = torch.zeros(2, dtype=torch.int32, device=DEV)
    call(stats=stats)
    n, direct = stats.tolist()
    return direct / max(n, 1)


def rough_sweeps(res: dict, si: int, gen) -> None:
    """K2 and K4 in bf16 at stage ``si``'s shape with rotated views and a
    blocky hypothesis window (``StageInputs(rough=True)``): against their
    plain versions, then their times and direct-gather shares (information,
    no limit), so that the design is not tuned to the bench's smooth,
    axis-aligned geometry alone."""
    from adamvs_tpu_torch.ops import sweep_fuse as sf

    st = StageInputs(si, gen, rough=True)
    ref, srcs = st.feats(torch.bfloat16)
    geo = (st.src_projs, st.ref_proj, st.lo, st.step, st.D)
    calls = {"K2": (lambda **kw: sf.fused_sweep_volume(ref, srcs, st.weights, *geo, **kw),
                    lambda: sf.fused_volume_ref(ref, srcs, st.weights, *geo)),
             "K4": (lambda **kw: sf.var_sweep_volume(ref, srcs, *geo, **kw),
                    lambda: sf.var_volume_ref(ref, srcs, *geo))}
    with torch.no_grad():
        for k, (kern, plain) in calls.items():
            _compare(f"{k} stage{si + 1} bf16 rotated views, blocky window", (k, torch.bfloat16),
                     kern(), plain())
            ms, share = time_ms(kern, SWEEP_REPS), direct_share(kern)
            res[k]["stages"][-1].update(rough_ms=ms, rough_direct_share=share)
            log(f"[kernels] {k} stage{si + 1} bf16 rotated views, blocky window: {ms:.3f} ms, "
                f"{share:.2%} of the windows gathered directly (information, no limit)")


def phase_edges() -> None:
    """The kernels against their plain versions at small ragged shapes, in
    float32: batch 2, sizes that are no multiple of the thread blocks, an odd
    hypothesis count, rotated views, samples behind the camera and out of
    the image; the sampler at every hypothesis of every view at once (N = D)
    and at random coordinates past every border; K5 in its three modes on
    the sweeps' inputs; then, in float32 and bfloat16, K1, K2, K4 and K5 (all
    modes) at the widths they take by padding or channel groups (1, 2, 4, 64
    and 128) and the sampler at 1, 3, 4, 12, 64 and 128; K3 at input widths
    8, 16 and 32, both regulariser widths and head kinds, D 1 and 5, at 38x54
    and at a size below every tile of its bf16 phases, and at the widths 4,
    20, 40 and 64 at 38x54 and D 5, in float32 and bfloat16."""
    from adamvs_tpu_torch.nn.blocks import init_parameters
    from adamvs_tpu_torch.nn.costreg import AdaRedCell
    from adamvs_tpu_torch.ops import red_scan as rs
    from adamvs_tpu_torch.ops import sweep_fuse as sf
    from adamvs_tpu_torch.ops import warp_sample as ws
    from adamvs_tpu_torch.ops.warp import sweep_coords

    gen = torch.Generator(device=DEV).manual_seed(1)
    B, Vs, h, w, D = 2, 3, 38, 54, 11
    projs = torch.from_numpy(bench_projs(h, w, Vs + 1, 60.0)["stage3"]).to(DEV)
    projs[1:, :3, :3] += 0.02 * torch.randn((Vs, 3, 3), generator=gen, device=DEV)
    ref_proj = projs[:1].expand(B, 4, 4).contiguous()
    src_projs = projs[1:, None].expand(Vs, B, 4, 4).contiguous()
    lo = -2.0 + 32.0 * torch.rand((B, h, w), generator=gen, device=DEV)  # some behind the camera
    step = 0.5 + torch.rand((B, h, w), generator=gen, device=DEV)
    f32 = torch.float32
    with torch.no_grad():
        for C in (8, 16, 32):
            ref = torch.randn((B, h, w, C), generator=gen, device=DEV)
            srcs = torch.randn((Vs, B, h, w, C), generator=gen, device=DEV)
            wts = torch.rand((B, Vs, h, w), generator=gen, device=DEV)
            geo = (src_projs, ref_proj, lo, step, D)
            _compare(f"K1 edge C{C}", ("K1", f32), sf.corr_sweep_volume(ref, srcs, *geo),
                     sf.corr_volume_ref(ref, srcs, *geo))
            _compare(f"K2 edge C{C}", ("K2", f32), sf.fused_sweep_volume(ref, srcs, wts, *geo),
                     sf.fused_volume_ref(ref, srcs, wts, *geo))
            _compare(f"K4 edge C{C}", ("K4", f32), sf.var_sweep_volume(ref, srcs, *geo),
                     sf.var_volume_ref(ref, srcs, *geo))
            # the plain K5 recomputes its volume under autograd of its own
            wn = sf.normalize_weights(wts)
            for mode in ("corr", "fused", "var"):
                g = (torch.randn((Vs, B, D, h, w), generator=gen, device=DEV) if mode == "corr"
                     else torch.randn((D, B, C, h, w), generator=gen, device=DEV))
                kern, plain = _k5_calls(mode, g, ref, srcs, wn, geo[:4])
                _compare_grads(f"K5-{mode} edge C{C}", (f"K5-{mode}", f32), kern(), plain())
            hyp = lo[:, None] + torch.arange(D, device=DEV)[None, :, None, None] * step[:, None]
            for v in range(Vs):
                u, vv = sweep_coords(srcs[v], src_projs[v], ref_proj, hyp)  # [B,D,h,w]
                _compare(f"K6/7 edge C{C} view {v}", ("K6/7", f32),
                         ws.sample_bilinear(srcs[v], u, vv), ws.sample_bilinear_ref(srcs[v], u, vv))
                g = torch.randn((B, D, h, w, C), generator=gen, device=DEV)
                _compare_l2(f"K6/7-bwd edge C{C} view {v}", ("K6/7-bwd", f32),
                            ws.sample_bilinear_bwd(g, u, vv, h, w),
                            ws.sample_bilinear_bwd_ref(g, u, vv, h, w))
            u = -3.0 + (w + 6.0) * torch.rand((B, 2, 17, 23), generator=gen, device=DEV)
            vv = -3.0 + (h + 6.0) * torch.rand((B, 2, 17, 23), generator=gen, device=DEV)
            u[:, :, :2] = -1e9
            _compare(f"K6/7 edge C{C} random coordinates", ("K6/7", f32),
                     ws.sample_bilinear(srcs[0], u, vv), ws.sample_bilinear_ref(srcs[0], u, vv))
            g = torch.randn((B, 2, 17, 23, C), generator=gen, device=DEV)
            _compare_l2(f"K6/7-bwd edge C{C} random coordinates", ("K6/7-bwd", f32),
                        ws.sample_bilinear_bwd(g, u, vv, h, w),
                        ws.sample_bilinear_bwd_ref(g, u, vv, h, w))
            # through the autograd Function, from a view that is not contiguous
            wide = torch.cat([srcs[1], srcs[0]], dim=-1).requires_grad_()
            with torch.enable_grad():
                (ws.sample_bilinear(wide[..., :C], u, vv).float() * g).sum().backward()
            _compare_l2(f"K6/7-bwd edge C{C} autograd of a strided view", ("K6/7-bwd", f32),
                        wide.grad[..., :C], ws.sample_bilinear_bwd_ref(g, u, vv, h, w))
            if wide.grad[..., C:].abs().max().item() != 0.0:
                fail(f"K6/7-bwd edge C{C}: gradient outside the sampled view")
        # the widths the kernels take by padding or channel groups (ops/sweep_fuse.py::
        # sweep_plan, ops/warp_sample.py::sample_width), float32 and bf16
        geo = (src_projs, ref_proj, lo, step, D)
        for C in (1, 2, 4, 64, 128):
            ref32 = torch.randn((B, h, w, C), generator=gen, device=DEV)
            srcs32 = torch.randn((Vs, B, h, w, C), generator=gen, device=DEV)
            wts = torch.rand((B, Vs, h, w), generator=gen, device=DEV)
            wn = sf.normalize_weights(wts)
            for dtype, tn in ((f32, "f32"), (torch.bfloat16, "bf16")):
                ref, srcs = ref32.to(dtype), srcs32.to(dtype)
                _compare(f"K1 edge C{C} {tn}", ("K1", dtype), sf.corr_sweep_volume(ref, srcs, *geo),
                         sf.corr_volume_ref(ref, srcs, *geo))
                _compare(f"K2 edge C{C} {tn}", ("K2", dtype),
                         sf.fused_sweep_volume(ref, srcs, wts, *geo),
                         sf.fused_volume_ref(ref, srcs, wts, *geo))
                _compare(f"K4 edge C{C} {tn}", ("K4", dtype), sf.var_sweep_volume(ref, srcs, *geo),
                         sf.var_volume_ref(ref, srcs, *geo))
                for mode in ("corr", "fused", "var"):
                    g = (torch.randn((Vs, B, D, h, w), generator=gen, device=DEV) if mode == "corr"
                         else torch.randn((D, B, C, h, w), generator=gen, device=DEV).to(dtype))
                    kern, plain = _k5_calls(mode, g, ref, srcs, wn, geo[:4])
                    _compare_grads(f"K5-{mode} edge C{C} {tn}", (f"K5-{mode}", dtype), kern(),
                                   plain())
        hyp = lo[:, None] + torch.arange(D, device=DEV)[None, :, None, None] * step[:, None]
        for C in (1, 3, 4, 12, 64, 128):
            feat = torch.randn((B, h, w, C), generator=gen, device=DEV)
            u, vv = sweep_coords(feat, src_projs[0], ref_proj, hyp)  # [B,D,h,w]
            for dtype, tn in ((f32, "f32"), (torch.bfloat16, "bf16")):
                f = feat.to(dtype)
                _compare(f"K6/7 edge C{C} {tn}", ("K6/7", dtype), ws.sample_bilinear(f, u, vv),
                         ws.sample_bilinear_ref(f, u, vv))
                g = torch.randn((B, D, h, w, C), generator=gen, device=DEV).to(dtype)
                _compare_l2(f"K6/7-bwd edge C{C} {tn}", ("K6/7-bwd", dtype),
                            ws.sample_bilinear_bwd(g, u, vv, h, w),
                            ws.sample_bilinear_bwd_ref(g, u, vv, h, w))
                # the autograd Function hands back the gradient of the unpadded width
                f = f.clone().requires_grad_()
                with torch.enable_grad():
                    (ws.sample_bilinear(f, u, vv).float() * g.float()).sum().backward()
                _compare_l2(f"K6/7-bwd edge C{C} {tn} autograd", ("K6/7-bwd", dtype), f.grad,
                            ws.sample_bilinear_bwd_ref(g, u, vv, h, w))
            # bf16 sources sampled into float32, and the gradient of that form: the float32
            # cotangent's, rounded once to the sources' bf16
            f = feat.to(torch.bfloat16).requires_grad_()
            g = torch.randn((B, D, h, w, C), generator=gen, device=DEV)
            with torch.enable_grad():
                out = ws.sample_bilinear(f, u, vv, out_dtype=f32)
                (out * g).sum().backward()
            _compare(f"K6/7 edge C{C} bf16->f32", ("K6/7", "bf16->f32"), out,
                     ws.sample_bilinear_ref(f.detach(), u, vv, out_dtype=f32))
            _compare_l2(f"K6/7-bwd edge C{C} bf16->f32 autograd", ("K6/7-bwd", "bf16->f32"),
                        f.grad, ws.sample_bilinear_bwd_ref(g, u, vv, h, w).to(torch.bfloat16))
            if f.grad.dtype != torch.bfloat16 or out.dtype != f32:
                fail(f"K6/7 edge C{C} bf16->f32: dtypes {out.dtype} {f.grad.dtype}")
        sample_bwd_edges(gen)
        # K3 at every input width of AdaMVS base 8, both regulariser widths and head kinds,
        # one and five depth steps, at 38x54 (no multiple of any tile) and at 6x10 (smaller
        # than every tile of the bf16 kernel's phases), in float32 and bf16; then widths the
        # bf16 kernel pads up to 8, 32 and 64 channels (4 is stage 3's at base 4) and 64
        for cin in (8, 16, 32, 4, 20, 40, 64):
            full = cin in (8, 16, 32)
            for base in (4, 8):
                for up in (False, True):
                    cell = AdaRedCell(cin, base, up)
                    init_parameters(cell, torch.Generator().manual_seed(cin + base + up))
                    cell = cell.to(DEV).eval()
                    for eh, ew in ((h, w), (6, 10)) if full else ((h, w),):
                        for dk in (1, 5) if full else (5,):
                            vol = torch.randn((dk, B, cin, eh, ew), generator=gen, device=DEV)
                            for dtype, tn in ((f32, "f32"), (torch.bfloat16, "bf16")):
                                c, v = copy.deepcopy(cell).to(dtype), vol.to(dtype)
                                _compare(f"K3 edge cin {cin} base {base} up {up} D {dk} {eh}x{ew} "
                                         f"{tn}", ("K3", dtype), rs.red_scan(c, v),
                                         rs.red_scan_ref(c, v))


# the redesigned K6/K7-bwd's paths at ragged shapes: (case, hypotheses per call, u and v
# of output pixel (x, y) at hypothesis n, the kernel's count that must be reached: the
# direct tiles (N = 1) or the flushes per sample at most (N > 1), or None)
SAMPLE_BWD_EDGES = (
    # a magnifying warp: many output pixels on one source pixel, coinciding targets in a warp
    ("magnifying x0.25", 1, lambda x, y, n: (3.3 + 0.25 * x, 2.1 + 0.25 * y), None),
    ("magnifying x0.02", 1, lambda x, y, n: (5.5 + 0.02 * x, 7.5 + 0.02 * y), None),
    # a footprint too large for a warp's shared box: its taps go to device memory directly
    ("footprint past the shared box", 1, lambda x, y, n: (3.0 * x - 20.0, 3.0 * y - 9.0),
     "direct"),
    # samples behind the camera (-1e9) and samples wholly outside the image
    ("behind the camera, outside the image", 1,
     lambda x, y, n: (torch.where(x < 20, -1e9, x + 40.0), torch.where(y > 30, y + 50.0, y - 0.5)),
     None),
    # a walk that stays on one tap set for all 16 hypotheses: 4 flushes per 16 samples
    ("walk on one tap set", 16, lambda x, y, n: (10.25 + 0.01 * n + 0.0 * x, 4.5 + 0.0 * y), 0.25),
    ("walk across taps", 16, lambda x, y, n: (0.9 * x + 0.37 * n - 2.0, y + 0.11 * n - 1.0),
     None),
)


def sample_bwd_edges(gen) -> None:
    """K6/K7-bwd's in-kernel paths (SAMPLE_BWD_EDGES) against the plain
    version, relative L2, at B = 2 with Vs = 4 in the batch axis, 37x70
    samples over a 41x66 source (no multiple of a tile), C 8, 12 (padded) and
    32, float32 and bf16 cotangents; each case also asserts the kernel's own
    count where it names one."""
    from adamvs_tpu_torch.ops import warp_sample as ws

    Bt, h, w, H, W = 2 * 4, 37, 70, 41, 66
    y, x = torch.meshgrid(torch.arange(h, device=DEV, dtype=torch.float32),
                          torch.arange(w, device=DEV, dtype=torch.float32), indexing="ij")
    for name, N, at, want in SAMPLE_BWD_EDGES:
        uv = [at(x, y, float(n)) for n in range(N)]
        u = torch.stack([a for a, _ in uv])[None].repeat(Bt, 1, 1, 1)
        v = torch.stack([b for _, b in uv])[None].repeat(Bt, 1, 1, 1)
        # a jitter below 1/100 pixel per view and batch, the walk's tap set kept
        u = (u + 0.004 * torch.rand(u.shape, generator=gen, device=DEV) * (u > -1e8)).contiguous()
        for C in (8, 12, 32):
            for dtype, tn in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                g = torch.randn((Bt, N, h, w, C), generator=gen, device=DEV).to(dtype)
                stats = torch.zeros(2, dtype=torch.int32, device=DEV)
                got = ws.sample_bilinear_bwd(g, u, v, H, W, stats=stats)
                _compare_l2(f"K6/7-bwd edge {name} N{N} C{C} {tn}", ("K6/7-bwd", dtype), got,
                            ws.sample_bilinear_bwd_ref(g, u, v, H, W))
                n0, n1 = stats.tolist()
                if want == "direct" and n1 == 0:
                    fail(f"K6/7-bwd edge {name}: no tile took the direct path ({n0} tiles)")
                if isinstance(want, float) and n1 > want * n0:
                    fail(f"K6/7-bwd edge {name}: {n1} flushes over {n0} samples, limit {want}")
                if want is not None:
                    log(f"[kernels] K6/7-bwd edge {name} N{N} C{C} {tn}: the kernel's counts "
                        f"{n0} {n1}")


def phase_sweep_windows() -> None:
    """K2, K4, K5-fused and K5-var (the tiled kernels) against their plain
    versions at small shapes, float32 and
    bfloat16, channels 8/16/32, batch 2, D 11, rotated views: under a blocky
    hypothesis window (4x6 cells of depth 40-120, nearest-upsampled, 38x54),
    whose source windows straddle depth edges and are staged in shared
    memory; and at 64x200 under a random per-pixel window reaching behind the
    camera with an x and y baseline, whose windows exceed the block's shared
    memory, so that the kernels' direct-gather branch runs (and K5's direct
    scatter). Fails unless the kernels' own counts show direct windows in
    every wide case."""
    from adamvs_tpu_torch.ops import sweep_fuse as sf

    gen = torch.Generator(device=DEV).manual_seed(5)
    B, Vs, D = 2, 3, 11
    for case, (h, w) in (("blocky", (38, 54)), ("wide", (64, 200))):
        projs = torch.from_numpy(bench_projs(h, w, Vs + 1, 60.0)["stage3"]).to(DEV)
        if case == "wide":
            projs[1:, 1, 3] = 60.0 * 5.0 * torch.arange(1, Vs + 1, device=DEV)
        projs[1:, :3, :3] += 0.02 * torch.randn((Vs, 3, 3), generator=gen, device=DEV)
        ref_proj = projs[:1].expand(B, 4, 4).contiguous()
        src_projs = projs[1:, None].expand(Vs, B, 4, 4).contiguous()
        if case == "blocky":
            coarse = 40.0 + 80.0 * torch.rand((B, 1, 4, 6), generator=gen, device=DEV)
            lo = F.interpolate(coarse, size=(h, w), mode="nearest")[:, 0].contiguous()
        else:
            lo = -2.0 + 32.0 * torch.rand((B, h, w), generator=gen, device=DEV)
        step = 0.5 + torch.rand((B, h, w), generator=gen, device=DEV)
        geo = (src_projs, ref_proj, lo, step, D)
        with torch.no_grad():
            for C in (8, 16, 32):
                ref = torch.randn((B, h, w, C), generator=gen, device=DEV)
                srcs = torch.randn((Vs, B, h, w, C), generator=gen, device=DEV)
                wts = torch.rand((B, Vs, h, w), generator=gen, device=DEV)
                wn = sf.normalize_weights(wts)
                for dtype, tn in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                    r, s = ref.to(dtype), srcs.to(dtype)
                    g = torch.randn((D, B, C, h, w), generator=gen, device=DEV).to(dtype)
                    for k, kern, plain in (
                            ("K2", lambda st: sf.fused_sweep_volume(r, s, wts, *geo, stats=st),
                             lambda: sf.fused_volume_ref(r, s, wts, *geo)),
                            ("K4", lambda st: sf.var_sweep_volume(r, s, *geo, stats=st),
                             lambda: sf.var_volume_ref(r, s, *geo)),
                            ("K5-fused",
                             lambda st: sf.fused_sweep_volume_bwd(g, r, s, wn, *geo[:4], stats=st),
                             lambda: sf.fused_volume_vjp(g, r, s, wn, *geo[:4])),
                            ("K5-var", lambda st: sf.var_sweep_volume_bwd(g, r, s, *geo[:4], stats=st),
                             lambda: sf.var_volume_vjp(g, r, s, *geo[:4]))):
                        stats = torch.zeros(2, dtype=torch.int32, device=DEV)
                        got = kern(stats)
                        n, direct = stats.tolist()
                        tag = f"{k} {case} C{C} {tn} ({direct} of {n} windows gathered directly)"
                        if k.startswith("K5"):
                            _compare_grads(tag, (k, dtype), got, plain())
                        else:
                            _compare(tag, (k, dtype), got, plain())
                        if case == "wide" and not direct:
                            fail(f"{k} wide C{C} {tn}: no window took the direct gather")


def _k5_calls(mode: str, g, ref, srcs, wn, geo):
    """(kernel, plain) callables of the K5 backward of ``mode`` ("corr",
    "fused" or "var"); each returns its gradients as a tuple, the kernel's
    taking the wrapper's keyword arguments (``geom``, ``stats``)."""
    from adamvs_tpu_torch.ops import sweep_fuse as sf

    if mode == "corr":
        return (lambda **kw: sf.corr_sweep_volume_bwd(g, ref, srcs, *geo, **kw),
                lambda: sf.corr_volume_vjp(g, ref, srcs, *geo))
    if mode == "fused":
        return (lambda **kw: sf.fused_sweep_volume_bwd(g, ref, srcs, wn, *geo, **kw),
                lambda: sf.fused_volume_vjp(g, ref, srcs, wn, *geo))
    return (lambda **kw: sf.var_sweep_volume_bwd(g, ref, srcs, *geo, **kw),
            lambda: sf.var_volume_vjp(g, ref, srcs, *geo))


def _compare_grads(tag: str, key, got: tuple, want: tuple) -> tuple[float, float]:
    """Each gradient of a K5 call against its plain version; the largest
    (max_abs_err, relative error)."""
    errs = [_compare(f"{tag} d{n}", key, a, b)
            for n, a, b in zip(("ref", "srcs", "weights"), got, want)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def _cotangent(mode: str, st, dtype, gen):
    """A seeded cotangent of the volume of ``mode`` in its layout and dtype:
    corr [Vs,B,D,h,w] float32, fused and var [D,B,C,h,w] in ``dtype``."""
    if mode == "corr":
        return torch.randn((V - 1, 1, st.D, st.h, st.w), generator=gen, device=DEV)
    return torch.randn((st.D, 1, st.C, st.h, st.w), generator=gen, device=DEV).to(dtype)


# K3's float32 form: the eval step's stage shapes (the 384x768 training crop) and the
# full frame's (2752x1856), the latter the shapes of predict --sweep_impl fused
# --reg_impl pallas at the CLI's default float32
K3_F32_FRAMES = (("eval", TRAIN_H, TRAIN_W), ("full", H, W))


def k3_f32_stages(label: str, height: int, width: int, gen, reps: int = 3,
                  variants: dict | None = None) -> list[dict]:
    """K3's float32 form at the three stage shapes of a ``height`` x
    ``width`` frame (stage 1 C32 D48, stage 2 C16 D32, stage 3 C8 D8, base
    8) on K2's float32 volume: against its plain version (``TOL``), its time
    by CUDA events (median of ``reps``), its kernels' time on the card in a
    trace (all of them and by kernel), the plain version's time, and its
    bound by the FMA roof and by the 3xTF32 roof; where the port has
    ``red_scan_plan``, each phase's grid, tile, shared memory and blocks per
    SM. ``variants``: {name: (lib, fn)} entries of text-edited builds of the
    kernel, timed in the same way in turn (CUDA events and the card's busy
    time)."""
    from adamvs_tpu_torch.nn.blocks import init_parameters
    from adamvs_tpu_torch.nn.costreg import AdaRedCell
    from adamvs_tpu_torch.ops import red_scan as rs
    from adamvs_tpu_torch.ops import sweep_fuse as sf

    f32 = torch.float32
    rows = []
    for si in range(3):
        st = StageInputs(si, gen, height, width)
        tag = f"K3 {label} stage{si + 1} f32 {st.h}x{st.w} C{st.C} D{st.D}"
        cell = AdaRedCell(st.C, BASE, st.up)
        init_parameters(cell, torch.Generator().manual_seed(10 + si))
        cell = cell.to(DEV).eval()
        with torch.no_grad():
            vol = sf.fused_sweep_volume(st.ref, st.srcs, st.weights, st.src_projs, st.ref_proj,
                                        st.lo, st.step, st.D)
            kern = lambda: rs.red_scan(cell, vol)
            plain = lambda: rs.red_scan_ref(cell, vol)
            err = _compare(tag, ("K3", f32), kern(), plain())
            ms, pms = time_ms(kern, reps), time_ms(plain, 1)
            busy, top = device_profile(kern, top=16)
            by_kernel = {n: t for n, t, _ in top if re.search(r"phase_[abc]|cell_conv", n)}
            timed = {}
            for name, entry in (variants or {}).items():
                saved = rs._entry
                rs._entry = lambda _, entry=entry: entry
                try:
                    timed[name] = (time_ms(kern, reps), device_busy_ms(kern))
                finally:
                    rs._entry = saved
        fma, tf = red_scan_bound(st, f32, "fma"), red_scan_bound(st, f32, "3xtf32")
        row = {"stage": si + 1, "shape": [st.h, st.w, st.C, st.D], "ms": ms,
               "kernel_ms": sum(by_kernel.values()), "busy_ms": busy, "plain_ms": pms,
               "bound_ms": tf[0], "bound_by": tf[1], "fma_bound_ms": fma[0],
               "fma_bound_by": fma[1], "max_abs_err": err[0], "max_rel_err": err[1],
               "kernels": [[n[:70], t, c] for n, t, c in top if n in by_kernel],
               "variants": timed}
        log(f"[kernels] {tag}: {ms:.3f} ms, its kernels {row['kernel_ms']:.3f} ms on the card "
            f"(all device work {busy:.3f}); plain {pms:.3f} ms; bound {tf[0]:.3f} ms by {tf[1]} "
            f"on the 3xTF32 roof, {fma[0]:.3f} ms by {fma[1]} on the FMA roof")
        log(f"[kernels] {tag} by kernel (ms on the card, launches): "
            + "; ".join(f"{n} {t:.3f} x{c}" for n, t, c in row["kernels"]))
        if hasattr(rs, "red_scan_plan"):
            row["plan"] = rs.red_scan_plan(BASE, st.C, st.up, 1, st.h, st.w)
            log(f"[kernels] {tag} launches per depth step: "
                + "; ".join(f"phase {p['phase']} grid {p['grid'][0]}x{p['grid'][1]}x{p['grid'][2]} "
                            f"= {p['grid'][0] * p['grid'][1] * p['grid'][2]} blocks of tile "
                            f"{p['tile'][0]}x{p['tile'][1]}, {p['smem_bytes']} bytes shared, "
                            f"{p['blocks_per_sm']} blocks per SM" for p in row["plan"]))
        for name, (t, b) in timed.items():
            log(f"[kernels] {tag} {name}: {t:.3f} ms, card busy {b:.3f} ms")
        rows.append(row)
        del st, vol, cell
        torch.cuda.empty_cache()
    tot = {k: sum(r[k] for r in rows) for k in ("ms", "kernel_ms", "plain_ms", "bound_ms",
                                                 "fma_bound_ms")}
    log(f"[kernels] K3 {label} f32, the three stages: {tot['ms']:.3f} ms, its kernels "
        f"{tot['kernel_ms']:.3f} ms (plain {tot['plain_ms']:.3f} ms); 3xTF32 roof "
        f"{tot['bound_ms']:.3f} ms ({tot['ms'] / tot['bound_ms']:.1f}x), FMA roof "
        f"{tot['fma_bound_ms']:.3f} ms ({tot['ms'] / tot['fma_bound_ms']:.2f}x)")
    return rows


def phase_k3_f32(res: dict, reps: int = 3) -> None:
    """K3's float32 form, which the trainer's eval step (the fused AdaMVS
    training paths) and the float32 fused predict path run, at the eval
    step's and at the full frame's stage shapes (``k3_f32_stages``). Kept
    apart from the bf16 rows of the kernels line (``f32_eval_stages``,
    ``f32_full_stages``)."""
    gen = torch.Generator(device=DEV).manual_seed(6)
    for label, height, width in K3_F32_FRAMES:
        res["K3"][f"f32_{label}_stages"] = k3_f32_stages(label, height, width, gen, reps)


def phase_k5(res: dict, reps: int = 3) -> None:
    """K5, each backward mode against its plain version (the autograd VJP of
    the plain volume) at the training stage shapes (384x768 crop, V=5,
    ndepths 48/32/8, base 8: 96x192 C32 D48, 192x384 C16 D32, 384x768 C8
    D8; corr at stage 1 only, as the training path runs it), in float32 with
    TF32 off and in bfloat16, with its float32 times (the training path's
    dtype), the plain version's and the bound. Every call, compared and
    timed, takes the forward's geometry, as the training forms do: ``ms`` by
    CUDA events, beside the kernel's own time in a trace (``kernel_ms``)."""
    from adamvs_tpu_torch.ops.sweep_fuse import normalize_weights, sweep_geometry

    gen = torch.Generator(device=DEV).manual_seed(4)
    for si in range(3):
        st = StageInputs(si, gen, TRAIN_H, TRAIN_W)
        geo = (st.src_projs, st.ref_proj, st.lo, st.step)
        wn = normalize_weights(st.weights)
        geom = sweep_geometry(st.src_projs, st.ref_proj)
        for mode, fwd in (("corr", "K1"), ("fused", "K2"), ("var", "K4")):
            if mode == "corr" and si > 0:
                continue
            k = f"K5-{mode}"
            for dtype in (torch.float32, torch.bfloat16):
                tn = "f32" if dtype == torch.float32 else "bf16"
                ref, srcs = st.feats(dtype)
                g = _cotangent(mode, st, dtype, gen)
                kern, plain = _k5_calls(mode, g, ref, srcs, wn, geo)
                err = _compare_grads(f"{k} stage{si + 1} {tn}", (k, dtype), kern(geom=geom),
                                     plain())
                old = res[k]["err"].get(tn, (0.0, 0.0))
                res[k]["err"][tn] = (max(old[0], err[0]), max(old[1], err[1]))
                if dtype == torch.float32:
                    ms = time_ms(lambda: kern(geom=geom), reps)
                    pms = time_ms(plain, 1)
                    bms, by = sweep_bwd_bound(fwd, st, dtype)
                    # the kernel's own time on the card, from a trace of one call (the wrapper's
                    # zeroing and casts are the rest of ``ms`` where the card waits)
                    _, top = device_profile(lambda: kern(geom=geom), top=8)
                    kms = sum(t for n, t, _ in top if "bwd" in n and "kernel" in n)
                    entry = {"stage": si + 1, "ms": ms, "plain_ms": pms, "bound_ms": bms,
                             "bound_by": by, "kernel_ms": kms}
                    if mode == "corr":
                        entry["flushes_per_sample"] = walk_counts(lambda **kw: kern(geom=geom, **kw))
                    res[k]["stages"].append(entry)
                    log(f"[kernels] {k} stage{si + 1} f32: {ms:.3f} ms with the forward's geometry; "
                        f"the kernel alone {kms:.3f} ms on the card (plain {pms:.3f} ms, bound "
                        f"{bms:.3f} ms by {by})"
                        + (f"; {entry['flushes_per_sample']:.3f} flushes per sample walked "
                           f"(information, no limit)" if mode == "corr" else ""))
                else:  # bf16, as the bf16 train paths call it
                    ms = time_ms(lambda: kern(geom=geom), reps)
                    bms, by = sweep_bwd_bound(fwd, st, dtype)
                    _, top = device_profile(lambda: kern(geom=geom), top=8)
                    kms = sum(t for n, t, _ in top if "bwd" in n and "kernel" in n)
                    res[k]["stages"][-1].update(bf16_ms=ms, bf16_kernel_ms=kms,
                                                bf16_bound_ms=bms, bf16_bound_by=by,
                                                bf16_rel_err=err[1])
                    log(f"[kernels] {k} stage{si + 1} bf16: {ms:.3f} ms with the forward's "
                        f"geometry; the kernel alone {kms:.3f} ms on the card (bound {bms:.3f} ms "
                        f"by {by})")
                del ref, srcs, g
        del st, geo, wn, geom
        torch.cuda.empty_cache()


def phase_reference() -> None:
    """Each path's model on a small frame at base 8 and at base 4, and each
    of REFERENCE_FORMS at base 8, in float32 (the bf16 paths too, so the
    limits hold to float32 rounding): kernels on the card against the plain
    path on the CPU; the precomp forms on the card against the stepped form
    on the CPU."""
    from adamvs_tpu_torch.models import build_model

    h, w = 128, 160
    rng = np.random.RandomState(1)
    imgs = torch.from_numpy(rng.randn(1, V, h, w, 3).astype(np.float32))
    projs = {k: torch.from_numpy(p[None]) for k, p in bench_projs(h, w, V, FOCAL * h / H).items()}
    dv = torch.tensor([[DMIN, DMAX]])
    # base 8 (the main paths'), and base 4, whose stage 3 features have C 4 (the
    # sweeps and the sampler pad them)
    # BASE8_ONLY at base 8 only: at base 4 they run the kernels the other forms run there
    forms = [(p[:3], b) for b in (BASE, 4) for p in PATHS if b == BASE or p[0] not in BASE8_ONLY]
    forms += [(f, BASE) for f in REFERENCE_FORMS]
    for (path, name, opts), base in forms:
        model = build_model(name, seed=1, device=DEV, ndepths=NDEPTHS, base=base,
                            cr_base=(base,) * 3, **opts)
        path = f"{path} base {base}"
        cpu_model = copy.deepcopy(model).cpu()
        if opts.get("reg_impl") == "precomp":
            cpu_model.reg_impl = "scan"  # precomp on the card against the stepped form
        got = model(imgs.to(DEV), {k: p.to(DEV) for k, p in projs.items()}, dv.to(DEV),
                    num_depth=NUM_DEPTH)
        want = cpu_model(imgs, projs, dv, num_depth=NUM_DEPTH)
        for key in ("stage1", "stage2", "stage3"):
            derr = (got[key]["depth"].cpu() - want[key]["depth"]).abs().max().item() / (DMAX - DMIN)
            cerr = (got[key]["photometric_confidence"].cpu()
                    - want[key]["photometric_confidence"]).abs().max().item()
            log(f"[reference] {path} {key}: depth err {derr:.2e} of the range, "
                f"confidence err {cerr:.2e}")
            if not (derr < 1e-4 and cerr < 1e-3):
                fail(f"{path} {key}: kernels on the card disagree with the plain path on the CPU")


def phase_main_path() -> tuple[dict, list]:
    """Every path of PATHS through PredictEngine at full width in its dtype
    (PATH_DTYPE, else bf16), each with all launch counters set to 0 just
    before it and read just after.
    Returns (launches summed over the paths, per-path statistics)."""
    from adamvs_tpu_torch.models import build_model
    from adamvs_tpu_torch.predict.engine import PredictEngine

    sample = _bench_sample()
    counted = wrappers()
    total = dict.fromkeys(KERNELS, 0)
    stats = []
    for path, name, opts, requests, per_map in PATHS:
        t_path = time.perf_counter()
        dtype = PATH_DTYPE.get(path, torch.bfloat16)
        model = build_model(name, seed=0, device=DEV, dtype=dtype, ndepths=NDEPTHS,
                            depth_intervals_ratio=RATIOS, base=BASE, cr_base=(BASE,) * 3, **opts)
        engine = PredictEngine(model, num_depth=NUM_DEPTH, device=DEV)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted.values():
            fn.launches = 0
        times = []
        for i in range(requests):
            t0 = time.perf_counter()
            depth, conf = engine.predict_sample(sample)
            times.append((time.perf_counter() - t0) * 1e3)
            if depth.shape != (H, W) or conf.shape != (H, W):
                fail(f"{path}: output shapes {depth.shape} {conf.shape}")
            if not (np.isfinite(depth).all() and np.isfinite(conf).all()):
                fail(f"{path}: non-finite depth or confidence")
            if not (conf.min() > 0.0 and conf.max() <= 1.0):
                fail(f"{path}: confidence outside (0, 1]: [{conf.min()}, {conf.max()}]")
            log(f"[main] {path} request {i}: {times[-1]:.1f} ms, depth [{depth.min():.1f}, "
                f"{depth.max():.1f}], confidence [{conf.min():.3f}, {conf.max():.3f}]")
        launches = {k: fn.launches for k, fn in counted.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        for k, n in launches.items():
            if n != requests * per_map.get(k, 0):
                fail(f"{path}: {k} launched {n} times over {requests} requests, expected "
                     f"{requests * per_map.get(k, 0)}")
            total[k] += n
        # one more request, traced, after the counts were read: the card's busy time in
        # it (and for the scan form, whose layers are not timed alone, its top kernels)
        scan = name == "adamvs" and opts.get("sweep_impl") == "scan"
        busy, top = device_profile(lambda: engine.predict_sample(sample), top=8 if scan else 0)
        if scan:
            layers = {}
            log(f"[main] {path} top kernels of the traced request (ms on the card, launches): "
                + "; ".join(f"{k} {ms:.2f} x{n}" for k, ms, n in top))
        elif path == "adamvs":
            layers = layer_times(model, sample)
        elif name == "adamvs":
            layers = {}  # the regulariser forms beside adamvs: the same layers around them
        else:
            layers = msrednet_layer_times(model, opts)
        entry = {"path": path, "dtype": str(dtype), "ms_per_map": statistics.mean(times[1:]),
                 "timed_ms": times[1:], "warmup_ms": times[0], "peak_gib": peak,
                 "launches": launches, "device_busy_ms": busy, "layers_ms": layers,
                 "top_kernels": top}
        stats.append(entry)
        log(f"[main] {path} {H}x{W} V={V} ndepths {NDEPTHS} {dtype}: {entry['ms_per_map']:.1f} ms "
            f"per depth map (timed {', '.join(f'{t:.1f}' for t in times[1:])}; warm-up "
            f"{times[0]:.1f}), peak {peak:.2f} GiB, launches {launches}, card busy in a traced "
            f"request {busy:.1f} ms ({busy / entry['ms_per_map']:.0%} of the mean)")
        del model, engine
        torch.cuda.empty_cache()
        log(f"[time] {path}: {time.perf_counter() - t_path:.1f} s")
    return total, stats


def train_batch(height: int, width: int, batch: int = 1) -> dict:
    """The bench's training batch (bench.py:191-212) as numpy arrays:
    seeded images, the bench geometry, depth values [B,3] = [300, 500,
    200/192], a uniform random GT pyramid at 1/4, 1/2 and 1/1 of the frame
    and all-ones masks."""
    rng = np.random.RandomState(0)
    interval = (DMAX - DMIN) / NUM_DEPTH
    gt = np.random.RandomState(3).uniform(320, 480, (batch, height, width)).astype(np.float32)
    depth = {"stage1": gt[:, ::4, ::4], "stage2": gt[:, ::2, ::2], "stage3": gt}
    return {
        "imgs": rng.randn(batch, V, height, width, 3).astype(np.float32),
        "proj_matrices": {k: np.repeat(p[None], batch, 0)
                          for k, p in bench_projs(height, width, V, FOCAL).items()},
        "depth_values": np.array([[DMIN, DMAX, interval]] * batch, np.float32),
        "depth": depth,
        "mask": {k: np.ones_like(v) for k, v in depth.items()},
        "depth_interval": np.full((batch,), interval, np.float32),
    }


def _train_model(name: str, opts: dict, seed: int, device):
    from adamvs_tpu_torch.models import build_model

    return build_model(name, seed=seed, device=device, ndepths=NDEPTHS,
                       depth_intervals_ratio=RATIOS, base=BASE, cr_base=(BASE,) * 3, **opts)


class ReluReplay(torch.overrides.TorchFunctionMode):
    """While active, watches every ``F.relu`` call. Recording (the card's
    run), it lets the real ``F.relu`` run and keeps its decisions (x > 0) in
    call order; replaying (the CPU's run), it computes each call as
    ``where(mask, x, 0)`` with the recorded mask.

    A ReLU whose input lies within float32 rounding of 0 can fall on opposite
    sides on the card (cuDNN) and on the CPU. The loss barely moves, but the
    gradient jumps: at a 128x160 frame a few such flips, some in layers of a
    few dozen pixels, move the whole gradient by ~1e-2. Replaying the card's
    decisions on the CPU puts both runs on the same piecewise-linear branch,
    so the gradients compare to float32 rounding. ``flips`` counts the
    decisions the CPU would have taken otherwise: rounding flips a few per
    million, so more than ``MAX_FLIPS`` of them means the two forwards
    differ beyond rounding."""

    MAX_FLIPS = 1e-5  # of the decisions

    def __init__(self, masks=None):
        super().__init__()
        self.replay = masks is not None
        self.masks, self.flips, self.calls = masks if self.replay else [], 0, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not F.relu:
            return func(*args, **kwargs)
        x = args[0]
        if not self.replay:
            self.masks.append((x > 0).cpu())
            self.calls += 1
            return func(*args, **kwargs)
        if self.calls >= len(self.masks):
            fail(f"the CPU made more ReLU calls than the {len(self.masks)} recorded on the card")
        mask = self.masks[self.calls].to(x.device)
        self.calls += 1
        self.flips += int((mask != (x > 0)).sum())
        return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))


class BranchReplay(ReluReplay):
    """``ReluReplay`` that replays ``torch.floor`` too: the card's floors of
    the sample positions in ``ops/warp.py::bilinear_sample`` (the deformable
    taps) are handed to the CPU, so a position within float32 rounding of an
    integer takes the same cell of the bilinear interpolation on both: the
    sample is continuous there, its gradient by the position is not.
    ``flips`` counts both kinds of decisions the CPU would have taken
    otherwise."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is not torch.floor:
            return super().__torch_function__(func, types, args, kwargs)
        out = func(*args, **(kwargs or {})).detach()  # the floor has no gradient
        if not self.replay:
            self.masks.append(out.cpu())
            self.calls += 1
            return out
        if self.calls >= len(self.masks):
            fail(f"the CPU made more decisions than the {len(self.masks)} recorded on the card")
        want = self.masks[self.calls].to(out.device)
        self.calls += 1
        self.flips += int((want != out).sum())
        return want


def phase_train_reference() -> None:
    """One train step of each path of TRAIN_PATHS (each model in its fused
    and scan forms) on a 128x160 frame: the card (K1/K2/K4 forward, K5
    backward; the scan forms K6/K7 and K6/K7-bwd) against the plain path on
    the CPU, float32, TF32 off, the CPU replaying the card's ReLU decisions
    (``ReluReplay``).
    Limits: loss within 1e-4 relative, the whole gradient within 1e-3
    relative L2, BatchNorm statistics within 1e-4 (relative, absolute below
    1), the CPU's own decisions differing from the card's in at most
    ``ReluReplay.MAX_FLIPS`` of them."""
    from adamvs_tpu_torch.models import model_loss
    from adamvs_tpu_torch.train.loop import to_device

    batch = train_batch(128, 160)
    for path, name, opts, *_ in TRAIN_PATHS:
        if "compute_dtype" in opts:
            continue  # the bf16 paths: phase_train_reference_bf16
        cpu = _train_model(name, opts, 1, "cpu")
        results = []
        record = ReluReplay()
        replay = ReluReplay(record.masks)
        for model, dev, mode in ((copy.deepcopy(cpu).to(DEV), torch.device(DEV), record),
                                 (cpu, torch.device("cpu"), replay)):
            model.train()
            b = to_device(batch, dev)
            with mode:
                out = model(b["imgs"], b["proj_matrices"], b["depth_values"], train=True)
                loss, _ = model_loss(name)(out, b["depth"], b["mask"], DLOSSW)
            loss.backward()
            grads = torch.cat([p.grad.flatten().cpu() for p in model.parameters()])
            stats = torch.cat([t.flatten().cpu() for n, t in model.named_buffers()
                               if n.endswith(("running_mean", "running_var"))])
            results.append((float(loss.detach()), grads, stats))
        (lg, gg, sg), (lc, gc, sc) = results
        lerr = abs(lg - lc) / abs(lc)
        gerr = float((gg - gc).norm() / gc.norm())
        serr = float(((sg - sc).abs() / sc.abs().clamp(min=1.0)).max())
        decisions = sum(m.numel() for m in record.masks)
        flip_share = replay.flips / max(decisions, 1)
        log(f"[reference] {path} 128x160: loss {lg:.6f} card vs {lc:.6f} cpu, rel err "
            f"{lerr:.2e} (limit 1e-4); gradient rel L2 {gerr:.2e} (limit 1e-3); BatchNorm "
            f"statistics err {serr:.2e} (limit 1e-4); the CPU took {replay.flips} of "
            f"{decisions} ReLU decisions from the card, {flip_share:.1e} (limit "
            f"{ReluReplay.MAX_FLIPS:.0e})")
        if replay.calls != record.calls or not decisions:
            fail(f"{path}: {record.calls} ReLU calls on the card, {replay.calls} on the CPU")
        if not (lerr < 1e-4 and gerr < 1e-3 and serr < 1e-4
                and flip_share <= ReluReplay.MAX_FLIPS):
            fail(f"{path}: the card's train step disagrees with the plain path on the CPU")


def _module_of(param: str) -> str:
    """The top-level module of a parameter: ``feature``, AdaMVS's
    ``DepthNet.i.reg`` and ``DepthNet.i.reg_fuse``, MS-REDNet's
    ``cost_regularization.i``."""
    parts = param.split(".")
    return ".".join(parts[:3] if parts[0] == "DepthNet" else
                    parts[:2] if parts[0] == "cost_regularization" else parts[:1])


def _bf16_step(model, dev: str, batch, name: str, mode) -> tuple[float, dict, torch.Tensor]:
    """(loss, {parameter: float32 gradient on the CPU}, BatchNorm statistics)
    of one train step of ``model`` on ``dev`` under the ReLU ``mode``."""
    from adamvs_tpu_torch.models import model_loss
    from adamvs_tpu_torch.train.loop import to_device

    model.train()
    b = to_device(batch, torch.device(dev))
    with mode:
        out = model(b["imgs"], b["proj_matrices"], b["depth_values"], train=True)
        loss, _ = model_loss(name)(out, b["depth"], b["mask"], DLOSSW)
    loss.backward()
    grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
    if not all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters()):
        fail(f"{name} bf16 step: parameters or gradients not float32")
    stats = torch.cat([t.flatten().float().cpu() for n, t in model.named_buffers()
                       if n.endswith(("running_mean", "running_var"))])
    return float(loss.detach()), grads, stats


def _rel_l2(a: dict, b: dict, keys) -> float:
    x = torch.cat([a[k].flatten().double() for k in keys])
    y = torch.cat([b[k].flatten().double() for k in keys])
    return float((x - y).norm() / y.norm())


def phase_train_reference_bf16() -> list:
    """One bf16 train step (float32 master weights) of each path of
    TRAIN_REFERENCE_BF16 on a 128x160 frame, the card against the plain path
    on the CPU, the CPU replaying the card's ReLU decisions. A bf16 gradient
    is chaotic (multiplying the float32 weights by 1 + 2^-22 n, about 4
    float32 steps, moves it by tenths in the feature net), so each top-level
    module's gradient is held within twice its noise: the largest distance
    over 3 such draws on the CPU against the CPU's step (all on the card's
    ReLU branch). Limits: that; the whole gradient, the card's bf16 against
    the CPU's float32, within 1.5 times the CPU's own bf16-vs-float32
    distance; the loss within 2e-3 relative; BatchNorm statistics within
    max(2 max|CPU bf16 - CPU float32|, 1e-3). The share of ReLU decisions
    the CPU took from the card is reported. Returns the per-path records."""
    batch = train_batch(128, 160)
    records = []
    for path, name, opts, *_ in TRAIN_PATHS:
        if path not in TRAIN_REFERENCE_BF16:
            continue
        t0 = time.perf_counter()
        cpu = _train_model(name, opts, 1, "cpu")
        record = ReluReplay()
        lg, gg, sg = _bf16_step(copy.deepcopy(cpu).to(DEV), DEV, batch, name, record)
        replay = ReluReplay(record.masks)
        lc, gc, sc = _bf16_step(copy.deepcopy(cpu), "cpu", batch, name, replay)
        f32 = copy.deepcopy(cpu)
        f32.compute_dtype = torch.float32
        l32, g32, s32 = _bf16_step(f32, "cpu", batch, name, ReluReplay(record.masks))
        noise = []
        for draw in range(3):
            jit = copy.deepcopy(cpu)
            gen = torch.Generator().manual_seed(draw)
            with torch.no_grad():
                for p in jit.parameters():
                    p.mul_(1 + 2.0 ** -22 * torch.randn(p.shape, generator=gen))
            noise.append(_bf16_step(jit, "cpu", batch, name, ReluReplay(record.masks))[1])
        modules = sorted({_module_of(n) for n in gg})
        rows, ok = [], True
        for m in modules:
            keys = [n for n in gg if _module_of(n) == m]
            err = _rel_l2(gg, gc, keys)
            ncpu = max(_rel_l2(d, gc, keys) for d in noise)
            ok = ok and err <= 2 * ncpu
            rows.append({"module": m, "err": err, "noise_cpu": ncpu, "limit": 2 * ncpu,
                         "bf16_vs_f32_cpu": _rel_l2(gc, g32, keys)})
        lerr = abs(lg - lc) / abs(lc)
        serr, slimit = (sg - sc).abs().max().item(), max(2 * (sc - s32).abs().max().item(), 1e-3)
        decisions = sum(m.numel() for m in record.masks)
        flip_share = replay.flips / max(decisions, 1)
        whole = _rel_l2(gc, g32, list(gg))
        card_whole = _rel_l2(gg, g32, list(gg))
        log(f"[reference] {path} 128x160 bf16, float32 master weights: loss {lg:.6f} card vs "
            f"{lc:.6f} cpu, rel err {lerr:.2e} (limit 2e-3; the CPU's float32 step {l32:.6f}); "
            f"BatchNorm statistics err {serr:.2e} (limit {slimit:.2e}); the CPU took "
            f"{replay.flips} of {decisions} ReLU decisions from the card ({flip_share:.1e}, "
            f"information); the whole gradient, card's bf16 vs the CPU's float32, "
            f"{card_whole:.3f} relative L2 (limit 1.5 x {whole:.3f}, the CPU's bf16 vs its "
            f"float32); {time.perf_counter() - t0:.1f} s")
        for r in rows:
            log(f"[reference] {path} {r['module']}: gradient card vs cpu {r['err']:.4f} relative "
                f"L2, noise on the cpu {r['noise_cpu']:.4f}, limit {r['limit']:.4f}; cpu bf16 vs "
                f"f32 {r['bf16_vs_f32_cpu']:.4f}")
        if replay.calls != record.calls or not decisions:
            fail(f"{path}: {record.calls} ReLU calls on the card, {replay.calls} on the CPU")
        if not (ok and card_whole <= 1.5 * whole and lerr <= 2e-3 and serr <= slimit):
            fail(f"{path}: the card's bf16 train step disagrees with the plain path on the CPU")
        records.append({"path": path, "loss_rel_err": lerr, "stats_err": serr,
                        "stats_limit": slimit, "relu_flip_share": flip_share,
                        "bf16_vs_f32_cpu": whole, "card_bf16_vs_f32_cpu": card_whole,
                        "modules": rows})
        del cpu, f32, noise
        torch.cuda.empty_cache()
    return records


def phase_train_paths() -> tuple[dict, list]:
    """Every path of TRAIN_PATHS through the Trainer on the bench's training
    batch (384x768, V=5, ndepths 48/32/8, base 8, batch 1, RMSprop lr 1e-3;
    float32, or bf16 compute with float32 master weights): a warm-up step and
    the timed steps, then one eval_epoch on the batch (K1-K3 or K4 in the
    path's compute dtype), with all launch counters set to 0 just before and
    read just after; the parameters and the optimizer's state must still be
    float32; then one more, traced, train step for the card's busy time and
    its top kernels, and one more timed by phase. Returns (launches summed
    over the paths, per-path statistics)."""
    from adamvs_tpu_torch.models import model_loss
    from adamvs_tpu_torch.train.loop import Trainer
    from adamvs_tpu_torch.train.state import create_train_state, make_optimizer

    batch = train_batch(TRAIN_H, TRAIN_W)
    counted = wrappers()
    total = dict.fromkeys(KERNELS, 0)
    stats = []
    # the Trainer's records go to the port's build directory, which git ignores
    logroot = os.path.join(REPO, "adamvs_tpu_torch", "_build", "chip_smoke_train")
    shutil.rmtree(logroot, ignore_errors=True)
    for path, name, opts, steps, per_step, per_eval in TRAIN_PATHS:
        t_path = time.perf_counter()
        model = _train_model(name, opts, 0, DEV)
        state = create_train_state(model, make_optimizer(model.parameters(), lr=1e-3))
        trainer = Trainer(state, model_loss(name), os.path.join(logroot, path), dlossw=DLOSSW,
                          num_stages=3, ckpt_step_freq=0, log_fn=lambda m: None, device=DEV)
        before = {k: t.detach().clone() for k, t in model.state_dict().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted.values():
            fn.launches = 0
        times = []
        for i in range(steps):
            t0 = time.perf_counter()
            loss = trainer.train_epoch(0, [batch])["loss"]  # ends on the loss's copy to the host
            times.append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(loss):
                fail(f"{path}: non-finite loss {loss} at step {i}")
            log(f"[main] {path} step {i}: {times[-1]:.1f} ms, loss {loss:.4f}")
        if state.nan_steps != 0 or state.step != steps:
            fail(f"{path}: {state.nan_steps} skipped of {state.step} steps")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = trainer.eval_epoch(0, [batch])  # ends on the metrics' copy to the host
        eval_ms = (time.perf_counter() - t0) * 1e3
        if not all(np.isfinite(x) for x in val.values()):
            fail(f"{path}: non-finite eval metrics {val}")
        launches = {k: fn.launches for k, fn in counted.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        for k, n in launches.items():
            want = steps * per_step.get(k, 0) + per_eval.get(k, 0)
            if n != want:
                fail(f"{path}: {k} launched {n} times over {steps} train steps and one eval, "
                     f"expected {want}")
            total[k] += n
        after = model.state_dict()
        params = [k for k, _ in model.named_parameters()]
        bn = [k for k in after if k.endswith(("running_mean", "running_var"))]
        moved = sum(not torch.equal(before[k], after[k]) for k in params)
        if moved < 0.9 * len(params) or not all(not torch.equal(before[k], after[k]) for k in bn):
            fail(f"{path}: {moved} of {len(params)} parameters moved, BatchNorm statistics "
                 f"{'moved' if bn else 'absent'}")
        if not all(p.dtype == torch.float32 for p in model.parameters()):
            fail(f"{path}: parameters are not float32 after training")
        opt_state = [t for st_ in state.optimizer.state.values() for t in st_.values()
                     if torch.is_tensor(t) and t.is_floating_point()]
        if not all(t.dtype == torch.float32 for t in opt_state):
            fail(f"{path}: optimizer state is not float32")
        busy, top = device_profile(lambda: trainer.train_epoch(0, [batch]), top=10)
        entry = {"path": path, "ms_per_step": statistics.mean(times[1:]),
                 "median_ms": statistics.median(times[1:]), "timed_ms": times[1:],
                 "warmup_ms": times[0], "peak_gib": peak, "launches": launches,
                 "device_busy_ms": busy, "top_kernels": top, "params_moved": moved,
                 "params": len(params), "eval": val, "eval_ms": eval_ms,
                 "phases_ms": train_phase_times(state, model_loss(name), batch)}
        stats.append(entry)
        dt = "bf16 (float32 master weights)" if "compute_dtype" in opts else "f32"
        log(f"[main] {path} {TRAIN_H}x{TRAIN_W} V={V} ndepths {NDEPTHS} {dt} "
            f"{ {k: v for k, v in opts.items() if k != 'compute_dtype'} }: "
            f"{entry['ms_per_step']:.1f} ms per train step (median {entry['median_ms']:.1f}; timed "
            f"{', '.join(f'{t:.1f}' for t in times[1:])}; warm-up {times[0]:.1f}), peak "
            f"{peak:.2f} GiB, {moved} of {len(params)} parameters and all {len(bn)} BatchNorm "
            f"statistics moved, launches {launches}, card busy in a traced step {busy:.1f} ms "
            f"({busy / entry['ms_per_step']:.0%} of the mean); eval step {eval_ms:.1f} ms, "
            f"abs_depth_error {val['abs_depth_error']:.3f}, loss {val['loss']:.4f}")
        log(f"[main] {path} one step by phase (ms): "
            + ", ".join(f"{k} {v:.1f}" for k, v in entry["phases_ms"].items()))
        log(f"[main] {path} top kernels of the traced step (ms on the card, launches): "
            + "; ".join(f"{n} {ms:.2f} x{c}" for n, ms, c in top))
        del model, state, trainer
        torch.cuda.empty_cache()
        log(f"[time] {path}: {time.perf_counter() - t_path:.1f} s")
    return total, stats


# The predict command's fixture: 6 aerial frames at the raw size that the CLI's
# defaults (--resize_scale 0.5 --max_h 5504 --max_w 3712) take to the main paths'
# 2752x1856, with the bench's focal length before the resize, a 10 m baseline and
# depths of about 330-470 m; every view is a reference once, with 4 sources.
CLI_VIEWS, CLI_RAW = 6, (2 * H, 2 * W)
CLI_FUSED = ["--sweep_impl", "fused", "--reg_impl", "pallas", "--compute_dtype", "bf16"]
# (run, flags, launches per forward)
CLI_RUNS = (
    ("defaults", [], {"K6/7": SCAN_STEP["adamvs"]}),
    ("fused_bf16", CLI_FUSED, {"K1": 1, "K2": 3, "K3": 3}),
    ("fused_bf16_cache_batch", CLI_FUSED + ["--feature_cache", "8", "--predict_batch", "2"],
     {"K1": 1, "K2": 3, "K3": 3}),
)


def cli_fixture(root: str) -> tuple[str, float]:
    """(the predict-source tree written under ``root``, its depth range)."""
    from adamvs_tpu_torch.data.synthetic import make_scene, write_predict_source_tree

    workers = min(8, os.cpu_count() or 1)
    t0 = time.perf_counter()
    scene = make_scene(num_views=CLI_VIEWS, height=CLI_RAW[0], width=CLI_RAW[1], seed=0,
                       focal=2 * FOCAL, fly_height=400.0, plane=(0.2, -0.16, 0.0),
                       baseline=10.0, tilt=0.025, workers=workers)
    t1 = time.perf_counter()
    tree = write_predict_source_tree(os.path.join(root, "source"), scene, workers=workers)
    log(f"[cli] fixture: {CLI_VIEWS} views {CLI_RAW[0]}x{CLI_RAW[1]}, depths "
        f"[{scene.depth_start}, {scene.depth_end}], rendered in {t1 - t0:.1f} s, PNGs written "
        f"in {time.perf_counter() - t1:.1f} s")
    return tree, scene.depth_end - scene.depth_start


def phase_cli(tmp: str, tree: str, depth_range: float) -> tuple[dict, list]:
    """The port's predict command (``adamvs_tpu_torch.cli.main``) in this
    process on the synthetic tree ``tree`` of CLI_VIEWS frames (``cli_fixture``,
    its outputs under ``tmp``), once per CLI_RUNS: the
    JAX CLI's defaults (AdaMVS scan form, float32), the fused bf16 form, and
    that form with the feature cache and batches of 2. Each run has every
    launch counter set to 0 just before it and read just after; its files are
    checked (layout, 2752x1856 finite maps, confidence in (0, 1], the camera
    text), the cached run against the uncached one, and the cache's hits.
    Returns (launches summed over the runs, per-run statistics)."""
    import contextlib
    import io

    from adamvs_tpu_torch.cli import main as cli_main
    from adamvs_tpu_torch.io.pfm import read_pfm

    counted = wrappers()
    total = dict.fromkeys(KERNELS, 0)
    stats = []
    names = [f"view_{i:03d}" for i in range(CLI_VIEWS)]
    want = [f"{n}{suffix}" for n in names
            for suffix in ("_init.pfm", "_prob.pfm", ".jpg", ".txt")]
    want += [f"color/{n}{suffix}" for n in names for suffix in ("_init.png", "_prob.png")]
    maps = {}
    for run, flags, per_forward in CLI_RUNS:
        out = os.path.join(tmp, run)
        argv = ["predict", "--data_folder", tree, "--output_folder", out, "--device", DEV,
                *flags]
        for fn in counted.values():
            fn.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            engine = cli_main(argv)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counted.items()}
        lines = [ln for ln in buf.getvalue().splitlines() if " done: " in ln]
        for ln in lines:
            log(f"[cli] {run}: {ln}")
        per_item = [tuple(float(x) for x in re.search(r"([\d.]+)s infer, ([\d.]+)s save",
                                                      ln).groups()) for ln in lines]
        if len(per_item) != CLI_VIEWS:
            fail(f"cli {run}: {len(per_item)} work items logged, expected {CLI_VIEWS}")
        batch = int(flags[flags.index("--predict_batch") + 1]) if "--predict_batch" in flags else 1
        forwards = -(-CLI_VIEWS // batch)
        for k, n in launches.items():
            if n != forwards * per_forward.get(k, 0):
                fail(f"cli {run}: {k} launched {n} times in {forwards} forwards, expected "
                     f"{forwards * per_forward.get(k, 0)}")
            total[k] += n
        files = sorted(os.path.relpath(os.path.join(d, f), out)
                       for d, _, fs in os.walk(out) for f in fs)
        if files != sorted(os.path.join("1", f) for f in want):
            fail(f"cli {run}: output files {files}")
        run_maps = {}
        for n in names:
            depth = read_pfm(os.path.join(out, "1", f"{n}_init.pfm"))[0]
            prob = read_pfm(os.path.join(out, "1", f"{n}_prob.pfm"))[0]
            if depth.shape != (H, W) or prob.shape != (H, W):
                fail(f"cli {run} {n}: maps {depth.shape} {prob.shape}, expected {(H, W)}")
            if not (np.isfinite(depth).all() and np.isfinite(prob).all()):
                fail(f"cli {run} {n}: non-finite depth or confidence")
            if not (prob.min() > 0.0 and prob.max() <= 1.0):
                fail(f"cli {run} {n}: confidence outside (0, 1]: [{prob.min()}, {prob.max()}]")
            with open(os.path.join(out, "1", f"{n}.txt")) as f:
                if not f.read().startswith("extrinsic: XrightYdown"):
                    fail(f"cli {run} {n}: camera text does not start with its header")
            run_maps[n] = (depth, prob)
        entry = {"run": run, "flags": flags, "wall_s": wall, "items": CLI_VIEWS,
                 "infer_s": [t[0] for t in per_item], "save_s": [t[1] for t in per_item],
                 "launches": launches}
        if engine.feature_cache:
            lookups = engine.cache_hits + engine.cache_misses
            entry["cache"] = {"hits": engine.cache_hits, "misses": engine.cache_misses}
            if lookups != CLI_VIEWS * V or engine.cache_hits < lookups - CLI_VIEWS:
                fail(f"cli {run}: feature cache {engine.cache_hits} hits of {lookups} "
                     f"lookups, expected at least {CLI_VIEWS * V - CLI_VIEWS} of "
                     f"{CLI_VIEWS * V}")
            base = maps["fused_bf16"]
            derr = max(np.abs(run_maps[n][0] - base[n][0]).max() for n in names) / depth_range
            cerr = max(np.abs(run_maps[n][1] - base[n][1]).max() for n in names)
            entry.update(depth_err=float(derr), conf_err=float(cerr))
            log(f"[cli] {run} against fused_bf16: depth err {derr:.2e} of the range (limit "
                f"1e-4), confidence err {cerr:.2e} (limit 1e-3)")
            if not (derr < 1e-4 and cerr < 1e-3):
                fail(f"cli {run}: the cached, batched run disagrees with the uncached one")
        maps[run] = run_maps
        shutil.rmtree(out)
        stats.append(entry)
        cache = (f", feature cache {entry['cache']['hits']} hits of "
                 f"{CLI_VIEWS * V} lookups" if "cache" in entry else "")
        log(f"[cli] {run} ({' '.join(flags) or 'the JAX CLI defaults'}): {CLI_VIEWS} work "
            f"items in {wall:.1f} s wall; per item infer {statistics.mean(entry['infer_s']):.3f}"
            f" s (first {entry['infer_s'][0]:.3f}), save {statistics.mean(entry['save_s']):.3f}"
            f" s; launches {launches}; files, shapes and values ok{cache}")
        del engine
        torch.cuda.empty_cache()
    return total, stats


HOST_IO_REPS = 3  # decodes of each fixture frame per reader, for the medians


def _host_ms(fn, *args):
    """(result, host milliseconds) of one call."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, 1e3 * (time.perf_counter() - t0)


def phase_host_io(tree: str) -> dict:
    """The host library (``csrc/host/``, built by phase_build) on the CLI
    fixture's CLI_VIEWS PNG frames (5504x3712 RGB): its PNG decode against
    PIL's, bit for bit, and the median milliseconds per frame of each on this
    machine's host (HOST_IO_REPS decodes a frame, the two readers in turns);
    the EXR depth of a 2752x1856 map written by the port's codec in each
    compression (float32, and float16 zip), against the port's Python codec
    bit for bit; ``center_image`` against the pipeline's formula in float64
    (within 1e-4; the pipeline's own float32 numpy version loses ~1e-1 to its
    float32 sums at this size, printed) and ``resize_bilinear`` against OpenCV at the predict
    pipeline's halving (|Δ| <= 1, at least 97 % exact), each timed once.
    Returns the figures."""
    import glob

    import cv2
    from PIL import Image

    from adamvs_tpu_torch.data.pipeline import center_image
    from adamvs_tpu_torch.io import exr, native

    def pil_png(path):
        with Image.open(path) as im:
            return np.array(im.convert("RGB"))

    frames = sorted(glob.glob(os.path.join(tree, "images", "*.png")))
    if len(frames) != CLI_VIEWS:
        fail(f"host_io: {len(frames)} fixture frames, expected {CLI_VIEWS}")
    ms = {"native": [], "pil": []}
    for path in frames:
        for _ in range(HOST_IO_REPS):
            got, t = _host_ms(native.read_png, path)
            ms["native"].append(t)
            want, t = _host_ms(pil_png, path)
            ms["pil"].append(t)
        if got.shape != (*CLI_RAW, 3) or got.dtype != np.uint8 or not np.array_equal(got, want):
            fail(f"host_io: the native PNG decode of {path} differs from PIL's "
                 f"({got.shape} {got.dtype})")
    out = {"frame": [*CLI_RAW, 3], "frames": len(frames), "reps": HOST_IO_REPS,
           "png_native_ms": statistics.median(ms["native"]),
           "png_pil_ms": statistics.median(ms["pil"])}
    log(f"[host_io] PNG {CLI_RAW[0]}x{CLI_RAW[1]} RGB, {len(frames)} frames x {HOST_IO_REPS}: "
        f"native {out['png_native_ms']:.1f} ms, PIL {out['png_pil_ms']:.1f} ms per frame "
        f"(median; min {min(ms['native']):.1f} / {min(ms['pil']):.1f}); bit-equal ok")

    img = got
    gen = np.random.RandomState(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = (DMIN + 0.3 * xx - 0.2 * yy + gen.rand(H, W) * 5).astype(np.float32)
    out["exr"] = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_exr_") as tmp:
        for compression, dtype in (("none", np.float32), ("zips", np.float32),
                                   ("zip", np.float32), ("zip", np.float16)):
            path = os.path.join(tmp, f"depth_{compression}.exr")
            exr.write_exr(path, {"Z": depth.astype(dtype)}, compression=compression)
            got, t_native = _host_ms(native.read_exr_depth, path)
            want, t_py = _host_ms(exr.read_exr_depth, path)
            if not (np.array_equal(got, want) and np.array_equal(got, depth.astype(dtype))):
                fail(f"host_io: the native EXR depth ({compression}, {np.dtype(dtype).name}) "
                     f"differs from the Python codec's")
            key = f"{compression}_{np.dtype(dtype).name}"
            out["exr"][key] = {"native_ms": t_native, "python_ms": t_py}
            log(f"[host_io] EXR {H}x{W} {key}: native {t_native:.1f} ms, Python codec "
                f"{t_py:.1f} ms; bit-equal ok")

    got, t_native = _host_ms(native.center_image, img)
    numpy32, t_np = _host_ms(center_image, img)
    f64 = img.astype(np.float64)
    want = (f64 - f64.mean(axis=(0, 1))) / (f64.std(axis=(0, 1)) + 1e-8)
    err, err32 = float(np.abs(got - want).max()), float(np.abs(numpy32 - want).max())
    out["center_image"] = {"max_abs_err": err, "numpy_f32_max_abs_err": err32,
                           "native_ms": t_native, "numpy_ms": t_np}
    log(f"[host_io] center_image {img.shape}: max|native - float64| {err:.2e} (limit 1e-4); "
        f"the pipeline's float32 numpy version {err32:.2e} (information: float32 sums over "
        f"{img.shape[0] * img.shape[1]} pixels); native {t_native:.1f} ms, numpy {t_np:.1f} ms")
    if not err <= 1e-4:
        fail("host_io: native center_image disagrees with the pipeline's formula in float64")
    got, t_native = _host_ms(native.resize_bilinear, img, H, W)
    want, t_cv = _host_ms(lambda a: cv2.resize(a, None, fx=0.5, fy=0.5,
                                               interpolation=cv2.INTER_LINEAR), img)
    if got.shape != want.shape:
        fail(f"host_io: resize_bilinear gave {got.shape}, OpenCV {want.shape}")
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    exact = float((diff == 0).mean())
    out["resize"] = {"max_abs_diff": int(diff.max()), "exact_share": exact,
                     "native_ms": t_native, "opencv_ms": t_cv}
    log(f"[host_io] resize_bilinear {img.shape[:2]} -> {got.shape[:2]}: max|native - OpenCV| "
        f"{diff.max()} (limit 1), exact {100 * exact:.2f} % (limit 97 %), native "
        f"{t_native:.1f} ms, OpenCV {t_cv:.1f} ms")
    if diff.max() > 1 or exact < 0.97:
        fail("host_io: native resize_bilinear disagrees with OpenCV")
    return out


EXTRAS_CROP = (128, 160)  # the card-against-CPU frame of phase_extras
EXTRAS_FWD_TOL, EXTRAS_GRAD_TOL = 1e-5, 1e-4  # of max|CPU|, per output and per gradient
EXTRAS_FULL_C, EXTRAS_FULL_D = 32, 48  # stage 1 of the 2752x1856 frame: 32 channels, 48 depths


@torch.no_grad()
def _seed_extras(module, seed: int) -> None:
    """Seeded weights, none at their init value: conv weights uniform(±1/sqrt
    (fan_in)) (the deformable offset head x4, so taps move by a few pixels),
    norm weights 1 + 0.3·N, biases 0.3·N."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        z = torch.randn(p.shape, generator=gen)
        if p.dim() > 1:
            bound = 1.0 / float(np.sqrt(p[0].numel()))
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound
                    * (4.0 if "offset" in name else 1.0))
        elif name.endswith("bias"):
            p.copy_(0.3 * z)
        else:
            p.copy_(1 + 0.3 * z)


def long_focal_utm_projs(height: int, width: int) -> np.ndarray:
    """[source, reference] projections [2,4,4] float32 of a nadir pair with a
    focal length of 4e4 px, camera centres at UTM-sized coordinates (5e5, 4e6)
    and 10 cm apart, the source turned by 1e-4 rad, for depths near 1000: the
    float32 grid lands about a pixel from the float64 one (as in
    tests/test_torch_port_extras.py)."""
    def proj(centre, angle):
        k = np.eye(4)
        k[0, 0] = k[1, 1] = 4.0e4
        k[0, 2], k[1, 2] = width / 2, height / 2
        rot = np.array([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0],
                        [0, 0, 1]])
        ext = np.eye(4)
        ext[:3, :3] = rot
        ext[:3, 3] = -rot @ np.asarray(centre)
        return k @ ext
    return np.stack([proj([5.0e5 + 0.1, 4.0e6 + 0.05, -1000.0], 1e-4),
                     proj([5.0e5, 4.0e6, -1000.0], 0.0)]).astype(np.float32)


def _extras_cases(height: int, width: int, C: int, D: int) -> list:
    """(name, module, input shapes, train mode, call) of each extras block,
    the float64-grid warp and depth_regression at a height x width frame with
    C channels and D depths; ``call(module, *inputs)`` returns the output."""
    from adamvs_tpu_torch import ops
    from adamvs_tpu_torch.nn import extras

    def block(m, x):
        return m(x)

    def lstm(m, c, h, x):
        return torch.cat(m((c, h), x)[0], dim=1)

    def warp64(m, feat, projs, depth):
        return ops.plane_sweep_warp(feat, projs[:1], projs[1:], depth, grid_dtype=torch.float64)

    def regression(m, cost, depth):
        return ops.depth_regression(torch.softmax(cost, dim=1), depth)

    hw, vol = (1, C, height, width), (1, 8, D, height, width)
    return [
        ("ConvGnReLU", extras.ConvGnReLU(C, C), [hw], False, block),
        ("ConvGn stride 2", extras.ConvGn(C, 2 * C, stride=2), [hw], False, block),
        ("ConvTransGnReLU", extras.ConvTransGnReLU(C, C // 2), [hw], False, block),
        ("ConvBnReLU3D train", extras.ConvBnReLU3D(8, 8), [vol], True, block),
        ("ConvBn3D stride 2", extras.ConvBn3D(8, 8, stride=2), [vol], False, block),
        ("ConvLSTMCell", extras.ConvLSTMCell(C, C), [hw, hw, hw], False, lstm),
        ("DeformConvBlock", extras.DeformConvBlock(C, C), [hw], False, block),
        ("DeformConvGnReLU", extras.DeformConvGnReLU(C, C), [hw], False, block),
        ("plane_sweep_warp float64 grid", None, [(1, height, width, C), "projs", (1, D)],
         False, warp64),
        ("depth_regression", None, [(1, D, height, width), (1, D, height // 4, width // 4)],
         False, regression),
    ]


def _extras_inputs(shapes, seed: int, height: int, width: int, D: int) -> list:
    """Seeded CPU inputs of an extras case: "projs" is the reference and
    source projection of the bench geometry at height x width; a (1, D)
    shape holds D depths in [DMIN, DMAX], a (1, D, h, w) one of a
    regression per-pixel depths around them."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for shape in shapes:
        if shape == "projs":
            p = bench_projs(height, width, 2, FOCAL * width / W)["stage3"]
            out.append(torch.tensor(p[[1, 0]]))
        elif len(shape) == 2:
            out.append(torch.linspace(DMIN, DMAX, shape[1])[None])
        elif len(shape) == 4 and shape[1] == D and shape[2] < height:
            out.append(torch.linspace(DMIN, DMAX, D)[None, :, None, None]
                       + 5 * torch.rand(shape, generator=gen))
        else:
            out.append(torch.randn(shape, generator=gen))
    return out


def phase_extras() -> dict:
    """``nn/extras.py``, the float64 warp grid and ``depth_regression`` on
    the card: (1) at a 128x160 frame (16 channels, 8 depths), card against
    CPU with the same seeded weights and inputs, float32 with TF32 off: the
    output within EXTRAS_FWD_TOL of max|CPU|, and the gradients of Σ y·g (g
    seeded) for every input and parameter within EXTRAS_GRAD_TOL of each
    gradient's max|CPU| (the DeformConvBlock's taps move by a few pixels,
    fractional and outside the frame; the 3-D train-mode block's running
    statistics too), the CPU replaying the card's ReLU decisions and the
    floors of the sample positions (``BranchReplay``), cuDNN restricted to
    its deterministic algorithms (with its default choice, runs on identical
    inputs moved the seeded ConvLSTMCell's distance from the CPU past the
    forward limit: the bar would test cuDNN's choice, as in
    ``phase_depth_shards``); (2) at the stage-1 shapes of the 2752x1856
    frame, on the card alone ([1,32,688,464] features, a [1,8,48,688,464]
    volume for the 3-D blocks): finite outputs, the forward and forward+backward times
    (CUDA events, median of 3) and the peak memory; (3) the float64 grid at
    that stage against the float32 one, the largest coordinate difference in
    pixels, at the bench geometry and at ``long_focal_utm_projs``. Returns
    the figures."""
    out = {"crop": {}, "full": {}, "grid64": {}}
    torch.backends.cudnn.deterministic = True
    try:
        _extras_crop(out["crop"])
    finally:
        torch.backends.cudnn.deterministic = False
    _extras_full(out)
    return out


def _extras_crop(out: dict) -> None:
    """Part (1) of ``phase_extras``: card against CPU at EXTRAS_CROP."""
    h, w = EXTRAS_CROP
    for i, (name, module, shapes, train, call) in enumerate(_extras_cases(h, w, 16, 8)):
        if module is not None:
            _seed_extras(module, i)
            module.train(train)
        card_module = copy.deepcopy(module).to(DEV) if module is not None else None
        inputs = _extras_inputs(shapes, 100 + i, h, w, 8)
        results = []
        record = BranchReplay()
        for dev, m, mode in ((DEV, card_module, record), ("cpu", module, None)):
            mode = mode or BranchReplay(record.masks)
            xs = [x.detach().to(dev).requires_grad_(x.dim() > 3) for x in inputs]
            with mode:
                y = call(m, *xs)
            g = torch.randn(y.shape, generator=torch.Generator().manual_seed(7)).to(dev)
            (y * g).sum().backward()
            grads = {f"input {j}": x.grad for j, x in enumerate(xs) if x.grad is not None}
            if m is not None:
                grads.update({n: p.grad for n, p in m.named_parameters()})
                grads.update({n: b for n, b in m.named_buffers() if "running" in n})
            results.append((y.detach().cpu(), {k: v.detach().cpu() for k, v in grads.items()}))
        (y_card, g_card), (y_cpu, g_cpu) = results
        decisions = sum(m.numel() for m in record.masks)
        flips = mode.flips
        if mode.calls != record.calls or flips > ReluReplay.MAX_FLIPS * max(decisions, 1):
            fail(f"extras {name}: the CPU took {flips} of {decisions} ReLU and floor decisions "
                 f"otherwise than the card ({mode.calls} calls, {record.calls} recorded)")
        if not torch.isfinite(y_card).all():
            fail(f"extras {name}: non-finite output on the card")
        fwd = ((y_card - y_cpu).abs().max() / y_cpu.abs().max()).item()
        worst, worst_name = 0.0, ""
        for k, want in g_cpu.items():
            rel = ((g_card[k] - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()
            if rel > worst:
                worst, worst_name = rel, k
        ok = fwd <= EXTRAS_FWD_TOL and worst <= EXTRAS_GRAD_TOL
        out[name] = {"forward_rel": fwd, "grad_rel": worst, "grad_worst": worst_name,
                     "tensors": len(g_cpu), "decisions": decisions, "replayed_flips": flips}
        log(f"[extras] {name} {h}x{w} card vs cpu: forward {fwd:.2e} (limit "
            f"{EXTRAS_FWD_TOL:.0e}), {len(g_cpu)} gradients and statistics worst {worst:.2e} "
            f"({worst_name}, limit {EXTRAS_GRAD_TOL:.0e}); the CPU replays the card's "
            f"{decisions} ReLU and floor decisions, {flips} of them flipped "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"extras {name}: card disagrees with CPU")


def _extras_full(out: dict) -> None:
    """Parts (2) and (3) of ``phase_extras``: the stage-1 shapes of the full
    frame on the card alone, and the float64 grid against the float32 one."""
    from adamvs_tpu_torch.ops.warp import _source_coords, warp_transform

    fh, fw = H // 4, W // 4
    for i, (name, module, shapes, train, call) in enumerate(
            _extras_cases(fh, fw, EXTRAS_FULL_C, EXTRAS_FULL_D)):
        if module is None:
            continue
        _seed_extras(module, i)
        module.to(DEV).train(train)
        inputs = [x.to(DEV) for x in _extras_inputs(shapes, 100 + i, fh, fw, EXTRAS_FULL_D)]
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            y = call(module, *inputs)
            if not torch.isfinite(y).all():
                fail(f"extras {name} at full width: non-finite output")
            fwd_ms = time_ms(lambda: call(module, *inputs), 3)
        xs = [x.requires_grad_(True) for x in inputs]

        def step():
            module.zero_grad(set_to_none=True)
            call(module, *xs).sum().backward()

        step_ms = time_ms(step, 3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        out["full"][name] = {"in": [list(x.shape) for x in inputs], "out": list(y.shape),
                             "forward_ms": fwd_ms, "forward_backward_ms": step_ms,
                             "peak_gib": peak}
        log(f"[extras] {name} full width {list(inputs[-1].shape)} -> {list(y.shape)}: forward "
            f"{fwd_ms:.2f} ms, forward+backward {step_ms:.2f} ms, peak {peak:.2f} GiB; finite ok")
        del module, inputs, xs, y
        torch.cuda.empty_cache()

    geometries = (
        ("bench", torch.tensor(bench_projs(H, W, 2, FOCAL)["stage1"], device=DEV),
         torch.linspace(DMIN, DMAX, EXTRAS_FULL_D, device=DEV)[None]),
        ("long_focal_utm", torch.tensor(long_focal_utm_projs(fh, fw), device=DEV),
         torch.linspace(1000.0, 1004.0, EXTRAS_FULL_D, device=DEV)[None]))
    for geometry, p, depth in geometries:
        coords = {}
        for dt in (torch.float32, torch.float64):
            rot, trans = warp_transform(p[1:], p[:1], dt)
            coords[dt] = _source_coords(rot, trans, depth.to(dt), fh, fw)
        du, dv = (float((a.double() - b).abs().max())
                  for a, b in zip(coords[torch.float32], coords[torch.float64]))
        ms = {str(dt)[6:]: time_ms(lambda: _source_coords(
            *warp_transform(p[1:], p[:1], dt), depth.to(dt), fh, fw), 3)
            for dt in (torch.float32, torch.float64)}
        out["grid64"][geometry] = {"max_du_px": du, "max_dv_px": dv, "ms": ms}
        log(f"[extras] grid {geometry} {EXTRAS_FULL_D}x{fh}x{fw}: max|float32 - float64| u "
            f"{du:.3e} px, v {dv:.3e} px; coordinates float32 {ms['float32']:.2f} ms, float64 "
            f"{ms['float64']:.2f} ms")


# One side of cli_ab, run by ``python3 -c`` in a checkout's root with (side, fixture tree,
# depth range): that checkout's phase_cli on the given fixture, one JSON line out. A tree
# whose phase_cli renders its own fixture (before PR 14) gets this one through cli_fixture.
CLI_AB_WORKER = r"""
import inspect, json, sys, tempfile, torch
sys.path.insert(0, ".")
import chip_smoke as cs
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
from adamvs_tpu_torch.kernels import build
build.build_all()
side, tree, depth_range = sys.argv[1], sys.argv[2], float(sys.argv[3])
with tempfile.TemporaryDirectory() as out:
    if inspect.signature(cs.phase_cli).parameters:
        _, stats = cs.phase_cli(out, tree, depth_range)
    else:
        cs.cli_fixture = lambda root: (tree, depth_range)
        _, stats = cs.phase_cli()
print("[cli_ab] " + json.dumps({"side": side, "runs": [
    {"run": e["run"], "wall_s": e["wall_s"], "infer_s": sum(e["infer_s"]),
     "save_s": sum(e["save_s"])} for e in stats]}), flush=True)
"""


def cli_ab(tree: str) -> None:
    """The predict command's runs of ``phase_cli`` in TREE (a checkout's
    root, e.g. the parent unpacked under ``_checkout/``) and in this
    checkout, in turns (TREE, this, this, TREE), each in a process of its
    own on one fixture rendered here: per run the wall and the summed infer
    and save seconds, for an A/B of the command in one call."""
    import tempfile

    sides = (("base", os.path.abspath(tree)), ("this", REPO), ("this", REPO),
             ("base", os.path.abspath(tree)))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_ab_") as tmp:
        fixture, depth_range = cli_fixture(tmp)
        for side, root in sides:
            proc = subprocess.run([sys.executable, "-c", CLI_AB_WORKER, side, fixture,
                                   str(depth_range)], cwd=root, capture_output=True, text=True,
                                  timeout=900)
            for line in proc.stdout.splitlines():
                if line.startswith("[cli_ab]") or (line.startswith("[cli] ") and "work items" in line):
                    log(line)
            if proc.returncode:
                fail(f"cli_ab: the {side} side in {root} failed:\n{proc.stderr[-3000:]}")


# The training commands' fixture: a WHU_OMVS tree of CLI_TRAIN_VIEWS views at the training
# crop's size, each view the reference of one sample of V views.
CLI_TRAIN_VIEWS = 6


def _check_train_logdir(run: str, logdir: str, epochs: int) -> dict:
    """The records a train command leaves in ``logdir``: metrics.jsonl with
    train and val records (the last val's abs_depth_error finite),
    train_record.txt with one line per epoch, one end-of-epoch .ckpt per
    epoch, and TensorBoard event files where tensorboardX imports. Returns
    the last val record."""
    names = sorted(os.listdir(logdir))
    recs = [json.loads(ln) for ln in open(os.path.join(logdir, "metrics.jsonl"))]
    vals = [r for r in recs if r["kind"] == "val"]
    if not any(r["kind"] == "train" for r in recs) or len(vals) != epochs:
        fail(f"cli {run}: metrics.jsonl holds {len(recs)} records, {len(vals)} val of {epochs}")
    if not np.isfinite(vals[-1]["abs_depth_error"]):
        fail(f"cli {run}: non-finite abs_depth_error {vals[-1]}")
    with open(os.path.join(logdir, "train_record.txt")) as f:
        if len(f.read().splitlines()) != epochs:
            fail(f"cli {run}: train_record.txt does not hold {epochs} lines")
    for e in range(epochs):
        if not any(n.startswith(f"model_{e:06d}_") and n.endswith(".ckpt") for n in names):
            fail(f"cli {run}: no checkpoint of epoch {e} in {names}")
    try:
        import tensorboardX  # noqa: F401
        tb = True
    except ImportError:
        tb = False
    events = [n for n in names if n.startswith("events.out.tfevents")]
    if tb and not events:
        fail(f"cli {run}: tensorboardX imports but no event file was written")
    log(f"[cli] {run}: {len(recs)} records in metrics.jsonl, val abs_depth_error "
        f"{vals[-1]['abs_depth_error']:.3f}; tensorboardX {'present' if tb else 'absent'}, "
        f"{len(events)} event files; files {names}")
    return vals[-1]


def phase_cli_train() -> tuple[dict, list]:
    """The port's train, test and profile commands (``adamvs_tpu_torch.cli
    .main``) in this process on a WHU_OMVS tree written by the port's
    writer (CLI_TRAIN_VIEWS views at 384x768), at their defaults (AdaMVS scan
    form, float32, V=5, ndepths 48/32/8) with ``--summary_freq 1``: train one
    epoch; train to 2 epochs with ``--resume``, which must resume and run
    epoch 1 only; test (the export files, PFMs at the GT's resolution,
    finite); profile (a trace file); train MS-REDNet one epoch; train one
    epoch with ``--compute_dtype bf16`` (its parameters and checkpoint must
    be float32), then test that checkpoint with ``--compute_dtype bf16`` and
    in float32. Each command has every launch counter set to 0 just before it
    and read just after.
    Returns (launches summed over the commands, per-command statistics)."""
    import contextlib
    import io
    import tempfile

    from adamvs_tpu_torch.cli import main as cli_main
    from adamvs_tpu_torch.data.synthetic import make_scene, write_whu_omvs_tree
    from adamvs_tpu_torch.io.pfm import read_pfm
    from adamvs_tpu_torch.train.checkpoint import latest_checkpoint

    counted = wrappers()
    total = dict.fromkeys(KERNELS, 0)
    stats = []
    n = CLI_TRAIN_VIEWS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_cli_") as tmp:
        t0 = time.perf_counter()
        scene = make_scene(num_views=n, height=TRAIN_H, width=TRAIN_W, seed=0, focal=800.0,
                           fly_height=400.0, plane=(0.2, -0.16, 0.0), baseline=20.0, tilt=0.05,
                           workers=min(8, os.cpu_count() or 1))
        tree = os.path.join(tmp, "whu_omvs")
        write_whu_omvs_tree(tree, scene)
        log(f"[cli] training fixture: WHU_OMVS tree of {n} views {TRAIN_H}x{TRAIN_W}, depths "
            f"[{scene.depth_start}, {scene.depth_end}] step {scene.depth_interval}, written in "
            f"{time.perf_counter() - t0:.1f} s")
        logs = {m: os.path.join(tmp, f"logs_{m}") for m in ("adamvs", "msrednet", "bf16")}
        trace = os.path.join(tmp, "trace")
        a, m = SCAN_STEP["adamvs"], SCAN_STEP["msrednet"]
        train_a = ["train", "--trainpath", tree, "--logdir", logs["adamvs"], "--summary_freq", "1"]
        # (run, argv, launches: n train steps with their backward and n eval steps)
        runs = (
            ("train", train_a + ["--epochs", "1"], {"K6/7": 2 * n * a, "K6/7-bwd": n * a}),
            ("resume", train_a + ["--epochs", "2", "--resume"],
             {"K6/7": 2 * n * a, "K6/7-bwd": n * a}),
            ("test", ["test", "--testpath", tree, "--logdir", logs["adamvs"]], {"K6/7": n * a}),
            ("profile", ["profile", "--testpath", tree, "--warmup", "1", "--iters", "2",
                         "--trace_dir", trace], {"K6/7": 3 * a}),
            ("train_msrednet", ["train", "--model", "msrednet", "--trainpath", tree, "--logdir",
                                logs["msrednet"], "--summary_freq", "1", "--epochs", "1"],
             {"K6/7": 2 * n * m, "K6/7-bwd": n * m}),
            # bf16 mixed precision: float32 master weights, a float32 checkpoint that the
            # bf16 and the float32 test commands both load
            ("train_bf16", ["train", "--trainpath", tree, "--logdir", logs["bf16"], "--summary_freq",
                            "1", "--epochs", "1", "--compute_dtype", "bf16"],
             {"K6/7": 2 * n * a, "K6/7-bwd": n * a}),
            ("test_bf16", ["test", "--testpath", tree, "--logdir", logs["bf16"], "--compute_dtype",
                           "bf16"], {"K6/7": n * a}),
            ("test_f32_of_bf16", ["test", "--testpath", tree, "--logdir", logs["bf16"]],
             {"K6/7": n * a}),
        )
        for run, argv, want in runs:
            for fn in counted.values():
                fn.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                result = cli_main(argv + ["--device", DEV])
            wall = time.perf_counter() - t0
            out = buf.getvalue()
            launches = {k: fn.launches for k, fn in counted.items()}
            for k, c in launches.items():
                if c != want.get(k, 0):
                    fail(f"cli {run}: {k} launched {c} times, expected {want.get(k, 0)}")
                total[k] += c
            entry = {"run": run, "argv": argv, "wall_s": wall, "launches": launches}
            if argv[0] == "train":
                epochs = int(argv[argv.index("--epochs") + 1])
                epoch_lines = re.findall(r"^Epoch (\d+), iter", out, re.M)
                if run == "resume":
                    if "resuming from" not in out or set(epoch_lines) != {"1"}:
                        fail(f"cli {run}: no 'resuming from', or epochs {set(epoch_lines)} ran")
                elif set(epoch_lines) != {"0"}:
                    fail(f"cli {run}: epochs {set(epoch_lines)} ran")
                if len(epoch_lines) != n:
                    fail(f"cli {run}: {len(epoch_lines)} train steps logged, expected {n}")
                if "--compute_dtype" in argv:
                    ckpt = torch.load(latest_checkpoint(argv[argv.index("--logdir") + 1]),
                                      map_location="cpu", weights_only=True)
                    kinds = {t.dtype for t in ckpt["model"].values()} | {
                        p.dtype for p in result.state.model.parameters()}
                    if not kinds <= {torch.float32, torch.int64}:
                        fail(f"cli {run}: parameters or checkpoint of dtypes {kinds}")
                    entry["checkpoint_dtypes"] = sorted(str(k) for k in kinds)
                step_s, data_s = result.times["step_s"], result.times["data_s"]
                entry.update(step_s=step_s, data_s=data_s,
                             loader_share=sum(data_s) / (sum(data_s) + sum(step_s)),
                             val=_check_train_logdir(run, argv[argv.index("--logdir") + 1], epochs))
                log(f"[cli] {run}: {n} steps, per step {statistics.mean(step_s):.3f} s (first "
                    f"{step_s[0]:.3f}, then {statistics.mean(step_s[1:]):.3f}), waiting for the "
                    f"loader {statistics.mean(data_s):.3f} s per step ({entry['loader_share']:.1%} "
                    f"of the epoch's train loop)")
            elif argv[0] == "test":
                if "final:" not in out:
                    fail(f"cli {run}: no 'final:' line")
                out_root = os.path.join(tree, "depths_whu_omvs", "images")
                names = [f"view_{i:03d}" for i in range(n)]
                files = sorted(os.path.relpath(os.path.join(d, f), out_root)
                               for d, _, fs in os.walk(out_root) for f in fs)
                expect = sorted([f"{v}{x}" for v in names for x in ("_init.pfm", "_prob.pfm", ".jpg")]
                                + [f"color/{v}{x}" for v in names for x in ("_init.png", "_prob.png")])
                if files != expect:
                    fail(f"cli test: export files {files}")
                for v in names:
                    for x in ("_init.pfm", "_prob.pfm"):
                        arr = read_pfm(os.path.join(out_root, v + x))[0]
                        if arr.shape != (TRAIN_H, TRAIN_W) or not np.isfinite(arr).all():
                            fail(f"cli test {v}{x}: shape {arr.shape}, finite "
                                 f"{np.isfinite(arr).all()}")
                entry["final"] = result
                log(f"[cli] {run}: {n} samples exported, PFMs {TRAIN_H}x{TRAIN_W} finite; final "
                    f"abs_depth_error {result['abs_depth_error']:.3f}")
            elif run == "profile":
                size = os.path.getsize(result) if os.path.exists(result) else 0
                if not size:
                    fail(f"cli profile: no trace at {result}")
                entry["trace_bytes"] = size
                log(f"[cli] profile: trace of {size} bytes; "
                    + "; ".join(ln for ln in out.splitlines() if ln.startswith(("warmup", "profile"))))
            stats.append(entry)
            log(f"[cli] {run} ({' '.join(argv)}): "
                f"{wall:.1f} s wall, launches {launches}")
            torch.cuda.empty_cache()
    return total, stats


# Row bands of `predict --tiles TILES` at the bench frame (predict/tiled.py, the halo of
# the JAX CLI): 688 rows a band, 1216-row band views (band 1 from row 432).
TILES, HALO = 4, 256
# (path, model, model options, dtype, launches per banded depth map)
TILED_FORMS = (
    ("tiled_adamvs_scan", "adamvs", {"sweep_impl": "scan", "reg_impl": "scan"}, torch.float32,
     {"K6/7": TILES * SCAN_STEP["adamvs"]}),
    ("tiled_adamvs_fused_regscan", "adamvs", {"sweep_impl": "fused", "reg_impl": "scan"},
     torch.bfloat16, {"K1": TILES, "K2": 3 * TILES}),
    ("tiled_msrednet_fused", "msrednet", {"sweep_impl": "fused"}, torch.bfloat16,
     {"K4": 3 * TILES}),
)
DEPTH_SHARDS = 4


def band_inputs(si: int, gen: torch.Generator, band: int = 1) -> StageInputs:
    """StageInputs of row band ``band`` of TILES: the band's reference rows,
    visibility weights and hypothesis window (``band_geometry``), the
    full-frame sources, and the reference projection shifted to the band's
    first row (``band_ref_proj``); ``h`` is the band's."""
    from adamvs_tpu_torch.predict.tiled import band_geometry

    st = StageInputs(si, gen)
    start, band_h, _ = band_geometry(band, TILES, H, HALO)
    s = 2 ** (2 - si)
    r0, bh = start // s, band_h // s
    st.h = bh
    st.ref = st.ref[:, r0:r0 + bh].contiguous()
    st.weights = st.weights[:, :, r0:r0 + bh].contiguous()
    st.lo, st.step = st.lo[:, r0:r0 + bh].contiguous(), st.step[:, r0:r0 + bh].contiguous()
    ref_proj = st.ref_proj.clone()
    ref_proj[:, 1] = st.ref_proj[:, 1] - r0 * st.ref_proj[:, 2]
    st.ref_proj = ref_proj
    st.rows = (r0, bh)
    return st


def phase_bands(res: dict) -> None:
    """K1, K2, K4 and K6/K7 at the shapes of ``predict --tiles 4``: band 1's
    reference rows against the full-frame sources (the first shapes whose
    reference is smaller than its sources), float32 and bf16, against their
    plain versions within TOL; the errors go in the kernels line under
    ``band f32`` and ``band bf16``."""
    from adamvs_tpu_torch.ops import sweep_fuse as sf
    from adamvs_tpu_torch.ops import warp_sample as ws
    from adamvs_tpu_torch.ops.warp import sweep_coords

    gen = torch.Generator(device=DEV).manual_seed(7)
    for si in range(3):
        st = band_inputs(si, gen)
        log(f"[bands] stage{si + 1}: reference rows {st.rows[0]}-{sum(st.rows) - 1} "
            f"({st.h}x{st.w}) of {st.srcs.shape[2]}x{st.srcs.shape[3]} sources, C {st.C}, "
            f"D {st.D}")
        for dtype in (torch.float32, torch.bfloat16):
            tn = "f32" if dtype == torch.float32 else "bf16"
            ref, srcs = st.feats(dtype)
            geo = (st.src_projs, st.ref_proj, st.lo, st.step, st.D)
            with torch.no_grad():
                if si == 0:
                    _record_err(res, "K1", f"band {tn}", _compare(
                        f"K1 band stage1 {tn}", ("K1", dtype),
                        sf.corr_sweep_volume(ref, srcs, *geo), sf.corr_volume_ref(ref, srcs, *geo)))
                _record_err(res, "K2", f"band {tn}", _compare(
                    f"K2 band stage{si + 1} {tn}", ("K2", dtype),
                    sf.fused_sweep_volume(ref, srcs, st.weights, *geo),
                    sf.fused_volume_ref(ref, srcs, st.weights, *geo)))
                _record_err(res, "K4", f"band {tn}", _compare(
                    f"K4 band stage{si + 1} {tn}", ("K4", dtype),
                    sf.var_sweep_volume(ref, srcs, *geo), sf.var_volume_ref(ref, srcs, *geo)))
                hyp = (st.lo + (st.D // 2) * st.step)[:, None]
                uv = [sweep_coords(srcs[v], st.src_projs[v], st.ref_proj, hyp) for v in range(V - 1)]
                uv = (torch.cat([a for a, _ in uv]), torch.cat([b for _, b in uv]))
                _record_err(res, "K6/7", f"band {tn}", _compare(
                    f"K6/7 band stage{si + 1} {tn} ({V - 1} views a call)", ("K6/7", dtype),
                    ws.sample_bilinear(srcs.flatten(0, 1), *uv),
                    ws.sample_bilinear_ref(srcs.flatten(0, 1), *uv)))
            del ref, srcs, uv
        del st
        torch.cuda.empty_cache()


def _bench_sample():
    """The main paths' request: 5 seeded random frames at 2752x1856 with the
    bench geometry and depths 300-500."""
    rng = np.random.RandomState(0)
    return types.SimpleNamespace(
        imgs=rng.randn(V, H, W, 3).astype(np.float32),
        proj_matrices=bench_projs(H, W, V, FOCAL),
        depth_values=np.array([DMIN, DMAX], np.float32),
    )


def _band_errors(depth, conf, want_depth, want_conf) -> dict:
    """tests/test_tiled.py's interior-row statistics of a banded map against
    the unbanded one (2 rows either side of each band boundary left out)."""
    rows = H // TILES
    interior = np.ones(H, bool)
    for b in range(1, TILES):
        interior[b * rows - 2:b * rows + 2] = False
    err = np.abs(depth - want_depth)[interior]
    cerr = np.abs(conf - want_conf)[interior]
    return {"max_abs_err": float(np.abs(depth - want_depth).max()),
            "median_err": float(np.median(err)), "within_1e-2": float((err < 1e-2).mean()),
            "conf_median_err": float(np.median(cerr))}


@contextlib.contextmanager
def _recorded(module, name: str, calls: list, active: bool = True):
    """While active, ``module.name`` (a kernel wrapper as a model module
    calls it) also appends each call's (arguments, output) to ``calls``."""
    if not active:
        yield
        return
    fn = getattr(module, name)

    def recording(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, out))
        return out

    setattr(module, name, recording)
    try:
        yield
    finally:
        setattr(module, name, fn)


def phase_tiled() -> tuple[dict, list]:
    """``predict --tiles 4`` (halo 256) through PredictEngine for TILED_FORMS
    at the bench frame: a banded request after a warm-up, with every launch
    counter set to 0 just before the two and read just after, against one
    unbanded request of the same engine model. The AdaMVS forms must meet
    tests/test_tiled.py's bars on the interior rows (median |Δ| < 1e-3, 97 %
    within 1e-2, confidence median < 1e-3). MS-REDNet's cells normalise with
    GroupNorm(1) over the whole map, so a band narrower than the frame moves
    its statistics and its depth, in JAX as in the port (tests/
    test_torch_port_parallel_tiled.py holds the port's bands to JAX's): its
    distance from the unbanded map is information. Its bands are held instead
    by K4's calls inside the first banded request, each against the plain
    volume on the same inputs within TOL, and by the bands on the card
    against the same bands on the CPU, float32, within phase_reference's
    limits: on phase_reference's 128x160 frame (4 bands of 32 rows, halo 16:
    64-row band views) with the seeded weights, and on a 512x256 frame with
    the stage features scaled so that the stage-1 variance volume reaches 1.
    With the seeded weights (stage-1 variances up to ~1e-7) the map at
    512x256 is ill-conditioned: moving every weight by one float32 step
    moves it by ~1e-2 of the range on the CPU alone, as far as card and CPU
    part; scaled, both distances fall to ~4e-6 (``probe_parallel``).
    Returns (launches, per-path statistics)."""
    from adamvs_tpu_torch.models import build_model
    from adamvs_tpu_torch.models import msrednet as msrednet_module
    from adamvs_tpu_torch.ops import sweep_fuse as sf
    from adamvs_tpu_torch.predict.engine import PredictEngine
    from adamvs_tpu_torch.predict.tiled import tiled_forward

    sample = _bench_sample()
    counted = wrappers()
    total = dict.fromkeys(KERNELS, 0)
    stats = []
    for path, name, opts, dtype, per_map in TILED_FORMS:
        t_path = time.perf_counter()
        model = build_model(name, seed=0, device=DEV, dtype=dtype, ndepths=NDEPTHS,
                            depth_intervals_ratio=RATIOS, base=BASE, cr_base=(BASE,) * 3, **opts)
        t0 = time.perf_counter()
        want = PredictEngine(model, num_depth=NUM_DEPTH, device=DEV).predict_sample(sample)
        unbanded = (time.perf_counter() - t0) * 1e3
        engine = PredictEngine(model, num_depth=NUM_DEPTH, device=DEV, tiles=TILES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted.values():
            fn.launches = 0
        times, k4_calls = [], []
        for i in range(2):
            t0 = time.perf_counter()
            with _recorded(msrednet_module, "var_sweep_volume", k4_calls,
                           name == "msrednet" and i == 0):
                depth, conf = engine.predict_sample(sample)
            times.append((time.perf_counter() - t0) * 1e3)
        launches = {k: fn.launches for k, fn in counted.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        for k, n in launches.items():
            if n != 2 * per_map.get(k, 0):
                fail(f"{path}: {k} launched {n} times over 2 banded requests, expected "
                     f"{2 * per_map.get(k, 0)}")
            total[k] += n
        if depth.shape != (H, W) or not (np.isfinite(depth).all() and np.isfinite(conf).all()):
            fail(f"{path}: banded output {depth.shape}, finite {np.isfinite(depth).all()}")
        if not (conf.min() > 0.0 and conf.max() <= 1.0):
            fail(f"{path}: confidence outside (0, 1]: [{conf.min()}, {conf.max()}]")
        errs = _band_errors(depth, conf, *want)
        entry = {"path": path, "dtype": str(dtype), "tiles": TILES, "halo": HALO,
                 "ms_per_map": times[1], "warmup_ms": times[0], "unbanded_ms": unbanded,
                 "peak_gib": peak, "launches": launches, **errs}
        stats.append(entry)
        log(f"[tiled] {path} {H}x{W} in {TILES} bands, halo {HALO}, {dtype}: {times[1]:.1f} ms "
            f"per depth map (warm-up {times[0]:.1f}; unbanded {unbanded:.1f}), peak {peak:.2f} GiB, "
            f"launches {launches}; against the unbanded map: max |Δ| {errs['max_abs_err']:.3e}, "
            f"interior median {errs['median_err']:.3e}, {errs['within_1e-2']:.4%} within 1e-2, "
            f"confidence median {errs['conf_median_err']:.3e}")
        if name == "adamvs":
            if not (errs["median_err"] < 1e-3 and errs["within_1e-2"] > 0.97
                    and errs["conf_median_err"] < 1e-3):
                fail(f"{path}: the banded map disagrees with the unbanded one")
        else:
            log(f"[tiled] {path}: GroupNorm(1) over the band, not the frame: the distance above "
                "is the reference algorithm's (information, no limit)")
            with torch.no_grad():
                for i, (args, out) in enumerate(k4_calls):
                    _compare(f"K4 in {path} band {i // 3} stage{i % 3 + 1} ({tuple(args[0].shape)} "
                             f"of {tuple(args[1].shape)})", ("K4", out.dtype), out,
                             sf.var_volume_ref(*args))
            if len(k4_calls) != 3 * TILES:
                fail(f"{path}: {len(k4_calls)} K4 calls recorded, expected {3 * TILES}")
            entry["k4_calls_checked"] = len(k4_calls)
            del k4_calls
        del model, engine
        torch.cuda.empty_cache()
        log(f"[time] {path}: {time.perf_counter() - t_path:.1f} s")
    # MS-REDNet's bands, card against CPU, with real bands: on phase_reference's frame with the
    # seeded weights, and at 512x256 with the stage features scaled so that the stage-1
    # variance volume reaches 1
    for h, w, scaled in ((128, 160, False), (512, 256, True)):
        rng = np.random.RandomState(1)
        imgs = torch.from_numpy(rng.randn(1, V, h, w, 3).astype(np.float32))
        projs = {k: torch.from_numpy(p[None])
                 for k, p in bench_projs(h, w, V, FOCAL * h / H).items()}
        dv = torch.tensor([[DMIN, DMAX]])
        dev_projs = {k: p.to(DEV) for k, p in projs.items()}
        model = build_model("msrednet", seed=1, device=DEV, ndepths=NDEPTHS, base=BASE,
                            cr_base=(BASE,) * 3, sweep_impl="fused")
        with torch.no_grad():
            if scaled:  # the stage outputs are 1x1 convolutions without bias
                calls = []
                with _recorded(msrednet_module, "var_sweep_volume", calls):
                    model(imgs.to(DEV), dev_projs, dv.to(DEV), num_depth=NUM_DEPTH)
                vmax = calls[0][1].abs().max().item()
                del calls
                for name in ("out1", "out2", "out3"):
                    getattr(model.feature, name).weight.mul_(vmax ** -0.5)
            got = tiled_forward(model, imgs.to(DEV), dev_projs, dv.to(DEV), TILES,
                                num_depth=NUM_DEPTH, halo=16)
            want = tiled_forward(copy.deepcopy(model).cpu(), imgs, projs, dv, TILES,
                                 num_depth=NUM_DEPTH, halo=16)
        derr = (got[0].cpu() - want[0]).abs().max().item() / (DMAX - DMIN)
        cerr = (got[1].cpu() - want[1]).abs().max().item()
        log(f"[tiled] msrednet_fused {h}x{w}"
            f"{f' (stage features x {vmax ** -0.5:.4g})' if scaled else ''} in {TILES} bands, "
            f"halo 16, float32, card against CPU: depth err {derr:.2e} of the range "
            f"(limit 1e-4), confidence err {cerr:.2e} (limit 1e-3)")
        if not (derr < 1e-4 and cerr < 1e-3):
            fail(f"msrednet_fused bands at {h}x{w}: the card disagrees with the plain path on "
                 "the CPU")
        del model, got, want
    return total, stats


def phase_depth_shards() -> tuple[dict, list]:
    """AdaMVS with ``depth_shards=4`` (the depth blocks one after another,
    JAX's ``depth_mesh`` path: K6/K7 over each block's hypotheses) at the
    bench frame in float32 through PredictEngine, against the unsharded scan
    form: depth and confidence within atol 1e-4 (tests/test_depth_shard.py).
    One request after a warm-up, the launch counters set to 0 before the two.
    The phase runs with ``cudnn.deterministic``: with cuDNN's default choice
    of algorithms two runs of the unsharded float32 form on the same input
    part by up to 2.1e-4 in depth (300-500, ``probe_parallel``), as far as
    the bar, so the bar would test cuDNN's run-to-run spread rather than the
    depth blocks."""
    sample = _bench_sample()
    counted = wrappers()
    kw = dict(seed=0, device=DEV, dtype=torch.float32, ndepths=NDEPTHS,
              depth_intervals_ratio=RATIOS, base=BASE, cr_base=(BASE,) * 3, sweep_impl="scan",
              reg_impl="scan")
    torch.backends.cudnn.deterministic = True
    try:
        return _depth_shards(sample, counted, kw)
    finally:
        torch.backends.cudnn.deterministic = False


def _depth_shards(sample, counted: dict, kw: dict) -> tuple[dict, list]:
    from adamvs_tpu_torch.models import build_model
    from adamvs_tpu_torch.predict.engine import PredictEngine

    want = PredictEngine(build_model("adamvs", **kw), num_depth=NUM_DEPTH,
                         device=DEV).predict_sample(sample)
    engine = PredictEngine(build_model("adamvs", depth_shards=DEPTH_SHARDS, **kw),
                           num_depth=NUM_DEPTH, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        depth, conf = engine.predict_sample(sample)
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: fn.launches for k, fn in counted.items()}
    per_map = {"K6/7": CORR_BLOCKS + 3 * DEPTH_SHARDS}
    for k, n in launches.items():
        if n != 2 * per_map.get(k, 0):
            fail(f"adamvs_depth_shards: {k} launched {n} times over 2 requests, expected "
                 f"{2 * per_map.get(k, 0)}")
    derr, cerr = float(np.abs(depth - want[0]).max()), float(np.abs(conf - want[1]).max())
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[depth_shards] adamvs {H}x{W} float32 in {DEPTH_SHARDS} depth blocks, cuDNN "
        f"deterministic: {times[1]:.1f} ms "
        f"per depth map (warm-up {times[0]:.1f}), peak {peak:.2f} GiB, launches {launches}; "
        f"against the unsharded scan form: depth max |Δ| {derr:.3e}, confidence {cerr:.3e} "
        f"(limits 1e-4)")
    if not (derr <= 1e-4 and cerr <= 1e-4):
        fail("adamvs_depth_shards disagrees with the unsharded forward")
    entry = {"path": "adamvs_depth_shards", "dtype": "torch.float32", "shards": DEPTH_SHARDS,
             "cudnn_deterministic": True,
             "ms_per_map": times[1], "warmup_ms": times[0], "peak_gib": peak,
             "launches": launches, "depth_max_abs_err": derr, "conf_max_abs_err": cerr}
    return launches, [entry]


def dp_batch(height: int = TRAIN_H, width: int = TRAIN_W) -> dict:
    """The training batch at 2 samples, the second with the left half of its
    mask zero at every stage (uneven masks: the loss's masked means differ
    from the mean of per-sample means)."""
    batch = train_batch(height, width, batch=2)
    for m in batch["mask"].values():
        m[1, :, : m.shape[2] // 2] = 0.0
    return batch


def _dp_result(model, loss: float) -> dict:
    return {"loss": loss,
            "grads": {k: p.grad.detach().to("cpu", copy=True)
                      for k, p in model.named_parameters() if p.grad is not None},
            "state": {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}}


def dp_worker(rank: int, port: int, out: str) -> None:
    """One of 2 gloo ranks sharing the card (``--dp-worker``): one
    data-parallel train step of fused AdaMVS on its half of ``dp_batch``;
    writes its loss, gradients, state, launches, ReLU decisions and step
    time to ``out``."""
    from adamvs_tpu_torch.models import model_loss
    from adamvs_tpu_torch.parallel import initialize_distributed, make_mesh, shard_batch
    from adamvs_tpu_torch.train.loop import Trainer
    from adamvs_tpu_torch.train.state import create_train_state, make_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo", timeout_s=300)
    model = _train_model("adamvs", {}, 0, DEV)
    state = create_train_state(model, make_optimizer(model.parameters(), lr=1e-3))
    mesh = make_mesh(data=2)
    trainer = Trainer(state, model_loss("adamvs"), os.path.join(out, f"log{rank}"),
                      dlossw=DLOSSW, num_stages=3, ckpt_step_freq=0, log_fn=lambda m: None,
                      device=DEV, mesh=mesh)
    counted = wrappers()
    for fn in counted.values():
        fn.launches = 0
    record = ReluReplay()
    t0 = time.perf_counter()
    with record:
        loss = trainer.train_epoch(0, [shard_batch(dp_batch(), mesh)])["loss"]
    result = _dp_result(model, loss)
    result.update(launches={k: fn.launches for k, fn in counted.items()}, masks=record.masks,
                  step_ms=(time.perf_counter() - t0) * 1e3)
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


def phase_data_parallel() -> tuple[dict, list]:
    """The Trainer in data-parallel mode on the card, fused AdaMVS, float32.
    A float32 AdaMVS step moves under rounding alone: a ReLU input within
    rounding of 0 flips (3 of 11.6 million decisions move a 64x128 step's
    gradient by 5e-3, ``probe_parallel``), so each comparison replays the
    reference run's ReLU decisions (``ReluReplay``; at most ``MAX_FLIPS`` of
    them may differ):

    1. world size 1 over nccl: 3 train steps on the training batch (384x768,
       V=5) over a data group of this process, with the launch counters set
       to 0 just before and read just after, against 3 steps of the plain
       Trainer from the same weights, the first step's decisions replayed:
       after the first step the loss within 1e-5 relative, the gradient within
       1e-3 relative L2, the parameters less the plain run's equal to
       RMSprop's step of the one gradient less that of the other within 1e-6,
       the BatchNorm statistics within 1e-4; the later steps' losses within
       1e-4 (unreplayed: RMSprop turns the rounding of a gradient near 0
       into a whole step, so the runs part by more than rounding);
    2. 2 gloo ranks in 2 processes sharing the card, one step on the 2-sample
       ``dp_batch`` (uneven masks, train-mode BatchNorm), against one process
       on the same global batch replaying the ranks' decisions (concatenated
       along the batch): the loss within 1e-4 relative on both ranks
       (tests/test_multihost.py's bar); the averaged gradient, alike on both
       ranks, within 1e-3 relative L2 (phase_train_reference's limit; a
       gradient not divided by the 2 ranks lies 1.0 from it); each rank's
       parameters less the one process's equal RMSprop's step of the rank's
       gradient less that of the one process's gradient, within 1e-6; the
       BatchNorm statistics within 1e-4.
    Returns (launches of part 1, per-path statistics)."""
    import torch.distributed as dist

    from adamvs_tpu_torch.models import model_loss
    from adamvs_tpu_torch.parallel import initialize_distributed, make_mesh
    from adamvs_tpu_torch.parallel.dryrun import free_port
    from adamvs_tpu_torch.train.loop import Trainer
    from adamvs_tpu_torch.train.state import create_train_state, make_optimizer

    stats = []
    root = os.path.join(REPO, "adamvs_tpu_torch", "_build", "chip_smoke_dp")
    shutil.rmtree(root, ignore_errors=True)
    batch = train_batch(TRAIN_H, TRAIN_W)
    counted = wrappers()
    steps = 3

    def trainer_of(model, label, mesh=None):
        state = create_train_state(model, make_optimizer(model.parameters(), lr=1e-3))
        return Trainer(state, model_loss("adamvs"), os.path.join(root, label), dlossw=DLOSSW,
                       num_stages=3, ckpt_step_freq=0, log_fn=lambda m: None, device=DEV,
                       mesh=mesh)

    initialize_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl", timeout_s=300)
    runs = {}
    record = ReluReplay()
    replay = ReluReplay(record.masks)
    try:
        for label, mode in (("plain", record), ("data_parallel", replay)):
            model = _train_model("adamvs", {}, 0, DEV)
            trainer = trainer_of(model, label, make_mesh(data=1) if label == "data_parallel"
                                 else None)
            torch.cuda.synchronize()
            for fn in counted.values():
                fn.launches = 0
            losses, times = [], []
            for i in range(steps):
                t0 = time.perf_counter()
                with mode if i == 0 else contextlib.nullcontext():
                    losses.append(trainer.train_epoch(0, [batch])["loss"])
                times.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    first = _dp_result(model, losses[0])
            runs[label] = (losses, times, {k: fn.launches for k, fn in counted.items()}, first,
                           {k: v.detach().to("cpu", copy=True)
                            for k, v in model.named_parameters()})
            del model, trainer
    finally:
        dist.destroy_process_group()
    ld, td, launches, fd, pd = runs["data_parallel"]
    lp, tp, _, fp, pp = runs["plain"]
    start = _train_model("adamvs", {}, 0, "cpu").state_dict()
    # after all the steps, as information: RMSprop makes whole steps of the rounding of
    # gradients near 0, and later steps are not replayed
    drift = float(torch.cat([(pd[k] - pp[k]).flatten() for k in pp]).norm()
                  / torch.cat([(pp[k] - start[k]).flatten() for k in pp]).norm())
    per_step = dict(TRAIN_PATHS[0][4])
    for k, n in launches.items():
        if n != steps * per_step.get(k, 0):
            fail(f"train_adamvs_data_parallel: {k} launched {n} times over {steps} steps, "
                 f"expected {steps * per_step.get(k, 0)}")
    keys = list(fp["grads"])
    bn = [k for k in fp["state"] if k.endswith(("running_mean", "running_var"))]

    def flat(grads):
        return torch.cat([grads[k].flatten() for k in keys])

    def step(g):
        return -1e-3 * g / ((0.1 * g * g).sqrt() + 1e-8)

    def compare(got, want):
        """(loss, gradient, parameter step, BatchNorm statistics) errors of
        one step's result ``got`` against ``want`` (``_dp_result``)."""
        gw = flat(want["grads"])
        return (abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                float((flat(got["grads"]) - gw).norm() / gw.norm()),
                max(float(((got["state"][k] - want["state"][k])
                           - (step(got["grads"][k]) - step(want["grads"][k]))).abs().max())
                    for k in keys),
                max(float(((got["state"][k] - want["state"][k]).abs()
                           / want["state"][k].abs().clamp(min=1.0)).max()) for k in bn))

    lerr, gerr, perr, serr = compare(fd, fp)
    later = max(abs(a - b) / abs(b) for a, b in zip(ld[1:], lp[1:]))
    share = replay.flips / max(sum(m.numel() for m in record.masks), 1)
    log(f"[data_parallel] world 1 over nccl, fused AdaMVS {TRAIN_H}x{TRAIN_W} float32, {steps} "
        f"steps: losses {', '.join(f'{x:.6f}' for x in ld)} against the plain Trainer's "
        f"{', '.join(f'{x:.6f}' for x in lp)}; step 1 (decisions replayed, {replay.flips} would "
        f"have flipped, {share:.1e}, limit {ReluReplay.MAX_FLIPS:.0e}): loss {lerr:.2e} (limit "
        f"1e-5), gradient rel L2 {gerr:.2e} (limit 1e-3), parameters against RMSprop's step "
        f"{perr:.2e} (limit 1e-6), BatchNorm statistics {serr:.2e} (limit 1e-4); later losses "
        f"{later:.2e} (limit 1e-4); parameters after {steps} steps {drift:.2e} of the plain run's "
        f"movement (information); {statistics.mean(td[1:]):.1f} ms per step (plain "
        f"{statistics.mean(tp[1:]):.1f}); launches {launches}")
    if not (lerr < 1e-5 and gerr < 1e-3 and perr < 1e-6 and serr < 1e-4 and later < 1e-4
            and share <= ReluReplay.MAX_FLIPS and replay.calls == len(record.masks)):
        fail("train_adamvs_data_parallel (world 1) disagrees with the plain Trainer")
    stats.append({"path": "train_adamvs_data_parallel", "world": 1, "backend": "nccl",
                  "ms_per_step": statistics.mean(td[1:]),
                  "plain_ms_per_step": statistics.mean(tp[1:]), "timed_ms": td,
                  "launches": launches, "loss_rel_err": lerr, "grad_rel_l2": gerr,
                  "param_step_err": perr, "bn_err": serr, "later_loss_rel_err": later,
                  "param_drift_after_steps": drift,
                  "relu_flips": replay.flips})
    del record, replay, fd, fp, pd, pp

    # 2. two gloo ranks sharing the card
    t0 = time.perf_counter()
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker", str(r),
                               str(port), root], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=REPO) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"data-parallel rank {r} over gloo exited {p.returncode}: {out[-3000:]}")
    wall = (time.perf_counter() - t0) * 1e3
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in (0, 1)]
    if len(ranks[0]["masks"]) != len(ranks[1]["masks"]):
        fail("the two gloo ranks made different numbers of ReLU calls")
    replay = ReluReplay([torch.cat(pair) for pair in zip(ranks[0].pop("masks"),
                                                         ranks[1].pop("masks"))])
    model = _train_model("adamvs", {}, 0, DEV)
    trainer = trainer_of(model, "single")
    with replay:
        one = _dp_result(model, trainer.train_epoch(0, [dp_batch()])["loss"])
    del model, trainer
    share = replay.flips / max(sum(m.numel() for m in replay.masks), 1)
    if replay.calls != len(replay.masks) or share > ReluReplay.MAX_FLIPS:
        fail(f"one process made {replay.calls} ReLU calls of the ranks' {len(replay.masks)}, "
             f"{replay.flips} decisions of its own differ")
    errs = []
    for r, got in enumerate(ranks):
        lrel, grel, prel, srel = compare(got, one)
        errs.append((lrel, grel, prel, srel))
        log(f"[data_parallel] gloo rank {r} of 2 on one card, 1 step of fused AdaMVS on its "
            f"half of a 2-sample batch (uneven masks): loss {got['loss']:.6f} against one "
            f"process's {one['loss']:.6f} (rel {lrel:.2e}, limit 1e-4); gradient rel L2 "
            f"{grel:.2e} (limit 1e-3); parameters against RMSprop's step {prel:.2e} (limit "
            f"1e-6); BatchNorm statistics {srel:.2e} (limit 1e-4); launches {got['launches']}")
        if not (lrel < 1e-4 and grel < 1e-3 and prel < 1e-6 and srel < 1e-4):
            fail(f"data-parallel rank {r} over gloo disagrees with one process")
        if {k: n for k, n in got["launches"].items() if n} != per_step:
            fail(f"data-parallel rank {r}: launches {got['launches']}, expected {per_step}")
    if not all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]) for k in one["state"]):
        fail("the two gloo ranks' states differ after the step")
    stats.append({"path": "train_adamvs_data_parallel_gloo2", "world": 2, "backend": "gloo",
                  "wall_ms": wall, "step_ms_per_rank": [r["step_ms"] for r in ranks],
                  "launches_per_rank": ranks[0]["launches"],
                  "loss_rel_err": max(e[0] for e in errs), "grad_rel_l2": max(e[1] for e in errs),
                  "param_step_err": max(e[2] for e in errs), "bn_err": max(e[3] for e in errs),
                  "relu_flips": replay.flips})
    log(f"[data_parallel] gloo 2 ranks: {wall / 1e3:.1f} s for both processes (start-up, the "
        f"build's libraries loaded, one step of {ranks[0]['step_ms']:.1f} / "
        f"{ranks[1]['step_ms']:.1f} ms); one process took {replay.flips} of "
        f"{sum(m.numel() for m in replay.masks)} ReLU decisions from the ranks; the ranks' "
        f"states are equal")
    return launches, stats


def train_phase_times(state, loss_fn, batch) -> dict:
    """Milliseconds of one more train step's phases, host clock with a
    synchronise after each: the upload of the batch, the forward with the
    loss, the backward, and the RMSprop update."""
    from adamvs_tpu_torch.train.loop import to_device

    out = {}
    t0 = time.perf_counter()
    b = to_device(batch, torch.device(DEV))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state.optimizer.zero_grad(set_to_none=True)
    pred = state.model.train()(b["imgs"], b["proj_matrices"], b["depth_values"], train=True)
    loss, _ = loss_fn(pred, b["depth"], b["mask"], DLOSSW)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    state.optimizer.step()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    out["upload"], out["forward"] = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    out["backward"], out["update"] = (t3 - t2) * 1e3, (t4 - t3) * 1e3
    return out


def msrednet_layer_times(model, opts: dict) -> dict:
    """Milliseconds of one MS-REDNet depth map's layers, each timed alone at
    its full-width shape on seeded random inputs: the feature net on the V
    views; per stage the variance (K4 in the fused form; in the scan form the
    per-hypothesis warps through K6/K7 and the float32 sums, and apart from
    them the stage's 4 x D sampler calls alone), the RedCell recurrence over D
    from zero states (and the card's busy time in it, from a trace), and the
    online softmax over D. Beside them, one GroupNorm(1) at the level-1 state's shape, as PyTorch's module computes it
    and as the port does (``group_norm1``). With ``reg_impl="precomp"`` only
    ``red_precomp_depth`` per stage (and its busy time): the layers around it
    are msrednet_fused's, timed in the same run."""
    from adamvs_tpu_torch.models.msrednet import red_precomp_depth, variance_slice
    from adamvs_tpu_torch.nn.blocks import group_norm1
    from adamvs_tpu_torch.ops.regression import (online_softmax_finalize, online_softmax_init,
                                                 online_softmax_update)
    from adamvs_tpu_torch.ops.sweep_fuse import var_sweep_volume
    from adamvs_tpu_torch.ops.warp import sweep_coords, view_transforms
    from adamvs_tpu_torch.ops.warp_sample import sample_bilinear

    dt = torch.bfloat16
    gen = torch.Generator(device=DEV).manual_seed(3)
    x = torch.randn((V, 3, H, W), generator=gen, device=DEV).to(dt)
    out = {}
    only_precomp = opts.get("reg_impl") == "precomp"
    with torch.no_grad():
        if not only_precomp:
            out["feature_net"] = time_ms(lambda: model.feature(x), 3)
        del x
        for si in range(3):
            st = StageInputs(si, gen)
            ref, srcs = st.feats(dt)
            tag = f"stage{si + 1}"
            fused = lambda: var_sweep_volume(ref, srcs, st.src_projs, st.ref_proj, st.lo, st.step,
                                             st.D)
            cell = model.cost_regularization[si]
            if only_precomp:
                vol = fused()
                precomp = lambda: red_precomp_depth(cell, vol, st.lo, st.step)
                out[f"precomp_{tag}"] = time_ms(precomp, 3)
                out[f"precomp_busy_{tag}"] = device_busy_ms(precomp)
                del st, ref, srcs, vol
                torch.cuda.empty_cache()
                continue
            if opts["sweep_impl"] == "fused":
                out[f"variance_{tag}"] = time_ms(fused, 3)
            else:
                transforms = view_transforms(st.src_projs, st.ref_proj)
                out[f"variance_{tag}"] = time_ms(lambda: [
                    variance_slice(ref, srcs, transforms, st.lo + float(d) * st.step)
                    for d in range(st.D)], 2)
                # the sampler calls alone: all source views of a hypothesis in one call
                coords = []
                for d in range(st.D):
                    uv = [sweep_coords(srcs[v], st.src_projs[v], st.ref_proj,
                                       (st.lo + float(d) * st.step)[:, None]) for v in range(V - 1)]
                    coords.append((torch.cat([a for a, _ in uv]), torch.cat([b for _, b in uv])))
                flat = srcs.flatten(0, 1)

                def sampler():
                    for uv in coords:
                        sample_bilinear(flat, *uv)

                out[f"sampler_{tag}"] = time_ms(sampler, 3)
                del coords
            vol = fused()

            def recurrence():
                state = cell.init_state(1, st.h, st.w, dt, DEV)
                for d in range(st.D):
                    state, _ = cell(state, vol[d])

            out[f"redcell_{tag}"] = time_ms(recurrence, 5)
            out[f"redcell_busy_{tag}"] = device_busy_ms(recurrence)
            gn = cell.conv_gru1.output_norm
            hx = torch.randn((1, cell.base, st.h, st.w), generator=gen, device=DEV).to(dt)
            out[f"groupnorm_module_{tag}"] = time_ms(lambda: gn(hx), 3)
            out[f"groupnorm_port_{tag}"] = time_ms(lambda: group_norm1(hx, gn), 3)
            cost = torch.randn((st.D, 1, st.h, st.w), generator=gen, device=DEV)

            def softmax():
                acc = online_softmax_init((1, st.h, st.w), device=DEV)
                for d in range(st.D):
                    acc = online_softmax_update(acc, cost[d], st.lo + float(d) * st.step)
                return online_softmax_finalize(acc)

            out[f"online_softmax_{tag}"] = time_ms(softmax, 3)
            del st, ref, srcs, vol, cost, hx
            torch.cuda.empty_cache()
    log(f"[main] msrednet {opts} layers (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def layer_times(model, sample) -> dict:
    """Milliseconds of the main path's layers outside the kernels, each timed
    alone at its full-width shape: the image upload, the feature net on the
    V views, the stage-1 CostRegNet2D on the V-1 corr volumes, and the three
    stages' softmax regression."""
    from adamvs_tpu_torch.ops.regression import softmax_regression

    dt = torch.bfloat16
    t0 = time.perf_counter()
    imgs = torch.from_numpy(sample.imgs).to(DEV)
    torch.cuda.synchronize()
    out = {"upload": (time.perf_counter() - t0) * 1e3}
    x = imgs.permute(0, 3, 1, 2).to(dt)
    gen = torch.Generator(device=DEV).manual_seed(2)
    corr = torch.randn((V - 1, NDEPTHS[0], H // 4, W // 4), generator=gen, device=DEV, dtype=dt)
    with torch.no_grad():
        out["feature_net"] = time_ms(lambda: model.feature(x), 3)
        out["reg2d"] = time_ms(lambda: model.DepthNet[0].reg(corr), 3)
        tails = 0.0
        for si, D in enumerate(NDEPTHS):
            oh, ow = (H // 2, W // 2) if si == 0 else (H, W)
            cost = torch.randn((D, 1, oh, ow), generator=gen, device=DEV, dtype=dt)
            lo = torch.full((1, oh, ow), DMIN, device=DEV)
            tails += time_ms(lambda: softmax_regression(cost, lo, lo), 3)
        out["softmax_regression"] = tails
    log("[main] layers outside the kernels (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def kernels_line(res: dict, launches: dict) -> dict:
    out = []
    for k in KERNELS:
        name, source, replaces = REPLACES[k]
        stages = res[k]["stages"]
        libs = [s["library_ms"] for s in stages if "library_ms" in s]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[k],
            "max_abs_err": res[k]["err"][MAIN_DTYPE.get(k, "bf16")][0],
            "ms": sum(s["ms"] for s in stages),
            "plain_ms": sum(s["plain_ms"] for s in stages),
            "bound_ms": sum(s["bound_ms"] for s in stages),
            "bound_by": max(stages, key=lambda s: s["bound_ms"])["bound_by"],
            "library_ms": sum(libs) if libs else None,
            "max_abs_err_f32": res[k]["err"]["f32"][0],
            "max_rel_err": {t: e[1] for t, e in res[k]["err"].items()},
            # at the row bands of predict --tiles 4 (phase_bands)
            "band_max_abs_err": {t[5:]: e[0] for t, e in res[k]["err"].items()
                                 if t.startswith("band ")} or None,
            "stages": stages,
            **{key: res[k][key] for key in ("f32_eval_stages", "f32_full_stages")
               if key in res[k]},
        })
    return {"kernels": out}


# text edits of the kernel sources for ablate(), by group of kernels: each
# removes one part of the kernels' work (the results are wrong; only the times
# count) or changes one of their constants. An edit is (anchor, replacement):
# the anchor must occur exactly once in the group's source (ABLATION_SOURCES).
ABLATIONS = {"sweep_fuse": {
    "no sampling": [("    if (own && cur.w > 0) {", "    if (own && cur.w < 0) {")],
    "trivial positions": [(
        "        uv = adamvs::sweep_position(rxyz, gv + 9, hyp);",
        "        uv = make_float2(__fadd_rn(static_cast<float>(x), __fmul_rn(0.6f, static_cast<float>(d))),\n"
        "                         static_cast<float>(y));")],
    "no copies": [(
        "            cp_async16(dst, sv + (static_cast<size_t>(y) * W + x) * (C * sizeof(T)) + 16 * c);",
        "            { if (x == -12345) cp_async16(dst, sv); }")],
    "no stores": [
        ("        store(o + static_cast<size_t>(c) * hw, __fsub_rn(",
         "        if (acc[j][c] == 1.2345e-30f) store(o + static_cast<size_t>(c) * hw, __fsub_rn("),
        ("        store(o + static_cast<size_t>(c) * hw, __fmul_rn(r[c], acc[j][c]));",
         "        if (acc[j][c] == 1.2345e-30f) store(o + static_cast<size_t>(c) * hw, acc[j][c]);")],
    "empty kernel": [("  const int tid = threadIdx.x;\n  const int p = tid % P",
                      "  if (Vs > 0) return;\n  const int tid = threadIdx.x;\n  const int p = tid % P")],
}}
ABLATIONS["sweep_fuse"]["skeleton"] = sum(
    (ABLATIONS["sweep_fuse"][k] for k in ("no sampling", "trivial positions", "no copies",
                                          "no stores")), [])
# K5-fused and K5-var (csrc/sweep_bwd.cu)
ABLATIONS["sweep_bwd"] = {
    "no sampling": [("    if (cur.w > 0) {  // a view with no tap in the image adds nothing",
                     "    if (cur.w < 0) {")],
    "no shared atomics": [("        red_shared(base + static_cast<unsigned>((rot + c) & (C - 1)) * 4, "
                           "__fmul_rn(w, v[c]));",
                           "        if (v[c] == 1.2345e-30f) red_shared(base, w);")],
    "no flush": [("      if (x >= 0 && x < W && y >= 0 && y < H &&\n          (e[0] != 0.f",
                  "      if (x == -12345 && x < W && y >= 0 && y < H &&\n          (e[0] != 0.f")],
    "no gathers": [("            load8_shared(wb + (q0 + (k & 1) + (k >> 1) * win.w) * kPix, vals);",
                    "            for (int c = 0; c < 8; ++c) vals[c] = wk[c & 3];")],
    "no cotangent reads": [("const float gc = to_f32(gp[static_cast<size_t>(c) * hw]);",
                            "const float gc = 1e-3f * static_cast<float>(c + d);")],
    "empty kernel": [("  constexpr int P = S::kPixels, KD = S::kD;\n  extern __shared__",
                      "  constexpr int P = S::kPixels, KD = S::kD;\n  if (Vs > 0) return;\n"
                      "  extern __shared__")],
}
# K1 (csrc/sweep_fuse.cu::corr_walk_kernel): runs of 8 and 16 hypotheses against the
# built 48, and registers for 6 blocks of 128 threads per SM against 4; no reuse
# computes the dot product of every tap that counts
ABLATIONS["corr"] = {
    "runs of 8": [("constexpr int kRun = 48;", "constexpr int kRun = 8;")],
    "runs of 16": [("constexpr int kRun = 48;", "constexpr int kRun = 16;")],
    "6 blocks per SM": [("__launch_bounds__(kWalkThreads, 4)\ncorr_walk_kernel",
                         "__launch_bounds__(kWalkThreads, 6)\ncorr_walk_kernel")],
    "no reuse": [("      const int taps = adamvs::walk_taps(c), need = taps & ~held;",
                  "      const int taps = adamvs::walk_taps(c), need = taps;")],
    "no gathers": [("    Row<T, 8>::load(p + 8 * i, v);",
                    "    for (int c = 0; c < 8; ++c) v[c] = r[8 * i + (c ^ 1)];")],
    "no stores": [("    *o = acc / static_cast<float>(C);", "    if (acc == 1.2345e-30f) *o = acc;")],
    "empty kernel": [("  const int pix = blockIdx.x * kWalkThreads + threadIdx.x;",
                      "  if (D > 0) return;\n"
                      "  const int pix = blockIdx.x * kWalkThreads + threadIdx.x;")],
}
# K5-corr (csrc/sweep_bwd.cu::corr_walk_bwd_kernel): no reuse flushes every tap at
# every sample; no scatter leaves out the flushes' global atomics, no flush the
# whole flush (its source rows, d ref's multiply-adds and the atomics)
ABLATIONS["corr_bwd"] = {
    "runs of 8": [("constexpr int kRun = 16;", "constexpr int kRun = 8;")],
    "runs of 48": [("constexpr int kRun = 16;", "constexpr int kRun = 48;")],
    "no reuse": [("    const int stay = some ? adamvs::staying(ddx, ddy) : 0;",
                  "    const int stay = 0;")],
    "no gathers": [("        Row<T, 8>::load(s + q + 8 * i, v);",
                    "        for (int e = 0; e < 8; ++e) v[e] = 1e-3f * static_cast<float>(e + i);")],
    "no scatter": [("        atomicAdd(dq, make_float4(",
                    "        if (aq == 1.2345e-30f) atomicAdd(dq, make_float4("),
                   ("        atomicAdd(dq + 1, make_float4(",
                    "        if (aq == 1.2345e-30f) atomicAdd(dq + 1, make_float4(")],
    "no flush": [("      if ((stay >> j & 1) || aq == 0.f) continue;",
                  "      if ((stay >> j & 1) || aq == 0.f || hx > -9) continue;")],
    "empty kernel": [("  const int pix = blockIdx.x * kWalkThreads + threadIdx.x;",
                      "  if (D > 0) return;\n"
                      "  const int pix = blockIdx.x * kWalkThreads + threadIdx.x;")],
}
# K6/K7-bwd (csrc/bilinear_sample.cu): the tile kernel (N = 1) with other tile shapes
# (8x8 as built; 32x2, 16x4 and 8x4 samples; 8x16 with a box of 256), without its warp
# match (wrong where samples share a corner: timing only), with every tile sent the
# direct way, without the box's flush; the walk (N = 16) with its next sample read
# after the current one is walked instead of before
ABLATIONS["sample_bwd"] = {
    "tiles 32x2": [("constexpr int kTileW = 8; ", "constexpr int kTileW = 32; ")],
    "tiles 16x4": [("constexpr int kTileW = 8; ", "constexpr int kTileW = 16; ")],
    "tiles 8x4": [("constexpr int kSteps = 2; ", "constexpr int kSteps = 1; "),
                  ("constexpr int kBoxCap = 160;", "constexpr int kBoxCap = 80;")],
    "tiles 8x16": [("constexpr int kSteps = 2; ", "constexpr int kSteps = 4; "),
                   ("constexpr int kBoxCap = 160;", "constexpr int kBoxCap = 256;")],
    "no match": [("const unsigned peers = __match_any_sync(kFull, corner);",
                  "const unsigned peers = 1u << lane;")],
    "all direct": [("const bool staged = bw * bh <= kBoxCap;", "const bool staged = false;")],
    "no flush": [("      atomicAdd(reinterpret_cast<float4*>(dst + q * C) + (j & 1), a);\n", "")],
    "empty kernels": [
        ("  long long job = static_cast<long long>(blockIdx.x) * kWarps + warp;\n",
         "  if (B > 0) return;\n  long long job = static_cast<long long>(blockIdx.x) * kWarps + warp;\n"),
        ("  const long long id = static_cast<long long>(blockIdx.x) * kWalkThreads + threadIdx.x;\n",
         "  if (B > 0) return;\n"
         "  const long long id = static_cast<long long>(blockIdx.x) * kWalkThreads + threadIdx.x;\n")],
}
ABLATION_SOURCES = {"sweep_fuse": "sweep_fuse", "sweep_bwd": "sweep_bwd", "corr": "sweep_fuse",
                    "corr_bwd": "sweep_bwd", "sample_bwd": "bilinear_sample"}
# the stages (or K6/K7-bwd's cases) each group is timed at
ABLATION_STAGES = {"corr": (0,), "corr_bwd": (0,), "sample_bwd": tuple(range(len(SAMPLE_BWD_CASES)))}


def _ablation_calls(group: str, si: int, gen):
    """(module, its entries attribute, binder of a built library, {kernel:
    call}) of the kernels of ``group`` at stage ``si``: K2 and K4, and K1
    (stage 1), in bf16 at the inference stage shape; K5-fused and K5-var,
    and K5-corr (stage 1), in float32 at the training stage shape with the
    forward's geometry handed in, as the training forms call them; K6/K7-bwd
    at case ``si`` of SAMPLE_BWD_CASES in float32, the calls of one train step
    (4 source views a call)."""
    from adamvs_tpu_torch.kernels import build
    from adamvs_tpu_torch.ops import sweep_fuse as sf
    from adamvs_tpu_torch.ops import warp_sample as ws
    from adamvs_tpu_torch.ops.warp import sweep_coords

    if group == "sample_bwd":
        stage, N, n_calls = SAMPLE_BWD_CASES[si]
        st = StageInputs(stage, gen, TRAIN_H, TRAIN_W)
        hyp = st.lo[:, None] + ((st.D - N) // 2 + torch.arange(N, device=DEV))[
            None, :, None, None] * st.step[:, None]
        uv = [sweep_coords(st.srcs[i], st.src_projs[i], st.ref_proj, hyp) for i in range(V - 1)]
        u, v = torch.cat([a for a, _ in uv]), torch.cat([b for _, b in uv])
        g = torch.randn((V - 1, N, st.h, st.w, st.C), generator=gen, device=DEV)

        def step_calls():
            for _ in range(n_calls):
                ws.sample_bilinear_bwd(g, u, v, st.h, st.w)

        bind = lambda lib: (lib, build.bind(lib, "adamvs_bilinear_sample_bwd", n_ptr=5, n_int=8))
        return ws, "_bwd_entry", bind, {f"K6/7-bwd N{N} C{st.C}": step_calls}
    if ABLATION_SOURCES[group] == "sweep_fuse":
        st = StageInputs(si, gen)
        ref, srcs = st.feats(torch.bfloat16)
        geo = (st.src_projs, st.ref_proj, st.lo, st.step, st.D)
        if group == "corr":
            return sf, "_entries", sf.bind_sweeps, {
                "K1": lambda: sf.corr_sweep_volume(ref, srcs, *geo)}
        return sf, "_entries", sf.bind_sweeps, {
            "K2": lambda: sf.fused_sweep_volume(ref, srcs, st.weights, *geo),
            "K4": lambda: sf.var_sweep_volume(ref, srcs, *geo)}
    st = StageInputs(si, gen, TRAIN_H, TRAIN_W)
    ref, srcs = st.feats(torch.float32)
    geo = (st.src_projs, st.ref_proj, st.lo, st.step)
    geom = sf.sweep_geometry(st.src_projs, st.ref_proj)
    wn = sf.normalize_weights(st.weights)
    modes = ("corr",) if group == "corr_bwd" else ("fused", "var")
    calls = {}
    for mode in modes:
        kern = _k5_calls(mode, _cotangent(mode, st, torch.float32, gen), ref, srcs, wn, geo)[0]
        calls[f"K5-{mode}"] = lambda kern=kern: kern(geom=geom)
    return sf, "_bwd_entries", sf.bind_sweep_bwd, calls


def k5_wrapper_parts(group: str, rounds: int, reps: int) -> None:
    """What CUDA events around a K5 call of ``group`` (sweep_bwd: K5-fused and
    K5-var; corr_bwd: K5-corr) see beyond the kernel, in float32 at the
    training stage shapes, ms per train step (the least of ``rounds``
    medians of ``reps`` runs): the call with the forward's geometry handed in,
    as the training forms make it, the call that computes its own, the
    geometry alone and the zeroing of the gradients alone."""
    from adamvs_tpu_torch.ops import sweep_fuse as sf

    gen = torch.Generator(device=DEV).manual_seed(0)
    modes = ("corr",) if group == "corr_bwd" else ("fused", "var")
    total = {}
    for si in (0,) if group == "corr_bwd" else range(3):
        st = StageInputs(si, gen, TRAIN_H, TRAIN_W)
        ref, srcs = st.feats(torch.float32)
        geo = (st.src_projs, st.ref_proj, st.lo, st.step)
        geom = sf.sweep_geometry(st.src_projs, st.ref_proj)
        wn = sf.normalize_weights(st.weights)
        for mode in modes:
            kern = _k5_calls(mode, _cotangent(mode, st, torch.float32, gen), ref, srcs, wn, geo)[0]
            parts = {"with the forward's geometry": lambda: kern(geom=geom), "with its own": kern,
                     "the geometry alone": lambda: sf.sweep_geometry(st.src_projs, st.ref_proj),
                     "the zeroing alone": lambda: (torch.zeros_like(ref), torch.zeros_like(srcs))}
            with torch.no_grad():
                times = {n: min(time_ms(f, reps) for _ in range(rounds)) for n, f in parts.items()}
            for n, t in times.items():
                total.setdefault(mode, {}).setdefault(n, 0.0)
                total[mode][n] += t
            log(f"[ablate] {group} stage{si + 1} K5-{mode} wrapper: "
                + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items()))
        del st, ref, srcs, geom, wn
        torch.cuda.empty_cache()
    for mode, times in total.items():
        log(f"[ablate] {group} per train step, K5-{mode} wrapper: "
            + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items()))


def probe_parallel(items=("1", "2", "3", "4", "5")) -> None:
    """``python3 chip_smoke.py --probe-parallel [item ...]``: the measurements
    behind the parallel paths' findings (PERF.md §6), information only, no
    limit; ``items`` picks among:

    1. on the host's CPU, how far 4 row bands (halo 96: 448-row band views)
       move the depth of fused MS-REDNet and of fused AdaMVS with the cell
       stepped from their unbanded maps on a 1024x256 frame (seeded random
       images, the bench geometry, base 8, float32);
    2. on the host's CPU, one float32 train step of fused AdaMVS on a
       2-sample 64x128 ``dp_batch`` through the data-parallel path of
       a one-rank gloo group against the plain step: the gradient's distance
       with and without the plain step's ReLU decisions replayed, and how
       many of them the replayed step would have taken otherwise;
    3. on the card, the float32 AdaMVS scan form on the main paths' request,
       run twice and in 4 depth blocks with cuDNN's default algorithms: the
       depth distance per stage; and K6/K7 with a block of hypotheses per
       call against one hypothesis per call, bitwise;
    4. fused MS-REDNet (seed 1) unbanded on a 512x256 frame, per stage: the
       card against the CPU, and the CPU against itself with every weight
       moved by one float32 step (random signs), beside the largest value of
       its stage-1 variance volume; then both again with the stage features
       scaled (``out1``..``out3``) so that this largest value is 1. If the
       seeded weights' tiny variances, not the port, part card from CPU, the
       one-step move parts the seeded model as far, and the scaled model's
       card and CPU maps agree to rounding;
    5. on the card, the cost of a data-parallel step: fused AdaMVS float32
       train steps on the training batch (384x768, V=5) through the plain
       Trainer and through the Trainer over a one-rank nccl data group, one
       warm-up step each, then ``DP_PAIRS`` pairs in alternating order: the
       median and quartiles of each one's ms per step."""
    import torch.distributed as dist

    from adamvs_tpu_torch.kernels import build
    from adamvs_tpu_torch.models import build_model, model_loss
    from adamvs_tpu_torch.models import msrednet as msrednet_module
    from adamvs_tpu_torch.ops import warp_sample as ws
    from adamvs_tpu_torch.ops.warp import _source_coords, warp_transform
    from adamvs_tpu_torch.parallel import initialize_distributed, make_mesh
    from adamvs_tpu_torch.parallel.dryrun import free_port
    from adamvs_tpu_torch.predict.tiled import tiled_forward
    from adamvs_tpu_torch.train.loop import make_train_step, to_device
    from adamvs_tpu_torch.train.state import create_train_state, make_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    phase_device()
    build.build_all()

    def frame(h, w, seed):
        rng = np.random.RandomState(seed)
        imgs = torch.from_numpy(rng.randn(1, V, h, w, 3).astype(np.float32))
        projs = {k: torch.from_numpy(p[None])
                 for k, p in bench_projs(h, w, V, FOCAL * h / H).items()}
        return imgs, projs, torch.tensor([[DMIN, DMAX]])

    # 1. bands against the unbanded map, CPU
    if "1" in items:
        imgs, projs, dv = frame(1024, 256, 0)
        for name, opts in (("msrednet", {"sweep_impl": "fused"}),
                           ("adamvs", {"sweep_impl": "fused", "reg_impl": "scan"})):
            model = build_model(name, seed=0, device="cpu", ndepths=NDEPTHS,
                                depth_intervals_ratio=RATIOS, base=BASE, cr_base=(BASE,) * 3, **opts)
            want = model(imgs, projs, dv, num_depth=NUM_DEPTH)["depth"][0].numpy()
            got = tiled_forward(model, imgs, projs, dv, TILES, num_depth=NUM_DEPTH, halo=96)[0]
            err = np.abs(got[0].numpy() - want)
            log(f"[probe] {name} {opts} 1024x256 CPU, {TILES} bands, halo 96, against the unbanded "
                f"map: median |Δ| {np.median(err):.4g}, max {err.max():.4g}, "
                f"{(err < 1e-2).mean():.2%} within 1e-2")

    # 2. the data-parallel step's gradient against the plain one, ReLU decisions replayed or not
    if "2" in items:
        batch = to_device(dp_batch(64, 128), torch.device("cpu"))
        initialize_distributed(f"localhost:{free_port()}", 1, 0, backend="gloo", timeout_s=300)
        try:
            group = make_mesh(data=1).data_group

            def grad(g, mode):
                model = _train_model("adamvs", {}, 0, "cpu")
                state = create_train_state(model, make_optimizer(model.parameters(), lr=1e-3))
                with mode:
                    make_train_step(model_loss("adamvs"), DLOSSW, g)(state, batch)
                return torch.cat([p.grad.flatten() for p in model.parameters()])

            record = ReluReplay()
            plain = grad(None, record)
            replay = ReluReplay(record.masks)
            replayed = grad(group, replay)
            free = grad(group, contextlib.nullcontext())
        finally:
            dist.destroy_process_group()
        log(f"[probe] fused AdaMVS train step, 2 x 64x128, CPU: the data-parallel path of a one-rank "
            f"group against the plain step, gradient rel L2 {float((free - plain).norm() / plain.norm()):.3e} "
            f"unreplayed, {float((replayed - plain).norm() / plain.norm()):.3e} with the plain step's "
            f"ReLU decisions replayed ({replay.flips} of {sum(m.numel() for m in record.masks)} "
            f"would have differed)")

    # 3. the scan form's run-to-run distance and the depth blocks, card, default cuDNN
    if "3" in items:
        sample = _bench_sample()
        imgs = torch.from_numpy(sample.imgs[None]).to(DEV)
        projs = {k: torch.from_numpy(v[None]).to(DEV) for k, v in sample.proj_matrices.items()}
        dv = torch.from_numpy(sample.depth_values[None]).to(DEV)
        kw = dict(seed=0, device=DEV, ndepths=NDEPTHS, depth_intervals_ratio=RATIOS, base=BASE,
                  cr_base=(BASE,) * 3, sweep_impl="scan", reg_impl="scan")
        plain = build_model("adamvs", **kw)
        a, b = (plain(imgs, projs, dv, num_depth=NUM_DEPTH) for _ in range(2))
        c = build_model("adamvs", depth_shards=DEPTH_SHARDS, **kw)(imgs, projs, dv,
                                                                    num_depth=NUM_DEPTH)
        for k in ("stage1", "stage2", "stage3"):
            log(f"[probe] adamvs_scan {H}x{W} float32 {k}: depth max |Δ| between two runs "
                f"{(a[k]['depth'] - b[k]['depth']).abs().max().item():.3e}, {DEPTH_SHARDS} depth "
                f"blocks against the first {(c[k]['depth'] - a[k]['depth']).abs().max().item():.3e}")
        del a, b, c, plain
        gen = torch.Generator(device=DEV).manual_seed(0)
        for si, dk in ((0, 12), (1, 8), (2, 2)):
            st = StageInputs(si, gen)
            rot, trans = warp_transform(st.src_projs[0], st.ref_proj)
            d = torch.arange(dk, dtype=torch.float32, device=DEV)
            hyp = st.lo[:, None] + d[None, :, None, None] * st.step[:, None]
            block = ws.sample_bilinear(st.srcs[0], *_source_coords(rot, trans, hyp, st.h, st.w))
            single = torch.cat([ws.sample_bilinear(st.srcs[0], *_source_coords(
                rot, trans, (st.lo + float(i) * st.step)[:, None], st.h, st.w)) for i in range(dk)],
                dim=1)
            log(f"[probe] K6/7 stage{si + 1}, {dk} hypotheses per call against one per call: "
                f"{'bit-equal' if torch.equal(block, single) else 'differ'}")
            del st

    # 4. MS-REDNet's seeded weights at 512x256: card against CPU, and the CPU against itself
    #    with every weight moved by one float32 step; then both again with the stage
    #    features scaled so that the stage-1 variance volume reaches 1
    if "4" in items:
        imgs, projs, dv = frame(512, 256, 2)
        model = build_model("msrednet", seed=1, device="cpu", ndepths=NDEPTHS, base=BASE,
                            cr_base=(BASE,) * 3, sweep_impl="fused")

        def by_stage(a, b):
            return ", ".join(f"{(a[k]['depth'].cpu() - b[k]['depth']).abs().max().item() / (DMAX - DMIN):.3e}"
                             for k in ("stage1", "stage2", "stage3"))

        for scaled in (False, True):
            calls = []
            with torch.no_grad(), _recorded(msrednet_module, "var_sweep_volume", calls):
                got = copy.deepcopy(model).to(DEV)(
                    imgs.to(DEV), {k: p.to(DEV) for k, p in projs.items()}, dv.to(DEV),
                    num_depth=NUM_DEPTH)
                want = model(imgs, projs, dv, num_depth=NUM_DEPTH)
                moved = copy.deepcopy(model)
                signs = torch.Generator().manual_seed(0)
                for p in moved.parameters():
                    p.mul_(1 + 2.0 ** -23 * (torch.randint(0, 2, p.shape, generator=signs) * 2 - 1))
                step = moved(imgs, projs, dv, num_depth=NUM_DEPTH)
            vmax = calls[0][1].abs().max().item()
            log(f"[probe] msrednet_fused 512x256 float32{', stage features scaled' if scaled else ''}"
                f" (stage-1 variance volume up to {vmax:.3e}), depth max |Δ| of the range by stage: "
                f"card against CPU {by_stage(got, want)}; CPU with every weight moved by one "
                f"float32 step against CPU {by_stage(step, want)}")
            with torch.no_grad():  # the stage outputs are 1x1 convolutions without bias
                for name in ("out1", "out2", "out3"):
                    getattr(model.feature, name).weight.mul_(vmax ** -0.5)

    # 5. the data-parallel step's cost against the plain step's, alternating, card
    if "5" in items:
        from adamvs_tpu_torch.train.loop import Trainer

        batch = train_batch(TRAIN_H, TRAIN_W)
        root = os.path.join(REPO, "adamvs_tpu_torch", "_build", "chip_smoke_dp_probe")
        shutil.rmtree(root, ignore_errors=True)
        initialize_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl", timeout_s=300)
        try:
            trainers = {}
            for label, mesh in (("plain", None), ("data_parallel", make_mesh(data=1))):
                model = _train_model("adamvs", {}, 0, DEV)
                state = create_train_state(model, make_optimizer(model.parameters(), lr=1e-3))
                trainers[label] = Trainer(state, model_loss("adamvs"), os.path.join(root, label),
                                          dlossw=DLOSSW, num_stages=3, ckpt_step_freq=0,
                                          log_fn=lambda m: None, device=DEV, mesh=mesh)
            times = {label: [] for label in trainers}
            for i in range(DP_PAIRS + 1):
                for label in (("plain", "data_parallel") if i % 2 else ("data_parallel", "plain")):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trainers[label].train_epoch(0, [batch])
                    if i:  # step 0 warms up
                        times[label].append((time.perf_counter() - t0) * 1e3)
        finally:
            dist.destroy_process_group()
        q = {k: statistics.quantiles(v, n=4) for k, v in times.items()}
        log(f"[probe] fused AdaMVS {TRAIN_H}x{TRAIN_W} float32 train step, {DP_PAIRS} alternating "
            f"pairs after a warm-up: data-parallel (one-rank nccl group) median "
            f"{q['data_parallel'][1]:.1f} ms (quartiles {q['data_parallel'][0]:.1f}-"
            f"{q['data_parallel'][2]:.1f}), plain {q['plain'][1]:.1f} ms (quartiles "
            f"{q['plain'][0]:.1f}-{q['plain'][2]:.1f})")

def ablate(groups=("sweep_fuse", "sweep_bwd", "corr", "corr_bwd", "sample_bwd"), rounds: int = 3,
           reps: int = 5) -> None:
    """``python3 chip_smoke.py --ablate [group ...]``: the kernels of each
    group at the stage shapes, built from their source as it is and from
    text-edited copies that each leave out a part of the kernels' work
    (ABLATIONS), timed in turns in one process (CUDA events, the least of
    ``rounds`` medians of ``reps`` runs) and by the card's busy time in one
    call (a trace, the least of ``rounds``). sweep_fuse: K2 and K4 in bf16 at
    the inference shapes, ms per depth map; sweep_bwd: K5-fused and K5-var
    in float32 at the training shapes, ms per train step; corr: K1 in bf16
    at the inference stage-1 shape, ms per depth map; corr_bwd: K5-corr in
    float32 at the training stage-1 shape, ms per train step; sample_bwd:
    K6/K7-bwd in float32 at SAMPLE_BWD_CASES, the calls of one train step per
    case (4 source views a call). The wrappers'
    own work (weight normalisation, geometry, allocation and zeroing) is in
    every time, on the host where the card waits for it; the "empty kernel"
    copy measures it, and for the K5 groups ``k5_wrapper_parts`` splits it."""
    from adamvs_tpu_torch.kernels import build
    from adamvs_tpu_torch.ops import sweep_fuse as sf

    log(f"[ablate] {phase_device()}")
    root = os.path.join(build.BUILD_DIR, "ablate")
    jobs = {}
    for group in groups:
        source = ABLATION_SOURCES[group]
        text0 = open(os.path.join(build.CSRC, f"{source}.cu")).read()
        for name, edits in {"as built": [], **ABLATIONS[group]}.items():
            text = text0
            for old, new in edits:
                if text.count(old) != 1:
                    fail(f"ablation {name!r}: its anchor is not in csrc/{source}.cu once")
                text = text.replace(old, new)
            d = os.path.join(root, group, name.replace(" ", "_"))
            os.makedirs(d, exist_ok=True)
            shutil.copy(os.path.join(build.CSRC, "common.cuh"), d)
            with open(os.path.join(d, f"{source}.cu"), "w") as f:
                f.write(text)
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
                   os.path.join(d, f"{source}.cu")]
            jobs[group, name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True))
    built = {}
    for (group, name), (d, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            fail(f"ablation {group} {name!r} did not build:\n{out}")
        built.setdefault(group, {})[name] = ctypes.CDLL(os.path.join(d, "lib.so"))
    for group, libs in built.items():
        gen = torch.Generator(device=DEV).manual_seed(0)
        total = {}
        per = "depth map" if ABLATION_SOURCES[group] == "sweep_fuse" else "train step"
        for si in ABLATION_STAGES.get(group, range(3)):
            module, attr, bind, calls = _ablation_calls(group, si, gen)
            bound = {name: bind(lib) for name, lib in libs.items()}
            entries = getattr(module, attr)
            # per variant and kernel: (CUDA events around a call, the card's busy time in it)
            best = {n: {k: [float("inf")] * 2 for k in calls} for n in bound}
            try:
                with torch.no_grad():
                    for r in range(rounds):
                        for name in list(bound)[:: 1 if r % 2 == 0 else -1]:
                            setattr(module, attr, lambda name=name: bound[name])
                            for k, call in calls.items():
                                b = best[name][k]
                                b[0] = min(b[0], time_ms(call, reps))
                                b[1] = min(b[1], device_busy_ms(call))
            finally:
                setattr(module, attr, entries)
            for name, times in best.items():
                for k, (t, busy) in times.items():
                    acc = total.setdefault(name, {}).setdefault(k, [0.0, 0.0])
                    acc[0] += t
                    acc[1] += busy
                where = f"case {si + 1}" if group == "sample_bwd" else f"stage{si + 1}"
                log(f"[ablate] {group} {where} {name}: "
                    + ", ".join(f"{k} {t:.3f} ms (card busy {busy:.3f})"
                                for k, (t, busy) in times.items()))
            del calls
            torch.cuda.empty_cache()
        for name, times in total.items():
            log(f"[ablate] {group} per {per}, {name}: "
                + ", ".join(f"{k} {t:.3f} ms (card busy {busy:.3f})"
                            for k, (t, busy) in times.items()))
        if group in ("sweep_bwd", "corr_bwd"):  # with the as-built copy: nothing builds csrc/
            entries, as_built = sf._bwd_entries, sf.bind_sweep_bwd(libs["as built"])
            sf._bwd_entries = lambda: as_built
            try:
                k5_wrapper_parts(group, rounds, reps)
            finally:
                sf._bwd_entries = entries


# text edits of csrc/red_scan.cu for k3_f32_probe, as in ABLATIONS; per variant the
# alternatives for the float32 form of PR 1 (eight direct-convolution kernels per depth
# step, cell_conv) and for its three phase kernels, the first whose anchors all occur
# once in the source being used
K3_F32_EDITS = {
    "empty kernels": (
        [("  extern __shared__ float ws[];\n", "  if (a.Ho > 0) return;\n  extern __shared__ float ws[];\n")],
        [("  float* gs = reinterpret_cast<float*>(smem);  // [c1 | h1] on the tile + 2\n",
          "  if (st.h > 0) return;\n  float* gs = reinterpret_cast<float*>(smem);\n"),
         ("  float* gs = reinterpret_cast<float*>(smem);  // [c2 | h2] on the tile + 2\n",
          "  if (st.h > 0) return;\n  float* gs = reinterpret_cast<float*>(smem);\n"),
         ("  float* hs = reinterpret_cast<float*>(smem);  // h1' on the tile + 1\n",
          "  if (st.h > 0) return;\n  float* hs = reinterpret_cast<float*>(smem);\n")]),
    "no weight loads": (
        [("  for (int i = threadIdx.y * kBX + threadIdx.x; i < nw; i += kBX * kBY) ws[i] = a.w[i];\n",
          "  if (nw < 0) ws[0] = a.w[0];\n")],),
    # the three-phase form: only a_hi b_hi of the three TF32 products, and the operands
    # fed unsplit (what the correction products and the split cost)
    "one TF32 product": (
        [("          mma_tf32(acc[t][nt], hi[t], b.z, b.w);\n          mma_tf32(acc[t][nt], lo[t], b.x, b.y);\n",
          "")],),
    "no split": (
        [("          hi[t][i] = tf32(v[i]);\n          lo[t][i] = tf32_operand(v[i] - __uint_as_float(hi[t][i]));\n",
          "          hi[t][i] = __float_as_uint(v[i]);\n          lo[t][i] = hi[t][i];\n")],),
}


def k3_variants(edits: dict, root: str) -> dict:
    """{name: (library, float32 entry)} of csrc/red_scan.cu built with each
    variant of ``edits`` (as K3_F32_EDITS) whose anchors the source has, one
    nvcc each, all at once, under ``root``."""
    from adamvs_tpu_torch.kernels import build

    text0 = open(os.path.join(build.CSRC, "red_scan.cu")).read()
    jobs = {}
    for name, alternatives in edits.items():
        found = next((e for e in alternatives if all(text0.count(old) == 1 for old, _ in e)), None)
        if found is None:
            log(f"[k3] variant {name!r}: no anchor set found in this source, left out")
            continue
        text = text0
        for old, new in found:
            text = text.replace(old, new)
        d = os.path.join(root, name.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(build.CSRC, "common.cuh"), d)
        with open(os.path.join(d, "red_scan.cu"), "w") as f:
            f.write(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
               os.path.join(d, "red_scan.cu")]
        jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    variants = {}
    for name, (d, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            fail(f"k3 variant {name!r} did not build:\n{out}")
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        variants[name] = (lib, build.bind(lib, "adamvs_red_scan_f32", n_ptr=17, n_int=7))
    return variants


def k3_f32_probe(tree: str | None = None, reps: int = 5) -> None:
    """``python3 chip_smoke.py --k3-f32 [TREE]``: K3's float32 form of the port
    in TREE (the root of a checkout; this one by default), to compare two
    versions of it in one call, each in its own process. At the eval step's
    and the full frame's stage shapes (``k3_f32_stages``), as built and as
    each variant of K3_F32_EDITS that its source has (CUDA events and the
    card's busy time), with the time by kernel of the trace; then the eval
    step of the fused AdaMVS Trainer (float32, the bench's training batch:
    host clock with a synchronize, median of ``reps`` after a warm-up, and
    the card's busy time) and the float32 fused AdaMVS map through
    PredictEngine (3 requests, the first a warm-up: ms, busy, peak). Ends
    with a ``[k3] {...}`` JSON line."""
    if tree:
        sys.path.insert(0, os.path.abspath(tree))
    from adamvs_tpu_torch.kernels import build
    from adamvs_tpu_torch.models import build_model, model_loss
    from adamvs_tpu_torch.ops import red_scan as rs
    from adamvs_tpu_torch.predict.engine import PredictEngine
    from adamvs_tpu_torch.train.loop import Trainer
    from adamvs_tpu_torch.train.state import create_train_state, make_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[k3] {phase_device()}; the port at {os.path.dirname(rs.__file__)}")
    build.build_all()
    root = os.path.join(build.BUILD_DIR, "k3_f32_probe")
    variants = k3_variants(K3_F32_EDITS, root)
    gen = torch.Generator(device=DEV).manual_seed(6)
    out = {"tree": os.path.dirname(os.path.dirname(rs.__file__))}
    for label, height, width in K3_F32_FRAMES:
        out[label] = k3_f32_stages(label, height, width, gen, 3, variants)
    # the eval step of the fused AdaMVS training path, float32
    model = _train_model("adamvs", {}, 0, DEV)
    state = create_train_state(model, make_optimizer(model.parameters(), lr=1e-3))
    trainer = Trainer(state, model_loss("adamvs"), os.path.join(root, "train"), dlossw=DLOSSW,
                      num_stages=3, ckpt_step_freq=0, log_fn=lambda m: None, device=DEV)
    batch = train_batch(TRAIN_H, TRAIN_W)
    times = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.eval_epoch(0, [batch])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    busy = device_busy_ms(lambda: trainer.eval_epoch(0, [batch]))
    out["eval_step"] = {"median_ms": statistics.median(times[1:]), "timed_ms": times[1:],
                        "busy_ms": busy}
    log(f"[k3] train_adamvs eval step f32 {TRAIN_H}x{TRAIN_W}: median {out['eval_step']['median_ms']:.1f} "
        f"ms (timed {', '.join(f'{t:.1f}' for t in times[1:])}), card busy {busy:.1f} ms")
    del model, state, trainer
    # the float32 fused map (predict --sweep_impl fused --reg_impl pallas, float32)
    model = build_model("adamvs", seed=0, device=DEV, dtype=torch.float32, ndepths=NDEPTHS,
                        depth_intervals_ratio=RATIOS, base=BASE, cr_base=(BASE,) * 3)
    engine = PredictEngine(model, num_depth=NUM_DEPTH, device=DEV)
    sample = _bench_sample()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        engine.predict_sample(sample)
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy = device_busy_ms(lambda: engine.predict_sample(sample))
    out["adamvs_f32_map"] = {"ms_per_map": statistics.mean(times[1:]), "timed_ms": times[1:],
                             "busy_ms": busy, "peak_gib": peak}
    log(f"[k3] adamvs f32 fused map {H}x{W}: {out['adamvs_f32_map']['ms_per_map']:.1f} ms "
        f"(timed {', '.join(f'{t:.1f}' for t in times[1:])}), card busy {busy:.1f} ms, peak "
        f"{peak:.2f} GiB")
    log("[k3] " + json.dumps(out))


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    try:
        import adamvs_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is not importable here: {e}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        log(f"[time] {phase.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    smi = timed(phase_device)
    timed(phase_build)
    res = timed(phase_kernels)
    timed(phase_k3_f32, res)
    timed(phase_k5, res)
    timed(phase_sample_bwd, res)
    timed(phase_edges)
    timed(phase_sweep_windows)
    timed(phase_bands, res)
    timed(phase_reference)
    timed(phase_train_reference)
    bf16_reference = timed(phase_train_reference_bf16)
    extras = timed(phase_extras)
    launches, main_stats = timed(phase_main_path)
    train_launches, train_stats = timed(phase_train_paths)
    tiled_launches, tiled_stats = timed(phase_tiled)
    shard_launches, shard_stats = timed(phase_depth_shards)
    dp_launches, dp_stats = timed(phase_data_parallel)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        t0 = time.perf_counter()
        tree, depth_range = cli_fixture(tmp)
        log(f"[time] cli_fixture: {time.perf_counter() - t0:.1f} s")
        host_io = timed(phase_host_io, tree)
        cli_launches, cli_stats = timed(phase_cli, tmp, tree, depth_range)
    cli_train_launches, cli_train_stats = timed(phase_cli_train)
    line = kernels_line(res, {k: n + train_launches[k] + tiled_launches[k] + shard_launches[k]
                              + dp_launches[k] + cli_launches[k] + cli_train_launches[k]
                              for k, n in launches.items()})
    line["main_path"] = main_stats + train_stats + tiled_stats + shard_stats + dp_stats
    line["train_reference_bf16"] = bf16_reference
    line["cli"] = cli_stats + cli_train_stats
    line["host_io"] = host_io
    line["extras"] = extras
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--probe-parallel"]:
        if not torch.cuda.is_available():
            fail("no CUDA device: the probes need one GPU")
        probe_parallel(*([sys.argv[2:]] if sys.argv[2:] else []))
    elif sys.argv[1:2] == ["--k3-f32"]:
        if not torch.cuda.is_available():
            fail("no CUDA device: the probe needs one GPU")
        k3_f32_probe(*sys.argv[2:3])
    elif sys.argv[1:2] == ["--cli-ab"]:
        if not torch.cuda.is_available() or len(sys.argv) != 3:
            fail("--cli-ab TREE needs one GPU and a checkout's root")
        cli_ab(sys.argv[2])
    elif sys.argv[1:2] == ["--ablate"]:
        if not torch.cuda.is_available():
            fail("no CUDA device: the ablation needs one GPU")
        ablate(*([sys.argv[2:]] if sys.argv[2:] else []))
    else:
        main()
