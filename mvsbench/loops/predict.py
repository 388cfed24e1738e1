"""Closed-loop prediction: one client sends a work item, waits for its depth
and confidence, sends the next.

A work item is a reference frame of a synthetic flight strip with its
nearest neighbours as sources (``scene.predict_items``), as numpy float32
frames of the size the mix states, as the predict command's loader hands a
sample to ``PredictEngine.predict_batch``; depth and confidence come back as
numpy arrays. Items cycle through the strip from an offset drawn from the
seed. Each request's latency is the host's clock around its
``predict_batch`` call; the window holds every request started before its
close and ends when the last one has returned.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import types
from unittest import mock

import numpy as np
import torch

from mvsbench import harness, program, trace
from mvsbench.check import check_predict
from mvsbench.scene import Strip, predict_items


@dataclasses.dataclass
class Window:
    wall_s: float = 0.0
    latencies_s: list = dataclasses.field(default_factory=list)
    kept: dict = dataclasses.field(default_factory=dict)  # request index -> (item, depth, conf)

    @property
    def maps(self) -> int:
        return len(self.latencies_s)


def closed_loop(engine, samples, offset: int, seconds: float, keep=(), before=None) -> Window:
    """Requests for ``seconds``; keeps the outputs of the request indices in
    ``keep``; ``before(i)`` runs just before request i is sent."""
    win = Window()
    n = len(samples)
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        item = (offset + i) % n
        if before is not None:
            before(i)
        ts = time.perf_counter()
        depth, conf = engine.predict_batch([samples[item]])[0]
        win.latencies_s.append(time.perf_counter() - ts)
        if i in keep:
            win.kept[i] = (item, depth, conf)
        i += 1
    win.wall_s = time.perf_counter() - t0
    return win


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))


def _instrumented(model, spans: dict, calls: dict):
    """Hooks and wrappers of the traced window: the upload span (from the
    request's start to the model's forward, synchronised), a ``feature_net``
    range around the feature module, and ``K2`` / ``K3`` ranges around the
    sweep and recurrence calls where the model looks them up, each call's
    shapes recorded."""
    from adamvs_tpu_torch.models import adamvs as ada

    feat = model.feature_module()
    model_device = next(model.parameters()).device
    ranges = []

    def pre_model(_m, _a):
        program.sync(model_device)
        spans["upload_s"].append(time.perf_counter() - spans["t_request"])

    def pre_feat(_m, _a):
        r = trace.label("feature_net")
        r.__enter__()
        ranges.append(r)

    def post_feat(_m, _a, _o):
        ranges.pop().__exit__(None, None, None)

    def wrap(fn, tag, shapes):
        def labelled(*a, **kw):
            calls[tag].append(shapes(*a))
            with trace.label(tag):
                return fn(*a, **kw)
        return labelled

    def k2_shapes(ref, srcs, _w, _sp, _rp, _lo, _st, num_depth, *rest):
        return {"B": ref.shape[0], "h": ref.shape[1], "w": ref.shape[2], "C": ref.shape[3],
                "Vs": srcs.shape[0], "D": int(num_depth), "es": ref.element_size()}

    def k3_shapes(cell, vol):
        D, B, cin, h, w = vol.shape
        return {"B": B, "h": h, "w": w, "cin": cin, "D": D, "base": cell.base, "up": cell.up,
                "es": vol.element_size()}

    hooks = [model.register_forward_pre_hook(pre_model), feat.register_forward_pre_hook(pre_feat),
             feat.register_forward_hook(post_feat)]
    patches = contextlib.ExitStack()
    patches.enter_context(mock.patch.object(ada, "fused_sweep_volume",
                                            wrap(ada.fused_sweep_volume, "K2", k2_shapes)))
    patches.enter_context(mock.patch.object(ada, "red_scan", wrap(ada.red_scan, "K3", k3_shapes)))
    return hooks, patches


def run(cell, args, t_start: float, device=None, plant=None):
    if plant is not None:
        plant()
    from adamvs_tpu_torch.predict.engine import PredictEngine

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device) if device else torch.device("cuda", 0)
    if dev.type == "cuda":
        from adamvs_tpu_torch.kernels import build

        torch.cuda.set_device(dev)
        build.build_all()
    items = predict_items(Strip(tr["scene"], args.seed + 1, dev), tr["items"], cfg["views"])
    dv = np.array(tr["depth_range"], np.float32)
    samples = [types.SimpleNamespace(imgs=it["imgs"], proj_matrices=it["proj_matrices"],
                                     depth_values=dv) for it in items]
    model = program.port_model(cfg, tr, program.draw_weights(cfg, args.seed, dev), dev)
    engine = PredictEngine(model, num_depth=cfg["num_depth"], device=dev,
                           feature_cache=tr["feature_cache"])
    rng = np.random.default_rng(args.seed)
    offset = int(rng.integers(len(samples)))
    t0 = time.perf_counter()
    for i in range(tr["warmup_requests"]):
        engine.predict_batch([samples[(offset + i) % len(samples)]])
    t_req = (time.perf_counter() - t0) / max(1, tr["warmup_requests"])
    # the requests whose outputs are compared, drawn from the seed among the first
    # half of the requests the window would hold at the warm-up's pace
    reach = max(1, int(0.5 * args.seconds / t_req))
    keep = set(rng.choice(reach, size=min(tr["check_requests"], reach), replace=False).tolist())
    program.sync(dev)
    setup_s = time.perf_counter() - t_start
    harness.log(f"[predict] set-up {setup_s:.3f} s, warm-up {t_req * 1e3:.1f} ms a request")

    win = closed_loop(engine, samples, offset, args.seconds, keep)
    harness.log(f"[predict] {win.maps} maps in {win.wall_s:.3f} s")
    res = types.SimpleNamespace(cell=cell, config=cfg, traffic=tr, window=win, trace=None,
                                spans={}, calls={}, traced_maps=0, breakdown=None,
                                busy_s=None, window_s=None)
    if args.trace:
        spans, calls = {"upload_s": [], "t_request": 0.0}, {"K2": [], "K3": []}
        hooks, patch = _instrumented(model, spans, calls)

        def spans_before(_i):
            program.sync(dev)
            spans["t_request"] = time.perf_counter()

        with patch, trace.traced() as holder, trace.window():
            tw = closed_loop(engine, samples, offset + win.maps, args.seconds,
                             before=spans_before)
        for h in hooks:
            h.remove()
        tr_ = holder[0]
        res.trace, res.spans, res.calls, res.traced_maps = tr_, spans, calls, tw.maps
        res.busy_s, res.window_s, res.breakdown = tr_.busy_s(), tr_.window_s, tr_.breakdown()
        harness.log(f"[predict] traced {tw.maps} maps in {tr_.window_s:.3f} s, busy "
                    f"{res.busy_s:.3f} s")
    peak = program.peak_bytes(dev)
    del engine, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, correct = check_predict(cell, args.seed, items, dv, win.kept, dev)
    res.correct, res.checks = correct, checks
    res.attempted, res.failed = win.maps, 0
    res.end_to_end = {"maps_per_s": win.maps / win.wall_s,
                      "map_ms_p95": p95(win.latencies_s) * 1e3, "setup_s": setup_s}
    res.device = (harness.device_info(cell.chips, peak) if dev.type == "cuda"
                  else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    return res
