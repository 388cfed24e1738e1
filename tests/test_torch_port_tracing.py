"""The port's spans (``adamvs_tpu_torch/tracing.py``) on the CPU.

Off (no profiler recording): a ``predict_batch`` and a Trainer step open no
record function, and ``span`` hands back the one shared no-op. On, under
``torch.profiler``: the host ranges ``adamvs.*`` nest as the engine, both
models (each inference form) and the Trainer open them, with one
``engine.request`` a map and one ``train.step`` a step, and none of them is
a user annotation (the kind the profiler mirrors on the device)."""

import types
from collections import Counter

import numpy as np
import pytest
import torch

from adamvs_tpu_torch import tracing
from adamvs_tpu_torch.data.pipeline import center_image
from adamvs_tpu_torch.data.synthetic import make_scene
from adamvs_tpu_torch.geom.camera import proj_matrix, stage_proj_matrices
from adamvs_tpu_torch.models import AdaMVS, MSREDNet, model_loss
from adamvs_tpu_torch.nn.blocks import init_parameters
from adamvs_tpu_torch.predict.engine import PredictEngine
from adamvs_tpu_torch.train.loop import Trainer
from adamvs_tpu_torch.train.state import create_train_state, make_optimizer

torch.set_num_threads(2)

TINY = dict(ndepths=(8, 4), depth_intervals_ratio=(4.0, 2.0), base=4, cr_base=(4, 4))


@pytest.fixture(scope="module")
def scene():
    return make_scene(num_views=3, height=64, width=64, seed=0)


def _sample(scene, view_ids=()):
    """A predict sample of the scene's three views, as the loader hands it."""
    proj = np.stack([proj_matrix(v.camera) for v in scene.views])
    return types.SimpleNamespace(
        imgs=np.stack([center_image(v.image) for v in scene.views]).astype(np.float32),
        proj_matrices=stage_proj_matrices(proj),
        depth_values=np.array([scene.depth_start, scene.depth_end], np.float32),
        view_ids=view_ids)


def _batch(scene):
    """A train batch of one sample (two stages: GT at 1/4 and full size)."""
    s = _sample(scene)
    gt = scene.views[0].depth[None].astype(np.float32)
    depth = {"stage1": np.ascontiguousarray(gt[:, ::4, ::4]), "stage2": gt}
    return {"imgs": s.imgs[None], "proj_matrices": {k: v[None] for k, v in
                                                    s.proj_matrices.items()},
            "depth_values": np.array([[scene.depth_start, scene.depth_end,
                                       scene.depth_interval]], np.float32),
            "depth": depth, "mask": {k: np.ones_like(v) for k, v in depth.items()},
            "depth_interval": np.array([scene.depth_interval], np.float32)}


def _model(cls, **opts):
    model = cls(**TINY, **opts)
    init_parameters(model, torch.Generator().manual_seed(0))
    return model


def _trainer(tmp_path, model):
    state = create_train_state(model, make_optimizer(model.parameters()))
    return Trainer(state, model_loss("adamvs" if isinstance(model, AdaMVS) else "msrednet"),
                   str(tmp_path), dlossw=(0.5, 1.0), num_stages=2, log_fn=lambda _m: None,
                   device="cpu")


def _spans(prof) -> tuple[Counter, set]:
    """(count of each ``adamvs.*`` host range, {(name, parent name)}): a
    range's parent is the innermost ``adamvs.*`` range that contains it
    (None at the root)."""
    rows = sorted((e.start_ns(), -(e.start_ns() + e.duration_ns()), e.name()[7:])
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(tracing.PREFIX))
    counts, pairs, stack = Counter(), set(), []
    for start, neg_end, name in rows:
        while stack and stack[-1][0] <= start:
            stack.pop()
        counts[name] += 1
        pairs.add((name, stack[-1][1] if stack else None))
        stack.append((-neg_end, name))
    return counts, pairs


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


def test_off_calls_no_record_function(scene, tmp_path, monkeypatch):
    calls = []
    real = tracing._RecordFunctionFast

    def counting(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(tracing, "_RecordFunctionFast", counting)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.span("engine.request") is tracing.OFF is tracing.span("train.step")
    engine = PredictEngine(_model(AdaMVS), num_depth=16, device="cpu")
    engine.predict_batch([_sample(scene)])
    _trainer(tmp_path, _model(AdaMVS)).train_epoch(0, [_batch(scene)])
    assert calls == []
    # the same calls under a profiler do open the spans
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        engine.predict_batch([_sample(scene)])
    assert "adamvs.engine.request" in calls


def test_spans_are_not_user_annotations(scene):
    """The spans are op-scope records: the profiler mirrors user annotations
    (``record_function``) on the device, and a span there would read as
    device activity."""
    engine = PredictEngine(_model(AdaMVS), num_depth=16, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.predict_batch([_sample(scene)])
        with torch.profiler.record_function("user.range"):
            pass
    events = prof.profiler.kineto_results.events()
    ours = [e for e in events if e.name().startswith(tracing.PREFIX)]
    assert ours and not any(e.is_user_annotation() for e in ours)
    assert [e.is_user_annotation() for e in events if e.name() == "user.range"] == [True]


def _stage_pairs(stages, parts):
    return {(f"model.{k}", "engine.request") for k in stages} | {
        (f"model.{k}.{p}", f"model.{k}") for k in stages for p in parts.get(k, ())}


ENGINE = {("engine.request", None), ("engine.upload", "engine.request"),
          ("engine.download", "engine.request"), ("model.features", "engine.request")}
FORMS = {
    "adamvs_fused": (AdaMVS, dict(sweep_impl="fused", reg_impl="pallas"),
                     {"stage1": ("match", "volume", "reg"), "stage2": ("volume", "reg")}),
    "adamvs_fused_stepped": (AdaMVS, dict(sweep_impl="fused", reg_impl="scan"),
                             {"stage1": ("match", "volume", "reg"),
                              "stage2": ("volume", "reg")}),
    "adamvs_scan": (AdaMVS, dict(sweep_impl="scan", reg_impl="scan"),
                    {"stage1": ("match", "reg"), "stage2": ("reg",)}),
    "msrednet_fused": (MSREDNet, dict(sweep_impl="fused"),
                       {"stage1": ("volume", "reg"), "stage2": ("volume", "reg")}),
    "msrednet_scan": (MSREDNet, dict(sweep_impl="scan"),
                      {"stage1": ("reg",), "stage2": ("reg",)}),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_predict_spans_nest(scene, form):
    cls, opts, parts = FORMS[form]
    engine = PredictEngine(_model(cls, **opts), num_depth=16, device="cpu")
    counts, pairs = _profiled(lambda: [engine.predict_batch([_sample(scene)]) for _ in range(2)])
    assert pairs == ENGINE | _stage_pairs(("stage1", "stage2"), parts)
    assert counts["engine.request"] == 2 and counts["model.stage2.reg"] == 2
    assert counts["engine.upload"] == counts["engine.download"] == 2


def test_predict_spans_with_the_feature_cache(scene):
    """The cached path: each missed view's upload and feature net inside the
    request; a second request over the same views hits the cache."""
    engine = PredictEngine(_model(AdaMVS), num_depth=16, device="cpu", feature_cache=3)
    counts, pairs = _profiled(lambda: [engine.predict_batch([_sample(scene, (0, 1, 2))])
                                       for _ in range(2)])
    parts = {"stage1": ("match", "volume", "reg"), "stage2": ("volume", "reg")}
    assert pairs == ENGINE | _stage_pairs(("stage1", "stage2"), parts)
    assert counts["engine.request"] == 2 and counts["model.features"] == 3
    assert counts["engine.upload"] == 3 + 2 and engine.cache_hits == 3


def test_train_spans_nest(scene, tmp_path):
    trainer = _trainer(tmp_path, _model(AdaMVS))
    counts, pairs = _profiled(lambda: trainer.train_epoch(0, [_batch(scene)] * 2))
    stages = {("model.stage1", "train.forward"), ("model.stage2", "train.forward")} | {
        (f"model.{k}.{p}", f"model.{k}") for k, ps in
        (("stage1", ("match", "volume", "reg")), ("stage2", ("volume", "reg"))) for p in ps}
    assert pairs == stages | {
        ("train.data", None), ("train.step", None), ("train.forward", "train.step"),
        ("model.features", "train.forward"), ("train.backward", "train.step"),
        ("train.finite_check", "train.step"), ("train.scalars", "train.step")}
    assert counts["train.step"] == 2 == len(trainer.times["step_s"])
    assert counts["train.data"] == 3  # the last wait finds the iterator spent
    for name in ("train.forward", "train.backward", "train.finite_check", "train.scalars"):
        assert counts[name] == 2, name
