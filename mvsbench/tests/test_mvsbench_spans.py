"""The program's spans in a trace (``mvsbench/spans.py``) and the readers of
``BENCHMARK.json``'s ``program_span`` metrics, on stub profiler events: a
``trace.Trace`` is built from a stand-in for ``torch.profiler.profile``
whose ``kineto_results.events()`` are hand-made, in milliseconds.

- The program's ranges are host rows only: busy time, kernel count, a
  harness range's device time and the breakdown read the same with them
  as without.
- Each reader returns None without its spans (the parent's program opens
  none) and the hand-computed value with them: host time in a span, device
  time of the work launched inside a span and the spans nested in it
  (launches paired one to one with activities, or no device time at all),
  idle time put down to the innermost of a step's phases (a gap split
  between a step and its finite check)."""

import types

import pytest
from torch.autograd import DeviceType

from mvsbench import harness, spans, trace

MS = 1_000_000  # ns


class Event:
    def __init__(self, name, device, start_ms, end_ms):
        self._name, self._device = name, device
        self._start, self._dur = int(start_ms * MS), int((end_ms - start_ms) * MS)

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur


def host(name, a, b):
    return Event(name, DeviceType.CPU, a, b)


def dev(name, a, b):
    return Event(name, DeviceType.CUDA, a, b)


def make_trace(events) -> trace.Trace:
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: list(events))))
    return trace.Trace(prof)


def shifted(events, ms):
    return [Event(e.name(), e.device_type(), e.start_ns() / MS + ms,
                  (e.start_ns() + e.duration_ns()) / MS + ms) for e in events]


def window(events, t1=100):
    return [host("mvsbench.window", 0, t1)] + events


# one map: host ranges of the engine, the model and the harness; the host's
# launch, copy and fill calls inside them, each a little before its activity
# on the device; the harness ranges' device-side annotations (the program's
# ranges have none)
def launched(name, at, a, b, call="cudaLaunchKernel"):
    return [host(call, at, at + 0.1), dev(name, a, b)]


MAP = [
    host("adamvs.engine.request", 1, 40),
    host("adamvs.engine.upload", 2, 6),
    *launched("Memcpy HtoD (Pageable -> Device)", 2.5, 3, 5, "cudaMemcpyAsync"),
    host("adamvs.model.features", 7, 12),
    *launched("cast", 7.5, 9, 9.5),
    host("mvsbench.feature_net", 8, 11),
    *launched("conv", 8.5, 10, 14, "cuLaunchKernel"),
    host("adamvs.model.stage1", 12, 20),
    *launched("copy_stage_views", 12.2, 15, 15.5),
    host("adamvs.model.stage1.match", 12.5, 14),
    *launched("K1", 13, 16, 17),
    host("adamvs.model.stage1.volume", 14, 15),
    host("mvsbench.K2", 14.2, 14.8),
    *launched("K2", 14.5, 17, 18),
    host("adamvs.model.stage1.reg", 15, 19),
    *launched("K3", 16, 18, 22),
    host("adamvs.model.stage2", 20, 25),
    host("adamvs.model.stage2.reg", 21, 24),
    *launched("K3", 22, 23, 26),
    host("adamvs.model.stage3", 25, 28),
    host("adamvs.model.stage3.volume", 25.5, 26),
    *launched("K2", 25.7, 27, 28),
    host("adamvs.model.stage3.reg", 26, 27.5),
    *launched("K3", 26.5, 28, 33),
    host("adamvs.engine.download", 28, 39),
    *launched("Memcpy DtoH (Device -> Pageable)", 29, 34, 35, "cudaMemcpyAsync"),
    dev("mvsbench.feature_net", 10, 14),
    dev("mvsbench.K2", 17, 18),
]
# per map: device ms launched inside features (cast + conv), stage 1 (its own copy,
# and K1, K2, K3 in the ranges nested in it), stage 2, stage 3; host ms
PREDICT = {"upload_span_ms": 4.0, "download_span_ms": 11.0, "features_span_ms": 4.5,
           "stage1_span_ms": 6.5, "stage2_span_ms": 3.0, "stage3_span_ms": 6.0}

# one train step; the device idles [1, 1.5], [3, 4], [9, 11], [15, 17], [21, 24], [27, 30]
STEP = [
    host("adamvs.train.data", 0.5, 1),
    host("adamvs.train.step", 1, 30),
    host("adamvs.train.forward", 2, 10),
    host("adamvs.train.backward", 10, 20),
    host("adamvs.train.finite_check", 20, 23),
    host("Optimizer.step#RMSprop.step", 23, 25),
    host("adamvs.train.scalars", 26, 28),
    dev("Memcpy HtoD (Pageable -> Device)", 1.5, 3),
    dev("fwd", 4, 9),
    dev("bwd", 11, 15),
    dev("bwd", 17, 21),
    dev("rmsprop", 24, 27),
]
# per step: forward idles [3, 4] and the first half of [9, 11]; backward the other half
# and [15, 17]; the finite check [21, 23] of the gap [21, 24], whose rest is the step's own
TRAIN = {"forward_span_ms": 8.0, "backward_span_ms": 10.0, "sync_span_ms": 5.0,
         "forward_idle_pct": 100 * 2 / 8, "backward_idle_pct": 100 * 3 / 10}


def read(name, t):
    return harness.reader(name)(types.SimpleNamespace(trace=t))


def test_program_spans_leave_the_device_side():
    """The program's ranges are host rows only: every device reading of the
    harness is as it is without them."""
    base = [e for e in MAP if not e.name().startswith("adamvs.")]
    without, with_ = make_trace(window(base)), make_trace(window(MAP))
    assert with_.notes == without.notes
    assert {n for n, _, _ in with_.notes} == {"mvsbench.feature_net", "mvsbench.K2"}
    assert with_.names == without.names
    assert with_.busy_s() == without.busy_s() == pytest.approx(
        (2 + 0.5 + 4 + 0.5 + 1 + 1 + 4 + 3 + 1 + 5 + 1) / 1e3)
    assert with_.kernels_in_window() == without.kernels_in_window() == 9
    assert with_.device_s_inside("K2") == without.device_s_inside("K2") == pytest.approx(1e-3)
    assert with_.breakdown()["device_ops"] == without.breakdown()["device_ops"]


@pytest.mark.parametrize("name", sorted(PREDICT) + sorted(TRAIN))
def test_readers_none_without_spans(name):
    plain = [e for e in MAP + STEP if not e.name().startswith("adamvs.")]
    assert read(name, make_trace(window(plain))) is None
    assert read(name, None) is None


@pytest.mark.parametrize("name", sorted(PREDICT))
def test_predict_readers(name):
    two_maps = make_trace(window(MAP + shifted(MAP, 50)))
    assert read(name, two_maps) == pytest.approx(PREDICT[name])


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_train_readers(name):
    two_steps = make_trace(window(STEP + shifted(STEP, 40)))
    assert read(name, two_steps) == pytest.approx(TRAIN[name])


def test_idle_put_down_to_the_innermost_phase():
    t = make_trace(window(STEP, t1=30))
    idle = spans.idle_s(t, spans.STEP_PHASES)
    want = {"train.step": 0.5 + 1 + 2, "train.forward": 1 + 1, "train.backward": 1 + 2,
            "train.finite_check": 2, "train.scalars": 1}
    assert idle == pytest.approx({k: v / 1e3 for k, v in want.items()})
    # every gap within the step counted once among its phases
    assert sum(idle.values()) == pytest.approx((30 - 1) / 1e3 - t.busy_s())
    # without the inner spans the whole gap is the step's
    assert spans.idle_s(t, ("train.step",))["train.step"] == pytest.approx(11.5e-3)


def test_device_time_follows_the_launches():
    """A span's device time is that of the activities launched inside it and
    inside the spans nested in it, wherever on the device they ran."""
    t = make_trace(window(MAP))
    assert spans.device_s(t, "model.features") == pytest.approx(4.5e-3)
    assert t.device_s_inside("feature_net") == pytest.approx(4e-3)
    assert spans.device_s(t, "model.stage1.volume") == pytest.approx(1e-3)
    assert spans.device_s(t, "model.stage1.match") == pytest.approx(1e-3)
    assert spans.device_s(t, "engine.request") == pytest.approx(t.busy_s())
    assert len(spans.intervals(t, "engine.request")) == 1
    assert spans.device_s(t, "engine.download") == pytest.approx(1e-3)
    assert spans.device_s(t, "train.step") is None


@pytest.mark.parametrize("fault", ["launch missing", "extra launch", "copy call meets a kernel"])
def test_unpaired_launches_give_no_device_time(fault):
    """Where the launches cannot be paired one to one with the activities
    (counts or kinds disagree), no device time is put down to a span; host
    times still read."""
    events = list(MAP)
    if fault == "launch missing":
        events.remove(next(e for e in events if e.name() == "cuLaunchKernel"))
    elif fault == "extra launch":
        events.append(host("cudaMemsetAsync", 21.5, 21.6))
    else:  # as many launches, each before its activity, but of the wrong kinds
        i = next(i for i, e in enumerate(events) if e.name() == "cuLaunchKernel")
        j = next(i for i, e in enumerate(events) if e.name() == "cudaMemcpyAsync")
        events[i] = host("cudaMemsetAsync", 8.5, 8.6)
        events[j] = host("cudaLaunchKernel", 2.5, 2.6)
    t = make_trace(window(events))
    assert spans.device_s(t, "model.features") is None
    assert read("features_span_ms", t) is None
    assert read("upload_span_ms", t) == pytest.approx(4.0)


def test_pairing_takes_no_clock():
    """The profiler's host and device clocks may differ by more than a
    launch's latency: an activity that reads as starting before its launch
    pairs all the same."""
    events = list(MAP)
    i = next(i for i, e in enumerate(events) if e.name() == "cuLaunchKernel")
    events[i] = host("cuLaunchKernel", 10.5, 10.6)  # conv reads as starting at 10
    t = make_trace(window(events))
    assert spans.device_s(t, "model.features") == pytest.approx(4.5e-3)
    assert read("features_span_ms", t) == pytest.approx(4.5)
