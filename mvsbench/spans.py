"""The program's own spans in a traced window: the ``adamvs.<name>`` host
ranges that the port opens while a profiler records (``adamvs_tpu_torch/
tracing.py``), as ``trace.Trace`` keeps them in ``host``. They carry no
device-side annotation, so the device's activity is left as it was.

The device work launched inside a span is found through the launches: the
host's launch, copy and fill calls (``cudaLaunchKernel``, ``cuLaunchKernel``,
``cudaMemcpyAsync``, ...) in ``host``, and the activities in ``dev``. On one
stream the card runs activities in the order of their launches, so the
k-th launch of the trace is the k-th activity. The pairing is taken only
where the counts agree and copy or fill calls meet copies or fills. On
several streams (autograd's backward) the pairs go astray wherever the
streams interleave (265,599 of 273,108 in a train window on an H100), and
copies meet kernels; on one, the profiler records a few launches out of
their order (33 pairs of 137,509 in a predict window), so a thousandth of
the pairs may disagree in kind. Otherwise (several streams, a graph launch,
a lost record) no device time is put down to a span. Time is not compared:
the profiler's host and device clocks differ by more than a launch's
latency now and then, so an activity can read as starting before its
launch.

A reader returns None where the window holds no such span: the parent of
the program that added them, a run without the card.
"""

from __future__ import annotations

import weakref

import numpy as np

from mvsbench.trace import gaps_ns, union_ns

PREFIX = "adamvs."
# host calls that start one device activity each: kernel launches (runtime and driver API),
# copies and fills
COPIES = ("cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
LAUNCHES = ("cudaLaunch", "cuLaunch", *COPIES)
# the share of launch/activity pairs that may disagree in kind (module docstring)
KINDS_OFF = 1e-3
# a train step's phases: idle time is put down to the innermost of them
STEP_PHASES = ("train.step", "train.forward", "train.backward", "train.finite_check",
               "train.scalars")

_INDEX: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _merge(iv: np.ndarray) -> np.ndarray:
    """The union of [start, end) rows as disjoint sorted rows."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    run_end = np.append(ends[np.flatnonzero(new)[1:] - 1], ends[-1])
    return np.stack([iv[new, 0], run_end], 1)


class _Index:
    """What the readers share, built once per trace: the host ranges of the
    program's spans, the launches' host starts (None where they cannot be
    paired with the activities), and the window's idle gaps with their
    running total."""

    def __init__(self, trace):
        rows: dict[str, list] = {}
        launches = []
        for n, s, e in trace.host:
            if n.startswith(PREFIX):
                rows.setdefault(n, []).append((s, e))
            elif n.startswith(LAUNCHES):
                launches.append((s, n.startswith(COPIES)))
        self.ranges = {n: np.array(sorted(r), np.int64).reshape(-1, 2) for n, r in rows.items()}
        launches.sort()
        starts = np.array([s for s, _ in launches], np.int64)
        copies = np.array([c for _, c in launches], bool)
        # one activity a launch, in launch order: as many, and the kinds agree
        paired = (len(starts) == len(trace.dev) and len(starts) > 0
                  and float(np.mean(copies != trace.is_copy)) <= KINDS_OFF)
        self.launches = starts if paired else None
        self.t0, self.t1 = trace.t0, trace.t1
        self.gaps = gaps_ns(trace.dev[trace.in_window()], trace.t0, trace.t1)
        self.idle_before = np.concatenate([[0], np.cumsum(self.gaps[:, 1] - self.gaps[:, 0])])

    def idle_ns(self, iv: np.ndarray) -> int:
        """Idle nanoseconds of the device within disjoint rows ``iv``."""
        def before(t):  # idle time in [t0, t)
            j = np.searchsorted(self.gaps[:, 0], t, "right")
            part = np.where(j > 0, np.minimum(t, self.gaps[j - 1, 1]) - self.gaps[j - 1, 0], 0)
            return self.idle_before[np.maximum(j - 1, 0)] + np.maximum(part, 0)

        if len(iv) == 0 or len(self.gaps) == 0:
            return 0
        return int((before(iv[:, 1]) - before(iv[:, 0])).sum())


def _index(trace) -> _Index:
    if trace not in _INDEX:
        _INDEX[trace] = _Index(trace)
    return _INDEX[trace]


def intervals(trace, name: str) -> np.ndarray:
    """[start, end) of the host ranges ``adamvs.<name>`` within the window,
    clipped to it, sorted."""
    idx = _index(trace)
    r = np.clip(idx.ranges.get(PREFIX + name, np.zeros((0, 2), np.int64)), idx.t0, idx.t1)
    return r[r[:, 1] > r[:, 0]]


def host_s(trace, name: str) -> float | None:
    """Host seconds inside the ``adamvs.<name>`` ranges of the window."""
    iv = intervals(trace, name)
    return union_ns(iv) / 1e9 if len(iv) else None


def device_s(trace, name: str) -> float | None:
    """Device seconds of the activities launched inside the ``adamvs.<name>``
    ranges of the window (spans nested in them included), clipped to the
    window; None where no such span holds a launch or the launches cannot be
    paired with the activities (module docstring)."""
    idx = _index(trace)
    iv = intervals(trace, name)
    if idx.launches is None or not len(iv):
        return None
    lo = np.searchsorted(idx.launches, iv[:, 0], "left")
    hi = np.searchsorted(idx.launches, iv[:, 1], "left")
    rows = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])
    if not len(rows):
        return None
    act = np.clip(trace.dev[rows], idx.t0, idx.t1)
    return union_ns(act[act[:, 1] > act[:, 0]]) / 1e9


def idle_s(trace, names) -> dict:
    """{name: idle seconds of the device} over the spans ``names``: each
    gap within the window is put down to the innermost of these spans that
    covers it, so a gap that runs from a span into one nested in it is
    split between the two. Names without a span are left out."""
    idx = _index(trace)
    spans = {n: intervals(trace, n) for n in names}
    out = {}
    for n, own in spans.items():
        if not len(own):
            continue
        inner = []
        for m, iv in spans.items():
            if m != n and len(iv):
                i = np.searchsorted(own[:, 0], iv[:, 0], "right") - 1
                keep = (i >= 0) & (own[np.maximum(i, 0), 1] >= iv[:, 1])
                inner.append(iv[keep])
        nested = _merge(np.concatenate(inner)) if inner else np.zeros((0, 2), np.int64)
        out[n] = (idx.idle_ns(own) - idx.idle_ns(nested)) / 1e9
    return out


def per_root_ms(trace, seconds: float | None, root: str) -> float | None:
    """``seconds`` over the window's count of ``adamvs.<root>`` spans, in
    milliseconds; None where either is missing."""
    if seconds is None:
        return None
    n = len(intervals(trace, root))
    return 1e3 * seconds / n if n else None
