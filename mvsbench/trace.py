"""The traced window: ``torch.profiler`` over the device and the host, and
its reduction to what the per-layer readers and the result line take.

A ``Trace`` holds, from the profiler's raw events (no per-event Python
records are built):

- every device activity (kernels, copies, fills) as (name, start, end) in
  nanoseconds, and which of them are kernels;
- the host's ops and the ``mvsbench.<label>`` ranges that the harness opens
  around calls into the program (``record_function``), and each range's
  device-side span (the profiler's GPU annotation of it), so the device
  time of the work launched inside a labelled range is known;
- the window's own start and end.

Device busy time is the union of the activities' intervals, so activities
that overlap on several streams (the collectives' own streams) count once.
"""

from __future__ import annotations

import bisect
import contextlib

import numpy as np
import torch
from torch.autograd import DeviceType

PREFIX = "mvsbench."


def union_ns(intervals: np.ndarray) -> int:
    """Total length of the union of [start, end) rows of ``intervals``."""
    if len(intervals) == 0:
        return 0
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    # a row starts a new run where it begins after every earlier row ended
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    run_end = np.append(ends[np.flatnonzero(new)[1:] - 1], ends[-1])
    return int((run_end - starts).sum())


def gaps_ns(intervals: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """The idle gaps [start, end) of the device within [lo, hi)."""
    if len(intervals) == 0:
        return np.array([[lo, hi]], np.int64)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    g_start = np.concatenate([[lo], ends])
    g_end = np.concatenate([iv[:, 0], [hi]])
    keep = g_end > g_start
    out = np.stack([g_start[keep], g_end[keep]], 1)
    out[:, 0] = np.clip(out[:, 0], lo, hi)
    out[:, 1] = np.clip(out[:, 1], lo, hi)
    return out[out[:, 1] > out[:, 0]]


class Trace:
    def __init__(self, prof):
        dev, notes, host = [], [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                if e.name().startswith(PREFIX):
                    # the device-side span of a labelled host range (kineto's GPU user
                    # annotation): from the first to the last activity launched inside it
                    notes.append(row)
                elif e.duration_ns() > 0:
                    dev.append(row)
            elif e.device_type() == DeviceType.CPU:
                host.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        self.names = [d[0] for d in dev]
        self.dev = np.array([d[1:3] for d in dev], np.int64).reshape(-1, 2)
        order = np.argsort(self.dev[:, 0], kind="stable")
        self.names = [self.names[i] for i in order]
        self.dev = self.dev[order]
        low = [n.lower() for n in self.names]
        self.is_copy = np.array([n.startswith(("memcpy", "memset")) for n in low], bool)
        self.is_nccl = np.array(["nccl" in n for n in low], bool)
        self.notes = notes
        self.host = host
        self._ranges: dict[str, np.ndarray] = {}
        win = self.ranges("window")
        if len(win) != 1:
            raise RuntimeError(f"the trace holds {len(win)} window ranges, not 1")
        self.t0, self.t1 = int(win[0, 0]), int(win[0, 1])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def in_window(self) -> np.ndarray:
        return (self.dev[:, 0] >= self.t0) & (self.dev[:, 0] < self.t1)

    def busy_s(self) -> float:
        iv = np.clip(self.dev[self.in_window()], self.t0, self.t1)
        return union_ns(iv) / 1e9

    def kernels_in_window(self) -> int:
        return int((self.in_window() & ~self.is_copy).sum())

    def nccl_s(self) -> float:
        m = self.in_window() & self.is_nccl
        return float((self.dev[m, 1] - self.dev[m, 0]).sum()) / 1e9

    def ranges(self, label: str) -> np.ndarray:
        """[start, end) of every ``mvsbench.<label>`` host range, sorted."""
        if label not in self._ranges:
            rows = [(s, e) for n, s, e in self.host if n == PREFIX + label]
            self._ranges[label] = np.array(sorted(rows), np.int64).reshape(-1, 2)
        return self._ranges[label]

    def device_s_inside(self, label: str) -> float | None:
        """Device seconds of the activities that ran within the device-side
        spans of the ``mvsbench.<label>`` ranges, each span from the first to
        the last activity launched inside its range (on one stream, the
        range's own work); None when the trace holds no such span."""
        spans = np.array(sorted((s, e) for n, s, e in self.notes if n == PREFIX + label),
                         np.int64).reshape(-1, 2)
        if len(spans) == 0:
            return None
        starts, ends = self.dev[:, 0], self.dev[:, 1]
        total = 0
        for s, e in spans:
            lo = max(0, np.searchsorted(starts, s, "left") - 1)
            hi = np.searchsorted(starts, e, "right")
            a = np.clip(starts[lo:hi], s, e)
            b = np.clip(ends[lo:hi], s, e)
            total += union_ns(np.stack([a, b], 1)[b > a])
        return total / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the longest idle gaps by
        the innermost host op running at their middle, in seconds."""
        w = self.in_window()
        by_name: dict[str, float] = {}
        for i in np.flatnonzero(w):
            by_name[self.names[i]] = by_name.get(self.names[i], 0.0) + (
                self.dev[i, 1] - self.dev[i, 0]) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = gaps_ns(self.dev[w], self.t0, self.t1)
        order = np.argsort(gaps[:, 0] - gaps[:, 1])[:2000]  # the longest first
        host = sorted((s, e, n) for n, s, e in self.host if not n.startswith("cuda"))
        starts = [h[0] for h in host]
        by_host: dict[str, float] = {}
        for g in gaps[order]:
            mid = (g[0] + g[1]) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name = "host outside any op"
            # the innermost op covering the middle: the latest start that still covers it
            while i >= 0 and i > bisect.bisect_right(starts, mid) - 64:
                if host[i][1] > mid:
                    name = host[i][2]
                    break
                i -= 1
            by_host[name] = by_host.get(name, 0.0) + (g[1] - g[0]) / 1e9
        gaps_top = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in gaps_top]}


@contextlib.contextmanager
def traced():
    """Profile the device and the host while active; yields a list that
    holds the ``Trace`` once the block has ended. The block opens one
    ``window`` range (``window()``), the traced window."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    holder: list = []
    with torch.profiler.profile(activities=acts) as prof:
        yield holder
    holder.append(Trace(prof))


@contextlib.contextmanager
def window():
    """The traced window: the device drained at both ends."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    with label("window"):
        yield
        sync()


def label(name: str):
    """A host range ``mvsbench.<name>`` in the trace."""
    return torch.profiler.record_function(PREFIX + name)
