"""``upload_pinned_pct`` (``mvsbench/metrics/upload_pinned_pct.py``) on
hand-built traces (``test_mvsbench_spans``'s stub profiler events): pageable
copies only read 0, pinned only 100, a mix the pinned share of the copies'
device time; copies outside the window, device-to-host copies and kernels
count for nothing; no trace, or no host-to-device copy, reads None."""

import types

import pytest

from mvsbench import harness
from mvsbench.tests.test_mvsbench_spans import dev, make_trace, window

PAGEABLE = "Memcpy HtoD (Pageable -> Device)"
PINNED = "Memcpy HtoD (Pinned -> Device)"
OTHERS = [dev("Memcpy DtoH (Device -> Pageable)", 60, 70), dev("conv", 20, 50),
          dev("Memset (Device)", 55, 56), dev(PAGEABLE, 120, 150)]  # the last after the window


def read(events):
    t = None if events is None else make_trace(window(events))
    return harness.reader("upload_pinned_pct")(types.SimpleNamespace(trace=t))


@pytest.mark.parametrize("name, want", [(PAGEABLE, 0.0), (PINNED, 100.0)],
                         ids=["pageable", "pinned"])
def test_one_kind_of_copy(name, want):
    assert read([dev(name, 1, 6), dev(name, 10, 13)] + OTHERS) == want


def test_a_mix_reads_the_pinned_share_of_device_time():
    # pinned 2 + 4 ms of 2 + 4 + 6 ms of host-to-device copies
    got = read([dev(PINNED, 1, 3), dev(PINNED, 5, 9), dev(PAGEABLE, 10, 16)] + OTHERS)
    assert got == pytest.approx(50.0)


def test_nothing_to_read():
    assert read(None) is None
    assert read([dev("conv", 1, 5)]) is None
