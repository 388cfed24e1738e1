"""Kernels (``ops/red_scan.py``, ``csrc/red_scan.cu``): K3's share of its
roofline, in %: the least time of the traced window's ``red_scan`` calls
(``work.k3_work`` at each call's shapes: bytes over the memory rate, or the
operations over the bf16 tensor cores' peak, or over a third of TF32's for
the float32 form's three products a multiply-add) over the device time
launched inside those calls."""

from mvsbench import work


def read(run):
    calls = run.calls.get("K3") if run.calls else None
    if run.trace is None or not calls:
        return None
    s = run.trace.device_s_inside("K3")
    if not s:
        return None
    least = 0.0
    for c in calls:
        nbytes, flops = work.k3_work(c["base"], c["cin"], c["h"], c["w"], c["D"], c["up"],
                                     c["es"])
        peak = work.PEAK_FLOPS["bf16"] if c["es"] == 2 else work.PEAK_FLOPS["tf32"] / 3
        least += c["B"] * work.bound_s(nbytes, flops, peak)
    return 100.0 * least / s
