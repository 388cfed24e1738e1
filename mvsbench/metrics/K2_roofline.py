"""Kernels (``ops/sweep_fuse.py``, ``csrc/sweep_fuse.cu``): K2's share of its
roofline, in %: the least time of the traced window's ``fused_sweep_volume``
calls (``work.k2_work`` at each call's shapes: bytes over the memory rate,
or float32 operations over the CUDA cores' peak) over the device time
launched inside those calls (the weights' normalisation and the geometry
included)."""

from mvsbench import work


def read(run):
    calls = run.calls.get("K2") if run.calls else None
    if run.trace is None or not calls:
        return None
    s = run.trace.device_s_inside("K2")
    if not s:
        return None
    least = sum(c["B"] * work.bound_s(*work.k2_work(c["Vs"], c["h"], c["w"], c["C"], c["D"],
                                                    c["es"]), work.F32_FLOPS) for c in calls)
    return 100.0 * least / s
