"""Whole model (``models/adamvs.py``, ``models/msrednet.py``, ``nn/``): the
model FLOPs of the maps completed in the untraced window (``work.
model_forward_flops`` at the mix's frame) over the window's wall, the chips
and the peak of the precision the mix states, in %."""

from mvsbench import work


def read(run):
    win = run.window
    if not win.maps:
        return None
    rows, cols = run.traffic["scene"]["frame_rows"], run.traffic["scene"]["frame_cols"]
    flops = work.model_forward_flops(run.config, rows, cols) * win.maps
    peak = work.PEAK_FLOPS[run.traffic["mfu_peak"]] * run.cell.chips
    return 100.0 * flops / (win.wall_s * peak)
