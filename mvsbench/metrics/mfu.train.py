"""Whole model under training (``train/loop.py``, ``models/``, ``nn/``): three
forwards' model FLOPs (``work.model_forward_flops`` at the crop) per crop of
the untraced window's completed steps, over its wall, the chips and the peak
of the precision the mix states, in %."""

from mvsbench import work


def read(run):
    if not run.steps:
        return None
    rows, cols = run.traffic["crop"]
    flops = 3 * work.model_forward_flops(run.config, rows, cols) * run.samples
    peak = work.PEAK_FLOPS[run.traffic["mfu_peak"]] * run.cell.chips
    return 100.0 * flops / (run.wall_s * peak)
