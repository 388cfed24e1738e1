"""Whole model (``models/adamvs.py``, ``models/msrednet.py``): device
milliseconds of the work launched inside the program's ``model.stage1``
spans (cascade stage 1: pair matching, fused volume, regression), per
``engine.request`` of the traced window."""

from mvsbench import spans


def read(run):
    if run.trace is None:
        return None
    return spans.per_root_ms(run.trace, spans.device_s(run.trace, "model.stage1"),
                             "engine.request")
