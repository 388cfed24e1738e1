"""Whole model (``models/adamvs.py``, ``models/msrednet.py``): device
milliseconds of the work launched inside the program's ``model.stage2``
spans (cascade stage 2: its fused volume and regression), per
``engine.request`` of the traced window."""

from mvsbench import spans


def read(run):
    if run.trace is None:
        return None
    return spans.per_root_ms(run.trace, spans.device_s(run.trace, "model.stage2"),
                             "engine.request")
