"""Whole model (``models/adamvs.py``, ``models/msrednet.py``): device
milliseconds of the work launched inside the program's ``model.stage3``
spans (cascade stage 3: its fused volume and regression), per
``engine.request`` of the traced window."""

from mvsbench import spans


def read(run):
    if run.trace is None:
        return None
    return spans.per_root_ms(run.trace, spans.device_s(run.trace, "model.stage3"),
                             "engine.request")
