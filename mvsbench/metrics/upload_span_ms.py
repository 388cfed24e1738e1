"""Engine (``predict/engine.py``): host milliseconds inside the program's
``engine.upload`` spans (the copies of frames, projections and depth range
to the device; pageable, so the host waits for each), per
``engine.request`` of the traced window."""

from mvsbench import spans


def read(run):
    if run.trace is None:
        return None
    return spans.per_root_ms(run.trace, spans.host_s(run.trace, "engine.upload"),
                             "engine.request")
