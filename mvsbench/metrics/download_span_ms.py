"""Engine (``predict/engine.py``): host milliseconds inside the program's
``engine.download`` spans (depth and confidence copied back to the host,
with the host's wait for the forward's tail), per ``engine.request`` of the
traced window."""

from mvsbench import spans


def read(run):
    if run.trace is None:
        return None
    return spans.per_root_ms(run.trace, spans.host_s(run.trace, "engine.download"),
                             "engine.request")
