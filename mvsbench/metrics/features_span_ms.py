"""Feature net (``nn/featurenet.py``, called in the models' ``_cascade``):
device milliseconds of the work launched inside the program's
``model.features`` spans (the feature net with its input's reshape and
dtype cast), per ``engine.request`` of the traced window."""

from mvsbench import spans


def read(run):
    if run.trace is None:
        return None
    return spans.per_root_ms(run.trace, spans.device_s(run.trace, "model.features"),
                             "engine.request")
