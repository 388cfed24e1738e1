"""Feature net (``nn/featurenet.py``, ``model.feature_module()``): device
milliseconds a map of the work launched inside a ``feature_net`` range that
forward hooks open around the feature module, in the traced window."""


def read(run):
    if run.trace is None or not run.traced_maps:
        return None
    s = run.trace.device_s_inside("feature_net")
    return None if s is None else 1e3 * s / run.traced_maps
