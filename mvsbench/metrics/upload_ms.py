"""Engine layer (``predict/engine.py``): milliseconds from a request's entry
into ``predict_batch`` to the model's forward, the device synchronised at
both ends (padding, the numpy-to-device copy of the frames and
projections), the mean over the traced window's requests."""


def read(run):
    spans = run.spans.get("upload_s") if run.spans else None
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
