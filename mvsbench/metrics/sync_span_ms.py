"""Train loop and autograd (``train/state.py``, ``train/loop.py``): host
milliseconds inside the program's ``train.finite_check`` and
``train.scalars`` spans, the step's two waits for the device (the loss's
finiteness, the step's scalars), per ``train.step`` of the traced window."""

from mvsbench import spans


def read(run):
    if run.trace is None:
        return None
    parts = [spans.host_s(run.trace, n) for n in ("train.finite_check", "train.scalars")]
    found = [p for p in parts if p is not None]
    return spans.per_root_ms(run.trace, sum(found) if found else None, "train.step")
