"""Train loop and autograd (``train/loop.py``, ``train/state.py``): device
kernels per train step in the traced window (rank 0), copies and fills left
out."""


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    return run.trace.kernels_in_window() / run.traced_steps
