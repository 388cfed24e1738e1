"""Train loop and autograd (``train/loop.py::make_train_step``): host
milliseconds inside the program's ``train.backward`` spans (``loss.
backward()``: the host waits while autograd's device thread launches), per
``train.step`` of the traced window."""

from mvsbench import spans


def read(run):
    if run.trace is None:
        return None
    return spans.per_root_ms(run.trace, spans.host_s(run.trace, "train.backward"),
                             "train.step")
