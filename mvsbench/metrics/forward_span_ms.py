"""Train loop and autograd (``train/loop.py::make_train_step``): host
milliseconds inside the program's ``train.forward`` spans (the model's
training form and the loss), per ``train.step`` of the traced window."""

from mvsbench import spans


def read(run):
    if run.trace is None:
        return None
    return spans.per_root_ms(run.trace, spans.host_s(run.trace, "train.forward"), "train.step")
