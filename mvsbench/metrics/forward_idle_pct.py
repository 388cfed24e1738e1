"""Device: the share of the program's ``train.forward`` spans (host time) in
which no kernel, copy or fill ran on the card, in %, over the traced
window (a gap put down to the innermost of a step's phase spans)."""

from mvsbench import spans


def read(run):
    if run.trace is None:
        return None
    host = spans.host_s(run.trace, "train.forward")
    if not host:
        return None
    return 100.0 * spans.idle_s(run.trace, spans.STEP_PHASES)["train.forward"] / host
