"""Parallel runtime (``parallel/mesh.py``, ``parallel/distributed.py``,
``nn/blocks.py::_GlobalBatchNorm``): device milliseconds of NCCL kernels per
train step in rank 0's traced window; nothing where no NCCL kernel ran."""


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    s = run.trace.nccl_s()
    return 1e3 * s / run.traced_steps if s > 0 else None
