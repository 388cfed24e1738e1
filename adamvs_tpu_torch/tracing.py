"""Spans of the port in the profiler's own timeline.

``span(name)`` opens a host range ``adamvs.<name>`` while a
``torch.profiler`` window records (the ``profile`` command's, a benchmark's
traced window, an operator's own), and is one shared no-op context
otherwise: an empty ``record_function`` costs microseconds even with no
profiler, a read of the profiler's flag tens of nanoseconds.

The range is an op-scope record (``torch._C._profiler._RecordFunctionFast``,
as torch's compiled kernels label their launches), not a user annotation
(``torch.profiler.record_function``): the profiler keeps it in the host
timeline, on the clock of the CUDA activities, but gives it no device-side
annotation, so a trace's device rows stay kernels, copies and fills alone.
The device work of a span is that of the launches inside it.

The profiler keeps the spans and nothing else does. A span's parent is the
span that contains it on the same thread; a request's or a step's root span
is ``adamvs.engine.request`` or ``adamvs.train.step``. Names are constants
(no step number, no shape), so readers aggregate by name. Where torch
already opens a range (``Optimizer.step#RMSprop.step``) the port adds none.
"""

from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

PREFIX = "adamvs."
OFF = contextlib.nullcontext()


def span(name: str):
    """A host range ``adamvs.<name>`` while a profiler records (torch's own
    flag, which ``torch.profiler.profile`` sets), else ``OFF``."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _RecordFunctionFast(PREFIX + name)
