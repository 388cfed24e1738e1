"""Engine (``predict/engine.py``): the share of the traced window's
host-to-device copy time on the device whose activity copied from
page-locked host memory (``Memcpy HtoD (Pinned -> Device)``, against
``(Pageable -> Device)``), in %; None where the window holds no such copy."""

import numpy as np


def read(run):
    t = run.trace
    if t is None:
        return None
    idx = np.flatnonzero(t.in_window())
    names = [t.names[i].lower() for i in idx]
    htod = np.array([n.startswith("memcpy htod") for n in names], bool)
    pinned = htod & np.array(["pinned" in n for n in names], bool)
    dur = t.dev[idx, 1] - t.dev[idx, 0]
    total = float(dur[htod].sum())
    if total <= 0:
        return None
    return 100.0 * float(dur[pinned].sum()) / total
