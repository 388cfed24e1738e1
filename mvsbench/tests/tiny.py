"""Tiny cells for the CPU tests: the benchmark's configurations and mixes at a
frame, depth count and width small enough for the CPU, with limits that only
a broken program passes."""

from __future__ import annotations

import copy
import os

from mvsbench import harness

SCENE = {"frame_rows": 64, "frame_cols": 96, "focal_px": 80.0, "flight_height_m": 400.0,
         "forward_overlap": 0.8, "plane_slope": [0.03, -0.05], "texture_rad_per_px": [0.04, 0.55]}


def tiny_cell(name: str, limits: dict | None = None, config: str | None = None,
              spec: dict | None = None) -> harness.Cell:
    """The cell ``name`` of BENCHMARK.json (or of ``spec``) cut to a CPU's size:
    64x96 frames (32x64 training crops), 3 views, ndepths 8/4/2, base 4; with
    ``config``, the configuration ``configs/<config>.json`` in place of the cell's."""
    cell = harness.resolve(name, spec)
    cfg = copy.deepcopy(cell.config if config is None else
                        harness.load_json(os.path.join(harness.BENCH, "configs", config + ".json")))
    cfg.update(views=3, ndepths=[8, 4, 2], cr_base_chs=[4, 4, 4], base=4, num_depth=16)
    tr = copy.deepcopy(cell.traffic)
    tr["scene"] = dict(SCENE)
    tr.update(items=2, warmup_requests=1, check_requests=2)
    if tr["kind"] == "train":
        tr.update(crop=[32, 64], pool=4, batch=2)
    return harness.Cell(cell.name, cell.chips, cfg, tr, cell.end_to_end, cell.per_layer,
                        limits if limits is not None else cell.limits)


ROOT = harness.ROOT
assert os.path.isdir(os.path.join(ROOT, "mvsbench"))
