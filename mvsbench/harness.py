"""What every cell shares: finding a cell's files by name, the device check,
the weights drawn from the seed, the per-layer readers, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs[].file``), a
traffic mix (``mvsbench/traffic/<traffic>.json``) and a chip count; the limits
of its comparison are ``mvsbench/limits/<cell>.json``. The mix's
``kind`` names its loop, ``mvsbench/loops/<kind>.py``; a per-layer metric
``<name>`` is read by ``mvsbench/metrics/<name>.py``. Nothing here lists a
cell, a mix or a metric: a new one is a new file and an entry in
``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "adamvs_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, spec: dict | None = None) -> Cell:
    """The cell ``workload`` with its configuration, traffic mix and the
    metrics it reports; raises ``KeyError`` for an unknown name."""
    spec = spec or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(BENCH, "traffic", cell["traffic"] + ".json"))
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload)]
    # a per-layer metric belongs to the cell when it lists it, or, without a list,
    # when the cell reports the end-to-end metric it moves
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    limits = load_json(os.path.join(BENCH, "limits", workload + ".json"))
    return Cell(workload, cell["chips"], config, traffic, e2e, per, limits)


def loop_module(kind: str):
    return importlib.import_module(f"mvsbench.loops.{kind}")


def reader(metric: str):
    """The ``read(run)`` of ``mvsbench/metrics/<metric>.py``."""
    path = os.path.join(BENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"mvsbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell: Cell, run) -> dict:
    """{name: {"value", "unit"}} of every per-layer metric of ``cell`` whose
    reader found something to read in ``run``."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"])(run)
        if value is not None:
            if not math.isfinite(value):
                raise ValueError(f"per-layer metric {m['name']} read {value}")
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, compared whole."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def require_cards(count: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"this cell needs {count} CUDA device(s); found {n}")


def device_info(count: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def draw_state_dict(module, seed: int, device, gain: float = 1.0) -> dict:
    """Weights for ``module``'s state dict drawn from ``seed`` on ``device``
    in one call: every convolution's weight and bias uniform in
    ±gain/sqrt(fan_in), fan_in = weight.shape[1] x kernel area (PyTorch's
    default initialisation at gain 1; He's uniform one at sqrt(6)),
    normalisations at identity (their state dict as constructed)."""
    import torch

    sd = {k: v.to(device) for k, v in module.state_dict().items()}
    convs = {}
    for name, m in module.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            bound = gain / math.sqrt(m.weight.shape[1] * m.weight[0, 0].numel())
            for p in ("weight", "bias"):
                if getattr(m, p) is not None:
                    convs[f"{name}.{p}" if name else p] = bound
    total = sum(sd[k].numel() for k in convs)
    g = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(total, generator=g, device=device) * 2 - 1
    off = 0
    for k, bound in convs.items():
        n = sd[k].numel()
        sd[k] = (u[off:off + n] * bound).view_as(sd[k]).clone()
        off += n
    return sd


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: list, breakdown: dict | None = None) -> str:
    """The last line of standard output; ``checks`` (name, number, limit)
    comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = [{"name": n, "value": v, "limit": lim} for n, v, lim in checks]
    return json.dumps(out)
