"""Run one cell of the benchmark once.

    python3 -m mvsbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``adamvs_tpu_torch``). Set-up
(imports, the kernels' build or load, weights and inputs drawn from the seed
on the device, warm-up) counts as ``setup_s``; then the cell's loop runs for
``--seconds`` seconds; then the program's state is freed and what the window
produced is compared with the plain reference (``mvsbench/check.py``). With
``--trace 0`` the last line of standard output carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a second window
run under the profiler (the first, untraced, window gives the counters). The
numbers compared and their limits are the last lines of standard error.

Exits with a code other than 0, printing no result, without enough CUDA
devices, when ``jax``, ``jaxlib``, ``flax`` or ``adamvs_tpu`` is loaded at the
end, or when the port is missing.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

T_START = time.perf_counter()


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m mvsbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, cell=None, device: str | None = None, plant=None) -> int:
    """Run a cell and print its result line. ``cell`` and ``device`` stand in
    for the cell of ``BENCHMARK.json`` and the card where a test drives the
    harness at a small size on the CPU; ``plant``, a module-level function,
    runs in every process of the cell before its set-up (a test plants a
    fault of the program with it)."""
    from mvsbench import harness

    args = parse(argv)
    cell = cell or harness.resolve(args.workload)
    if device is None:
        harness.require_cards(cell.chips)
    import torch

    harness.log(f"[run] {cell.name} seed {args.seed} seconds {args.seconds} trace {args.trace}; "
                f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 matmul "
                f"{torch.backends.cuda.matmul.allow_tf32} cudnn {torch.backends.cudnn.allow_tf32}")
    loop = harness.loop_module(cell.traffic["kind"])
    res = loop.run(cell, args, T_START, device, plant)
    if res is None:  # a rank other than 0 of a multi-process cell
        return 0
    found = harness.forbidden_modules()
    if found:
        harness.log(f"[run] forbidden modules loaded: {', '.join(found)}")
        return 3
    for name, value, limit in res.checks:
        harness.log(f"[check] {name} {value!r} limit {limit!r}")
    harness.log(f"[check] correct {res.correct}")
    if args.trace:
        metrics = harness.read_per_layer(cell, res)
    else:
        metrics = {m["name"]: {"value": float(res.end_to_end[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_rec = dict(res.device)
    if args.trace:
        device_rec.update(busy_s=res.busy_s, window_s=res.window_s)
    print(harness.result_line(res.correct, res.attempted, res.failed, metrics, device_rec,
                              res.checks, res.breakdown if args.trace else None), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
