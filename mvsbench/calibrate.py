"""Readings that set a cell's limits, on one card, at the cell's own sizes:

    python3 -m mvsbench.calibrate --workload <cell> --seeds 101,102,103

For each seed it prints one JSON line with the numbers that the check of a
run compares (``mvsbench/check.py``), read where the program would stand:

- ``control``: the reference computed one precision below the one the mix
  states (the mix's ``control``: float8 e4m3 for bf16, bfloat16 for float32
  where cuDNN may use TF32), against the float32 reference;
- ``witness``: the reference at the mix's own precision (bf16 rounding at
  the control's points; for training, torch's defaults, cuDNN in TF32),
  what rounding alone does at that precision (information);
- training cells also read each fault of the program that the cell can have,
  planted in the reference put in the program's place: ``half_batch`` (half
  of every global batch left out, the mean taken over the rest) and, over
  several ranks, ``no_exchange`` (rank 0 alone: its own crops' statistics,
  loss and gradient, nothing exchanged). A state left unchanged reads 1 by
  every change number and needs no run.

The program's own readings are those of the benchmark's runs, whose check
lines print every number (``--program`` reads them here too).

``--leaves`` (training cells, one card) reads, instead, which parameters
give the worst-leaf gaps and why: for the parameters with the largest gaps
of the change over the three steps and of the first gradient, the program's
and the witness's gaps beside their size, how far their gradient stands from
the median parameter's, and how many of their elements moved the other way
from the reference (``look``).
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from mvsbench import check, harness
from mvsbench.reference.numerics import CONTROL_DTYPES, Numerics, strict_float32
from mvsbench.reference.train import RMSprop, train_step
from mvsbench.scene import Strip, predict_items, train_batches

# the reference at the precision a mix states: bf16 rounding at the control's points
WITNESS = {"bf16": "bfloat16"}


def _half(batch: dict, keep: int) -> dict:
    """The first ``keep`` samples of a global batch."""
    if isinstance(batch, dict):
        return {k: _half(v, keep) for k, v in batch.items()}
    return batch[:keep]


def predict_readings(cell, seed: int, dev, with_program: bool = False) -> dict:
    cfg, tr = cell.config, cell.traffic
    items = predict_items(Strip(tr["scene"], seed + 1, dev), tr["items"], cfg["views"])
    dv = np.array(tr["depth_range"], np.float32)
    interval = float(dv[1] - dv[0]) / cfg["num_depth"]
    got = _program_maps(cell, seed, items, dv, dev) if with_program else None
    ref = check.reference_model(cfg, seed, dev)
    nx = Numerics(CONTROL_DTYPES[tr["control"]])
    same = Numerics(CONTROL_DTYPES[WITNESS[tr["dtype"]]])
    rows, wit, prog = [], [], []
    for i, item in enumerate(items[:tr["check_requests"]]):
        want = check.reference_maps(ref, cfg, item, dv, dev)
        if got is not None:
            prog.append(check.predict_numbers(got[i], want, interval))
        rows.append(check.predict_numbers(check.reference_maps(ref, cfg, item, dv, dev, nx),
                                          want, interval))
        wit.append(check.predict_numbers(check.reference_maps(ref, cfg, item, dv, dev, same),
                                         want, interval))
    out = {"control": check.worst(rows), "witness": check.worst(wit)}
    if prog:
        out["program"] = check.worst(prog)
    return out


def _program_maps(cell, seed: int, items: list, dv, dev) -> list:
    """The program's maps of the first ``check_requests`` items, one request
    each after one warm-up, as the closed loop sends them."""
    import types

    from adamvs_tpu_torch.predict.engine import PredictEngine

    from mvsbench import program

    cfg, tr = cell.config, cell.traffic
    model = program.port_model(cfg, tr, program.draw_weights(cfg, seed, dev), dev)
    engine = PredictEngine(model, num_depth=cfg["num_depth"], device=dev,
                           feature_cache=tr["feature_cache"])
    samples = [types.SimpleNamespace(imgs=it["imgs"], proj_matrices=it["proj_matrices"],
                                     depth_values=dv) for it in items]
    engine.predict_batch([samples[-1]])
    out = [engine.predict_batch([s])[0] for s in samples[:tr["check_requests"]]]
    del engine, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def train_readings(cell, seed: int, dev, with_program: bool = False) -> dict:
    cfg, tr = cell.config, cell.traffic
    ranks, batch = tr["ranks"], tr["batch"]
    got = None
    if with_program and ranks == 1:
        from mvsbench.loops import train as loop

        trainer, _, _, got = loop.program(cell, seed, dev)
        loop.close(trainer)
        del trainer
    rows, cols = tr["crop"]
    pool = train_batches(Strip(tr["scene"], seed + 1, dev), 3, batch * ranks, cfg["views"], rows,
                         cols, tr["depth_range"], cfg["num_depth"], seed)
    want = check.reference_record(cfg, seed, pool, dev)
    nx = Numerics(CONTROL_DTYPES[tr["control"]])
    out = {"program": check.train_numbers(got, want)} if got is not None else {}
    out["control"] = check.train_numbers(check.reference_record(cfg, seed, pool, dev, nx), want)
    if got is None:
        out["witness"] = check.train_numbers(
            check.reference_record(cfg, seed, pool, dev, tf32=True), want)
    half = [_half(b, batch * ranks // 2) for b in pool]
    out["half_batch"] = check.train_numbers(check.reference_record(cfg, seed, half, dev), want)
    if ranks > 1:
        local = [_half(b, batch) for b in pool]
        out["no_exchange"] = check.train_numbers(
            check.reference_record(cfg, seed, local, dev), want)
    return out


# --- which leaves read the worst-leaf gaps -------------------------------------------

def _program_steps(cell, seed: int, dev):
    """The program's first three steps, as a run's set-up drives them:
    (|g| of every element of the first gradient, from RMSprop's state after
    one step; every parameter's change after the first step and over the
    three; the batches)."""
    from mvsbench import program
    from mvsbench.loops import train as loop

    kept = {}
    norms = loop._opt_grad_norms

    def keeping(model, opt, alpha):
        kept["g1"] = {k: (opt.state[p]["square_avg"].double() / (1 - alpha)).sqrt().cpu()
                      for k, p in model.named_parameters()}
        kept["first"] = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
        kept["model"] = model
        return norms(model, opt, alpha)

    loop._opt_grad_norms = keeping
    try:
        trainer, pool, _, _ = loop.program(cell, seed, dev)
    finally:
        loop._opt_grad_norms = norms
    start = program.draw_weights(cell.config, seed, dev)
    change = {k: (p.detach() - start[k]).cpu() for k, p in kept.pop("model").named_parameters()}
    first = {k: v - start[k].cpu() for k, v in kept["first"].items()}
    loop.close(trainer)
    return kept["g1"], first, change, pool[:loop.SETUP_STEPS]


def _reference_steps(cfg: dict, seed: int, batches: list, dev, tf32: bool = False):
    """The reference's steps on ``batches``: (each step's gradients, every
    parameter's change after the first step and over all), whole."""
    ref = check.reference_model(cfg, seed, dev)
    start = {k: p.detach().clone() for k, p in ref.named_parameters()}
    opt = RMSprop(ref.parameters(), lr=cfg["lr"], alpha=cfg["rmsprop_alpha"])
    grads, first = [], None
    with contextlib.nullcontext() if tf32 else strict_float32():
        for b in batches:
            _, g, _ = train_step(ref, opt, check.to_tensors(b, dev), cfg["dlossw"],
                                 checkpoint_steps=check.recompute(b))
            grads.append({k: v.cpu() for k, v in g.items()})
            if first is None:
                first = {k: (p.detach() - start[k]).cpu() for k, p in ref.named_parameters()}
    return grads, first, {k: (p.detach() - start[k]).cpu() for k, p in ref.named_parameters()}


def _norm(x) -> float:
    return float(x.double().norm())


def look(cell, seed: int, dev, top: int = 4) -> dict:
    """The parameters with the largest change and first-gradient gaps
    (``check.train_numbers``' measure) of the program and of the TF32
    witness against the float32 reference on one seed. For each: its
    elements, its reference gradient and change over the median parameter's,
    both sides' gaps, the share of its elements that the program (witness)
    moved the other way from the reference over the three steps (and its
    gap after the first step alone), the share
    whose reference gradient turned sign between steps, the program's median
    and 90th-percentile relative error of the first gradient's elements, and
    the smallest of each step's reference gradient at the elements moved the
    other way, over the leaf's root mean square at that step. Over all
    elements: the share whose first step went the other way."""
    cfg = cell.config
    g1, first, changed, batches = _program_steps(cell, seed, dev)
    torch.cuda.empty_cache()
    grads, ref_first, ref_change = _reference_steps(cfg, seed, batches, dev)
    wit_grads, wit_first, wit_change = _reference_steps(cfg, seed, batches, dev, tf32=True)
    gn = {k: _norm(g) for k, g in grads[0].items()}
    med = float(np.median(list(gn.values())))
    moving = [k for k in gn if gn[k] >= 1e-3 * med]
    cn = {k: _norm(ref_change[k]) for k in moving}
    cmed = float(np.median(list(cn.values())))

    def change_gap(side, k):
        return abs(_norm(side[k]) - cn[k]) / max(cn[k], cmed)

    def grad_gap(side, k):
        return abs(_norm(side[k]) - gn[k]) / max(gn[k], med)

    def against(side, k):
        return float(((side[k] > 0) != (ref_change[k] > 0)).double().mean())

    def first_against(side):
        """Over every element of the moving leaves: the share whose first step
        went the other way from the reference's, and the median of their first
        reference gradient over the root mean square of their leaf's."""
        flips, sizes, n = 0, [], 0
        for k in moving:
            g = grads[0][k].double()
            f = (side[k] * ref_first[k]) < 0
            flips += int(f.sum())
            n += f.numel()
            sizes.append(g[f].abs() / g.pow(2).mean().sqrt())
        sizes = torch.cat(sizes)
        return flips / n, float(sizes.median()) if sizes.numel() else None

    rows = []
    for k in sorted(moving, key=lambda k: -change_gap(changed, k))[:top]:
        g = grads[0][k].double().abs()
        rel = (g1[k] - g).abs() / g.clamp_min(1e-30)
        turned = ((grads[0][k] > 0) != (grads[1][k] > 0)) | ((grads[1][k] > 0) != (grads[2][k] > 0))
        flipped = (changed[k] > 0) != (ref_change[k] > 0)
        # the reference's gradient of each step at the elements moved the other way, over
        # the root mean square of the leaf's at that step
        small = [float((s[k][flipped].double().abs() / s[k].double().pow(2).mean().sqrt())
                       .min()) if flipped.any() else None for s in grads]
        rows.append({"leaf": k, "elements": g.numel(), "grad_over_median": gn[k] / med,
                     "change_over_median": cn[k] / cmed, "gap": change_gap(changed, k),
                     "first_step_gap": abs(_norm(first[k]) - _norm(ref_first[k]))
                     / max(_norm(ref_first[k]), 1e-30),
                     "witness_gap": change_gap(wit_change, k), "against": against(changed, k),
                     "witness_against": against(wit_change, k),
                     "grad_turned": float(turned.double().mean()),
                     "g1_rel_err_median": float(rel.median()),
                     "g1_rel_err_p90": float(rel.quantile(0.9)), "against_grads_over_rms": small})
    wit_g1 = wit_grads[0]
    grad_rows = [{"leaf": k, "elements": grads[0][k].numel(), "grad_over_median": gn[k] / med,
                  "gap": grad_gap(g1, k), "witness_gap": grad_gap(wit_g1, k)}
                 for k in sorted(gn, key=lambda k: -grad_gap(g1, k))[:top]]
    sizes = sorted(g.numel() for g in grads[0].values())
    return {"first_step_against": first_against(first),
            "witness_first_step_against": first_against(wit_first),
            "change_gap": max(change_gap(changed, k) for k in moving),
            "witness_change_gap": max(change_gap(wit_change, k) for k in moving),
            "grad_gap": max(grad_gap(g1, k) for k in gn),
            "witness_grad_gap": max(grad_gap(wit_g1, k) for k in gn),
            "leaves": len(gn), "moving": len(moving), "median_elements": sizes[len(sizes) // 2],
            "change_leaves": rows, "grad_leaves": grad_rows}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python3 -m mvsbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--program", action="store_true",
                   help="read the program too, on one card (its first steps, or its maps of "
                        "the compared items)")
    p.add_argument("--leaves", action="store_true",
                   help="training cells: which parameters read the worst-leaf gaps (look)")
    args = p.parse_args(argv)
    cell = harness.resolve(args.workload)
    harness.require_cards(1)
    dev = torch.device("cuda", 0)
    fn = predict_readings if cell.traffic["kind"] == "predict" else train_readings
    for seed in (int(s) for s in args.seeds.split(",")):
        out = look(cell, seed, dev) if args.leaves else fn(cell, seed, dev, args.program)
        print(json.dumps({"workload": cell.name, "seed": seed, **out}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
