"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``mvsbench/reference``) computed afresh from the
same seed, inputs and weights, in float32 with TF32 off.

Prediction (per compared request, the worst over the requests):

- ``depth_rel``: mean |depth - reference depth| over the frame, over the
  reference map's own mean |depth - its median| (its relief), so that the
  seeds' different sensitivities to rounding compare alike;
- and, printed for information, ``depth_err`` (mean, in depth intervals of
  range / ``num_depth``), ``depth_med``, ``depth_p99``, ``conf_err`` (mean),
  ``conf_p99``.

Training (the first three steps, which set-up drives through the window's
own ``Trainer.train_epoch``):

- ``loss_gap``: the largest |loss - reference loss| / |reference loss| of
  the three steps (``loss1_gap``: the first step's);
- ``grad_gap``: over the parameters, the largest | |g| - |g_ref| | / max(|g_ref|,
  median |g_ref|) of the first gradient, the program's |g| worked out from
  RMSprop's state after one step (v = (1 - alpha) g^2);
- ``grad_median_gap``: the same, of the median parameter;
- ``change_gap``, ``change_median_gap``: the same of the parameters' change
  over the three steps, leaving out parameters whose reference gradient is
  under a thousandth of the median parameter's (they move by round-off
  alone under RMSprop);
- ``stats_gap``: the same of the BatchNorm running statistics' change;
- ``depth1_err``: the first step's final depth (before any update), mean
  |depth - reference depth| in depth intervals.

A cell compares the numbers its ``mvsbench/limits/<cell>.json`` names, each
with its limit; PERF.md gives the readings they were set from and why those
numbers. The others are printed for information.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from mvsbench import harness, program
from mvsbench.reference.numerics import FLOAT32, Numerics, strict_float32
from mvsbench.reference.train import RMSprop, train_step


def judge(numbers: dict, lim: dict) -> tuple[list, bool]:
    """(checks, correct): every limited number at or under its limit, and
    every one present and finite."""
    checks, ok = [], True
    for name, limit in lim.items():
        if name.startswith("_"):
            continue
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok &= bool(good)
        checks.append((name, None if v is None else float(v), limit))
    return checks, ok


# --- prediction ----------------------------------------------------------------

def reference_model(cfg: dict, seed: int, device):
    ref = program.reference_module(cfg, device)
    ref.load_state_dict(program.draw_weights(cfg, seed, device))
    return ref


@torch.no_grad()
def reference_maps(ref, cfg: dict, item: dict, dv: np.ndarray, device,
                   nx: Numerics = FLOAT32) -> tuple[np.ndarray, np.ndarray]:
    """The reference's (depth, confidence) of one work item."""
    ref.eval()
    imgs = torch.from_numpy(item["imgs"])[None].to(device)
    projs = {k: torch.from_numpy(v)[None].to(device) for k, v in item["proj_matrices"].items()}
    with strict_float32():
        out = ref(imgs, projs, torch.from_numpy(dv)[None].to(device),
                  num_depth=cfg["num_depth"], nx=nx)
    return out["depth"][0].cpu().numpy(), out["photometric_confidence"][0].cpu().numpy()


def predict_numbers(got: tuple, want: tuple, interval: float) -> dict:
    d = np.abs(got[0].astype(np.float64) - want[0])
    c = np.abs(got[1].astype(np.float64) - want[1])
    relief = np.abs(want[0] - np.median(want[0])).mean()
    return {"depth_err": float(d.mean() / interval), "depth_med": float(np.median(d) / interval),
            "depth_p99": float(np.percentile(d, 99) / interval),
            "depth_rel": float(d.mean() / relief),
            "conf_err": float(c.mean()), "conf_p99": float(np.percentile(c, 99))}


def worst(rows: list[dict]) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]} if rows else {}


def check_predict(cell, seed: int, items: list, dv: np.ndarray, kept: dict, device):
    """Every kept request's maps against the reference's of its work item."""
    cfg = cell.config
    ref = reference_model(cfg, seed, device)
    interval = float(dv[1] - dv[0]) / cfg["num_depth"]
    rows = []
    for idx in sorted(kept):
        item, depth, conf = kept[idx]
        want = reference_maps(ref, cfg, items[item], dv, device)
        rows.append(predict_numbers((depth, conf), want, interval))
        harness.log(f"[check] request {idx} (item {item}): {rows[-1]}")
    numbers = worst(rows)
    numbers["compared"] = len(rows)
    checks, ok = judge(numbers, cell.limits)
    return checks, ok and len(rows) > 0


# --- training ------------------------------------------------------------------

def _norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def _gap(got: dict, want: dict, keys) -> float:
    med = float(np.median([want[k] for k in keys]))
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keys)


def stats_keys(model) -> list:
    return [k for k, _ in model.named_buffers() if k.endswith(("running_mean", "running_var"))]


def change_norms(state0: dict, state3: dict, keys) -> dict:
    return {k: float((state3[k].double() - state0[k].double()).norm()) for k in keys}


# the reference keeps every depth step's activations for a global batch of up to 4 crops of
# 384x768; a larger one (a data-parallel cell's) would not fit one 80 GB card, so it
# recomputes each step's activations in the backward pass
KEEP_PIXELS = 4 * 384 * 768


def recompute(batch: dict) -> bool:
    b, _, h, w = batch["imgs"].shape[:4]
    return b * h * w > KEEP_PIXELS


def reference_record(cfg: dict, seed: int, batches: list, device,
                     nx: Numerics = FLOAT32, tf32: bool = False) -> dict:
    """The reference's three steps on ``batches`` (global batches, numpy):
    losses, first-gradient norms, parameter and statistic change norms.
    ``tf32``: under torch's defaults (cuDNN may use TF32) instead of with
    TF32 off."""
    ref = reference_model(cfg, seed, device)
    state0 = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    opt = RMSprop(ref.parameters(), lr=cfg["lr"], alpha=cfg["rmsprop_alpha"])
    losses, grad1, depth1 = [], None, None
    with contextlib.nullcontext() if tf32 else strict_float32():
        for b in batches:
            tb = to_tensors(b, device)
            loss, grads, depth = train_step(ref, opt, tb, cfg["dlossw"], nx,
                                            checkpoint_steps=recompute(b))
            losses.append(loss)
            if grad1 is None:
                grad1, depth1 = _norms(grads), depth.cpu()
            del tb, grads
    state3 = ref.state_dict()
    keys = [k for k, _ in ref.named_parameters()] + stats_keys(ref)
    return {"losses": losses, "grad_norms": grad1, "depth1": depth1,
            "interval": float(batches[0]["depth_interval"][0]),
            "change_norms": change_norms(state0, state3, keys)}


def to_tensors(batch, device):
    if isinstance(batch, dict):
        return {k: to_tensors(v, device) for k, v in batch.items()}
    return torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(device)


def train_numbers(got: dict, want: dict) -> dict:
    params = list(want["grad_norms"])
    med = float(np.median([want["grad_norms"][k] for k in params]))
    moving = [k for k in params if want["grad_norms"][k] >= 1e-3 * med]
    stats = [k for k in want["change_norms"] if k not in want["grad_norms"]]
    cmed = float(np.median([want["change_norms"][k] for k in moving]))
    d_got = got["depth1"].double()
    d_want = want["depth1"][:len(d_got)].double()  # rank 0 holds the global batch's first part
    dd = (d_got - d_want).abs()
    per_leaf = [abs(got["change_norms"][k] - want["change_norms"][k])
                / max(want["change_norms"][k], cmed) for k in moving]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
        "loss1_gap": abs(got["losses"][0] - want["losses"][0]) / abs(want["losses"][0]),
        "depth1_err": float(dd.mean()) / want["interval"],
        "change_median_gap": float(np.median(per_leaf)),
        "grad_gap": _gap(got["grad_norms"], want["grad_norms"], params),
        "grad_median_gap": float(np.median([abs(got["grad_norms"][k] - want["grad_norms"][k])
                                            / max(want["grad_norms"][k], med) for k in params])),
        "change_gap": _gap(got["change_norms"], want["change_norms"], moving),
        "stats_gap": _gap(got["change_norms"], want["change_norms"], stats),
    }


def check_train(cell, seed: int, record: dict, batches: list, device):
    """The program's ``record`` of its first three steps against the
    reference's on the same global batches."""
    want = reference_record(cell.config, seed, batches, device)
    numbers = train_numbers(record, want)
    harness.log(f"[check] losses {record['losses']} reference {want['losses']}; {numbers}")
    return judge(numbers, cell.limits)
