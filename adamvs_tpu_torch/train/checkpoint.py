"""Checkpoints (counterpart of adamvs_tpu/train/checkpoint.py).

A checkpoint is the reference's ``.ckpt`` layout, one ``torch.save`` dict
``{"epoch", "model", "optimizer", "step", "nan_steps"}`` with the reference
state_dict names, in ``model_{epoch:06d}[_{metric:.4f}][_step{N}].ckpt``.
The latest is the one with the highest epoch; within an epoch an end-of-epoch
save outranks a step save, and a later step outranks an earlier one.
Resuming from an end-of-epoch save starts the next epoch, from a step save
the same epoch again.
"""

from __future__ import annotations

import os
import re

import torch

_CKPT_RE = re.compile(r"^model_(\d{6})(?:_[0-9.]+)?(?:_step(\d+))?\.ckpt$")


def save_checkpoint(logdir: str, state, epoch: int, metric: float | None = None,
                    tag: str | None = None) -> str:
    name = f"model_{epoch:06d}"
    if metric is not None:
        name += f"_{metric:.4f}"
    if tag is not None:
        name += f"_{tag}"
    path = os.path.abspath(os.path.join(logdir, name + ".ckpt"))
    tmp = path + ".tmp"
    torch.save({
        "epoch": epoch,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "nan_steps": state.nan_steps,
    }, tmp)
    os.replace(tmp, path)
    return path


def _ckpt_key(name: str) -> tuple[int, int, int] | None:
    """Sort key (epoch, is_end_of_epoch, step)."""
    m = _CKPT_RE.match(name)
    if not m:
        return None
    step = int(m.group(2)) if m.group(2) else -1
    return (int(m.group(1)), 1 if step < 0 else 0, step)


def latest_checkpoint(logdir: str) -> str | None:
    if not os.path.isdir(logdir):
        return None
    keyed = [(key, name) for name in os.listdir(logdir) if (key := _ckpt_key(name)) is not None]
    return os.path.join(logdir, max(keyed)[1]) if keyed else None


def next_epoch_after(path: str) -> int:
    """The epoch to run next when resuming from ``path``."""
    m = _CKPT_RE.match(os.path.basename(path))
    if not m:
        return 0
    epoch = int(m.group(1))
    return epoch if m.group(2) else epoch + 1


def _optimizer_matches(saved: dict, optimizer: torch.optim.Optimizer) -> bool:
    """Whether a saved optimizer state_dict fits ``optimizer``: the same
    parameter groups, sizes and hyperparameter names."""
    groups = optimizer.param_groups
    saved_groups = saved.get("param_groups", [])
    return len(groups) == len(saved_groups) and all(
        len(g["params"]) == len(s["params"]) and set(g) == set(s)
        for g, s in zip(groups, saved_groups))


def restore_checkpoint(path: str, state):
    """Load ``path`` into ``state`` in place and return it. The optimizer
    state is restored only when it fits the state's optimizer, so a run with
    another optimizer still restores the model and the counters."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    if _optimizer_matches(ckpt["optimizer"], state.optimizer):
        state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    state.nan_steps = int(ckpt["nan_steps"])
    return state
