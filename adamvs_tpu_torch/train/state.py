"""Train state, optimizer and learning-rate schedule (counterpart of
adamvs_tpu/train/state.py).

The optimizer is ``torch.optim.RMSprop(lr, alpha=0.9, eps=1e-8)``, which the
JAX package's optax chain reproduces (eps outside the square root, weight
decay added to the gradient first). The schedule is piecewise constant in
optimizer updates: from ``milestone_epoch * steps_per_epoch`` updates on, the
rate is multiplied by ``gamma`` once more. A non-finite loss skips the update
and is counted.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..tracing import span


def parse_lrepochs(s: str) -> tuple[tuple[int, ...], float]:
    """``"10,12,14:2"`` -> ((10, 12, 14), gamma 1/2)."""
    epochs, down = s.split(":")
    return tuple(int(e) for e in epochs.split(",") if e.strip()), 1.0 / float(down)


def make_lr_schedule(base_lr: float, milestones_epochs, gamma: float,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate after ``n`` applied updates."""
    boundaries = sorted(int(e * steps_per_epoch) for e in milestones_epochs)

    def schedule(n: int) -> float:
        lr = base_lr
        for b in boundaries:
            if n >= b:
                lr *= gamma
        return lr

    return schedule


def make_optimizer(params, lr: float = 1e-3, alpha: float = 0.9, weight_decay: float = 0.0,
                   eps: float = 1e-8) -> torch.optim.RMSprop:
    return torch.optim.RMSprop(params, lr=lr, alpha=alpha, eps=eps, weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the steps taken and the steps whose update
    was skipped for a non-finite loss. ``lr_schedule``, when given, sets the
    rate before each update from the number of updates applied so far."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    nan_steps: int = 0
    lr_schedule: Callable[[int], float] | None = None


def create_train_state(model, optimizer, lr_schedule=None) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, lr_schedule=lr_schedule)


def apply_updates_if_finite(state: TrainState, loss: torch.Tensor) -> bool:
    """Apply the optimizer update from the gradients in place when ``loss``
    is finite; otherwise leave parameters and optimizer state as they are and
    count the step in ``nan_steps``. ``step`` advances either way. Returns
    whether the update was applied."""
    with span("train.finite_check"):  # a host sync on the loss
        finite = bool(torch.isfinite(loss))
    if finite:
        if state.lr_schedule is not None:
            lr = state.lr_schedule(state.step - state.nan_steps)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
        state.optimizer.step()
    else:
        state.nan_steps += 1
    state.step += 1
    return finite
