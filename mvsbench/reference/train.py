"""The published training objective and optimizer, plain: each stage's
masked smooth-L1 depth loss weighted by ``dlossw`` (Ada-MVS adds the mean
of the same term over stage 1's per-view depths), and RMSprop (``lr``,
``alpha``, eps outside the square root) written out."""

from __future__ import annotations

import torch

from .models import resize
from .numerics import FLOAT32, Numerics


def _masked_smooth_l1(est, gt, mask):
    x = resize(est, gt.shape[-2], gt.shape[-1]) - gt
    ax = x.abs()
    val = torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)
    m = (mask > 0.5).float()
    return (val * m).sum() / m.sum().clamp(min=1.0)


def cascade_loss(out: dict, depth: dict, mask: dict, dlossw) -> torch.Tensor:
    """The loss of a reference model's outputs against the GT pyramid."""
    total = 0.0
    for i, w in enumerate(dlossw):
        key = f"stage{i + 1}"
        term = _masked_smooth_l1(out[key]["depth"], depth[key], mask[key])
        pairs = out[key].get("pair_result", ())
        if pairs:
            pair_terms = [_masked_smooth_l1(p, depth[key], mask[key]) for p in pairs]
            term = term + sum(pair_terms) / len(pairs)
        total = total + w * term
    return total


class RMSprop:
    """``v = alpha v + (1 - alpha) g^2; p -= lr g / (sqrt(v) + eps)``."""

    def __init__(self, params, lr=1e-3, alpha=0.9, eps=1e-8):
        self.params = list(params)
        self.lr, self.alpha, self.eps = lr, alpha, eps
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self):
        for p, v in zip(self.params, self.v):
            v.mul_(self.alpha).addcmul_(p.grad, p.grad, value=1 - self.alpha)
            p.addcdiv_(p.grad, v.sqrt().add_(self.eps), value=-self.lr)


def train_step(model, opt: RMSprop, batch: dict, dlossw, nx: Numerics = FLOAT32,
               checkpoint_steps: bool = False) -> tuple[float, dict, torch.Tensor]:
    """One step on ``batch`` (tensors, the trainer's layout): (loss, the
    gradient of each named parameter, the final stage's depth before the
    update)."""
    model.train()
    for p in model.parameters():
        p.grad = None
    out = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"], nx=nx,
                checkpoint_steps=checkpoint_steps)
    loss = cascade_loss(out, batch["depth"], batch["mask"], dlossw)
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    opt.step()
    return float(loss.detach()), grads, out["depth"].detach()
