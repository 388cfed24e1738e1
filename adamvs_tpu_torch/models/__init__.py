"""Model factory and losses of the port."""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..nn.blocks import init_parameters
from .adamvs import AdaMVS
from .losses import cas_mvs_vis_loss, cas_rednet_loss
from .msrednet import MSREDNet

MODELS = {"adamvs": AdaMVS, "msrednet": MSREDNet}
LOSSES = {"adamvs": cas_mvs_vis_loss, "msrednet": cas_rednet_loss}


def build_model(name: str = "adamvs", seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32, **kwargs) -> torch.nn.Module:
    """The model ``name`` ("adamvs" or "msrednet") in eval mode with weights
    drawn from ``seed``, on ``device`` (CUDA unless given) in ``dtype``."""
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r} (choose one of {sorted(MODELS)})")
    model = MODELS[name](**kwargs)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device=resolve_device(device), dtype=dtype).eval()


def model_loss(name: str):
    """The training loss of the model ``name``."""
    if name not in LOSSES:
        raise ValueError(f"unknown model {name!r} (choose one of {sorted(LOSSES)})")
    return LOSSES[name]


__all__ = ["AdaMVS", "MSREDNet", "build_model", "cas_mvs_vis_loss", "cas_rednet_loss",
           "model_loss"]
