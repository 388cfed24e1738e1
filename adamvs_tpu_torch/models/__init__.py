"""Model factory of the port."""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..nn.blocks import init_parameters
from .adamvs import AdaMVS
from .msrednet import MSREDNet

MODELS = {"adamvs": AdaMVS, "msrednet": MSREDNet}


def build_model(name: str = "adamvs", seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32, **kwargs) -> torch.nn.Module:
    """The model ``name`` ("adamvs" or "msrednet") in eval mode with weights
    drawn from ``seed``, on ``device`` (CUDA unless given) in ``dtype``."""
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r} (choose one of {sorted(MODELS)})")
    model = MODELS[name](**kwargs)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device=resolve_device(device), dtype=dtype).eval()


__all__ = ["AdaMVS", "MSREDNet", "build_model"]
