"""Model factory of the port."""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..nn.blocks import init_parameters
from .adamvs import AdaMVS


def build_model(seed: int = 0, device=None, dtype: torch.dtype = torch.float32,
                **kwargs) -> AdaMVS:
    """An ``AdaMVS`` in eval mode with weights drawn from ``seed``, on
    ``device`` (CUDA unless given) in ``dtype``."""
    model = AdaMVS(**kwargs)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device=resolve_device(device), dtype=dtype).eval()


__all__ = ["AdaMVS", "build_model"]
