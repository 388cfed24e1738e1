"""The system under test, built from a configuration and a traffic mix: the
port's model with the benchmark's weights, its prediction engine, its
Trainer. Everything the harness takes from the port is imported here or in
the loops."""

from __future__ import annotations

import torch

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def port_model(cfg: dict, traffic: dict, state_dict: dict, device, train: bool = False):
    """The port's ``cfg["model"]`` in the mix's forms (``sweep_impl``,
    ``reg_impl``) computing in the mix's dtype, with ``state_dict`` loaded.
    For inference its parameters are cast to that dtype (as ``build_model``
    does); for training they stay float32."""
    from adamvs_tpu_torch.models import MODELS

    dtype = DTYPES[traffic["dtype"]]
    kw = dict(ndepths=tuple(cfg["ndepths"]), depth_intervals_ratio=tuple(cfg["depth_inter_r"]),
              base=cfg["base"], cr_base=tuple(cfg["cr_base_chs"]),
              sweep_impl=traffic["sweep_impl"], reg_impl=traffic["reg_impl"][cfg["model"]],
              compute_dtype=dtype)
    with torch.device(device):
        model = MODELS[cfg["model"]](**kw)
    model.load_state_dict(state_dict, strict=True)
    if not train:
        model = model.to(dtype=dtype)
    return model.eval()


def reference_module(cfg: dict, device):
    """The plain reference model of ``cfg`` on ``device`` (weights not yet
    drawn)."""
    from mvsbench.reference.models import MODELS

    with torch.device(device):
        return MODELS[cfg["model"]](cfg["ndepths"], cfg["depth_inter_r"], cfg["base"],
                                    cfg["cr_base_chs"])


def draw_weights(cfg: dict, seed: int, device) -> dict:
    """The cell's weights, drawn from ``seed`` on ``device``."""
    from mvsbench.harness import draw_state_dict

    return draw_state_dict(reference_module(cfg, device), seed, device, cfg["init_gain"])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
