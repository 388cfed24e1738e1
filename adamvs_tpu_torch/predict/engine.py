"""Full-resolution prediction engine (counterpart of adamvs_tpu/predict/engine.py).

Inputs are zero-padded bottom/right to multiples of 32 (the cascade halves
the frame five times) and the outputs cropped back. A sample is duck-typed:
anything with ``.imgs`` [V,H,W,3], ``.proj_matrices`` {"stageK": [V,4,4]}
and ``.depth_values`` [2], as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _pad_to_multiple(imgs: np.ndarray, base: int = 32) -> tuple[np.ndarray, int, int]:
    """Zero-pad [V,H,W,3] bottom/right to multiples of ``base``."""
    V, H, W, C = imgs.shape
    ph = (-H) % base
    pw = (-W) % base
    if ph or pw:
        imgs = np.pad(imgs, ((0, 0), (0, ph), (0, pw), (0, 0)))
    return imgs, H, W


class PredictEngine:
    """Streaming predictor over a fixed model, on ``device`` (CUDA unless
    given; raises when no CUDA device is present and none was given). Any
    model of ``models.build_model`` serves (AdaMVS or MS-REDNet): the engine
    reads only the outputs ``depth`` and ``photometric_confidence``."""

    def __init__(self, model, num_depth: int = 192, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.num_depth = num_depth

    @torch.no_grad()
    def _forward(self, imgs: np.ndarray, projs: dict, depth_values: np.ndarray):
        dev = self.device
        out = self.model(
            torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).to(dev),
            {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev) for k, v in projs.items()},
            torch.from_numpy(np.asarray(depth_values, np.float32)).to(dev),
            num_depth=self.num_depth,
        )
        return (out["depth"].float().cpu().numpy(),
                out["photometric_confidence"].float().cpu().numpy())

    def predict_sample(self, sample) -> tuple[np.ndarray, np.ndarray]:
        """(depth [H,W], confidence [H,W]) of one sample."""
        imgs, H, W = _pad_to_multiple(np.asarray(sample.imgs))
        depth, prob = self._forward(
            imgs[None],
            {k: np.asarray(v)[None] for k, v in sample.proj_matrices.items()},
            np.asarray(sample.depth_values)[None],
        )
        return depth[0][:H, :W], prob[0][:H, :W]

    def predict_batch(self, samples: list) -> list[tuple[np.ndarray, np.ndarray]]:
        """Batched forward over same-shape samples."""
        padded = [_pad_to_multiple(np.asarray(s.imgs)) for s in samples]
        depth, prob = self._forward(
            np.stack([p[0] for p in padded]),
            {k: np.stack([np.asarray(s.proj_matrices[k]) for s in samples])
             for k in samples[0].proj_matrices},
            np.stack([np.asarray(s.depth_values) for s in samples]),
        )
        return [(depth[i][: p[1], : p[2]], prob[i][: p[1], : p[2]])
                for i, p in enumerate(padded)]
