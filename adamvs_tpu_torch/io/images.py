"""Image and ground-truth-depth readers (counterpart of
adamvs_tpu/io/images.py).

PIL decodes every image format it knows. GT depth dialects
(cas_total_rscv.py:432-451):

- ``whu_mvs``: 16-bit PNG, depth = png / 64;
- ``dtu`` / ``BlendedMVS``: PFM;
- ``whu_omvs``: EXR (the port's codec, ``io/exr.py``) with a sibling mask
  PNG under ``masks/``; pixels whose mask value is below 0.5 are zeroed.

The JAX package's optional native PNG/EXR library (``io/native.py``) is not
ported (ROADMAP.md queue 1: the native PNG/EXR library).
"""

from __future__ import annotations

import numpy as np

from .exr import read_exr_depth
from .pfm import read_pfm


def read_image(path: str) -> np.ndarray:
    """RGB uint8 [H,W,3]."""
    from PIL import Image

    with Image.open(path) as img:
        return np.array(img.convert("RGB"))


def read_gt_depth(path: str, set_name: str) -> np.ndarray:
    """The ground-truth depth [H,W] float32 of a sample of ``set_name``."""
    from PIL import Image

    if set_name == "whu_mvs":
        with Image.open(path) as img:
            return np.asarray(img, dtype=np.float32) / 64.0
    if set_name in ("dtu", "BlendedMVS"):
        return np.asarray(read_pfm(path)[0], dtype=np.float32)
    if set_name == "whu_omvs":
        depth = read_exr_depth(path)
        mask_path = path.replace("depths", "masks").replace(".exr", ".png")
        with Image.open(mask_path) as m:
            mask = np.asarray(m.convert("L"), dtype=np.float32) / 255.0
        depth = depth.copy()
        depth[mask < 0.5] = 0.0
        return depth
    raise ValueError(f"unknown set_name {set_name!r}")
