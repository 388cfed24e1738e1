"""Image and ground-truth-depth readers (counterpart of
adamvs_tpu/io/images.py).

A PNG decodes through the port's host library (``io/native.py``) when it
holds 8-bit samples; a 16-bit PNG, or one the library does not take (fewer
than 8 bits a sample, interlaced), goes to PIL, as does every other format.
An EXR depth decodes through the host library, and one it does not take
through the port's Python codec (``io/exr.py``). GT depth dialects
(cas_total_rscv.py:432-451):

- ``whu_mvs``: 16-bit PNG, depth = png / 64;
- ``dtu`` / ``BlendedMVS``: PFM;
- ``whu_omvs``: EXR with a sibling mask PNG under ``masks/``; pixels whose
  mask value is below 0.5 are zeroed.
"""

from __future__ import annotations

import numpy as np

from . import native
from .exr import read_exr_depth as _read_exr_depth_py
from .pfm import read_pfm


def read_image(path: str) -> np.ndarray:
    """RGB uint8 [H,W,3]: gray is repeated, alpha dropped."""
    from PIL import Image

    if path.lower().endswith(".png"):
        try:
            img = native.read_png(path)
        except ValueError:
            img = None  # a PNG flavour the library does not take -> PIL
        if img is not None and img.dtype == np.uint8:
            if img.ndim == 2:
                return np.repeat(img[..., None], 3, axis=-1)
            if img.shape[2] == 2:
                return np.repeat(img[..., :1], 3, axis=-1)
            return np.ascontiguousarray(img[..., :3])
    with Image.open(path) as img:
        return np.array(img.convert("RGB"))


def read_exr_depth(path: str) -> np.ndarray:
    """[H,W] float32 depth of an EXR file."""
    try:
        return native.read_exr_depth(path)
    except ValueError:
        return _read_exr_depth_py(path)


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
