"""Image reader (counterpart of adamvs_tpu/io/images.py::read_image).

PIL decodes every format it knows. The JAX package's optional native PNG
library (``io/native.py``) is not ported.
"""

from __future__ import annotations

import numpy as np


def read_image(path: str) -> np.ndarray:
    """RGB uint8 [H,W,3]."""
    from PIL import Image

    with Image.open(path) as img:
        return np.array(img.convert("RGB"))
