"""PFM (Portable Float Map) codec (counterpart of adamvs_tpu/io/pfm.py).

Byte-compatible with the reference's reader/writer (datasets/data_io.py:161-226):
header ``PF``/``Pf``, ``<width> <height>``, scale line whose sign encodes
endianness, rows stored bottom-to-top.
"""

from __future__ import annotations

import sys

import numpy as np


def read_pfm(path: str) -> tuple[np.ndarray, float]:
    with open(path, "rb") as f:
        header = f.readline().decode("ascii").rstrip()
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        dims = f.readline().decode("ascii").split()
        width, height = int(dims[0]), int(dims[1])
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, dtype=endian + "f4", count=width * height * channels)
    shape = (height, width, 3) if channels == 3 else (height, width)
    return np.flipud(data.reshape(shape)).copy(), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.asarray(image)
    if image.dtype != np.float32:
        raise ValueError("PFM images must be float32")
    if image.ndim == 3 and image.shape[2] == 3:
        header = b"PF\n"
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        header = b"Pf\n"
    else:
        raise ValueError(f"bad PFM shape {image.shape}")
    flipped = np.flipud(image)
    little = flipped.dtype.byteorder == "<" or (
        flipped.dtype.byteorder == "=" and sys.byteorder == "little"
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode("ascii"))
        f.write(f"{-scale if little else scale:f}\n".encode("ascii"))
        flipped.tofile(f)
