"""ctypes bindings of the port's host library (counterpart of
adamvs_tpu/io/native.py).

The library (``csrc/host/*.cc``: PNG and EXR decoders, image centring and a
bilinear resize, OpenMP) is built with g++ at its first use
(``kernels/build.py::build_host``); a failed build raises, and nothing falls
back. A decoder's nonzero return code raises ``ValueError`` with the
code, as JAX's binding does, so a caller can send that file to another
decoder (``io/images.py``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..kernels.build import build_host

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "mvs_png_info": (ctypes.c_int, [_u8p, ctypes.c_size_t, _i32p, _i32p, _i32p, _i32p]),
    "mvs_png_decode": (ctypes.c_int, [_u8p, ctypes.c_size_t, ctypes.c_void_p]),
    "mvs_exr_info": (ctypes.c_int, [_u8p, ctypes.c_size_t, _i32p, _i32p]),
    "mvs_exr_read_depth": (ctypes.c_int, [_u8p, ctypes.c_size_t, _f32p]),
    "mvs_center_image_u8": (None, [_u8p] + [ctypes.c_int32] * 3 + [_f32p]),
    "mvs_resize_bilinear_u8": (None, [_u8p] + [ctypes.c_int32] * 3 + [_u8p]
                               + [ctypes.c_int32] * 2),
    "mvs_native_version": (ctypes.c_int, []),
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The host library, built first if needed, with every entry declared."""
    lib = ctypes.CDLL(build_host()[0])
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _buffer(data: bytes):
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data)


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes -> [H,W,C] uint8 or uint16 (C dropped when 1)."""
    lib = _lib()
    buf = _buffer(data)
    w, h, c, bd = (ctypes.c_int32() for _ in range(4))
    rc = lib.mvs_png_info(buf, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                          ctypes.byref(bd))
    if rc != 0:
        raise ValueError(f"mvs_png_info failed: {rc}")
    dtype = np.uint8 if bd.value == 8 else np.uint16
    out = np.empty((h.value, w.value, c.value), dtype=dtype)
    rc = lib.mvs_png_decode(buf, len(data), out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"mvs_png_decode failed: {rc}")
    return out[..., 0] if c.value == 1 else out


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def read_exr_depth(path: str) -> np.ndarray:
    """The depth channel (Z, else Y, else R, else the first) of a scanline
    EXR as [H,W] float32."""
    lib = _lib()
    with open(path, "rb") as f:
        data = f.read()
    buf = _buffer(data)
    w, h = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.mvs_exr_info(buf, len(data), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"mvs_exr_info failed: {rc}")
    out = np.empty((h.value, w.value), dtype=np.float32)
    rc = lib.mvs_exr_read_depth(buf, len(data), out.ctypes.data_as(_f32p))
    if rc != 0:
        raise ValueError(f"mvs_exr_read_depth failed: {rc}")
    return out


def center_image(img: np.ndarray) -> np.ndarray:
    """(img - mean) / (std + 1e-8) per channel of [H,W,C] uint8, as float32."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    out = np.empty((h, w, c), dtype=np.float32)
    _lib().mvs_center_image_u8(img.ctypes.data_as(_u8p), h, w, c, out.ctypes.data_as(_f32p))
    return out


def resize_bilinear(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """[H,W,C] uint8 resized to [dh,dw,C] (half-pixel centres, as
    ``cv2.INTER_LINEAR``, within one unit of it)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    out = np.empty((dh, dw, c), dtype=np.uint8)
    _lib().mvs_resize_bilinear_u8(img.ctypes.data_as(_u8p), h, w, c, out.ctypes.data_as(_u8p),
                                  dh, dw)
    return out
