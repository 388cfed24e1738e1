"""Camera model and convention conversions (host-side, numpy; counterpart of
adamvs_tpu/geom/camera.py, kept as the port's own copy).

The reference encodes a camera as a ``[2,4,4]`` float array: ``cam[0]`` is the
4x4 extrinsic ``Tcw`` (world->camera, XrightYdown), ``cam[1][:3,:3]`` is the
intrinsic ``K``, and row ``cam[1][3]`` packs the depth-range metadata
``[depth_start, depth_interval, depth_count, depth_end]``
(reference: datasets/cas_total_rscv.py:273-426, datasets/predict_oblique.py:72-111).

Here a camera is a small typed record; ``legacy_cam_array``/``camera_from_legacy``
convert to/from the packed array for on-disk parity (cam txt writers, sample
pass-through fields).

Conventions (reference: datasets/cas_total_rscv.py:400-409):
- WHU photogrammetric cameras are given as XrightYup / ``[Rwc|twc]``.
- Converted to XrightYdown by right-multiplying ``Rwc`` with diag(1,-1,-1),
  then inverted to get ``Tcw``.
- Projection matrix is ``K @ Tcw[:3,:]`` embedded in a 4x4 whose last row is
  ``[0,0,0,1]`` (cas_total_rscv.py:512-518).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

_FLIP_YZ = np.diag([1.0, -1.0, -1.0]).astype(np.float64)


@dataclasses.dataclass
class Camera:
    """Pinhole camera with a depth-range annotation.

    K:    [3,3] intrinsics (XrightYdown pixel frame).
    tcw:  [4,4] extrinsic world->camera (XrightYdown, [Rcw|tcw]).
    depth_start / depth_interval / depth_count / depth_end: plane-sweep range.
    """

    K: np.ndarray
    tcw: np.ndarray
    depth_start: float = 0.0
    depth_interval: float = 0.0
    depth_count: float = 0.0
    depth_end: float = 0.0

    def copy(self) -> "Camera":
        return Camera(
            K=self.K.copy(),
            tcw=self.tcw.copy(),
            depth_start=self.depth_start,
            depth_interval=self.depth_interval,
            depth_count=self.depth_count,
            depth_end=self.depth_end,
        )


def convert_photogrammetric_extrinsic(rwc: np.ndarray, twc: np.ndarray) -> np.ndarray:
    """XrightYup [Rwc|twc] -> XrightYdown Tcw.

    Matches cas_total_rscv.py:400-409 / predict_oblique.py:83-89: the rotation is
    right-multiplied by diag(1,-1,-1) (flip camera Y/Z axes), assembled into Twc,
    then inverted.
    """
    rwc = np.asarray(rwc, dtype=np.float64).reshape(3, 3)
    twc = np.asarray(twc, dtype=np.float64).reshape(3)
    twc_mat = np.eye(4, dtype=np.float64)
    twc_mat[:3, :3] = rwc @ _FLIP_YZ
    twc_mat[:3, 3] = twc
    return np.linalg.inv(twc_mat).astype(np.float32)


def proj_matrix(cam: Camera) -> np.ndarray:
    """4x4 projection: rows 0..2 = K @ Tcw[:3,:], row 3 = Tcw row 3.

    (cas_total_rscv.py:512-518 — the reference copies the extrinsic then
    overwrites the first three rows, so row 3 stays [0,0,0,1].)
    """
    proj = cam.tcw.astype(np.float32).copy()
    proj[:3, :4] = cam.K.astype(np.float32) @ proj[:3, :4]
    return proj


def scale_camera(cam: Camera, scale: float) -> Camera:
    """Scale intrinsics for a resized image (preprocess.py:22-34)."""
    out = cam.copy()
    out.K[0, 0] *= scale
    out.K[1, 1] *= scale
    out.K[0, 2] *= scale
    out.K[1, 2] *= scale
    return out


def crop_camera(cam: Camera, start_h: int, start_w: int) -> Camera:
    """Shift the principal point for a crop whose origin is (start_h, start_w)
    (preprocess.py:90-92)."""
    out = cam.copy()
    out.K[0, 2] -= start_w
    out.K[1, 2] -= start_h
    return out


def ceil_to_multiple(x: int, base: int) -> int:
    return int(math.ceil(x / base) * base)


def crop_to_multiple(
    h: int, w: int, max_h: int, max_w: int, resize_scale: float = 1.0, base: int = 32
) -> tuple[int, int]:
    """Target (new_h, new_w) for network input: clamp to max, else ceil to a
    multiple of ``base`` (preprocess.py:68-89; crop origin is (0,0))."""
    max_h = int(max_h * resize_scale)
    max_w = int(max_w * resize_scale)
    new_h = max_h if h > max_h else ceil_to_multiple(h, base)
    new_w = max_w if w > max_w else ceil_to_multiple(w, base)
    return new_h, new_w


def depth_sample_count(start: float, end: float, interval: float, base: int = 32) -> int:
    """Hypothesis count rounded up to a multiple of ``base``
    (cas_total_rscv.py:315,421: int((end-start)/interval/32 + 1) * 32)."""
    return int((end - start) / interval / base + 1) * base


def stage_proj_matrices(proj: np.ndarray, num_stages: int = 3) -> dict[str, np.ndarray]:
    """Per-stage projection matrices for the cascade.

    ``proj`` is [V,4,4] at full resolution. Stage k (1-based) runs at scale
    1/2^(num_stages-k); the first two ROWS of the 4x4 product are divided by the
    scale (cas_total_rscv.py:540-549 — equivalent to scaling K's first two rows).
    Returns {"stage1": [V,4,4] (coarsest), ..., "stageN": full res}.
    """
    out = {}
    for k in range(1, num_stages + 1):
        s = 2 ** (num_stages - k)
        p = proj.copy()
        p[..., :2, :] = p[..., :2, :] / s
        out[f"stage{k}"] = p
    return out


def legacy_cam_array(cam: Camera) -> np.ndarray:
    """Pack into the reference's [2,4,4] layout."""
    arr = np.zeros((2, 4, 4), dtype=np.float32)
    arr[0] = cam.tcw
    arr[1, :3, :3] = cam.K
    arr[1, 3, 0] = cam.depth_start
    arr[1, 3, 1] = cam.depth_interval
    arr[1, 3, 2] = cam.depth_count
    arr[1, 3, 3] = cam.depth_end
    return arr


def camera_from_legacy(arr: np.ndarray) -> Camera:
    arr = np.asarray(arr, dtype=np.float32)
    return Camera(
        K=arr[1, :3, :3].copy(),
        tcw=arr[0].copy(),
        depth_start=float(arr[1, 3, 0]),
        depth_interval=float(arr[1, 3, 1]),
        depth_count=float(arr[1, 3, 2]),
        depth_end=float(arr[1, 3, 3]),
    )
