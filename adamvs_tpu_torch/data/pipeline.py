"""Predict sample assembly: images + cameras -> the model's inputs
(counterpart of the predict part of adamvs_tpu/data/pipeline.py).

A sample holds ``imgs`` float32 [V,H,W,3] (per-image mean/var normalised),
``proj_matrices`` {"stage1", "stage2", "stage3"}: [V,4,4] and
``depth_values`` float32 [2] = [min, max] (predict_oblique.py:114-190).
Images are read with PIL and resized with OpenCV, both imported by the
functions that use them.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np

from ..geom.camera import (
    Camera,
    convert_photogrammetric_extrinsic,
    crop_camera,
    crop_to_multiple,
    proj_matrix,
    scale_camera,
    stage_proj_matrices,
)
from ..io.images import read_image
from .lists import PredictSource, PredictSpec


def center_image(img: np.ndarray) -> np.ndarray:
    """Per-image mean/var normalization (preprocess.py:102-112)."""
    img = np.asarray(img, dtype=np.float32)
    var = np.var(img, axis=(0, 1), keepdims=True)
    mean = np.mean(img, axis=(0, 1), keepdims=True)
    return (img - mean) / (np.sqrt(var) + 1e-8)


@dataclasses.dataclass
class PredictSample:
    imgs: np.ndarray
    proj_matrices: dict[str, np.ndarray]
    depth_values: np.ndarray  # [2] = [min, max]
    out_image: np.ndarray
    out_cam: Any
    ref_image_path: str
    name: str
    vid: str
    # source image ids (ref first) — the per-view preprocessing is
    # ref-independent, so these key the engine's cross-sample feature cache
    view_ids: tuple = ()


# predict-source cameras carry k1,k2,k3,p1,p2 lens-distortion coefficients.
# The reference silently ignores them (predict_oblique.py:72-111), which is
# right only for pre-undistorted imagery: warn once per camera at a soft
# threshold of corner displacement, raise at a hard one.
_DISTORTION_WARNED: set = set()


def _check_distortion(pcam, camera_id, warn_px: float = 0.5, hard_px: float = 8.0):
    dist = np.asarray(getattr(pcam, "distortion", ()), dtype=np.float64)
    if dist.size == 0 or not np.any(dist):
        return
    # max radial displacement in px at the frame corner, odd/even radial terms
    # k1 r^3 + k2 r^5 + k3 r^7 + tangential ~ 3|p| r^2
    r = float(np.hypot(pcam.x0, pcam.y0)) or 1.0
    k = list(dist) + [0.0] * (5 - dist.size)
    shift = abs(k[0]) * r**3 + abs(k[1]) * r**5 + abs(k[4]) * r**7 \
        + 3.0 * (abs(k[2]) + abs(k[3])) * r**2
    if shift > hard_px:
        raise ValueError(
            f"camera {camera_id}: distortion {dist.tolist()} displaces the "
            f"frame corner by ~{shift:.1f}px; undistort the imagery first "
            "(the pinhole plane-sweep warp assumes zero distortion)"
        )
    if shift > warn_px and camera_id not in _DISTORTION_WARNED:
        _DISTORTION_WARNED.add(camera_id)
        warnings.warn(
            f"camera {camera_id}: nonzero distortion {dist.tolist()} "
            f"(~{shift:.2f}px at frame corner) is ignored by the pinhole "
            "warp; depths may shift near image edges"
        )


def load_predict_sample(
    source: PredictSource,
    spec: PredictSpec,
    num_depth: int = 192,
    resize_scale: float = 0.5,
    max_h: int = 5504,
    max_w: int = 3712,
    sample_scale: float = 1.0,
) -> PredictSample:
    """Assemble a full-resolution predict sample (predict_oblique.py:114-190):
    photogrammetric records -> camera, resize (OpenCV INTER_LINEAR), crop to
    32-multiples with principal-point shift, per-stage projection matrices."""
    import cv2

    images, projs = [], []
    out_image = out_cam = ref_path = None
    depth_min = depth_max = 0.0
    name = vid = ""
    for view, image_id in enumerate(spec.view_ids):
        photo = source.photos[image_id]
        pcam = source.cameras[photo.camera_id]
        _check_distortion(pcam, photo.camera_id)
        img = read_image(source.image_paths[image_id])
        cam = Camera(
            K=np.array(
                [[pcam.fx, 0, pcam.x0], [0, pcam.fy, pcam.y0], [0, 0, 1]], dtype=np.float32
            ),
            tcw=convert_photogrammetric_extrinsic(photo.rwc, photo.twc),
            depth_start=photo.depth_min,
            depth_interval=(photo.depth_max - photo.depth_min) / num_depth,
            depth_count=float(num_depth),
            depth_end=photo.depth_max,
        )
        if resize_scale != 1.0:
            img = cv2.resize(img, None, fx=resize_scale, fy=resize_scale,
                             interpolation=cv2.INTER_LINEAR)
            cam = scale_camera(cam, resize_scale)
        h, w = img.shape[:2]
        new_h, new_w = crop_to_multiple(h, w, max_h, max_w, resize_scale)
        img = img[:new_h, :new_w]
        cam = crop_camera(cam, 0, 0)  # crop origin is (0,0): principal point unchanged
        if view == 0:
            out_image = img
            out_cam = cam
            depth_min, depth_max = cam.depth_start, cam.depth_end
            ref_path = source.image_paths[image_id]
            name = source.image_names[image_id]
            vid = str(photo.camera_id)
        cost_cam = scale_camera(cam, sample_scale)
        projs.append(proj_matrix(cost_cam))
        images.append(center_image(img))

    imgs = np.stack(images)
    proj = np.stack(projs)
    return PredictSample(
        imgs=imgs,
        proj_matrices=stage_proj_matrices(proj),
        depth_values=np.array([depth_min, depth_max], dtype=np.float32),
        out_image=out_image,
        out_cam=out_cam,
        ref_image_path=ref_path,
        name=name,
        vid=vid,
        view_ids=tuple(spec.view_ids),
    )
