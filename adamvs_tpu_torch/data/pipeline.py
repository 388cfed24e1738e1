"""Host-side sample assembly: images and cameras into the model's inputs
(counterpart of adamvs_tpu/data/pipeline.py).

A training sample (the reference's NCHW equivalent is
cas_total_rscv.py:558-567) holds:

- ``imgs`` float32 [V,H,W,3], per-image mean/var normalised;
- ``proj_matrices`` {"stage1", "stage2", "stage3"}: [V,4,4];
- ``depth`` {"stageK"}: the GT pyramid at 1/4, 1/2 and 1/1, downsampled
  nearest-neighbour; ``mask`` {"stageK"}: depth within [depth_min,
  depth_max];
- ``depth_values`` float32 [3] = [depth_min, depth_max, depth_interval] and
  ``depth_interval``.

A predict sample holds ``imgs``, ``proj_matrices`` and ``depth_values``
float32 [2] = [min, max] (predict_oblique.py:114-190). Images are read with
PIL, augmented with PIL's ImageEnhance and resized with OpenCV, each
imported by the function that uses it.
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
from ..io.cams_text import (
    read_blendedmvs_cam,
    read_dtu_cam,
    read_obliquewhu_cam,
    read_whu_cam,
)
from ..io.images import read_gt_depth, read_image
from .lists import PredictSource, PredictSpec, SampleSpec

_CAM_READERS = {
    "whu_mvs": read_whu_cam,
    "dtu": read_dtu_cam,
    "BlendedMVS": read_blendedmvs_cam,
    "whu_omvs": read_obliquewhu_cam,
}


def center_image(img: np.ndarray) -> np.ndarray:
    """Per-image mean/var normalization (preprocess.py:102-112)."""
    img = np.asarray(img, dtype=np.float32)
    var = np.var(img, axis=(0, 1), keepdims=True)
    mean = np.mean(img, axis=(0, 1), keepdims=True)
    return (img - mean) / (np.sqrt(var) + 1e-8)


def color_augment(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Photometric augmentation: colour, brightness, contrast and sharpness
    jitter (preprocess.py:116-135), drawn from ``rng`` in that order."""
    from PIL import Image, ImageEnhance

    pil = Image.fromarray(img)
    pil = ImageEnhance.Color(pil).enhance(rng.randint(1, 301) / 100.0)
    pil = ImageEnhance.Brightness(pil).enhance(rng.randint(10, 201) / 100.0)
    pil = ImageEnhance.Contrast(pil).enhance(rng.randint(10, 201) / 100.0)
    pil = ImageEnhance.Sharpness(pil).enhance(rng.randint(0, 301) / 100.0)
    return np.array(pil)


def gaussian_augment(
    img: np.ndarray, rng: np.random.RandomState, mean: float = 0.02, sigma: float = 0.03
) -> np.ndarray:
    """Additive per-pixel Gaussian noise (the reference's ``randomGaussian``,
    preprocess.py:137-156, vectorised). The reference never calls it (its
    call site is commented out, preprocess.py:119), so the train pipeline
    does not either."""
    img = np.asarray(img, dtype=np.float32)
    noise = rng.normal(mean, sigma, size=img.shape).astype(np.float32)
    return img + noise


@dataclasses.dataclass
class TrainSample:
    imgs: np.ndarray
    proj_matrices: dict[str, np.ndarray]
    depth: dict[str, np.ndarray]
    mask: dict[str, np.ndarray]
    depth_values: np.ndarray
    depth_interval: float
    out_image: np.ndarray
    out_cam: Any
    name: str
    vid: str


def _pyramid(arr: np.ndarray, num_stages: int = 3) -> dict[str, np.ndarray]:
    """The GT pyramid, OpenCV INTER_NEAREST downsampling
    (cas_total_rscv.py:529-538)."""
    import cv2

    h, w = arr.shape
    out = {}
    for k in range(1, num_stages + 1):
        s = 2 ** (num_stages - k)
        if s == 1:
            out[f"stage{k}"] = arr
        else:
            out[f"stage{k}"] = cv2.resize(arr, (w // s, h // s), interpolation=cv2.INTER_NEAREST)
    return out


def load_train_sample(
    spec: SampleSpec,
    mode: str = "train",
    interval_scale: float = 1.0,
    rng: np.random.RandomState | None = None,
) -> TrainSample:
    """Read one training or test sample: its views (colour-augmented from
    ``rng`` in train mode), cameras in the corpus's dialect, GT depth and
    mask pyramids."""
    read_cam = _CAM_READERS[spec.set_name]
    depth_image = read_gt_depth(spec.depth_path, spec.set_name)

    images, projs = [], []
    ref_cam: Camera | None = None
    out_image = None
    for view in range(spec.view_cnts):
        img = read_image(spec.image_paths[view])
        if mode == "train" and rng is not None:
            img = color_augment(img, rng)
        cam = read_cam(spec.cam_paths[view], interval_scale)
        if view == 0:
            ref_cam = cam
            out_image = img
        projs.append(proj_matrix(cam))
        images.append(center_image(img))

    imgs = np.stack(images)  # [V,H,W,3]
    proj = np.stack(projs)  # [V,4,4]
    depth_values = np.array(
        [ref_cam.depth_start, ref_cam.depth_end, ref_cam.depth_interval], dtype=np.float32
    )
    mask = (
        (depth_image >= ref_cam.depth_start) & (depth_image <= ref_cam.depth_end)
    ).astype(np.float32)

    return TrainSample(
        imgs=imgs,
        proj_matrices=stage_proj_matrices(proj),
        depth=_pyramid(depth_image.astype(np.float32)),
        mask=_pyramid(mask),
        depth_values=depth_values,
        depth_interval=float(ref_cam.depth_interval),
        out_image=out_image,
        out_cam=ref_cam,
        name=spec.name,
        vid=spec.vid,
    )


def batch_train_samples(samples: list[TrainSample]) -> dict[str, Any]:
    """Collate samples into a batch of numpy arrays (a leading B axis)."""
    return {
        "imgs": np.stack([s.imgs for s in samples]),
        "proj_matrices": {
            k: np.stack([s.proj_matrices[k] for s in samples])
            for k in samples[0].proj_matrices
        },
        "depth": {k: np.stack([s.depth[k] for s in samples]) for k in samples[0].depth},
        "mask": {k: np.stack([s.mask[k] for s in samples]) for k in samples[0].mask},
        "depth_values": np.stack([s.depth_values for s in samples]),
        "depth_interval": np.array([s.depth_interval for s in samples], dtype=np.float32),
    }


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
