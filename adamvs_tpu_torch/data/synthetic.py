"""Synthetic aerial scenes and predict-source trees (counterpart of the
predict part of adamvs_tpu/data/synthetic.py).

Scene model: a tilted plane ``z = a*x + b*y + h0`` textured with a smooth
procedural RGB function, photographed by downward-looking cameras given in
the WHU photogrammetric convention (XrightYup, [Rwc|twc]). Images are
rendered by exact ray/plane intersection, so multi-view photo-consistency
and ground-truth depth are analytic. The renderer works in row bands, so a
full-size aerial frame (5504x3712) needs a few hundred MB, not several GB,
and the bands may render on several threads; every pixel is computed as the
JAX package computes it.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os

import numpy as np

from ..geom.camera import Camera, convert_photogrammetric_extrinsic, depth_sample_count

_TEXTURE_COMPONENTS = 24
_TEXTURE_MAX_FREQ = 0.30  # rad / world unit; ~0.55 rad/px at GSD ≈ 1.85
# rows rendered at a time: a band's [rows, W, 24] float64 temporaries stay a few MB
_BAND_ROWS = 16


def _texture_basis():
    """Fixed random band-limited spectrum: aperiodic (no false plane-sweep
    matches, unlike a few pure sinusoids) yet smooth enough that bilinear
    resampling between views stays photo-consistent."""
    rng = np.random.RandomState(42)
    n = _TEXTURE_COMPONENTS
    freqs = rng.uniform(0.02, _TEXTURE_MAX_FREQ, size=(3, n))
    angles = rng.uniform(0, 2 * np.pi, size=(3, n))
    phases = rng.uniform(0, 2 * np.pi, size=(3, n))
    fx = freqs * np.cos(angles)
    fy = freqs * np.sin(angles)
    return fx, fy, phases


_TEX_FX, _TEX_FY, _TEX_PHASE = _texture_basis()


def _texture(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Smooth, matchable RGB texture over world (x, y); float in [0, 255]."""
    x = np.asarray(x)[..., None]
    y = np.asarray(y)[..., None]
    chans = []
    scale = np.sqrt(2.0 / _TEXTURE_COMPONENTS)
    for c in range(3):  # in place: the same operations, one temporary fewer each
        arg = x * _TEX_FX[c]
        arg += y * _TEX_FY[c]
        arg += _TEX_PHASE[c]
        v = np.sin(arg, out=arg).sum(-1)
        chans.append(0.5 + 0.3 * scale * v)
    return np.clip(np.stack(chans, axis=-1) * 255.0, 0, 255)


def _rot_xyz(rx: float, ry: float, rz: float) -> np.ndarray:
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


@dataclasses.dataclass
class SyntheticView:
    name: str
    camera: Camera  # converted XrightYdown Tcw camera
    rwc: np.ndarray  # photogrammetric rotation (XrightYup)
    twc: np.ndarray  # projection center
    image: np.ndarray  # uint8 [H,W,3]
    depth: np.ndarray  # float32 [H,W]
    mask: np.ndarray  # uint8 [H,W] (255 valid)


@dataclasses.dataclass
class SyntheticScene:
    views: list[SyntheticView]
    plane: tuple[float, float, float]  # z = a x + b y + h0
    depth_start: float
    depth_end: float
    depth_interval: float

    @property
    def height(self) -> int:
        return self.views[0].image.shape[0]

    @property
    def width(self) -> int:
        return self.views[0].image.shape[1]


def render_view(
    K: np.ndarray,
    rwc: np.ndarray,
    twc: np.ndarray,
    height: int,
    width: int,
    plane: tuple[float, float, float],
    workers: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Render (image, depth) for a photogrammetric camera by ray casting,
    ``_BAND_ROWS`` rows at a time on ``workers`` threads.

    ``rwc``/``twc`` are XrightYup [Rwc|twc]; depth is the camera-frame z after
    the XrightYdown conversion (the quantity the plane sweep hypothesizes over).
    """
    a, b, h0 = plane
    tcw_mat = convert_photogrammetric_extrinsic(rwc, twc).astype(np.float64)
    rcw = tcw_mat[:3, :3]
    c = np.asarray(twc, dtype=np.float64)
    Kinv = np.linalg.inv(K.astype(np.float64))
    image = np.empty((height, width, 3), np.uint8)
    depth = np.empty((height, width), np.float32)

    def band(r0: int) -> None:
        r1 = min(r0 + _BAND_ROWS, height)
        v, u = np.meshgrid(np.arange(r0, r1, dtype=np.float64),
                           np.arange(width, dtype=np.float64), indexing="ij")
        pix = np.stack([u, v, np.ones_like(u)], axis=-1)  # [rows,W,3]
        d_cam = pix @ Kinv.T
        d_world = d_cam @ rcw  # Rcw^T @ d_cam, row-vector form
        denom = d_world[..., 2] - a * d_world[..., 0] - b * d_world[..., 1]
        t = (a * c[0] + b * c[1] + h0 - c[2]) / denom
        p = c[None, None, :] + t[..., None] * d_world
        depth[r0:r1] = ((p - c[None, None, :]) @ rcw[2]).astype(np.float32)  # camera-frame z
        image[r0:r1] = _texture(p[..., 0], p[..., 1]).astype(np.uint8)

    starts = range(0, height, _BAND_ROWS)
    if workers <= 1:
        for r0 in starts:
            band(r0)
    else:
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(band, starts))
    return image, depth


def make_scene(
    num_views: int = 5,
    height: int = 96,
    width: int = 128,
    seed: int = 0,
    focal: float = 200.0,
    fly_height: float = 400.0,
    plane: tuple[float, float, float] = (0.1, -0.08, 30.0),
    baseline: float = 120.0,
    tilt: float = 0.3,
    workers: int = 1,
) -> SyntheticScene:
    """Build a synthetic scene: view 0 is the nadir reference, the rest orbit
    it at ``baseline``, tilted by ``tilt`` toward the scene centre; each view
    renders on ``workers`` threads (``render_view``)."""
    rng = np.random.RandomState(seed)
    K = np.array(
        [[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]],
        dtype=np.float32,
    )
    views: list[SyntheticView] = []
    depth_min, depth_max = np.inf, -np.inf
    for i in range(num_views):
        if i == 0:
            rwc = np.eye(3)
            twc = np.array([0.0, 0.0, fly_height])
        else:
            ang = 2 * np.pi * (i - 1) / max(1, num_views - 1)
            twc = np.array(
                [baseline * np.cos(ang), baseline * np.sin(ang), fly_height + rng.uniform(-5, 5)]
            )
            # tilt toward the scene center to keep frusta overlapping: for a
            # camera at (b·cosθ, b·sinθ, h) the small-angle look-at solution is
            # rx = -(b/h)·sinθ, ry = +(b/h)·cosθ (tilt ≈ baseline/fly_height)
            rwc = _rot_xyz(
                -tilt * np.sin(ang) + rng.uniform(-0.01, 0.01),
                tilt * np.cos(ang) + rng.uniform(-0.01, 0.01),
                rng.uniform(-0.02, 0.02),
            )
        image, depth = render_view(K, rwc, twc, height, width, plane, workers=workers)
        cam = Camera(K=K.copy(), tcw=convert_photogrammetric_extrinsic(rwc, twc))
        mask = np.full((height, width), 255, dtype=np.uint8)
        views.append(
            SyntheticView(name=f"view_{i:03d}", camera=cam, rwc=rwc, twc=twc, image=image,
                          depth=depth, mask=mask)
        )
        depth_min = min(depth_min, float(depth.min()))
        depth_max = max(depth_max, float(depth.max()))

    start = float(np.floor(depth_min - 2.0))
    end = float(np.ceil(depth_max + 2.0))
    interval = (end - start) / 96.0
    for view in views:
        view.camera.depth_start = start
        view.camera.depth_end = end
        view.camera.depth_interval = interval
        view.camera.depth_count = float(depth_sample_count(start, end, interval))
    return SyntheticScene(
        views=views, plane=plane, depth_start=start, depth_end=end, depth_interval=interval
    )


def write_predict_source_tree(root: str, scene: SyntheticScene, workers: int = 1) -> str:
    """Write a predict-source dir (viewpair/image_info/camera_info/image_path
    txt files, data_io.py:47-133) with the scene's views as PNGs, encoded on
    ``workers`` threads."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)

    n = len(scene.views)
    cam = scene.views[0].camera
    with open(os.path.join(root, "camera_info.txt"), "w") as f:
        f.write("# CAMERA_ID WIDTH HEIGHT PIXELSIZE fx fy cx cy K1 K2 K3 P1 P2\n")
        f.write(
            f"1 {scene.width} {scene.height} 1.0 {float(cam.K[0,0])!r} {float(cam.K[1,1])!r} "
            f"{float(cam.K[0,2])!r} {float(cam.K[1,2])!r} 0 0 0 0 0\n"
        )
    with open(os.path.join(root, "image_info.txt"), "w") as f:
        f.write("# IMAGE_ID CAMERA_ID Rwc[9] twc[3] MINDEPTH MAXDEPTH NAME\n")
        for i, view in enumerate(scene.views):
            rwc = " ".join(repr(float(x)) for x in view.rwc.reshape(-1))
            twc = " ".join(repr(float(x)) for x in view.twc)
            f.write(
                f"{i} 1 {rwc} {twc} {scene.depth_start!r} {scene.depth_end!r} "
                f"images/{view.name}.png\n"
            )
    paths = [os.path.join(img_dir, view.name + ".png") for view in scene.views]
    with cf.ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        list(pool.map(lambda v, path: Image.fromarray(v.image).save(path), scene.views, paths))
    with open(os.path.join(root, "image_path.txt"), "w") as f:
        f.write(f"{n}\n")
        for i, (view, path) in enumerate(zip(scene.views, paths)):
            f.write(f"{i} {view.name} {path}\n")
    with open(os.path.join(root, "viewpair.txt"), "w") as f:
        f.write(f"{n}\n")
        for i in range(n):
            srcs = [j for j in range(n) if j != i]
            f.write(f"{i}\n")
            f.write(str(len(srcs)) + " " + " ".join(f"{j} {1.0}" for j in srcs) + "\n")
    return root
