"""Synthetic aerial scenes and the trees written from them (counterpart of
adamvs_tpu/data/synthetic.py): a predict-source directory and the four
training corpora's layouts (WHU_OMVS, WHU-MVS, DTU, BlendedMVS), each file
byte for byte what the JAX writers write for the same scene.

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
from ..io.exr import write_exr_depth
from ..io.pfm import write_pfm

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


def _write_obliquewhu_cam_txt(path: str, view: SyntheticView) -> None:
    """WHU_OMVS train cam dialect (cas_total_rscv.py:388-426): two header
    tokens, Twc(XrightYup) 4x4 at tokens [2..17], K at [18..26],
    start/end/interval at [27..29]."""
    twc_mat = np.eye(4)
    twc_mat[:3, :3] = view.rwc
    twc_mat[:3, 3] = view.twc
    cam = view.camera
    toks = ["extrinsic", "Twc_XrightYup"]
    toks += [repr(float(x)) for x in twc_mat.reshape(-1)]
    toks += [repr(float(x)) for x in cam.K.reshape(-1)]
    toks += [repr(float(cam.depth_start)), repr(float(cam.depth_end)), repr(float(cam.depth_interval))]
    with open(path, "w") as f:
        f.write(" ".join(toks) + "\n")


def write_whu_omvs_tree(root: str, scene: SyntheticScene, scene_name: str = "009_53") -> str:
    """Write a train/val tree in the WHU_OMVS layout (cas_total_rscv.py:209-267).

    Every view serves as a reference with the remaining views as sources.
    """
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "index.txt"), "w") as f:
        f.write(scene_name + "\n")
    sdir = os.path.join(root, scene_name)
    for sub in ("images", "cams", "depths", "masks", "info"):
        os.makedirs(os.path.join(sdir, sub), exist_ok=True)

    n = len(scene.views)
    for i, view in enumerate(scene.views):
        Image.fromarray(view.image).save(os.path.join(sdir, "images", view.name + ".png"))
        _write_obliquewhu_cam_txt(os.path.join(sdir, "cams", view.name + ".txt"), view)
        write_exr_depth(os.path.join(sdir, "depths", view.name + ".exr"), view.depth)
        Image.fromarray(view.mask).save(os.path.join(sdir, "masks", view.name + ".png"))

    with open(os.path.join(sdir, "info", "image_path.txt"), "w") as f:
        f.write(f"{n}\n")
        for i, view in enumerate(scene.views):
            f.write(f"{i} {view.name} {os.path.join(sdir, 'images', view.name + '.png')}\n")
    with open(os.path.join(sdir, "info", "viewpair.txt"), "w") as f:
        f.write(f"{n}\n")
        for i in range(n):
            srcs = [j for j in range(n) if j != i]
            f.write(f"{i}\n")
            f.write(str(len(srcs)) + " " + " ".join(f"{j} {1.0}" for j in srcs) + "\n")
    return sdir


def _write_dtu_cam_txt(path: str, view: SyntheticView, interval_count: int = 192) -> None:
    """DTU dialect (cas_total_rscv.py:323-355): label, Tcw 4x4 at [1..16],
    label, K at [18..26], start + interval at [27..28]."""
    cam = view.camera
    toks = ["extrinsic"]
    toks += [repr(float(x)) for x in cam.tcw.reshape(-1)]
    toks += ["intrinsic"]
    toks += [repr(float(x)) for x in cam.K.reshape(-1)]
    interval = (cam.depth_end - cam.depth_start) / interval_count
    toks += [repr(float(cam.depth_start)), repr(float(interval))]
    with open(path, "w") as f:
        f.write(" ".join(toks) + "\n")


def _write_blendedmvs_cam_txt(path: str, view: SyntheticView) -> None:
    """BlendedMVS dialect (cas_total_rscv.py:357-386): start/interval/count/end
    at tokens [27..30]."""
    cam = view.camera
    toks = ["extrinsic"]
    toks += [repr(float(x)) for x in cam.tcw.reshape(-1)]
    toks += ["intrinsic"]
    toks += [repr(float(x)) for x in cam.K.reshape(-1)]
    toks += [
        repr(float(cam.depth_start)), repr(float(cam.depth_interval)),
        repr(float(cam.depth_count)), repr(float(cam.depth_end)),
    ]
    with open(path, "w") as f:
        f.write(" ".join(toks) + "\n")


def _pair_file_with_scores(path: str, n: int) -> None:
    with open(path, "w") as f:
        f.write(f"{n}\n")
        for i in range(n):
            srcs = [j for j in range(n) if j != i]
            f.write(f"{i}\n")
            f.write(str(len(srcs)) + " " + " ".join(f"{j} {1.0}" for j in srcs) + "\n")


def write_dtu_tree(root: str, scene: SyntheticScene, scan: str = "scan1") -> str:
    """DTU layout (cas_total_rscv.py:110-162): Rectified/{scan}_train pngs with
    7 light conditions, shared Cameras/, Depths/{scan}/*.pfm."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "index.txt"), "w") as f:
        f.write(scan + "\n")
    img_dir = os.path.join(root, "Rectified", f"{scan}_train")
    cam_dir = os.path.join(root, "Cameras")
    dep_dir = os.path.join(root, "Depths", scan)
    for d in (img_dir, cam_dir, dep_dir):
        os.makedirs(d, exist_ok=True)
    n = len(scene.views)
    _pair_file_with_scores(os.path.join(root, "pair.txt"), n)
    for i, view in enumerate(scene.views):
        for light in range(7):
            Image.fromarray(view.image).save(
                os.path.join(img_dir, f"rect_{i + 1:0>3}_{light}_r5000.png")
            )
        _write_dtu_cam_txt(os.path.join(cam_dir, f"{i:0>8}_cam.txt"), view)
        write_pfm(os.path.join(dep_dir, f"depth_map_{i:0>4}.pfm"), view.depth)
    return root


def write_blendedmvs_tree(root: str, scene: SyntheticScene, sid: str = "5a0000") -> str:
    """BlendedMVS layout (cas_total_rscv.py:164-207): per-scene blended_images/
    jpgs, cams/ with pair.txt, rendered_depth_maps/ pfm."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "index.txt"), "w") as f:
        f.write(sid + "\n")
    sdir = os.path.join(root, sid)
    for sub in ("blended_images", "cams", "rendered_depth_maps"):
        os.makedirs(os.path.join(sdir, sub), exist_ok=True)
    n = len(scene.views)
    _pair_file_with_scores(os.path.join(sdir, "cams", "pair.txt"), n)
    for i, view in enumerate(scene.views):
        Image.fromarray(view.image).save(
            os.path.join(sdir, "blended_images", f"{i:0>8}.jpg"), quality=98
        )
        _write_blendedmvs_cam_txt(os.path.join(sdir, "cams", f"{i:0>8}_cam.txt"), view)
        write_pfm(os.path.join(sdir, "rendered_depth_maps", f"{i:0>8}.pfm"), view.depth)
    return root


def write_whu_mvs_tree(root: str, scene: SyntheticScene, block: str = "009_53") -> str:
    """WHU-MVS layout (cas_total_rscv.py:43-108): Images/{block}/{view}/,
    Cams/, Depths/ (16-bit png depths x64), root pair.txt without scores."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "index.txt"), "w") as f:
        f.write(block + "\n")
    n = len(scene.views)
    with open(os.path.join(root, "pair.txt"), "w") as f:
        f.write(f"{n}\n")
        for i in range(n):
            srcs = [j for j in range(n) if j != i]
            f.write(f"{i}\n")
            f.write(str(len(srcs)) + " " + " ".join(str(j) for j in srcs) + "\n")
    fname = "000000"
    for i, view in enumerate(scene.views):
        img_dir = os.path.join(root, "Images", block, str(i))
        cam_dir = os.path.join(root, "Cams", block, str(i))
        dep_dir = os.path.join(root, "Depths", block, str(i))
        for d in (img_dir, cam_dir, dep_dir):
            os.makedirs(d, exist_ok=True)
        Image.fromarray(view.image).save(os.path.join(img_dir, fname + ".png"))
        # whu_mvs cam dialect (cas_total_rscv.py:273-321): Twc at [1..16],
        # pera block [17..29] = f x0 y0 start end interval + location
        twc_mat = np.eye(4)
        twc_mat[:3, :3] = view.rwc
        twc_mat[:3, 3] = view.twc
        cam = view.camera
        toks = ["extrinsic"]
        toks += [repr(float(x)) for x in twc_mat.reshape(-1)]
        toks += [
            repr(float(cam.K[0, 0])), repr(float(cam.K[0, 2])), repr(float(cam.K[1, 2])),
            repr(float(cam.depth_start)), repr(float(cam.depth_end)),
            repr(float(cam.depth_interval)),
        ]
        toks += ["0"] * 7  # location block
        with open(os.path.join(cam_dir, fname + ".txt"), "w") as f:
            f.write(" ".join(toks) + "\n")
        depth_png = np.clip(view.depth * 64.0, 0, 65535).astype(np.uint16)
        Image.fromarray(depth_png).save(os.path.join(dep_dir, fname + ".png"))
    return root
