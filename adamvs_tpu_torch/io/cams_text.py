"""Camera and metadata text codecs (counterpart of
adamvs_tpu/io/cams_text.py).

The four training corpora's camera dialects (whitespace tokens, as the
reference parsers read them):

- WHU-MVS (cas_total_rscv.py:273-321): Twc 4x4 (XrightYup, [Rwc|twc]) at
  tokens [1..16], then f, x0, y0, depth_start, depth_end, depth_interval and
  a location block at [17..29];
- DTU (cas_total_rscv.py:323-355): Tcw 4x4 at [1..16], K at [18..26], start
  [27], interval [28], end = start + 192 intervals;
- BlendedMVS (cas_total_rscv.py:357-386): Tcw at [1..16], K at [18..26],
  start [27], interval [28], count [29], end [30];
- WHU_OMVS (cas_total_rscv.py:388-426): Twc (XrightYup) at [2..17], K at
  [18..26], start [27], end [28], interval [29].

A predict-source directory (data_io.py:47-133) holds ``camera_info.txt``
(CAMERA_ID W H PIXELSIZE fx fy cx cy k1..p2), ``image_info.txt`` (IMAGE_ID
CAMERA_ID Rwc[9] twc[3] MIN MAX NAME), ``image_path.txt`` (count, then
[index name path] triples) and ``viewpair.txt`` (count, then per view: a ref
id line and a line "n id score id score ..."). ``write_red_cam``
(data_io.py:136-158) writes the output camera text file.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..geom.camera import Camera, convert_photogrammetric_extrinsic, depth_sample_count


def _tokens(path: str) -> list[str]:
    with open(path) as f:
        return f.read().split()


def _mat4(words: list[str], start: int) -> np.ndarray:
    return np.array([float(w) for w in words[start : start + 16]], dtype=np.float64).reshape(4, 4)


def _mat3(words: list[str], start: int) -> np.ndarray:
    return np.array([float(w) for w in words[start : start + 9]], dtype=np.float32).reshape(3, 3)


def read_whu_cam(path: str, interval_scale: float = 1.0) -> Camera:
    """WHU-MVS dialect: photogrammetric Twc (XrightYup) + f/x0/y0 block."""
    words = _tokens(path)
    twc = _mat4(words, 1)
    tcw = convert_photogrammetric_extrinsic(twc[:3, :3], twc[:3, 3])
    pera = [float(w) for w in words[17:30]]
    f, x0, y0 = pera[0], pera[1], pera[2]
    K = np.array([[f, 0, x0], [0, f, y0], [0, 0, 1]], dtype=np.float32)
    start = np.float32(pera[3])
    end = np.float32(pera[4])
    interval = np.float32(pera[5] * interval_scale)
    return Camera(
        K=K, tcw=tcw, depth_start=float(start), depth_interval=float(interval),
        depth_count=float(depth_sample_count(start, end, interval)), depth_end=float(end),
    )


def read_dtu_cam(path: str, interval_scale: float = 1.0) -> Camera:
    words = _tokens(path)
    tcw = _mat4(words, 1).astype(np.float32)
    K = _mat3(words, 18)
    start = np.float32(float(words[27]))
    interval = np.float32(float(words[28]) * interval_scale)
    end = np.float32(start + interval * 192)
    return Camera(
        K=K, tcw=tcw, depth_start=float(start), depth_interval=float(interval),
        depth_count=float(depth_sample_count(start, end, interval)), depth_end=float(end),
    )


def read_blendedmvs_cam(path: str, interval_scale: float = 1.0) -> Camera:
    words = _tokens(path)
    tcw = _mat4(words, 1).astype(np.float32)
    K = _mat3(words, 18)
    start = np.float32(float(words[27]))
    interval = np.float32(float(words[28]) * interval_scale)
    count = np.float32(float(words[29]) / interval_scale)
    end = np.float32(float(words[30]))
    return Camera(
        K=K, tcw=tcw, depth_start=float(start), depth_interval=float(interval),
        depth_count=float(count), depth_end=float(end),
    )


def read_obliquewhu_cam(path: str, interval_scale: float = 1.0) -> Camera:
    words = _tokens(path)
    twc = _mat4(words, 2)
    tcw = convert_photogrammetric_extrinsic(twc[:3, :3], twc[:3, 3])
    K = _mat3(words, 18)
    start = np.float32(float(words[27]))
    end = np.float32(float(words[28]))
    interval = np.float32(float(words[29]) * interval_scale)
    return Camera(
        K=K, tcw=tcw, depth_start=float(start), depth_interval=float(interval),
        depth_count=float(depth_sample_count(start, end, interval)), depth_end=float(end),
    )


@dataclasses.dataclass
class PredictCamera:
    camera_id: int
    width: int
    height: int
    pixelsize: float
    fx: float
    fy: float
    x0: float
    y0: float
    distortion: np.ndarray


@dataclasses.dataclass
class PredictPhoto:
    image_id: int
    camera_id: int
    rwc: np.ndarray  # [3,3], XrightYup
    twc: np.ndarray  # [3]
    depth_min: float
    depth_max: float
    name: str


def _data_lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line.split()


def read_predict_cameras(path: str) -> dict[int, PredictCamera]:
    cams = {}
    for e in _data_lines(path):
        cam = PredictCamera(
            camera_id=int(e[0]), width=int(e[1]), height=int(e[2]), pixelsize=float(e[3]),
            fx=float(e[4]), fy=float(e[5]), x0=float(e[6]), y0=float(e[7]),
            distortion=np.array([float(x) for x in e[8:]], dtype=np.float64),
        )
        cams[cam.camera_id] = cam
    return cams


def read_predict_images(path: str) -> dict[int, PredictPhoto]:
    photos = {}
    for e in _data_lines(path):
        ph = PredictPhoto(
            image_id=int(e[0]), camera_id=int(e[1]),
            rwc=np.array([float(x) for x in e[2:11]], dtype=np.float64).reshape(3, 3),
            twc=np.array([float(x) for x in e[11:14]], dtype=np.float64),
            depth_min=float(e[14]), depth_max=float(e[15]), name=e[16],
        )
        photos[ph.image_id] = ph
    return photos


def read_predict_image_paths(path: str) -> tuple[dict[int, str], dict[int, str]]:
    """``image_path.txt``: count, then [index, name, path] triples
    (data_io.py:99-113). Returns (paths, names) keyed by index."""
    with open(path) as f:
        toks = f.read().split()
    total = int(toks[0])
    paths, names = {}, {}
    for i in range(total):
        idx = int(toks[i * 3 + 1])
        names[idx] = toks[i * 3 + 2]
        paths[idx] = toks[i * 3 + 3]
    return paths, names


def read_view_pairs(path: str, view_num: int) -> list[list[int]]:
    """``viewpair.txt`` / ``pair.txt``: per entry, a ref id line then a line
    ``n src0 score0 src1 score1 ...``; sources padded to view_num-1 by
    repeating the first (data_io.py:116-133)."""
    metas = []
    with open(path) as f:
        count = int(f.readline())
        for _ in range(count):
            ref = int(f.readline().rstrip())
            srcs = [int(x) for x in f.readline().rstrip().split()[1::2]]
            if not srcs:
                continue
            if len(srcs) < view_num:
                srcs = srcs + [srcs[0]] * (view_num - len(srcs))
            metas.append([ref] + srcs)
    return metas


def write_red_cam(path: str, cam_arr: np.ndarray, ref_path: str) -> None:
    """Write the output cam txt in the reference layout (data_io.py:136-158).

    ``cam_arr`` is the legacy [2,4,4] packing.
    """
    with open(path, "w") as f:
        f.write("extrinsic: XrightYdown, [Rcw|tcw]\n")
        for i in range(4):
            f.write(" ".join(str(cam_arr[0][i][j]) for j in range(4)) + " \n")
        f.write("\n")
        f.write("intrinsic\n")
        for i in range(3):
            f.write(" ".join(str(cam_arr[1][i][j]) for j in range(3)) + " \n")
        f.write(
            "\n" + str(cam_arr[1][3][0]) + " " + str(cam_arr[1][3][1]) + " "
            + str(cam_arr[1][3][2]) + " " + str(cam_arr[1][3][3]) + "\n"
        )
        f.write("\n")
        f.write(str(ref_path) + "\n")
