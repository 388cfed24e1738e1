"""Predict-source metadata text codecs (counterpart of the predict part of
adamvs_tpu/io/cams_text.py).

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
