"""Sample lists of the four training corpora and predict work lists
(counterpart of adamvs_tpu/data/lists.py). The path conventions are the
reference's, so the same on-disk trees work: cas_total_rscv.py:24-267 for
train and val (``build_sample_list``), predict_oblique.py:12-33 for predict
(``build_predict_list``)."""

from __future__ import annotations

import dataclasses
import os

from ..io.cams_text import (
    read_predict_cameras,
    read_predict_image_paths,
    read_predict_images,
    read_view_pairs,
)


@dataclasses.dataclass
class SampleSpec:
    set_name: str
    view_cnts: int
    image_paths: list[str]  # [view_cnts] ref first
    cam_paths: list[str]  # [view_cnts]
    depth_path: str
    name: str  # output basename (ref image stem)
    vid: str  # output subdirectory id


@dataclasses.dataclass
class PredictSpec:
    """One predict work item: ref view id + source view ids."""

    view_ids: list[int]  # [view_num], ref first


def _read_index(data_folder: str) -> list[str]:
    with open(os.path.join(data_folder, "index.txt")) as f:
        return f.read().split()


def _name_vid(ref_image_path: str, set_name: str) -> tuple[str, str]:
    # cas_total_rscv.py:551-556: whu_omvs uses the parent dir, others the grandparent
    name = os.path.splitext(os.path.basename(ref_image_path))[0]
    parts = os.path.dirname(ref_image_path).split("/")
    vid = parts[-1] if set_name == "whu_omvs" else parts[-2]
    return name, vid


def _whu_omvs_list(data_folder: str, view_num: int) -> list[SampleSpec]:
    samples = []
    for scene in _read_index(data_folder):
        sdir = os.path.join(data_folder, scene)
        paths, names = read_predict_image_paths(os.path.join(sdir, "info", "image_path.txt"))
        del paths  # train layout resolves images by name, not the path column
        metas = []
        with open(os.path.join(sdir, "info", "viewpair.txt")) as f:
            count = int(f.readline())
            for _ in range(count):
                ref = int(f.readline().rstrip())
                srcs = [int(x) for x in f.readline().rstrip().split()[1::2]]
                metas.append((ref, srcs))
        for ref, srcs in metas:
            view_cnts = min(view_num, len(srcs) + 1)
            ids = [ref] + srcs[: view_cnts - 1]
            image_paths = [os.path.join(sdir, "images", names[i] + ".png") for i in ids]
            cam_paths = [os.path.join(sdir, "cams", names[i] + ".txt") for i in ids]
            depth_path = os.path.join(sdir, "depths", names[ref] + ".exr")
            name, vid = _name_vid(image_paths[0].replace("\\", "/"), "whu_omvs")
            samples.append(
                SampleSpec("whu_omvs", view_cnts, image_paths, cam_paths, depth_path, name, vid)
            )
    return samples


def _whu_mvs_list(data_folder: str, view_num: int) -> list[SampleSpec]:
    samples = []
    scenes = _read_index(data_folder)
    refs, srcs_list = [], []
    with open(os.path.join(data_folder, "pair.txt")) as f:
        count = int(f.readline().rstrip())
        for _ in range(count):
            refs.append(int(f.readline().rstrip()))
            srcs_list.append([int(x) for x in f.readline().rstrip().split()][1:])
    for scene in scenes:
        for ref, srcs in zip(refs, srcs_list):
            ref_dir = os.path.join(data_folder, "Images", scene, str(ref))
            files = sorted(os.listdir(ref_dir))
            view_cnts = min(view_num, len(srcs) + 1)
            for fname in files:
                stem = os.path.splitext(fname)[0]
                ids = [ref] + srcs[: view_cnts - 1]
                image_paths = [
                    os.path.join(data_folder, "Images", scene, str(i), fname) for i in ids
                ]
                cam_paths = [
                    os.path.join(data_folder, "Cams", scene, str(i), stem + ".txt") for i in ids
                ]
                depth_path = os.path.join(data_folder, "Depths", scene, str(ref), stem + ".png")
                name, vid = _name_vid(image_paths[0].replace("\\", "/"), "whu_mvs")
                samples.append(
                    SampleSpec("whu_mvs", view_cnts, image_paths, cam_paths, depth_path, name, vid)
                )
    return samples


def _dtu_list(data_folder: str, view_num: int) -> list[SampleSpec]:
    samples = []
    scenes = _read_index(data_folder)
    metas = []
    with open(os.path.join(data_folder, "pair.txt")) as f:
        count = int(f.readline().rstrip())
        for _ in range(count):
            ref = int(f.readline().rstrip())
            srcs = [int(x) for x in f.readline().rstrip().split()[1::2]]
            for light in range(7):
                metas.append((light, ref, srcs))
    for scene in scenes:
        img_dir = os.path.join(data_folder, "Rectified", f"{scene}_train")
        cam_dir = os.path.join(data_folder, "Cameras")
        for light, ref, srcs in metas:
            view_cnts = min(view_num, len(srcs) + 1)
            ids = [ref] + srcs[: view_cnts - 1]
            image_paths = [
                os.path.join(img_dir, f"rect_{i + 1:0>3}_{light}_r5000.png") for i in ids
            ]
            cam_paths = [os.path.join(cam_dir, f"{i:0>8}_cam.txt") for i in ids]
            depth_path = os.path.join(data_folder, "Depths", scene, f"depth_map_{ref:0>4}.pfm")
            name, vid = _name_vid(image_paths[0].replace("\\", "/"), "dtu")
            samples.append(
                SampleSpec("dtu", view_cnts, image_paths, cam_paths, depth_path, name, vid)
            )
    return samples


def _blendedmvs_list(data_folder: str, view_num: int) -> list[SampleSpec]:
    samples = []
    for scene in _read_index(data_folder):
        sdir = os.path.join(data_folder, scene)
        metas = []
        with open(os.path.join(sdir, "cams", "pair.txt")) as f:
            count = int(f.readline().rstrip())
            for _ in range(count):
                ref = int(f.readline().rstrip())
                srcs = [int(x) for x in f.readline().rstrip().split()[1::2]]
                metas.append((ref, srcs))
        for ref, srcs in metas:
            view_cnts = min(view_num, len(srcs) + 1)
            ids = [ref] + srcs[: view_cnts - 1]
            image_paths = [os.path.join(sdir, "blended_images", f"{i:0>8}.jpg") for i in ids]
            cam_paths = [os.path.join(sdir, "cams", f"{i:0>8}_cam.txt") for i in ids]
            depth_path = os.path.join(sdir, "rendered_depth_maps", f"{ref:0>8}.pfm")
            name, vid = _name_vid(image_paths[0].replace("\\", "/"), "BlendedMVS")
            samples.append(
                SampleSpec("BlendedMVS", view_cnts, image_paths, cam_paths, depth_path, name, vid)
            )
    return samples


def build_sample_list(data_folder: str, set_name: str, view_num: int) -> list[SampleSpec]:
    if set_name == "whu_omvs":
        return _whu_omvs_list(data_folder, view_num)
    if set_name == "whu_mvs":
        return _whu_mvs_list(data_folder, view_num)
    if set_name == "dtu":
        return _dtu_list(data_folder, view_num)
    if set_name == "BlendedMVS":
        return _blendedmvs_list(data_folder, view_num)
    raise ValueError(f"unknown set_name {set_name!r}")


@dataclasses.dataclass
class PredictSource:
    """Parsed predict-source directory (predict_oblique.py:14-32)."""

    cameras: dict
    photos: dict
    image_paths: dict[int, str]
    image_names: dict[int, str]
    work_items: list[PredictSpec]


def build_predict_list(data_folder: str, view_num: int) -> PredictSource:
    cameras = read_predict_cameras(os.path.join(data_folder, "camera_info.txt"))
    photos = read_predict_images(os.path.join(data_folder, "image_info.txt"))
    paths, names = read_predict_image_paths(os.path.join(data_folder, "image_path.txt"))
    pairs = read_view_pairs(os.path.join(data_folder, "viewpair.txt"), view_num)
    items = [PredictSpec(view_ids=p[: view_num]) for p in pairs]
    return PredictSource(cameras, photos, paths, names, items)
