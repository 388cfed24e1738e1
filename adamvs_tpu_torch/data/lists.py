"""Predict work lists (counterpart of the predict part of
adamvs_tpu/data/lists.py; the path conventions of predict_oblique.py:12-33)."""

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
class PredictSpec:
    """One predict work item: ref view id + source view ids."""

    view_ids: list[int]  # [view_num], ref first


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
