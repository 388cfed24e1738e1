"""The port's host side of ``predict`` against the JAX package's: camera
helpers, the PFM codec, the predict-source text readers and the camera
writer, the sample assembly (resize, crop, projections), the distortion
check, the synthetic scene and its predict-source tree, and the preview
colour maps. Everything is numpy (PIL and OpenCV for images) on the CPU; the
files are compared byte for byte where the JAX package writes them."""

import dataclasses
import os

import numpy as np
import pytest

from adamvs_tpu.data import lists as jlists
from adamvs_tpu.data import pipeline as jpipe
from adamvs_tpu.data import synthetic as jsyn
from adamvs_tpu.geom import camera as jcam
from adamvs_tpu.io import cams_text as jtext
from adamvs_tpu.io import pfm as jpfm
from adamvs_tpu.predict import engine as jengine
from adamvs_tpu_torch.data import lists as tlists
from adamvs_tpu_torch.data import pipeline as tpipe
from adamvs_tpu_torch.data import synthetic as tsyn
from adamvs_tpu_torch.geom import camera as tcam
from adamvs_tpu_torch.io import cams_text as ttext
from adamvs_tpu_torch.io import pfm as tpfm
from adamvs_tpu_torch.predict import engine as tengine


def _camera(mod, seed=0):
    rng = np.random.RandomState(seed)
    rwc = jsyn._rot_xyz(*rng.uniform(-0.3, 0.3, 3))
    K = np.array([[2200.5, 0, 1850.25], [0, 2199.75, 2760.5], [0, 0, 1]], np.float32)
    return mod.Camera(K=K, tcw=mod.convert_photogrammetric_extrinsic(rwc, rng.randn(3) * 100),
                      depth_start=301.25, depth_interval=1.0625, depth_count=192.0,
                      depth_end=505.5)


def _assert_same(a, b):
    """Equal records: dataclasses field by field, arrays bit for bit."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


# --- geom/camera.py -----------------------------------------------------------

CAMERA_CALLS = {
    "convert_photogrammetric_extrinsic": lambda m: m.convert_photogrammetric_extrinsic(
        jsyn._rot_xyz(0.1, -0.2, 0.3), np.array([10.0, -20.0, 400.0])),
    "proj_matrix": lambda m: m.proj_matrix(_camera(m)),
    "scale_camera": lambda m: m.scale_camera(_camera(m), 0.5),
    "crop_camera": lambda m: m.crop_camera(_camera(m), 17, 33),
    "crop_to_multiple": lambda m: [m.crop_to_multiple(h, w, 5504, 3712, s)
                                   for h, w, s in ((2752, 1856, 0.5), (2760, 1800, 0.5),
                                                   (48, 64, 0.5), (100, 150, 1.0),
                                                   (6000, 4000, 1.0))],
    "ceil_to_multiple": lambda m: [m.ceil_to_multiple(x, 32) for x in (1, 32, 33, 1855)],
    "depth_sample_count": lambda m: m.depth_sample_count(300.0, 500.0, 1.0416666),
    "stage_proj_matrices": lambda m: m.stage_proj_matrices(
        np.stack([m.proj_matrix(_camera(m, s)) for s in range(3)])),
    "legacy_cam_array": lambda m: m.legacy_cam_array(_camera(m)),
    "camera_from_legacy": lambda m: m.camera_from_legacy(m.legacy_cam_array(_camera(m, 2))),
}


@pytest.mark.parametrize("name", sorted(CAMERA_CALLS))
def test_camera_helpers_equal_jax(name):
    _assert_same(CAMERA_CALLS[name](tcam), CAMERA_CALLS[name](jcam))


# --- io/pfm.py ------------------------------------------------------------------

@pytest.mark.parametrize("shape,scale", [((37, 53), 1.0), ((20, 31, 3), 2.5), ((16, 8, 1), 1.0)])
def test_pfm_files_identical_and_cross_readable(tmp_path, shape, scale):
    img = np.random.RandomState(3).randn(*shape).astype(np.float32)
    tpath, jpath = str(tmp_path / "t.pfm"), str(tmp_path / "j.pfm")
    tpfm.write_pfm(tpath, img, scale)
    jpfm.write_pfm(jpath, img, scale)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    want = img.reshape(shape[:2]) if len(shape) == 3 and shape[2] == 1 else img
    for reader, path in ((jpfm.read_pfm, tpath), (tpfm.read_pfm, jpath)):
        got, s = reader(path)
        np.testing.assert_array_equal(got, want)
        assert s == scale
    with pytest.raises(ValueError):
        tpfm.write_pfm(tpath, img.astype(np.float64))


# --- predict-source trees -------------------------------------------------------

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """JAX-written predict-source trees: the 96x128 scene, and a 100x150 one
    whose size is no multiple of 32."""
    out = {}
    for key, (h, w) in {"96x128": (96, 128), "100x150": (100, 150)}.items():
        scene = jsyn.make_scene(num_views=4, height=h, width=w, seed=1)
        out[key] = jsyn.write_predict_source_tree(str(tmp_path_factory.mktemp(key)), scene)
    return out


READERS = {
    "cameras": lambda m, root: m.read_predict_cameras(os.path.join(root, "camera_info.txt")),
    "images": lambda m, root: m.read_predict_images(os.path.join(root, "image_info.txt")),
    "image_paths": lambda m, root: m.read_predict_image_paths(
        os.path.join(root, "image_path.txt")),
    "view_pairs": lambda m, root: m.read_view_pairs(os.path.join(root, "viewpair.txt"), 5),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_predict_text_readers_equal_jax(trees, name):
    root = trees["96x128"]
    _assert_same(READERS[name](ttext, root), READERS[name](jtext, root))


@pytest.mark.parametrize("view_num", [3, 5])
def test_build_predict_list_equal_jax(trees, view_num):
    root = trees["96x128"]
    _assert_same(tlists.build_predict_list(root, view_num),
                 jlists.build_predict_list(root, view_num))


def test_write_red_cam_byte_identical(tmp_path):
    for seed in range(3):
        arr = jcam.legacy_cam_array(_camera(jcam, seed))
        ttext.write_red_cam(str(tmp_path / "t.txt"), arr, "/data/images/view_000.png")
        jtext.write_red_cam(str(tmp_path / "j.txt"), arr, "/data/images/view_000.png")
        text = open(tmp_path / "t.txt", "rb").read()
        assert text == open(tmp_path / "j.txt", "rb").read()
        assert text.startswith(b"extrinsic: XrightYdown")


@pytest.mark.parametrize("tree", ["96x128", "100x150"])
@pytest.mark.parametrize("resize_scale", [1.0, 0.5])
def test_load_predict_sample_bit_equal(trees, tree, resize_scale):
    root = trees[tree]
    tsrc, jsrc = tlists.build_predict_list(root, 3), jlists.build_predict_list(root, 3)
    kw = dict(num_depth=32, resize_scale=resize_scale, max_h=5504, max_w=3712)
    for tspec, jspec in zip(tsrc.work_items, jsrc.work_items):
        got = tpipe.load_predict_sample(tsrc, tspec, **kw)
        want = jpipe.load_predict_sample(jsrc, jspec, **kw)
        for field in ("imgs", "proj_matrices", "depth_values", "out_image", "out_cam",
                      "ref_image_path", "name", "vid", "view_ids"):
            _assert_same(getattr(got, field), getattr(want, field))
        assert got.imgs.shape[1:3] == want.imgs.shape[1:3]


def test_center_image_equal_jax():
    img = np.random.RandomState(0).randint(0, 256, (33, 47, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tpipe.center_image(img), jpipe.center_image(img))


def test_check_distortion_warns_and_refuses():
    def pcam(k1, p1=0.0):
        return ttext.PredictCamera(camera_id=0, width=3712, height=5504, pixelsize=1.0,
                                   fx=4400.0, fy=4400.0, x0=1856.0, y0=2752.0,
                                   distortion=np.array([k1, 0.0, p1, 0.0, 0.0]))

    for mod, cam_id in ((tpipe, 9001), (jpipe, 9002)):
        mod._check_distortion(pcam(0.0), cam_id)  # no distortion: silent
        mod._check_distortion(pcam(1e-11), cam_id)  # ~0.37 px: below the warning
        with pytest.warns(UserWarning, match="ignored by the pinhole"):
            mod._check_distortion(pcam(1e-10), cam_id)  # ~3.7 px at the corner
        with pytest.raises(ValueError, match="undistort"):
            mod._check_distortion(pcam(1e-9), cam_id + 10)  # ~37 px
        with pytest.raises(ValueError, match="undistort"):
            mod._check_distortion(pcam(0.0, p1=1e-6), cam_id + 20)


# --- data/synthetic.py ------------------------------------------------------------

def test_synthetic_scene_equal_jax():
    kw = dict(num_views=3, height=70, width=90, seed=4, focal=150.0)
    got, want = tsyn.make_scene(**kw, workers=2), jsyn.make_scene(**kw)
    for g, w in zip(got.views, want.views):
        for field in ("name", "rwc", "twc", "image", "depth", "mask"):
            _assert_same(getattr(g, field), getattr(w, field))
        _assert_same(dataclasses.asdict(g.camera), dataclasses.asdict(w.camera))
    assert (got.plane, got.depth_start, got.depth_end, got.depth_interval) == \
        (want.plane, want.depth_start, want.depth_end, want.depth_interval)


def test_render_view_in_row_bands_equals_jax(monkeypatch):
    K = np.array([[300.0, 0, 61.5], [0, 300.0, 40.0], [0, 0, 1]], np.float32)
    rwc, twc = jsyn._rot_xyz(0.1, -0.05, 0.02), np.array([10.0, 5.0, 400.0])
    want = jsyn.render_view(K, rwc, twc, 83, 123, (0.1, -0.08, 30.0))
    for band_rows, workers in ((7, 1), (16, 3), (200, 2)):
        monkeypatch.setattr(tsyn, "_BAND_ROWS", band_rows)
        got = tsyn.render_view(K, rwc, twc, 83, 123, (0.1, -0.08, 30.0), workers)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_write_predict_source_tree_equal_jax(tmp_path):
    from PIL import Image

    kw = dict(num_views=3, height=64, width=80, seed=2)
    troot = tsyn.write_predict_source_tree(str(tmp_path / "t"), tsyn.make_scene(**kw), workers=2)
    jroot = jsyn.write_predict_source_tree(str(tmp_path / "j"), jsyn.make_scene(**kw))
    for name in ("camera_info.txt", "image_info.txt", "viewpair.txt", "image_path.txt"):
        text = open(os.path.join(troot, name)).read()
        assert text.replace(troot, "ROOT") == open(os.path.join(jroot, name)).read().replace(
            jroot, "ROOT"), name
    names = sorted(os.listdir(os.path.join(jroot, "images")))
    assert names == sorted(os.listdir(os.path.join(troot, "images"))) and len(names) == 3
    for name in names:
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(troot, "images", name))),
            np.asarray(Image.open(os.path.join(jroot, "images", name))))


# --- preview colours --------------------------------------------------------------

def test_colour_maps_equal_jax():
    rng = np.random.RandomState(5)
    depth = rng.uniform(300, 500, (41, 57)).astype(np.float32)
    prob = rng.uniform(-0.1, 1.1, (41, 57)).astype(np.float32)
    depth[0, :3] = (np.nan, np.inf, -np.inf)
    prob[1, :2] = (np.nan, 1.0)
    for d in (depth, np.full((4, 5), np.nan, np.float32), np.linspace(0, 1, 20, dtype=np.float32)):
        np.testing.assert_array_equal(tengine.colorize_depth(d), jengine.colorize_depth(d))
    np.testing.assert_array_equal(tengine.colorize_prob(prob), jengine.colorize_prob(prob))
    grid = np.linspace(0, 1, 4097)
    np.testing.assert_array_equal(tengine.colorize_prob(grid), jengine.colorize_prob(grid))
