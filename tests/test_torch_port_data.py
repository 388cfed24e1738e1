"""The port's training data pipeline against the JAX package's, on trees the
JAX writers write: the EXR codec (byte-equal files, three pixel types and
three compressions), the four camera dialects, ``build_sample_list`` on the
four corpora, ``load_train_sample`` in test mode and in train mode from the
same ``RandomState``, ``batch_train_samples``, ``batch_iterator``'s order and
contents for a seed and an epoch, and the port's four tree writers byte for
byte against JAX's. Everything here is exact: the two sides run the same
numpy, PIL and OpenCV code."""

import dataclasses
import os

import numpy as np
import pytest

from adamvs_tpu.data import lists as jlists
from adamvs_tpu.data import loader as jloader
from adamvs_tpu.data import pipeline as jpipeline
from adamvs_tpu.data import synthetic as jsynthetic
from adamvs_tpu.io import cams_text as jcams
from adamvs_tpu.io import exr as jexr
from adamvs_tpu.io import images as jimages
from adamvs_tpu_torch.data import lists, loader, pipeline, synthetic
from adamvs_tpu_torch.io import cams_text, exr, images

CORPORA = {
    "whu_omvs": ("write_whu_omvs_tree", "read_obliquewhu_cam"),
    "whu_mvs": ("write_whu_mvs_tree", "read_whu_cam"),
    "dtu": ("write_dtu_tree", "read_dtu_cam"),
    "BlendedMVS": ("write_blendedmvs_tree", "read_blendedmvs_cam"),
}


@pytest.fixture(scope="module")
def scene():
    return jsynthetic.make_scene(num_views=4, height=48, width=64, seed=3)


@pytest.fixture(scope="module")
def trees(tmp_path_factory, scene):
    """One JAX-written tree per corpus."""
    root = tmp_path_factory.mktemp("corpora")
    out = {}
    for set_name, (writer, _) in CORPORA.items():
        path = str(root / set_name)
        getattr(jsynthetic, writer)(path, scene)
        out[set_name] = path
    return out


def _same(a, b, where=""):
    """Exact equality of nested dicts, lists, dataclasses and arrays."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        _same(dataclasses.asdict(a), dataclasses.asdict(b), where)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and a.shape == np.asarray(b).shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
@pytest.mark.parametrize("dtype", ["float32", "float16", "uint32"])
def test_exr_files_are_byte_equal_and_round_trip(tmp_path, dtype, compression):
    """17 rows (a ZIP chunk of 16 and a short one), two channels; some rows
    compress, some do not (the codec then stores them raw)."""
    rng = np.random.RandomState(0)
    if dtype == "uint32":
        z = rng.randint(0, 2**31, (17, 23)).astype(np.uint32)
    else:
        z = (rng.randn(17, 23) * 100).astype(dtype)
    z[:8] = z[0, 0]  # compressible rows
    chans = {"Z": z, "A": z[::-1].copy()}
    got, want = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    exr.write_exr(got, chans, compression=compression)
    jexr.write_exr(want, chans, compression=compression)
    assert open(got, "rb").read() == open(want, "rb").read()
    for path in (got, want):
        back = exr.read_exr(path)
        _same(back, jexr.read_exr(path))
        _same(back, chans)


def test_exr_depth_reader(tmp_path, scene):
    path = str(tmp_path / "d.exr")
    jexr.write_exr_depth(path, scene.views[0].depth)
    got = exr.read_exr_depth(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jexr.read_exr_depth(path))
    np.testing.assert_array_equal(got, scene.views[0].depth)


@pytest.mark.parametrize("set_name", sorted(CORPORA))
def test_camera_dialects_and_gt_depths_match_jax(trees, set_name):
    _, reader = CORPORA[set_name]
    specs = jlists.build_sample_list(trees[set_name], set_name, 3)
    for spec in specs[:2]:
        for path in spec.cam_paths:
            for scale in (1.0, 0.5):
                _same(getattr(cams_text, reader)(path, scale), getattr(jcams, reader)(path, scale),
                      path)
        _same(images.read_gt_depth(spec.depth_path, set_name),
              jimages.read_gt_depth(spec.depth_path, set_name), spec.depth_path)


@pytest.mark.parametrize("set_name", sorted(CORPORA))
def test_build_sample_list_matches_jax(trees, set_name):
    for view_num in (3, 5):
        got = lists.build_sample_list(trees[set_name], set_name, view_num)
        want = jlists.build_sample_list(trees[set_name], set_name, view_num)
        assert len(got) == len(want) > 0
        _same(got, want, set_name)
    with pytest.raises(ValueError, match="unknown set_name"):
        lists.build_sample_list(trees[set_name], "kitti", 3)


@pytest.mark.parametrize("mode", ["test", "train"])
@pytest.mark.parametrize("set_name", sorted(CORPORA))
def test_load_train_sample_matches_jax(trees, set_name, mode):
    """Test mode, and train mode with its colour augmentation drawn from two
    RandomStates of one seed."""
    spec = lists.build_sample_list(trees[set_name], set_name, 3)[1]
    jspec = jlists.build_sample_list(trees[set_name], set_name, 3)[1]
    got = pipeline.load_train_sample(spec, mode=mode, interval_scale=0.8,
                                     rng=np.random.RandomState(5))
    want = jpipeline.load_train_sample(jspec, mode=mode, interval_scale=0.8,
                                       rng=np.random.RandomState(5))
    _same(got, want, set_name)
    assert got.depth["stage1"].shape == (12, 16) and got.depth["stage3"].shape == (48, 64)
    if mode == "train":
        plain = pipeline.load_train_sample(spec, mode="test")
        assert not np.array_equal(got.imgs, plain.imgs)


def test_augmentations_and_pyramid_match_jax(scene):
    img = scene.views[1].image
    _same(pipeline.color_augment(img, np.random.RandomState(2)),
          jpipeline.color_augment(img, np.random.RandomState(2)))
    _same(pipeline.gaussian_augment(img, np.random.RandomState(2)),
          jpipeline.gaussian_augment(img, np.random.RandomState(2)))
    _same(pipeline._pyramid(scene.views[1].depth), jpipeline._pyramid(scene.views[1].depth))


def test_batch_train_samples_matches_jax(trees):
    specs = lists.build_sample_list(trees["whu_omvs"], "whu_omvs", 3)
    got = pipeline.batch_train_samples([pipeline.load_train_sample(s, mode="test")
                                        for s in specs[:3]])
    want = jpipeline.batch_train_samples([jpipeline.load_train_sample(s, mode="test")
                                          for s in specs[:3]])
    _same(got, want)
    assert got["imgs"].shape == (3, 3, 48, 64, 3) and got["depth_values"].shape == (3, 3)


@pytest.mark.parametrize("shuffle,drop_last,epoch", [(True, True, 0), (True, True, 2),
                                                     (False, False, 0)])
def test_batch_iterator_matches_jax(trees, shuffle, drop_last, epoch):
    """Same batches in the same order, augmentation included: 4 samples in
    batches of 3 (a short last batch kept or dropped)."""
    specs = lists.build_sample_list(trees["whu_omvs"], "whu_omvs", 3)
    jspecs = jlists.build_sample_list(trees["whu_omvs"], "whu_omvs", 3)
    kw = dict(batch_size=3, mode="train", shuffle=shuffle, seed=7, num_workers=2,
              drop_last=drop_last, epoch=epoch, prefetch=1)
    got = list(loader.batch_iterator(specs, **kw))
    want = list(jloader.batch_iterator(jspecs, **kw))
    assert len(got) == len(want) == (1 if drop_last else 2)
    _same(got, want)


@pytest.mark.parametrize("set_name", sorted(CORPORA))
def test_tree_writers_are_byte_equal_to_jax(tmp_path, trees, set_name):
    """The port's writer on the port's scene against the JAX writer on the
    JAX scene: the same files, byte for byte (absolute paths in the text
    files aside, which name each tree's own root)."""
    port_scene = synthetic.make_scene(num_views=4, height=48, width=64, seed=3)
    root = str(tmp_path / set_name)
    getattr(synthetic, CORPORA[set_name][0])(root, port_scene)
    want_root = trees[set_name]

    def files(r):
        return sorted(os.path.relpath(os.path.join(d, f), r) for d, _, fs in os.walk(r)
                      for f in fs if not d.startswith(os.path.join(r, "depths_")))

    assert files(root) == files(want_root)
    for rel in files(root):
        got = open(os.path.join(root, rel), "rb").read()
        want = open(os.path.join(want_root, rel), "rb").read()
        assert got.replace(root.encode(), b"") == want.replace(want_root.encode(), b""), rel
