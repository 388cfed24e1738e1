"""The port's host library (``adamvs_tpu_torch/csrc/host/``, built with g++
at its first use, bound by ``adamvs_tpu_torch/io/native.py``) against the
JAX package's native and Python paths: ``tests/test_native.py``'s cases
(PNG flavours, EXR compressions and pixel types, centring, the resize
against OpenCV), the readers' dispatch (``io/images.py``) bit for bit
against JAX's on the same files, a PNG flavour the library does not take
going to PIL, the loaders reading through the library, and a failed build
raising."""

import io as _io

import cv2
import numpy as np
import pytest
from PIL import Image

from adamvs_tpu.data import lists as jlists
from adamvs_tpu.data import pipeline as jpipeline
from adamvs_tpu.data import synthetic as jsynthetic
from adamvs_tpu.io import images as jimages
from adamvs_tpu.io import native as jnative
from adamvs_tpu_torch.data import lists, pipeline
from adamvs_tpu_torch.io import exr, images, native
from adamvs_tpu_torch.kernels import build


def _png_bytes(arr, mode=None):
    buf = _io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, format="PNG")
    return buf.getvalue()


def _smooth():
    """Smooth gradients: PIL picks the sub, up, average and Paeth filters."""
    y, x = np.mgrid[0:64, 0:64]
    return np.stack([(x * 2) % 256, (y * 3) % 256, (x + y) % 256], -1).astype(np.uint8)


PNGS = {
    "rgb8": lambda rng: rng.randint(0, 256, (37, 53, 3), dtype=np.uint8),
    "gray8": lambda rng: rng.randint(0, 256, (16, 23), dtype=np.uint8),
    "gray16": lambda rng: rng.randint(0, 65535, (20, 31), dtype=np.uint16),
    "rgba8": lambda rng: rng.randint(0, 256, (12, 18, 4), dtype=np.uint8),
    "smooth": lambda rng: _smooth(),
}


@pytest.mark.parametrize("kind", sorted(PNGS))
def test_decode_png(kind):
    img = PNGS[kind](np.random.RandomState(0))
    data = _png_bytes(img)
    out = native.decode_png(data)
    assert out.dtype == img.dtype
    np.testing.assert_array_equal(out, img)
    np.testing.assert_array_equal(out, jnative.decode_png(data))


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_exr_depth(tmp_path, compression, dtype):
    depth = (np.random.RandomState(0).rand(45, 61) * 1000).astype(dtype)
    p = str(tmp_path / "d.exr")
    exr.write_exr(p, {"Z": depth}, compression=compression)
    out = native.read_exr_depth(p)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, depth.astype(np.float32))
    np.testing.assert_array_equal(out, exr.read_exr_depth(p))
    np.testing.assert_array_equal(images.read_exr_depth(p), jimages.read_exr_depth(p))


def test_center_image():
    img = np.random.RandomState(0).randint(0, 256, (64, 48, 3), dtype=np.uint8)
    out = native.center_image(img)
    assert out.dtype == np.float32 and out.shape == img.shape
    np.testing.assert_allclose(out, pipeline.center_image(img), atol=1e-4)
    np.testing.assert_array_equal(out, jnative.center_image(img))


# (size, least share of values equal to cv2's): cv2 rounds its weights to 11-bit fixed
# point, so at an upscale's fractional weights about one value in eight differs by one
@pytest.mark.parametrize("size,exact", [((32, 48), 0.97), ((97, 131), 0.85)])
def test_resize_against_cv2(size, exact):
    img = np.random.RandomState(0).randint(0, 256, (64, 96, 3), dtype=np.uint8)
    ref = cv2.resize(img, size[::-1], interpolation=cv2.INTER_LINEAR)
    out = native.resize_bilinear(img, *size)
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() > exact
    np.testing.assert_array_equal(out, jnative.resize_bilinear(img, *size))


READ_IMAGE = {
    "rgb8": (lambda rng: rng.randint(0, 256, (33, 41, 3), dtype=np.uint8), None),
    "gray8": (lambda rng: rng.randint(0, 256, (33, 41), dtype=np.uint8), None),
    "gray_alpha8": (lambda rng: rng.randint(0, 256, (33, 41, 2), dtype=np.uint8), "LA"),
    "rgba8": (lambda rng: rng.randint(0, 256, (33, 41, 4), dtype=np.uint8), None),
    "gray16": (lambda rng: rng.randint(0, 65535, (33, 41), dtype=np.uint16), None),
    "bit1": (lambda rng: rng.rand(33, 41) > 0.5, None),
}


@pytest.mark.parametrize("kind", sorted(READ_IMAGE) + ["palette", "jpeg"])
def test_read_image_matches_jax(tmp_path, kind):
    """The dispatch of ``read_image``: 8-bit PNGs decode natively and are
    made RGB as JAX makes them; 16-bit and 1-bit PNGs and other formats go
    to PIL. Bit for bit against JAX's reader."""
    rng = np.random.RandomState(1)
    if kind == "palette":
        p = str(tmp_path / "p.png")
        Image.fromarray(rng.randint(0, 256, (33, 41, 3), dtype=np.uint8)).quantize(16).save(p)
    elif kind == "jpeg":
        p = str(tmp_path / "j.jpg")
        Image.fromarray(rng.randint(0, 256, (33, 41, 3), dtype=np.uint8)).save(p)
    else:
        make, mode = READ_IMAGE[kind]
        p = str(tmp_path / f"{kind}.png")
        Image.fromarray(make(rng), mode=mode).save(p)
    got = images.read_image(p)
    assert got.dtype == np.uint8 and got.shape == (33, 41, 3) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, jimages.read_image(p))
    with Image.open(p) as im:
        np.testing.assert_array_equal(got, np.array(im.convert("RGB")))


def test_one_bit_png_goes_to_pil(tmp_path, monkeypatch):
    """The library returns -5 for a 1-bit PNG; the reader asks PIL."""
    p = str(tmp_path / "bits.png")
    bits = np.random.RandomState(2).rand(19, 27) > 0.5
    Image.fromarray(bits).save(p)
    with pytest.raises(ValueError, match="-5"):
        native.read_png(p)
    calls = []
    real = native.read_png
    monkeypatch.setattr(native, "read_png", lambda path: calls.append(path) or real(path))
    got = images.read_image(p)
    assert calls == [p]
    np.testing.assert_array_equal(got, np.repeat(bits[..., None].astype(np.uint8) * 255, 3, -1))


def test_loaders_read_through_the_library(tmp_path, monkeypatch):
    """The train loader (PNG images, EXR depths) and the predict loader (PNG
    images) decode through the host library and give JAX's samples."""
    calls = {"png": 0, "exr": 0}
    read_png, read_exr = native.read_png, native.read_exr_depth

    def counted(kind, fn):
        def call(path):
            calls[kind] += 1
            return fn(path)
        return call

    monkeypatch.setattr(native, "read_png", counted("png", read_png))
    monkeypatch.setattr(native, "read_exr_depth", counted("exr", read_exr))
    scene = jsynthetic.make_scene(num_views=4, height=48, width=64, seed=3)
    root = str(tmp_path / "whu_omvs")
    jsynthetic.write_whu_omvs_tree(root, scene)
    spec = lists.build_sample_list(root, "whu_omvs", 3)[1]
    got = pipeline.load_train_sample(spec, mode="test")
    jspec = jlists.build_sample_list(root, "whu_omvs", 3)[1]
    want = jpipeline.load_train_sample(jspec, mode="test")
    np.testing.assert_array_equal(got.imgs, want.imgs)
    np.testing.assert_array_equal(got.depth["stage3"], want.depth["stage3"])
    assert calls == {"png": 3, "exr": 1}
    src_root = jsynthetic.write_predict_source_tree(str(tmp_path / "source"), scene)
    src = lists.build_predict_list(src_root, 3)
    jsrc = jlists.build_predict_list(src_root, 3)
    kw = dict(num_depth=32, resize_scale=1.0, max_h=5504, max_w=3712)
    got = pipeline.load_predict_sample(src, src.work_items[0], **kw)
    want = jpipeline.load_predict_sample(jsrc, jsrc.work_items[0], **kw)
    np.testing.assert_array_equal(got.imgs, want.imgs)
    assert calls["png"] == 6


def test_failed_build_raises(tmp_path, monkeypatch):
    """Without a compiler the first read raises; nothing falls back to PIL."""
    p = str(tmp_path / "t.png")
    Image.fromarray(np.zeros((4, 5, 3), np.uint8)).save(p)
    monkeypatch.setattr(build, "CXX", "no-such-compiler-g++")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    native._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no-such-compiler-g\\+\\+ not found"):
            images.read_image(p)
        with pytest.raises(RuntimeError, match="not found"):
            images.read_exr_depth(p)
    finally:
        native._lib.cache_clear()


def test_build_is_keyed_by_sources_and_target(tmp_path, monkeypatch):
    """A build lands under a name that carries the hash of the sources, the
    flags and the compiler's target, through a temporary file."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    path, built = build.build_host()
    assert built and path.startswith(str(tmp_path)) and "libmvsnative-" in path
    assert sorted(p.name for p in tmp_path.iterdir()) == [path.rsplit("/", 1)[1]]
    assert build.build_host() == (path, False)
    monkeypatch.setattr(build, "HOST_FLAGS", build.HOST_FLAGS + ["-DMVS_PROBE=1"])
    assert build._host_lib_path(build._cxx()) != path
