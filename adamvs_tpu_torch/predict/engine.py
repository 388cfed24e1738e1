"""Full-resolution prediction engine (counterpart of adamvs_tpu/predict/engine.py).

``PredictEngine.run`` reads a predict-source directory, runs the cascade per
reference view and writes the reference's output layout
(``{out}/{vid}/{name}_init.pfm``, ``_prob.pfm``, the reference image as
``.jpg``, the camera as ``.txt``, ``color/*.png``; predict_whu.py:110-153).

Inputs are zero-padded bottom/right to multiples of 32 (the cascade halves
the frame five times) and the outputs cropped back. A sample is duck-typed:
anything with ``.imgs`` [V,H,W,3], ``.proj_matrices`` {"stageK": [V,4,4]}
and ``.depth_values`` [2], as numpy arrays (``data/pipeline.py::
PredictSample``; its ``view_ids`` key the feature cache).

The feature cache keeps the feature pyramids of the last ``feature_cache``
images on the device (LRU by image id): in an aerial block every image is a
source view of several work items. Per-view preprocessing does not depend on
the reference, so a cached pyramid is the one the uncached forward computes;
it runs the feature net per view (batch 1), the uncached forward on all B·V
views at once.

With ``tiles`` > 1 each frame runs in row bands (``predict/tiled.py``),
with the feature cache too. Over several ranks each takes its share of the
work items.

Images are written with PIL, imported by the writer; the preview colours are
``predict/viridis.py``'s copy of matplotlib's table.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time

import numpy as np
import torch

from ..data.pipeline import load_predict_sample
from ..device import resolve_device
from ..geom.camera import legacy_cam_array
from ..io.cams_text import write_red_cam
from ..io.pfm import write_pfm
from ..parallel.distributed import rank, world_size
from ..tracing import span
from .tiled import HALO_ROWS, tiled_forward
from .viridis import viridis_rgb


def _pad_to_multiple(imgs: np.ndarray, base: int = 32) -> tuple[np.ndarray, int, int]:
    """Zero-pad [V,H,W,3] bottom/right to multiples of ``base``."""
    V, H, W, C = imgs.shape
    ph = (-H) % base
    pw = (-W) % base
    if ph or pw:
        imgs = np.pad(imgs, ((0, 0), (0, ph), (0, pw), (0, 0)))
    return imgs, H, W


def colorize_depth(depth: np.ndarray) -> np.ndarray:
    """Reference color convention: visualize 36000 - depth with NaN scrubbing
    (train_whu.py:253-257, predict_whu.py:133-147), viridis-mapped."""
    img = 36000.0 - depth
    img = np.where(np.isinf(img), np.nan, img)
    if np.isnan(img).all():
        img = np.zeros_like(img)
    else:
        img = np.where(np.isnan(img), np.nanmin(img) - 1, img)
    lo, hi = img.min(), img.max()
    norm = (img - lo) / (hi - lo + 1e-12)
    return viridis_rgb(norm)


def colorize_prob(prob: np.ndarray) -> np.ndarray:
    return viridis_rgb(np.nan_to_num(prob).clip(0, 1))


def save_prediction_outputs(out_dir: str, sample, depth: np.ndarray, prob: np.ndarray,
                            display: bool = True) -> str:
    from PIL import Image

    folder = os.path.join(out_dir, sample.vid)
    os.makedirs(os.path.join(folder, "color"), exist_ok=True)
    name = sample.name
    write_pfm(os.path.join(folder, f"{name}_init.pfm"), np.float32(depth))
    write_pfm(os.path.join(folder, f"{name}_prob.pfm"), np.float32(prob))
    Image.fromarray(sample.out_image).save(os.path.join(folder, f"{name}.jpg"))
    write_red_cam(
        os.path.join(folder, f"{name}.txt"), legacy_cam_array(sample.out_cam),
        sample.ref_image_path,
    )
    if display:
        Image.fromarray(colorize_depth(depth)).save(
            os.path.join(folder, "color", f"{name}_init.png"))
        Image.fromarray(colorize_prob(prob)).save(
            os.path.join(folder, "color", f"{name}_prob.png"))
    return folder


class PredictEngine:
    """Streaming predictor over a fixed model, on ``device`` (CUDA unless
    given; raises when no CUDA device is present and none was given). Any
    model of ``models.build_model`` serves (AdaMVS or MS-REDNet): the engine
    reads only the outputs ``depth`` and ``photometric_confidence``; ``run``
    prints a line per work item. ``feature_cache``: how many images' feature pyramids stay on the device
    (0: none); ``cache_hits`` and ``cache_misses`` count its lookups.

    ``tiles`` > 1: each frame runs in that many row bands with ``halo``
    rows of overlap (``predict/tiled.py``, ``HALO_ROWS`` unless given), one
    after another on this device, frame by frame (JAX's ``tile_mesh``). As
    in JAX, the bands take the scan regulariser: ``reg_impl`` "pallas" and
    "precomp" raise ``ValueError``."""

    def __init__(self, model, num_depth: int = 192, device=None, feature_cache: int = 0,
                 tiles: int = 1, halo: int | None = None):
        reg_impl = getattr(model, "reg_impl", "scan")
        if tiles > 1 and reg_impl != "scan":
            # JAX's engine packs no regulariser for a tile mesh, so its model raises
            # (adamvs_tpu/predict/engine.py:135, models/adamvs.py:610-622)
            raise ValueError(f"reg_impl={reg_impl!r} requires the packed regulariser, which "
                             f"row-band prediction (tiles={tiles}) does not pack: use "
                             "reg_impl='scan'")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.num_depth = num_depth
        self.tiles = tiles
        self.halo = halo or HALO_ROWS
        self.feature_cache = feature_cache
        self._feat_cache: dict = {}  # image id -> {stageK: [1,C,h,w]}, oldest first
        self.cache_hits = self.cache_misses = 0

    @torch.no_grad()
    def _forward(self, imgs: np.ndarray | None, projs: dict, depth_values: np.ndarray,
                 features: dict | None = None):
        dev = self.device
        with span("engine.upload"):  # pageable copies: the host waits for each
            if imgs is not None:
                imgs = torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).to(dev)
            projs = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
                     for k, v in projs.items()}
            dv = torch.from_numpy(np.asarray(depth_values, np.float32)).to(dev)
        if self.tiles > 1:
            depth, conf = tiled_forward(self.model, imgs, projs, dv, self.tiles,
                                        num_depth=self.num_depth, halo=self.halo,
                                        features=features)
        else:
            out = self.model(imgs, projs, dv, num_depth=self.num_depth, features=features)
            depth, conf = out["depth"], out["photometric_confidence"]
        with span("engine.download"):  # waits for the forward's tail
            return depth.float().cpu().numpy(), conf.float().cpu().numpy()

    def predict_sample(self, sample) -> tuple[np.ndarray, np.ndarray]:
        """(depth [H,W], confidence [H,W]) of one sample."""
        return self.predict_batch([sample])[0]

    def predict_batch(self, samples: list) -> list[tuple[np.ndarray, np.ndarray]]:
        """Batched forward over same-shape samples; with the feature cache on
        and every sample's ``view_ids`` known, over their cached pyramids.
        In row bands (``tiles`` > 1), one sample after another."""
        if self.tiles > 1 and len(samples) > 1:
            return [self.predict_batch([s])[0] for s in samples]
        with span("engine.request"):
            padded = [_pad_to_multiple(np.asarray(s.imgs)) for s in samples]
            # one sample: a view, not a copy of its [V,H,W,3] float32 frames
            imgs = padded[0][0][None] if len(padded) == 1 else np.stack([p[0] for p in padded])
            projs = {k: np.stack([np.asarray(s.proj_matrices[k]) for s in samples])
                     for k in samples[0].proj_matrices}
            dv = np.stack([np.asarray(s.depth_values) for s in samples])
            if self.feature_cache and all(getattr(s, "view_ids", ()) for s in samples):
                per_sample = [self._cached_features(s, imgs[i]) for i, s in enumerate(samples)]
                features = {k: torch.stack([f[k] for f in per_sample]) for k in per_sample[0]}
                depth, prob = self._forward(None, projs, dv, features)  # {stageK: [B,V,C,h,w]}
            else:
                depth, prob = self._forward(imgs, projs, dv)
            return [(depth[i][: p[1], : p[2]], prob[i][: p[1], : p[2]])
                    for i, p in enumerate(padded)]

    # -- cross-sample feature caching -----------------------------------
    @torch.no_grad()
    def _view_features(self, image_id, img: np.ndarray) -> dict:
        """The pyramid {stageK: [C,h,w]} of one padded view [H,W,3], from the
        cache or computed and cached (evicting the least recently used)."""
        if image_id in self._feat_cache:
            self.cache_hits += 1
            feats = self._feat_cache.pop(image_id)
        else:
            self.cache_misses += 1
            with span("engine.upload"):
                x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(self.device)
            dtype = next(self.model.parameters()).dtype
            with span("model.features"):
                feats = {k: v[0] for k, v in
                         self.model.feature_module()(x.permute(2, 0, 1)[None].to(dtype)).items()}
        self._feat_cache[image_id] = feats  # most recently used last
        while len(self._feat_cache) > self.feature_cache:
            del self._feat_cache[next(iter(self._feat_cache))]
        return feats

    def _cached_features(self, sample, imgs: np.ndarray) -> dict:
        """{stageK: [V,C,h,w]} of one sample's padded views [V,H,W,3]."""
        per_view = [self._view_features(sample.view_ids[v], imgs[v]) for v in range(len(imgs))]
        return {k: torch.stack([fv[k] for fv in per_view]) for k in per_view[0]}

    def run(self, source, out_dir: str, num_views: int | None = None, display: bool = True,
            load_kwargs: dict | None = None, batch_size: int = 1) -> list[str]:
        """Predict every work item of ``source`` (``data/lists.py::
        PredictSource``) into ``out_dir``, ``batch_size`` samples per
        forward, with the next chunk's samples loading on two threads while
        the card works; returns the output folders. Rank r of n
        (``parallel.initialize_distributed``) takes the items i with
        i % n == r."""
        os.makedirs(out_dir, exist_ok=True)
        load_kwargs = load_kwargs or {}
        written = []
        t_start = time.time()
        items = source.work_items[:num_views] if num_views else source.work_items
        n, r = world_size(), rank()
        mine = [(i, spec) for i, spec in enumerate(items) if i % n == r]
        chunks = [mine[b0: b0 + batch_size] for b0 in range(0, len(mine), batch_size)]
        with cf.ThreadPoolExecutor(max_workers=2) as pool:
            def submit(chunk):
                return [pool.submit(load_predict_sample, source, spec, num_depth=self.num_depth,
                                    **load_kwargs) for _, spec in chunk]

            pending = submit(chunks[0]) if chunks else None
            for ci, chunk in enumerate(chunks):
                t0 = time.time()
                futures = pending
                pending = submit(chunks[ci + 1]) if ci + 1 < len(chunks) else None
                samples = [f.result() for f in futures]
                results = self.predict_batch(samples)
                t1 = time.time()
                for (i, _), sample, (depth, prob) in zip(chunk, samples, results):
                    written.append(save_prediction_outputs(out_dir, sample, depth, prob, display))
                    print(
                        f"depth inference {i} ({sample.name}) done: "
                        f"{(t1 - t0) / len(chunk):.3f}s infer, "
                        f"{(time.time() - t1) / len(chunk):.3f}s save")
        if self.feature_cache:
            print(f"feature cache: {self.cache_hits} hits, {self.cache_misses} misses")
        print(f"predict finished: {len(written)} views in {time.time() - t_start:.1f}s")
        return written
