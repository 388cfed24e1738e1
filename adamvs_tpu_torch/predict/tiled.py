"""Row-band prediction (counterpart of adamvs_tpu/predict/tiled.py).

The cost volume is per-pixel independent given the features, so one large
reference frame splits into ``count`` bands of rows:

1. the features are computed once on the full frame (or come from the
   engine's feature cache): a source may be sampled anywhere in its frame;
2. band ``i`` takes its reference rows, extended by a halo over the
   regularisers' receptive field (``band_geometry``), shifts the reference
   projection by the band's first row (``band_ref_proj``: ``P'[1,:] =
   P[1,:] - r0·P[2,:]``) and runs the whole cascade on the band through the
   models' tuple form of ``features=`` (band reference, full sources);
3. the halo is cropped and the bands are concatenated along the rows.

On one card the bands run one after another; over a process group
(``group``, of ``count`` ranks) each rank runs its own band and the bands
are gathered (``parallel/mesh.py::run_blocks``). Either way the numbers are
those of JAX's ``shard_map`` over a ``tile`` axis. Interior rows match the
unbanded forward: convolutions and recurrent cells see the same
neighbourhoods inside the halo, and BatchNorm uses its running statistics.
"""

from __future__ import annotations

import torch

from ..ops.warp import band_ref_proj
from ..parallel.mesh import run_blocks

# covers the stage-1 regulariser's receptive field (~50 px at 1/4 resolution,
# ~200 full-resolution rows) and the recurrent cells'
HALO_ROWS = 256


def band_geometry(band: int, count: int, H: int, halo: int = HALO_ROWS) -> tuple[int, int, int]:
    """(start, band_h, offset) of band ``band`` of ``count`` over ``H``
    full-resolution rows, as JAX's ``tiled_forward`` computes them
    (adamvs_tpu/predict/tiled.py:91-118): ``band_h`` is rows + 2·halo
    rounded up to 32 (the cascade halves the band five times), at most H;
    ``start`` is the band's first row, clipped to the frame and 4-aligned so
    every stage's row offset is whole; ``offset`` is the first of its
    ``H // count`` own rows inside the band (clamped, as JAX's dynamic slice
    clamps its start)."""
    if H % 32:
        raise ValueError(f"H={H} must be a multiple of 32 (pad first)")
    if H % (count * 4):
        raise ValueError(f"H={H} must divide into {count} 4-aligned bands")
    rows = H // count
    band_h = min(H, -(-(rows + 2 * halo) // 32) * 32)
    start = (min(max(band * rows - halo, 0), H - band_h) // 4) * 4
    offset = min(max(band * rows - start, 0), band_h - rows)
    return start, band_h, offset


@torch.no_grad()
def tiled_forward(model, imgs: torch.Tensor | None, proj_matrices: dict,
                  depth_values: torch.Tensor, count: int, num_depth: int | None = None,
                  halo: int = HALO_ROWS, features: dict | None = None, group=None):
    """The unbanded forward's (depth [B,H,W], confidence [B,H,W]) of
    ``model`` (in eval mode) computed in ``count`` row bands.

    ``imgs`` [B,V,H,W,3], or ``features`` {"stageK": [B,V,C,h,w]}, the
    full-frame pyramid (the engine's cache; ``imgs`` may then be None; stage
    1 sits at 1/4 of the frame). ``group``: a process group of ``count``
    ranks, one band each; None runs the bands one after another here."""
    n = len(model.ndepths)
    if features is None:
        B, V = imgs.shape[:2]
        H = imgs.shape[2]
        dtype = model.compute_dtype
        flat = imgs.reshape((B * V,) + imgs.shape[2:]).permute(0, 3, 1, 2).to(dtype)
        features = {k: f.reshape((B, V) + f.shape[1:])
                    for k, f in model.feature_module()(flat).items()}
    else:
        B, V = features["stage1"].shape[:2]
        H = features["stage1"].shape[3] * 4
    rows = H // count
    stages = []
    for k in range(1, n + 1):
        fs = features[f"stage{k}"]  # [B,V,C,h,w]
        # stage k sits at 1/2^(3-k) of the frame for any cascade length (the
        # feature trunk is always 3-scale: H/4, H/2, H)
        stages.append((2 ** (3 - k), fs[:, 0], fs[:, 1:].permute(1, 0, 3, 4, 2).contiguous()))

    def band(i: int):
        start, band_h, off = band_geometry(i, count, H, halo)
        feats, projs = {}, {}
        for k, (s, ref, srcs) in enumerate(stages, start=1):
            r0 = start // s
            feats[f"stage{k}"] = (ref[:, :, r0:r0 + band_h // s].permute(0, 2, 3, 1), srcs)
            projs[f"stage{k}"] = band_ref_proj(proj_matrices[f"stage{k}"], r0)
        out = model(None, projs, depth_values, num_depth=num_depth, features=feats)
        return (out["depth"][:, off:off + rows].contiguous(),
                out["photometric_confidence"][:, off:off + rows].contiguous())

    bands = run_blocks(band, count, group)
    return torch.cat([d for d, _ in bands], dim=1), torch.cat([c for _, c in bands], dim=1)
