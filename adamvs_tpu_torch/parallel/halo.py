"""Row bands of one frame over the ranks of a tile group, for training
(the port's counterpart of XLA's partitioning of JAX's train step when
``shard_batch`` shards image rows over the ``tile`` axis,
adamvs_tpu/parallel/mesh.py:45-76).

Each rank of the group holds the rows ``[t·h, (t+1)·h)`` of every map, ``t``
its index in the group. While ``tile_rows(group)`` is active:

- ``exchange_rows`` extends a band by its neighbours' border rows (a halo)
  and sends the halo's gradient back to the rows' owners;
- ``halo_conv2d`` / ``halo_conv_transpose2d`` compute a convolution's rows of
  the band as the convolution of the whole frame would (``nn/blocks.py``
  routes ``Conv2d`` and ``ConvTranspose2d`` with a kernel taller than one
  row through them);
- ``halo_resize_bilinear`` does the same for ``F.interpolate(bilinear,
  align_corners=False)`` by an integer factor (``ops/regression.py::
  resize_bilinear``);
- ``gather_rows`` assembles a band's maps to the whole frame's, and its
  backward sums every rank's gradient into the owner's rows.

Without ``tile_rows`` each of them is the plain op. Every exchange is an
``all_gather`` of every rank's border rows over the group: it takes CPU and
CUDA tensors alike on gloo and on nccl (gloo's point-to-point ``send``/
``recv`` and ``scatter`` are not taken for CUDA tensors everywhere), and it
costs about as much as a send at 2-4 bands. A rank whose peer is missing
fails at the collective's timeout.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class TileRows:
    """The tile group, this rank's band index in it and the band count."""

    group: object
    index: int
    count: int


_TILES: list = []


@contextlib.contextmanager
def tile_rows(group):
    """While active, ``tile_context()`` names ``group`` (None: no bands)."""
    _TILES.append(None if group is None else
                  TileRows(group, dist.get_rank(group), dist.get_world_size(group)))
    try:
        yield
    finally:
        _TILES.pop()


def tile_context() -> TileRows | None:
    """The bands of the innermost ``tile_rows``, else None."""
    return _TILES[-1] if _TILES else None


def _gather(t: torch.Tensor, tiles: TileRows) -> list[torch.Tensor]:
    t = t.contiguous()
    bufs = [torch.empty_like(t) for _ in range(tiles.count)]
    dist.all_gather(bufs, t, group=tiles.group)
    return bufs


class _ExchangeRows(torch.autograd.Function):
    """``x`` [..., h, w] with ``top`` rows above and ``bottom`` below: the
    previous band's last rows and the next band's first, or at the frame's
    first and last band zeros (``edge=False``) or copies of the edge row
    (``edge=True``). Backward: the halo rows' gradients go back to the
    ranks that own the rows, and a copied edge row's to that row."""

    @staticmethod
    def forward(ctx, x, top, bottom, edge, tiles):
        h = x.shape[-2]
        if top > h or bottom > h:
            raise ValueError(f"a halo of {top}/{bottom} rows needs bands of as many rows, got {h}")
        ctx.args = (top, bottom, edge, tiles)
        t, n = tiles.index, tiles.count
        head, tail = x[..., :bottom, :], x[..., h - top:, :]
        parts = _gather(torch.cat([head.flatten(), tail.flatten()]), tiles) if n > 1 else None
        if t > 0:
            above = parts[t - 1][head.numel():].view_as(tail)
        else:
            above = (x[..., :1, :] if edge else torch.zeros_like(x[..., :1, :])).expand_as(tail)
        if t < n - 1:
            below = parts[t + 1][:head.numel()].view_as(head)
        else:
            below = (x[..., -1:, :] if edge else torch.zeros_like(x[..., -1:, :])).expand_as(head)
        return torch.cat([above, x, below], dim=-2)

    @staticmethod
    def backward(ctx, g):
        top, bottom, edge, tiles = ctx.args
        t, n = tiles.index, tiles.count
        h = g.shape[-2] - top - bottom
        g_above, g_below = g[..., :top, :], g[..., top + h:, :]
        dx = g[..., top:top + h, :].clone()
        parts = (_gather(torch.cat([g_above.flatten(), g_below.flatten()]), tiles) if n > 1
                 else None)
        if t < n - 1:  # the next band's top halo holds this band's last rows
            dx[..., h - top:, :] += parts[t + 1][:g_above.numel()].view_as(g_above)
        elif edge:
            dx[..., -1:, :] += g_below.sum(dim=-2, keepdim=True)
        if t > 0:  # the previous band's bottom halo holds this band's first rows
            dx[..., :bottom, :] += parts[t - 1][g_above.numel():].view_as(g_below)
        elif edge:
            dx[..., :1, :] += g_above.sum(dim=-2, keepdim=True)
        return dx, None, None, None, None


def exchange_rows(x: torch.Tensor, top: int, bottom: int, edge: bool = False) -> torch.Tensor:
    """``x`` [..., h, w], this rank's band, with ``top`` rows of the previous
    band above it and ``bottom`` rows of the next below it (zeros, or with
    ``edge`` copies of the edge row, beyond the frame); differentiable.
    Without ``tile_rows``, the frame's own padding."""
    if top == 0 and bottom == 0:
        return x
    return _ExchangeRows.apply(x, top, bottom, edge, tile_context() or TileRows(None, 0, 1))


def conv_halo(kernel: int, stride: int, padding: int) -> tuple[int, int]:
    """(rows above, rows below) a band that a convolution's output rows of
    the band read: output row ``i`` reads input rows ``s·i - p`` to ``s·i -
    p + k - 1``."""
    return padding, max(0, kernel - padding - stride)


def conv_transpose_halo(kernel: int, stride: int, padding: int) -> tuple[int, int]:
    """(rows above, rows below) a band that a transposed convolution's
    output rows ``[s·a, s·(a + h))`` of the band gather from: output row
    ``o`` takes input row ``i`` through tap ``kk`` where ``s·i + kk = o +
    p``."""
    offs = [(o + padding - kk) // stride for o in range(stride) for kk in range(kernel)
            if (o + padding - kk) % stride == 0]
    return max(0, -min(offs)), max(0, max(offs))


def _band_rows(h: int, stride: int) -> int:
    if h % stride:
        raise ValueError(f"a band of {h} rows does not divide by the stride {stride}")
    return h // stride


def halo_conv2d(x, weight, bias, stride, padding, dilation=(1, 1), groups: int = 1):
    """``F.conv2d`` of the whole frame, at this rank's band ``x`` [N,C,h,w]:
    the convolution over the band with its halo (``conv_halo``), row padding
    0, then the band's ``h / stride`` output rows."""
    if tuple(dilation)[0] != 1:
        raise ValueError(f"row bands take convolutions without row dilation, got {dilation}")
    k, s, p = weight.shape[2], stride[0], padding[0]
    out_rows = _band_rows(x.shape[2], s)
    x = exchange_rows(x, *conv_halo(k, s, p))
    return F.conv2d(x, weight, bias, stride, (0, padding[1]), dilation, groups)[:, :, :out_rows]


def halo_conv_transpose2d(x, weight, bias, stride, padding, output_padding, groups: int = 1,
                          dilation=(1, 1)):
    """``F.conv_transpose2d`` of the whole frame, at this rank's band ``x``
    [N,C,h,w]: the transposed convolution over the band with its halo
    (``conv_transpose_halo``), then the band's ``stride·h`` output rows,
    which start ``stride·top`` rows in."""
    if tuple(dilation)[0] != 1:
        raise ValueError(f"row bands take convolutions without row dilation, got {dilation}")
    k, s, p = weight.shape[2], stride[0], padding[0]
    top, bottom = conv_transpose_halo(k, s, p)
    h = x.shape[2]
    y = F.conv_transpose2d(exchange_rows(x, top, bottom), weight, bias, stride, padding,
                           output_padding, groups, dilation)
    if y.shape[2] < s * (top + h):
        raise ValueError(f"transposed conv k={k} s={s} p={p} gives {y.shape[2]} rows, fewer "
                         f"than the band's {s * h} after {s * top}")
    return y[:, :, s * top:s * (top + h)]


def halo_resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``F.interpolate(bilinear, align_corners=False)`` of the whole frame to
    ``height`` rows per band, at this rank's band ``x`` [N,C,h,w]. An integer
    up-factor f reads at most one row beyond each side (copies of the edge
    row beyond the frame, where the frame's sampling clamps): the band with
    one halo row on each side is resized by f and its rows ``[f, f + f·h)``
    kept. An integer down-factor reads within the band, on bands aligned to
    it. Any other ratio raises."""
    h = x.shape[2]
    if height == h or (height < h and h % height == 0):
        return F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False)
    if height % h:
        raise ValueError(f"row bands resize by integer factors only, got {h} -> {height} rows")
    f = height // h
    y = F.interpolate(exchange_rows(x, 1, 1, edge=True), size=(f * (h + 2), width),
                      mode="bilinear", align_corners=False)
    return y[:, :, f:f + height]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tiles):
        ctx.args = (dim, tiles, x.shape[dim])
        return torch.cat(_gather(x, tiles), dim=dim)

    @staticmethod
    def backward(ctx, g):
        dim, tiles, h = ctx.args
        g = g.clone(memory_format=torch.contiguous_format)  # reduced in place: not autograd's
        dist.all_reduce(g, group=tiles.group)  # every band's gradient of the whole frame
        return g.narrow(dim, tiles.index * h, h).contiguous(), None, None


def gather_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every band of ``x`` (this rank's rows along ``dim``) concatenated in
    band order, the whole frame's, on every rank of the tile group;
    differentiable: each rank's rows get the sum of every rank's gradient of
    them (one all-reduce of the frame's gradient, which gloo takes where it
    may not take a reduce-scatter). Without ``tile_rows``, ``x``."""
    tiles = tile_context()
    return x if tiles is None else _GatherRows.apply(x, dim, tiles)


def gather_rows_nograd(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x``'s bands over ``group`` (a tile group) concatenated along ``dim``,
    without a gradient; ``x`` itself without a group."""
    if group is None:
        return x
    return torch.cat(_gather(x, TileRows(group, 0, dist.get_world_size(group))), dim=dim)


__all__ = ["TileRows", "conv_halo", "conv_transpose_halo", "exchange_rows", "gather_rows",
           "gather_rows_nograd", "halo_conv2d", "halo_conv_transpose2d",
           "halo_resize_bilinear", "tile_context", "tile_rows"]
