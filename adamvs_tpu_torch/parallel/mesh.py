"""The (data, tile) layout of ranks (counterpart of adamvs_tpu/parallel/mesh.py).

JAX lays its devices out as a ``(data, tile)`` grid; here the grid holds
ranks, rank ``r`` at ``(r // tile, r % tile)``, and ``make_mesh`` makes one
process group along each axis:

- ``data``: the ranks that share a tile index; training averages over them
  (``train/loop.py``), each taking its contiguous slice of the global batch
  (``shard_batch``) after rank 0's parameters were broadcast (``replicate``);
- ``tile``: the ranks that share a data index; row bands (``predict/
  tiled.py``) and depth blocks (``models/adamvs.py``) take one index each.
  In training with ``tile`` > 1 each of them holds one row band of its data
  slice (``shard_batch``, as JAX's shards image rows over ``tile``): the
  train step runs under ``parallel.halo.tile_rows`` over the tile group,
  and its batch statistics, masked means and gradient average span the
  whole mesh (``stats_group``).

Work split by ``(index, count)`` runs through ``run_blocks``: one process
runs the indices one after another, a group gives one to each rank and
gathers the results.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .distributed import rank, world_size


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` x ``tile`` ranks and this rank's groups along each axis
    (None without a process group)."""

    data: int
    tile: int
    data_group: object = None
    tile_group: object = None

    @property
    def data_index(self) -> int:
        return rank() // self.tile

    @property
    def tile_index(self) -> int:
        return rank() % self.tile

    @property
    def stats_group(self):
        """The ranks over which a train step's batch statistics, masked
        means and gradient average run: the data group, or with row bands
        (``tile`` > 1) every rank of the mesh, which is the world
        (``make_mesh`` covers all ranks). None without a process group."""
        if self.tile_group is None or self.tile == 1:
            return self.data_group
        return dist.group.WORLD


def make_mesh(data: int | None = None, tile: int = 1) -> Mesh:
    """A (data, tile) mesh over every rank; ``data=None`` takes the ranks
    that ``tile`` leaves. Every rank must call it, in the same order as any
    other group it makes."""
    n = world_size()
    if data is None:
        if n % tile:
            raise ValueError(f"{n} devices not divisible by tile={tile}")
        data = n // tile
    if data * tile > n:
        raise ValueError(f"mesh {data}x{tile} needs more than {n} devices (the world has {n} "
                         f"rank(s), one device each)")
    if data * tile < n:
        raise ValueError(f"mesh {data}x{tile} must cover all {n} ranks")
    if not dist.is_initialized():
        return Mesh(data, tile)
    groups = {}
    for t in range(tile):  # the data groups, then the tile groups
        groups["data", t] = dist.new_group([d * tile + t for d in range(data)])
    for d in range(data):
        groups["tile", d] = dist.new_group([d * tile + t for t in range(tile)])
    r = rank()
    return Mesh(data, tile, groups["data", r % tile], groups["tile", r // tile])


# the rows of a band must halve five times: twice in the feature net, three more
# times in stage 1's CostRegNet2D (and in its SPP pool of 8)
BAND_ROW_MULTIPLE = 32


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous slice of a global batch (nested dicts of
    arrays, batch leading) over ``data``; with ``tile`` > 1 also this rank's
    row band of it, as JAX's ``shard_batch`` (adamvs_tpu/parallel/mesh.py:
    45-76): ``imgs`` [B,V,H,W,3] on axis 2, every stage's ``depth`` and
    ``mask`` [B,h,w] on axis 1, band ``tile_index`` of ``tile``. Raises
    ``ValueError`` unless the band's rows H/tile are a multiple of 32."""
    if mesh.tile > 1:
        H = batch["imgs"].shape[2]
        if H % (mesh.tile * BAND_ROW_MULTIPLE):
            raise ValueError(
                f"{H} image rows over tile={mesh.tile} give bands of {H / mesh.tile:g} rows; a "
                f"band needs a multiple of {BAND_ROW_MULTIPLE} rows (the feature net halves them "
                f"twice, then stage 1's CostRegNet2D and SPP pool three more times)")

    def rows(x, axis):
        n = x.shape[axis] // mesh.tile
        band = [slice(None)] * x.ndim
        band[axis] = slice(mesh.tile_index * n, (mesh.tile_index + 1) * n)
        return x[tuple(band)]

    def cut(x, top=None):
        if isinstance(x, dict):
            return {k: cut(v, k if top is None else top) for k, v in x.items()}
        if x.shape[0] % mesh.data:
            raise ValueError(f"batch {x.shape[0]} is not divisible by the data axis {mesh.data}")
        b = x.shape[0] // mesh.data
        x = x[mesh.data_index * b:(mesh.data_index + 1) * b]
        if mesh.tile > 1 and top in ("imgs", "depth", "mask"):
            x = rows(x, 2 if top == "imgs" else 1)
        return x

    return cut(batch)


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> None:
    """Broadcast the parameters and buffers of the first rank of the mesh's
    statistics group (``Mesh.stats_group``: the data group, or every rank
    with row bands) to the group's other ranks, in place."""
    group = mesh.stats_group
    if group is None:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0, group=group)  # rank 0 is the group's first


def run_blocks(fn, count: int, group=None) -> list:
    """``[fn(i) for i in range(count)]``: in this process one index after
    another, or over ``group`` (of ``count`` ranks) each rank's own index,
    the results (tensors, or tuples of tensors, of one shape whatever the
    index) gathered to every rank."""
    if group is None:
        return [fn(i) for i in range(count)]
    if dist.get_world_size(group) != count:
        raise ValueError(f"{count} blocks need a group of {count} ranks, got "
                         f"{dist.get_world_size(group)}")
    mine = fn(dist.get_rank(group))
    single = torch.is_tensor(mine)
    parts = []
    for t in (mine,) if single else mine:
        t = t.contiguous()
        bufs = [torch.empty_like(t) for _ in range(count)]
        dist.all_gather(bufs, t, group=group)
        parts.append(bufs)
    return [p[0] if single else tuple(p) for p in zip(*parts)]


def average_gradients(module: torch.nn.Module, group) -> None:
    """Each gradient of ``module`` summed over ``group`` and divided by its
    size, in one all-reduce."""
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


__all__ = ["Mesh", "average_gradients", "make_mesh", "replicate", "run_blocks", "shard_batch"]
