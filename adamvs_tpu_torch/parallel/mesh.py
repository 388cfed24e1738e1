"""The (data, tile) layout of ranks (counterpart of adamvs_tpu/parallel/mesh.py).

JAX lays its devices out as a ``(data, tile)`` grid; here the grid holds
ranks, rank ``r`` at ``(r // tile, r % tile)``, and ``make_mesh`` makes one
process group along each axis:

- ``data``: the ranks that share a tile index; training averages over them
  (``train/loop.py``), each taking its contiguous slice of the global batch
  (``shard_batch``) after rank 0's parameters were broadcast (``replicate``);
- ``tile``: the ranks that share a data index; row bands (``predict/
  tiled.py``) and depth blocks (``models/adamvs.py``) take one index each.

Work split by ``(index, count)`` runs through ``run_blocks``: one process
runs the indices one after another, a group gives one to each rank and
gathers the results. JAX's ``shard_batch`` also shards image rows over
``tile`` while training; that needs convolutions with halo exchange and is
not ported (``shard_batch`` raises for it).
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


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous slice of a global batch (nested dicts of
    arrays, batch leading) over ``data``."""
    if mesh.tile > 1:
        raise NotImplementedError("training with image rows sharded over the tile axis is not "
                                  "ported (ROADMAP.md queue 3)")

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if x.shape[0] % mesh.data:
            raise ValueError(f"batch {x.shape[0]} is not divisible by the data axis {mesh.data}")
        b = x.shape[0] // mesh.data
        return x[mesh.data_index * b:(mesh.data_index + 1) * b]

    return cut(batch)


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> None:
    """Broadcast the parameters and buffers of the data group's first rank
    to the group's other ranks, in place."""
    if mesh.data_group is None:
        return
    src = mesh.tile_index  # the group's rank at data index 0
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=mesh.data_group)


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
