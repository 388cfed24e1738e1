"""Ranks as devices: the process group, the (data, tile) mesh and the work
split by (index, count) (counterpart of adamvs_tpu/parallel)."""

from .distributed import data_group, data_parallel, initialize_distributed, rank, world_size
from .mesh import Mesh, make_mesh, replicate, run_blocks, shard_batch

__all__ = ["Mesh", "data_group", "data_parallel", "initialize_distributed", "make_mesh", "rank",
           "replicate", "run_blocks", "shard_batch", "world_size"]
