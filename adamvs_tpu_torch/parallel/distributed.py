"""Multi-process runtime (counterpart of adamvs_tpu/parallel/distributed.py).

JAX runs one process per host with several devices in it; PyTorch runs one
process per card. A JAX device is a rank here: ``torch.distributed`` over
``nccl`` for CUDA tensors and ``gloo`` for the CPU (or for CUDA tensors of
several ranks that share one card).

Launch one process per card, with the JAX CLI's variables:

    JAX_COORDINATOR=host0:1234 NUM_PROCESSES=4 PROCESS_ID=$i \\
        python -m adamvs_tpu_torch.cli train --distributed --data_parallel 0 ...

or with torchrun, whose ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
``RANK`` are read where the JAX variables are unset:

    torchrun --nproc_per_node 4 -m adamvs_tpu_torch.cli train --distributed --data_parallel 0 ...

``data_parallel(group)`` sets the statistics group while a step runs: the
train-mode BatchNorm statistics (``nn/blocks.py``) and the losses' masked
means (``models/losses.py``) are then those of the global batch over the
group's ranks, as JAX computes them over its global array. The train step
passes its mesh's ``stats_group``: the data group, or, when image rows are
sharded over a tile axis too, every rank of the mesh, whose row bands make
up the global batch together (``parallel/halo.py``).
"""

from __future__ import annotations

import contextlib
import datetime
import os

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

# seconds a rank waits for its peers at the setup and at each collective
DEFAULT_TIMEOUT_S = 600.0


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, backend: str | None = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group once; a second call does nothing.

    ``coordinator`` ("host:port", rank 0's address), ``num_processes`` and
    ``process_id`` default to ``JAX_COORDINATOR``, ``NUM_PROCESSES`` and
    ``PROCESS_ID``; where those are unset, to torchrun's ``MASTER_ADDR:
    MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. ``backend`` defaults to
    ``nccl`` where CUDA is present, else ``gloo``; with ``nccl`` each rank
    takes the card ``LOCAL_RANK`` (else its rank modulo the cards). The setup
    and every collective wait at most ``timeout_s`` for the peers.

    A setup that was asked for and fails raises: a coordinator and a process
    count (given or in the JAX variables), or torchrun's variables with a
    ``WORLD_SIZE`` above 1. When nothing was found, or torchrun's variables
    name a world of 1 and the setup fails, the process runs alone, as JAX's
    auto-detection does."""
    if dist.is_initialized():
        return
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    num_processes = num_processes or _int_env("NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("PROCESS_ID")
    explicit = coordinator is not None and num_processes is not None
    if explicit and process_id is None:
        raise ValueError(f"a coordinator ({coordinator}) and {num_processes} processes need "
                         "process_id (PROCESS_ID)")
    if not explicit:
        found = [os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")]
        if not all(found):
            return  # no cluster: the process runs alone
        coordinator = f"{found[0]}:{found[1]}"
        num_processes, process_id = int(found[2]), int(found[3])
        explicit = num_processes > 1
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    card = {}
    if backend == "nccl":
        local = _int_env("LOCAL_RANK")
        card["device_id"] = torch.device(
            "cuda", local if local is not None else process_id % torch.cuda.device_count())
        torch.cuda.set_device(card["device_id"])
    try:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(seconds=timeout_s), **card)
    except (ValueError, RuntimeError, OSError):
        if explicit:
            # a requested multi-process setup that fails must be loud: each process
            # carrying on alone would redo the whole work list
            raise
        # a world of 1 that fails to form: the process runs alone


def _int_env(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of ranks, 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


_DATA_GROUPS: list = []


@contextlib.contextmanager
def data_parallel(group):
    """While active, ``data_group()`` is ``group``, the ranks whose parts
    make up the global batch (None: one process holds it)."""
    _DATA_GROUPS.append(group)
    try:
        yield
    finally:
        _DATA_GROUPS.pop()


def data_group():
    """The data group of the innermost ``data_parallel``, else None."""
    return _DATA_GROUPS[-1] if _DATA_GROUPS else None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, differentiable
    (``torch.distributed.nn.functional.all_reduce``): the gradient of each
    rank's input is the sum of every rank's output gradient."""
    return dist_nn.all_reduce(t, group=group)
