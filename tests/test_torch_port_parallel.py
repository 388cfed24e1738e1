"""The port's process group and mesh (``adamvs_tpu_torch/parallel``) on the
CPU: ``initialize_distributed`` (idempotent; a setup that was asked for and
fails raises, a failing world of 1 lets the process run alone), the mesh's
checks, ``run_blocks`` in one process, ``online_softmax_merge`` against
JAX's (with an empty shard, tests/test_depth_shard.py's case) and the
depth-sharded AdaMVS forward in one process against the unsharded one."""

import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from adamvs_tpu.ops import regression as jreg
from adamvs_tpu_torch.models import build_model
from adamvs_tpu_torch.ops import regression as treg
from adamvs_tpu_torch.parallel import (
    initialize_distributed,
    make_mesh,
    rank,
    run_blocks,
    world_size,
)
from adamvs_tpu_torch.parallel.dryrun import free_port
from tests.test_torch_port_parallel_tiled import CFG, NUM_DEPTH, _scene

CLUSTER_VARS = ("JAX_COORDINATOR", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture()
def no_cluster(monkeypatch):
    for k in CLUSTER_VARS:
        monkeypatch.delenv(k, raising=False)
    yield monkeypatch
    if dist.is_initialized():
        dist.destroy_process_group()


def test_initialize_is_idempotent(no_cluster):
    port = free_port()
    initialize_distributed(f"localhost:{port}", 1, 0, backend="gloo", timeout_s=30)
    group = dist.group.WORLD
    # a second call, even one naming another setup, keeps the first group
    initialize_distributed(f"localhost:{free_port()}", 2, 1, backend="gloo", timeout_s=2)
    assert dist.group.WORLD is group and (rank(), world_size()) == (0, 1)
    mesh = make_mesh(data=1)
    assert mesh.data_group is not None and (mesh.data, mesh.tile) == (1, 1)


def test_no_cluster_runs_alone(no_cluster):
    initialize_distributed(backend="gloo", timeout_s=2)
    assert not dist.is_initialized() and (rank(), world_size()) == (0, 1)


@pytest.mark.parametrize("how", ["arguments", "jax_variables", "torchrun_variables"])
def test_explicit_setup_that_fails_raises(no_cluster, how):
    """Rank 1 of 2 with nobody at the coordinator's port: it must raise, not
    carry on alone (torchrun's variables with a world of 2 ask for it too)."""
    port = free_port()
    coord = f"localhost:{port}"
    call = {}
    if how == "arguments":
        call = dict(coordinator=coord, num_processes=2, process_id=1)
    elif how == "jax_variables":
        for k, v in (("JAX_COORDINATOR", coord), ("NUM_PROCESSES", "2"), ("PROCESS_ID", "1")):
            no_cluster.setenv(k, v)
    else:
        for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port)),
                     ("WORLD_SIZE", "2"), ("RANK", "1")):
            no_cluster.setenv(k, v)
    with pytest.raises((RuntimeError, ValueError, OSError)):
        initialize_distributed(backend="gloo", timeout_s=2, **call)
    assert not dist.is_initialized()


def test_explicit_setup_needs_a_process_id(no_cluster):
    with pytest.raises(ValueError, match="process_id"):
        initialize_distributed(f"localhost:{free_port()}", 2, backend="gloo", timeout_s=2)


def test_auto_detection_that_fails_runs_alone(no_cluster):
    """torchrun's variables naming a world of 1 whose store cannot open (its
    port is taken): the process runs alone."""
    with socket.socket() as taken:
        taken.bind(("localhost", 0))
        taken.listen()
        for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(taken.getsockname()[1])),
                     ("WORLD_SIZE", "1"), ("RANK", "0")):
            no_cluster.setenv(k, v)
        initialize_distributed(backend="gloo", timeout_s=2)
    assert not dist.is_initialized() and world_size() == 1


def test_mesh_checks_name_the_world(no_cluster):
    with pytest.raises(ValueError, match=r"mesh 2x1 needs more than 1 devices.*1 rank"):
        make_mesh(data=2)
    with pytest.raises(ValueError, match="not divisible by tile=2"):
        make_mesh(tile=2)
    mesh = make_mesh()
    assert (mesh.data, mesh.tile, mesh.data_group) == (1, 1, None)
    assert run_blocks(lambda i: torch.full((2,), float(i)), 3)[2].tolist() == [2.0, 2.0]


def _state(mod, costs, depths, d0, d1, shape):
    acc = mod.online_softmax_init(shape)
    for d in range(d0, d1):
        c, z = costs[d], depths[d]
        acc = mod.online_softmax_update(acc, torch.from_numpy(c) if mod is treg else jnp.asarray(c),
                                        torch.from_numpy(z) if mod is treg else jnp.asarray(z))
    return acc


def test_online_softmax_merge_matches_jax():
    """Three blocks of 4 depths and an empty shard, tree-merged, against the
    full scan and against JAX's merge of the same partial states."""
    rng = np.random.RandomState(0)
    D, shape = 12, (1, 5, 7)
    costs = rng.randn(D, *shape).astype(np.float32) * 3
    depths = rng.rand(D, *shape).astype(np.float32) * 100 + 300
    out = {}
    for mod in (treg, jreg):
        parts = [_state(mod, costs, depths, 4 * b, 4 * b + 4, shape) for b in range(3)]
        parts.append(mod.online_softmax_init(shape))  # an empty shard
        merged = mod.online_softmax_merge(mod.online_softmax_merge(parts[0], parts[1]),
                                          mod.online_softmax_merge(parts[2], parts[3]))
        out[mod.__name__] = [np.asarray(x) for x in mod.online_softmax_finalize(merged)]
        full = [np.asarray(x) for x in mod.online_softmax_finalize(
            _state(mod, costs, depths, 0, D, shape))]
        for m, f in zip(out[mod.__name__], full):
            np.testing.assert_allclose(m, f, rtol=1e-5)
    for t, j in zip(out[treg.__name__], out[jreg.__name__]):
        np.testing.assert_allclose(t, j, rtol=1e-6)
    # two empty states merge without NaN
    e = treg.online_softmax_merge(treg.online_softmax_init(shape), treg.online_softmax_init(shape))
    assert torch.isfinite(e.s).all() and (e.s == 0).all()


@pytest.mark.parametrize("shards", [2, 4])
def test_depth_sharded_forward_matches_unsharded(shards):
    """AdaMVS with ``depth_shards`` (the blocks one after another here) on
    the 96x128 scene against the unsharded scan form, atol 1e-4 on depth
    and confidence (tests/test_depth_shard.py's bar); the same parameters."""
    imgs, projs, dv = _scene(96, 128)
    plain = build_model("adamvs", seed=0, device="cpu", **CFG, sweep_impl="scan", reg_impl="scan")
    sharded = build_model("adamvs", seed=0, device="cpu", **CFG, sweep_impl="scan",
                          reg_impl="scan", depth_shards=shards)
    assert sharded.state_dict().keys() == plain.state_dict().keys()
    a = plain(imgs, projs, dv, num_depth=NUM_DEPTH)
    b = sharded(imgs, projs, dv, num_depth=NUM_DEPTH)
    for k in ("depth", "photometric_confidence"):
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=1e-4, err_msg=k)


def test_depth_sharded_checks():
    with pytest.raises(ValueError, match="reg_impl='pallas'"):
        build_model("adamvs", seed=0, device="cpu", **CFG, sweep_impl="fused", reg_impl="pallas",
                    depth_shards=2)
    imgs, projs, dv = _scene(96, 128)
    model = build_model("adamvs", seed=0, device="cpu", **CFG, sweep_impl="scan",
                        reg_impl="scan", depth_shards=3)
    with pytest.raises(ValueError, match="ndepths entry 8 must divide the depth shards"):
        model(imgs, projs, dv, num_depth=NUM_DEPTH)
