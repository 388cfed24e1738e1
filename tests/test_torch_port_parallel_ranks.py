"""The port's parallel paths over real gloo processes on the CPU:

- ``predict --distributed`` over 2 processes (the JAX CLI's variables): the
  outputs are disjoint and together every work item
  (tests/test_multihost.py::test_two_process_predict_work_queue);
- ``train --distributed --data_parallel 0`` over 2 processes: each rank its
  shard of the sample list, equal losses, records and checkpoints on rank 0;
- the depth-sharded AdaMVS forward with one depth block per rank of 2
  against the unsharded forward (atol 1e-4);
- ``python -m adamvs_tpu_torch.parallel.dryrun`` on 4 ranks (``slow``).

Every process and every collective has a time limit."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from adamvs_tpu_torch.data.synthetic import (
    make_scene,
    write_predict_source_tree,
    write_whu_omvs_tree,
)
from adamvs_tpu_torch.parallel.dryrun import free_port
from tests.test_torch_port_parallel_train import (
    GLOO_TIMEOUT,
    PROC_TIMEOUT,
    REPO,
    results,
    run_workers,
)

TINY = ["--view_num", "3", "--ndepths", "8,4", "--depth_inter_r", "4,2", "--cr_base_chs", "4,4",
        "--device", "cpu"]

CLI_WORKER = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)
    pid = sys.argv[1]
    os.environ.update(JAX_COORDINATOR={coord!r}, NUM_PROCESSES="2", PROCESS_ID=pid)
    from adamvs_tpu_torch.cli import main
    from adamvs_tpu_torch.parallel import rank, world_size

    argv = {argv!r}
    out = main([a.replace("PID", pid) for a in argv])
    assert (rank(), world_size()) == (int(pid), 2)
    print("RESULT" + json.dumps({{"pid": int(pid)}}))
""")


def test_two_process_predict_work_queue(tmp_path):
    src = str(tmp_path / "source")
    write_predict_source_tree(src, make_scene(num_views=4, height=96, width=128, seed=0))
    out = str(tmp_path / "out")
    argv = ["predict", *TINY, "--numdepth", "16", "--resize_scale", "1.0", "--data_folder", src,
            "--output_folder", out + "/pPID", "--distributed", "--display", "false"]
    script = CLI_WORKER.format(repo=REPO, coord=f"localhost:{free_port()}", argv=argv)
    assert sorted(results(run_workers(script, 2, REPO))) == [0, 1]
    names = {}
    for pid in (0, 1):
        root = os.path.join(out, f"p{pid}")
        names[pid] = sorted(n for d, _, files in os.walk(root) for n in files
                            if n.endswith("_init.pfm"))
    assert set(names[0]).isdisjoint(names[1])
    assert len(names[0]) == len(names[1]) == 2
    assert sorted(names[0] + names[1]) == [f"view_{i:03d}_init.pfm" for i in range(4)]


def test_two_process_train_command(tmp_path):
    """4 samples over 2 ranks at --batch_size 2: each rank trains on its 2
    samples, one per step, and both log the same global loss at each step;
    only rank 0 writes records and checkpoints."""
    tree = str(tmp_path / "whu")
    write_whu_omvs_tree(tree, make_scene(num_views=4, height=96, width=128, seed=0))
    argv = ["train", *TINY, "--dlossw", "0.5,1.0", "--trainpath", tree, "--logdir",
            str(tmp_path / "logPID"), "--epochs", "1", "--num_workers", "1", "--batch_size", "2",
            "--summary_freq", "1", "--distributed", "--data_parallel", "0"]
    script = CLI_WORKER.format(repo=REPO, coord=f"localhost:{free_port()}", argv=argv)
    outs = run_workers(script, 2, REPO)
    losses = [[ln for ln in o.splitlines() if ln.startswith("Epoch 0, iter")] for o in outs]
    assert len(losses[0]) == len(losses[1]) == 2
    for a, b in zip(*losses):
        assert a.split("loss=")[1].split(",")[0] == b.split("loss=")[1].split(",")[0], (a, b)
    log0, log1 = os.listdir(tmp_path / "log0"), os.listdir(tmp_path / "log1")
    assert "metrics.jsonl" in log0 and any(n.endswith(".ckpt") for n in log0)
    assert not any(n.endswith((".ckpt", ".jsonl", ".txt")) for n in log1)


DEPTH_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)
    from adamvs_tpu_torch.parallel import initialize_distributed, make_mesh
    from adamvs_tpu_torch.models import build_model

    pid = int(sys.argv[1])
    initialize_distributed({coord!r}, 2, pid, backend="gloo", timeout_s={gloo})
    case = torch.load({case!r}, weights_only=False)
    mesh = make_mesh(data=1, tile=2)
    kw = dict(case["cfg"], seed=0, device="cpu", sweep_impl="scan", reg_impl="scan")
    out = build_model("adamvs", depth_shards=2, depth_group=mesh.tile_group, **kw)(
        case["imgs"], case["projs"], case["dv"], num_depth=32)
    want = build_model("adamvs", **kw)(case["imgs"], case["projs"], case["dv"], num_depth=32)
    err = {{k: (out[k] - want[k]).abs().max().item() for k in ("depth", "photometric_confidence")}}
    print("RESULT" + json.dumps({{"pid": pid, "err": err}}))
""")


def test_depth_blocks_over_two_ranks(tmp_path):
    import torch

    from tests.test_torch_port_parallel_tiled import CFG, _scene

    imgs, projs, dv = _scene(96, 128)
    case = str(tmp_path / "case.pt")
    torch.save({"cfg": CFG, "imgs": imgs, "projs": projs, "dv": dv}, case)
    script = DEPTH_WORKER.format(repo=REPO, coord=f"localhost:{free_port()}", gloo=GLOO_TIMEOUT,
                                 case=case)
    got = results(run_workers(script, 2, REPO))
    for pid in (0, 1):
        for k, e in got[pid]["err"].items():
            assert e <= 1e-4, (pid, k, e)


@pytest.mark.slow
def test_dryrun_on_four_ranks():
    proc = subprocess.run([sys.executable, "-m", "adamvs_tpu_torch.parallel.dryrun", "--ranks",
                           "4", "--device", "cpu", "--timeout", str(PROC_TIMEOUT)], cwd=REPO,
                          capture_output=True, text=True, timeout=PROC_TIMEOUT + 120)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    for line in ("Trainer epoch OK: mesh=(data=2, tile=2)", "row bands OK",
                 "row bands (halo >= receptive field) OK", "depth blocks OK", "dryrun OK"):
        assert line in proc.stdout, line
    assert np.isfinite(float(proc.stdout.split("loss=")[1].split()[0]))
