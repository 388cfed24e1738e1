"""Training: ``Trainer.train_epoch``, as the ``train`` command builds it, over
an iterator of host batches, on one card or data-parallel over several.

A global batch holds ``batch`` x ranks crops of a synthetic flight strip
(``scene.train_batches``: every crop at its own place, V views, analytic GT
at the three stage resolutions); each rank takes its part (``parallel.
shard_batch``), as the command's loader gives each rank its share. Set-up
builds one Trainer, drives it through its first three steps by
``train_epoch`` on three distinct batches (the steps the reference follows),
and hands the same Trainer to the window. On one card the window's iterator
stops at the deadline; over several ranks every rank takes the same number
of steps, fixed before the window from the set-up steps' pace and broadcast
once. Crops per second count every crop of the completed steps, all ranks
together, over the wall of the ``train_epoch`` call.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import shutil
import socket
import tempfile
import time
import types

import torch

from mvsbench import harness, trace
from mvsbench import program as program_
from mvsbench.check import change_norms, check_train, stats_keys
from mvsbench.scene import Strip, train_batches

SETUP_STEPS = 3
RANK_TIMEOUT_S = 180  # a rank's wait for its peers at the set-up and at each collective


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(cell, args, t_start: float, device=None, plant=None):
    ranks = cell.traffic["ranks"]
    if device is None:
        from adamvs_tpu_torch.kernels import build

        build.build_all()  # once, before the ranks start
    if ranks == 1:
        return _rank(0, 1, 0, cell, args, t_start, device, plant)
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, ranks, port, cell, args, device, plant))
             for r in range(1, ranks)]
    for p in procs:
        p.start()
    try:
        res = _rank(0, ranks, port, cell, args, t_start, device, plant)
    finally:
        for p in procs:
            p.join(timeout=300)
            if p.is_alive():
                p.terminate()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return res


def _worker(rank, ranks, port, cell, args, device, plant):
    _rank(rank, ranks, port, cell, args, time.perf_counter(), device, plant)


def _opt_grad_norms(model, opt, alpha: float) -> dict:
    """|g| of each parameter from RMSprop's state after one step (0 where the
    optimizer holds none: it took no step)."""
    return {k: float((opt.state[p]["square_avg"].double().sum() / (1 - alpha)).sqrt())
            if "square_avg" in opt.state.get(p, {}) else 0.0
            for k, p in model.named_parameters()}


def program(cell, seed: int, dev, ranks: int = 1):
    """The system under test of ``cell`` on ``dev``, driven through its
    first ``SETUP_STEPS`` steps by ``train_epoch``: (trainer, the global
    batch pool, its feed, the record of those steps: each step's loss and
    host seconds, the first gradient's norms from RMSprop's state, the first
    step's final depth, the parameters' and statistics' change norms)."""
    from adamvs_tpu_torch.models import model_loss
    from adamvs_tpu_torch.parallel import make_mesh, shard_batch
    from adamvs_tpu_torch.train.loop import Trainer
    from adamvs_tpu_torch.train.state import create_train_state, make_optimizer

    cfg, tr = cell.config, cell.traffic
    rows, cols = tr["crop"]
    pool = train_batches(Strip(tr["scene"], seed + 1, dev), tr["pool"], tr["batch"] * ranks,
                         cfg["views"], rows, cols, tr["depth_range"], cfg["num_depth"], seed)
    model = program_.port_model(cfg, tr, program_.draw_weights(cfg, seed, dev), dev, train=True)
    keys = [k for k, _ in model.named_parameters()] + stats_keys(model)
    state0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model.parameters(), lr=cfg["lr"], alpha=cfg["rmsprop_alpha"])
    mesh = make_mesh(data=ranks) if ranks > 1 else None
    trainer = Trainer(create_train_state(model, opt), model_loss(cfg["model"]),
                      tempfile.mkdtemp(prefix="mvsbench-train-"), dlossw=tuple(cfg["dlossw"]),
                      num_stages=len(cfg["ndepths"]), log_fn=lambda _m: None, device=dev,
                      mesh=mesh)
    feed = (lambda b: shard_batch(b, mesh)) if mesh else (lambda b: b)

    # the first steps, through the window's own call and feed; the reference follows them
    record = {"losses": [], "step_s": []}
    inner = trainer.train_step

    def recording(st, batch):
        t = time.perf_counter()
        out = inner(st, batch)
        record["losses"].append(float(out[1]["loss"]))
        record["step_s"].append(time.perf_counter() - t)
        if len(record["losses"]) == 1:
            record["grad_norms"] = _opt_grad_norms(model, opt, cfg["rmsprop_alpha"])
            record["depth1"] = out[2].float().cpu()
        return out

    trainer.train_step = recording
    trainer.train_epoch(0, (feed(b) for b in pool[:SETUP_STEPS]))
    trainer.train_step = inner
    record["change_norms"] = change_norms(state0, model.state_dict(), keys)
    return trainer, pool, feed, record


def close(trainer) -> None:
    """Free the program's state and the Trainer's log directory."""
    trainer.close()
    shutil.rmtree(trainer.logdir, ignore_errors=True)
    trainer.state = None


def _rank(rank, ranks, port, cell, args, t_start, device, plant=None):
    if plant is not None:
        plant()
    import torch.distributed as dist

    from adamvs_tpu_torch.parallel import initialize_distributed

    tr = cell.traffic
    dev = torch.device(device) if device else torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if ranks > 1:
        initialize_distributed(f"localhost:{port}", ranks, rank,
                               backend="nccl" if dev.type == "cuda" else "gloo",
                               timeout_s=RANK_TIMEOUT_S)
    trainer, pool, feed, record = program(cell, args.seed, dev, ranks)
    t_step = sum(record["step_s"][1:]) / (SETUP_STEPS - 1)
    steps = None
    if ranks > 1:  # every rank takes the same number of steps: one broadcast
        n = torch.tensor([math.ceil(args.seconds / t_step)], device=dev)
        dist.broadcast(n, src=0)
        steps = int(n)
    program_.sync(dev)
    setup_s = time.perf_counter() - t_start
    harness.log(f"[train] rank {rank} set-up {setup_s:.3f} s, step {t_step * 1e3:.1f} ms "
                f"(losses {record['losses']})")

    def window():
        count = [0]

        def batches():
            t0 = time.perf_counter()
            i = SETUP_STEPS + count[0]
            while (count[0] < steps) if steps is not None else (time.perf_counter() - t0 <
                                                                args.seconds):
                count[0] += 1
                yield feed(pool[i % len(pool)])
                i += 1

        t0 = time.perf_counter()
        trainer.train_epoch(1, batches())
        program_.sync(dev)
        return count[0], time.perf_counter() - t0

    n_steps, wall = window()
    harness.log(f"[train] rank {rank}: {n_steps} steps in {wall:.3f} s")
    res = types.SimpleNamespace(cell=cell, config=cell.config, traffic=tr, trace=None,
                                breakdown=None, busy_s=None, window_s=None, steps=n_steps,
                                wall_s=wall, samples=n_steps * tr["batch"] * ranks,
                                traced_steps=0)
    if args.trace:
        with trace.traced() as holder, trace.window():
            res.traced_steps, _ = window()
        t = holder[0]
        res.trace, res.window_s, res.breakdown = t, t.window_s, t.breakdown()
        busy = t.busy_s()
        harness.log(f"[train] rank {rank}: traced {res.traced_steps} steps in {t.window_s:.3f} "
                    f"s, busy {busy:.3f} s")
    peak = program_.peak_bytes(dev)
    busy_all, peaks = [busy if args.trace else 0.0], [peak]
    if ranks > 1:
        gathered = [None] * ranks
        dist.all_gather_object(gathered, (busy_all[0], peak))
        busy_all, peaks = [g[0] for g in gathered], [g[1] for g in gathered]
        dist.destroy_process_group()
    close(trainer)
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank != 0:
        return None
    res.busy_s = sum(busy_all) / ranks if args.trace else None
    res.checks, res.correct = check_train(cell, args.seed, record, pool[:SETUP_STEPS], dev)
    res.attempted, res.failed = n_steps, 0
    res.end_to_end = {"train_samples_per_s": res.samples / wall, "setup_s": setup_s}
    res.device = (harness.device_info(ranks, max(peaks)) if dev.type == "cuda"
                  else {"platform": "cpu", "kind": "cpu", "count": ranks, "memory_peak_bytes": 0})
    return res
