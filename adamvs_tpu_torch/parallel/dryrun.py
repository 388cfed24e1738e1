"""Multi-rank dry run of the port's parallel paths, on the CPU or on cards (the counterpart
of ``__graft_entry__.py::dryrun_multichip``):

    python -m adamvs_tpu_torch.parallel.dryrun [--ranks 4] [--timeout 600] [--device cpu]

starts ``--ranks`` processes on this machine (a free localhost port), one
nccl rank per card or, with ``--device cpu``, gloo ranks on the CPU, and
makes JAX's three checks at flagship-shaped stages (AdaMVS, ndepths
48/32/8, 256x64 frames, base 4, the scan form, seeded weights):

1. one ``Trainer`` epoch over JAX's mesh, (data=2, tile=ranks/2) for 4
   ranks or more, else (data=ranks, tile=1): one sample per data slice,
   with ``tile`` > 1 each rank holding one row band of its sample (256 rows
   over 2 bands: 128 a band), gives a finite loss equal to one process's on
   the global batch (within 1e-4 relative);
2. row bands (``predict/tiled.py``) against the unbanded forward: one band
   per rank with a 96-row halo (median |Δ| < 1e-3, 97 % within 1e-2), then
   two bands over pairs of ranks with a 128-row halo (max < 1e-2, median
   < 1e-4);
3. depth blocks (``AdaMVS(depth_shards=...)``) over up to 4 ranks against the
   unsharded forward: max |Δ| < 1e-3.

Each rank, and each collective, waits at most ``--timeout`` seconds. Exits
0 when every rank passed its checks.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..device import resolve_device

NDEPTHS = (48, 32, 8)
H, W, V = 256, 64, 3
CFG = dict(ndepths=NDEPTHS, depth_intervals_ratio=(4.0, 2.0, 1.0), base=4, cr_base=(4, 4, 4),
           sweep_impl="scan", reg_impl="scan")


def dummy_batch(B: int) -> tuple:
    """JAX's ``_dummy_batch``: random images, identity cameras with 0.1 x-offsets
    per view, depths [10, 20] with interval 0.2 ([B,3])."""
    imgs = np.random.RandomState(0).randn(B, V, H, W, 3).astype(np.float32)
    proj = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    for v in range(V):
        proj[:, v, 0, 3] = 0.1 * v
    projs = {}
    for k in (1, 2, 3):
        p = proj.copy()
        p[:, :, :2, :] /= 2 ** (3 - k)
        projs[f"stage{k}"] = p
    dv = np.tile(np.array([[10.0, 20.0, 0.2]], np.float32), (B, 1))
    return imgs, projs, dv


def train_batch(B: int) -> dict:
    imgs, projs, dv = dummy_batch(B)
    gt = np.random.RandomState(1).uniform(10, 20, (B, H, W)).astype(np.float32)
    return {"imgs": imgs, "proj_matrices": projs, "depth_values": dv,
            "depth": {"stage1": gt[:, ::4, ::4], "stage2": gt[:, ::2, ::2], "stage3": gt},
            "mask": {"stage1": np.ones((B, H // 4, W // 4), np.float32),
                     "stage2": np.ones((B, H // 2, W // 2), np.float32),
                     "stage3": np.ones((B, H, W), np.float32)},
            "depth_interval": np.full((B,), 0.2, np.float32)}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"dryrun check failed: {msg}")


def rank_main(rank: int, ranks: int, port: int, timeout_s: float, device: str) -> None:
    import torch.distributed as dist

    from ..models import build_model, model_loss
    from ..predict.tiled import tiled_forward
    from ..train.loop import Trainer
    from ..train.state import create_train_state, make_optimizer
    from .distributed import initialize_distributed
    from .mesh import make_mesh, shard_batch

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // ranks))
    initialize_distributed(f"localhost:{port}", ranks, rank,
                           backend="nccl" if device == "cuda" else "gloo", timeout_s=timeout_s)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device(
        "cpu")
    say = print if rank == 0 else (lambda *a: None)

    def model(**kw):
        return build_model("adamvs", seed=0, device=dev, **CFG, **kw)

    # 1. Trainer epoch over JAX's dry-run mesh against one process on the global batch
    data, tile = (2, ranks // 2) if ranks >= 4 else (ranks, 1)
    batch = train_batch(data)
    mesh = make_mesh(data=data, tile=tile)
    with tempfile.TemporaryDirectory() as tmp:
        m = model()
        state = create_train_state(m, make_optimizer(m.parameters(), lr=1e-3))
        tr = Trainer(state, model_loss("adamvs"), tmp, num_stages=3, ckpt_step_freq=0,
                     log_fn=lambda s: None, device=dev, mesh=mesh)
        loss = tr.train_epoch(0, [shard_batch(batch, mesh)])["loss"]
    check(np.isfinite(loss), f"non-finite data-parallel loss {loss}")
    if rank == 0:
        with tempfile.TemporaryDirectory() as tmp:
            m = model()
            state = create_train_state(m, make_optimizer(m.parameters(), lr=1e-3))
            tr = Trainer(state, model_loss("adamvs"), tmp, num_stages=3, ckpt_step_freq=0,
                         log_fn=lambda s: None, device=dev)
            loss1 = tr.train_epoch(0, [batch])["loss"]
        check(abs(loss - loss1) < 1e-4 * max(1.0, abs(loss1)), f"loss {loss} vs {loss1}")
        say(f"Trainer epoch OK: mesh=(data={data}, tile={tile}) of {device} ranks, "
            f"ndepths={NDEPTHS}, {H}x{W} ({H // tile} rows a band), loss={loss:.6f} (one process "
            f"{loss1:.6f}, Δ={abs(loss - loss1):.2e})")
    dist.barrier()

    # 2. row bands against the unbanded forward
    imgs, projs, dv = dummy_batch(1)
    imgs, dv = torch.from_numpy(imgs).to(dev), torch.from_numpy(dv[:, :2].copy()).to(dev)
    projs = {k: torch.from_numpy(v).to(dev) for k, v in projs.items()}
    m = model()
    depth_ref = m(imgs, projs, dv, num_depth=16)["depth"]
    bands = make_mesh(data=1, tile=ranks)
    depth, _ = tiled_forward(m, imgs, projs, dv, ranks, num_depth=16, halo=96,
                             group=bands.tile_group)
    err = (depth - depth_ref).abs().cpu().numpy()
    check(np.median(err) < 1e-3 and (err < 1e-2).mean() > 0.97,
          f"bands deviate: median {np.median(err)}, within 1e-2 {(err < 1e-2).mean()}")
    say(f"row bands OK: {ranks} bands over {ranks} ranks, halo 96, median|Δ| vs unbanded "
        f"{np.median(err):.2e}")
    if ranks % 2 == 0:
        pairs = make_mesh(data=ranks // 2, tile=2)
        depth2, _ = tiled_forward(m, imgs, projs, dv, 2, num_depth=16, halo=128,
                                  group=pairs.tile_group)
        err2 = (depth2 - depth_ref).abs().cpu().numpy()
        check(err2.max() < 1e-2 and np.median(err2) < 1e-4,
              f"large-halo bands deviate: max {err2.max()}, median {np.median(err2)}")
        say(f"row bands (halo >= receptive field) OK: 2 bands over pairs of ranks, halo 128, "
            f"max|Δ| {err2.max():.2e}, median|Δ| {np.median(err2):.2e}")

    # 3. depth blocks against the unsharded forward
    k = min(4, ranks)
    group = dist.new_group(list(range(k)))
    if rank < k:
        out = model(depth_shards=k, depth_group=group)(imgs, projs, dv, num_depth=16)
        derr = (out["depth"] - depth_ref).abs().max().item()
        check(derr < 1e-3, f"depth blocks deviate: max {derr}")
        say(f"depth blocks OK: {k} blocks over {k} ranks, max|Δ| vs unsharded {derr:.2e}")
    dist.barrier()
    say(f"dryrun OK: {ranks} {device} ranks over {dist.get_backend()}")
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds each rank, and each collective, may take")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                   help="cuda: one nccl rank per card (raises without enough cards); "
                        "cpu: gloo ranks")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    resolve_device(args.device)
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        raise RuntimeError(f"{args.ranks} nccl ranks need {args.ranks} cards, "
                           f"{torch.cuda.device_count()} found; pass --device cpu for gloo ranks")
    if args.rank is not None:
        rank_main(args.rank, args.ranks, args.port, args.timeout, args.device)
        return 0
    port = free_port()
    cmd = [sys.executable, "-m", "adamvs_tpu_torch.parallel.dryrun", "--ranks", str(args.ranks),
           "--port", str(port), "--timeout", str(args.timeout), "--device", args.device]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [q for q in os.environ.get("PYTHONPATH", "").split(os.pathsep) if q]))
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(args.ranks)]
    failed = False
    try:
        for r, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=args.timeout + 60)
            if proc.returncode != 0:
                failed = True
                print(f"--- rank {r} exited {proc.returncode}:\n{out[-4000:]}", flush=True)
            elif r == 0:
                print(out, end="", flush=True)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
