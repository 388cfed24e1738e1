"""Data-parallel training of the port over two gloo processes on the CPU
(the port's counterpart of tests/test_multihost.py::
test_two_process_data_parallel_training).

The global batch of 2 has uneven masks (half of one sample's pixels are
masked out) and the model trains with BatchNorm in train mode, so a step
that averaged per-rank losses or normalised with per-rank statistics would
differ from one process on the global batch. Each rank takes its contiguous
slice (``parallel.shard_batch``) and the ``Trainer`` runs over the data
group; the loss must be equal on both ranks and equal one process's on the
global batch, and so must the parameters and BatchNorm statistics after the
step (the JAX test compares the loss only: a gradient off by the world size
leaves the loss as it is). That one process's loss is held to JAX's
``Trainer`` on the same global batch and weights."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from adamvs_tpu.models import AdaMVS as JAdaMVS
from adamvs_tpu.models import cas_mvs_vis_loss as jcas_mvs_vis_loss
from adamvs_tpu.train import Trainer as JTrainer
from adamvs_tpu.train import create_train_state as jcreate_train_state
from adamvs_tpu.train import make_optimizer as jmake_optimizer
from adamvs_tpu.train.torch_import import import_adamvs_state_dict
from adamvs_tpu_torch.models import AdaMVS, model_loss
from adamvs_tpu_torch.nn.blocks import init_parameters
from adamvs_tpu_torch.parallel.dryrun import free_port
from adamvs_tpu_torch.parallel.mesh import Mesh, shard_batch
from adamvs_tpu_torch.train.loop import Trainer
from adamvs_tpu_torch.train.state import create_train_state, make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(ndepths=(8, 4, 4), depth_intervals_ratio=(4.0, 2.0, 1.0), base=4, cr_base=(4, 4, 4))
DLOSSW = (0.5, 1.0, 2.0)
B, V, H, W = 2, 3, 32, 64
# seconds: each worker process, and each collective inside it
PROC_TIMEOUT, GLOO_TIMEOUT = 240, 60

WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)
    from adamvs_tpu_torch.models import AdaMVS, model_loss
    from adamvs_tpu_torch.parallel import initialize_distributed, make_mesh, shard_batch
    from adamvs_tpu_torch.train.loop import Trainer
    from adamvs_tpu_torch.train.state import create_train_state, make_optimizer

    pid = int(sys.argv[1])
    initialize_distributed({coord!r}, 2, pid, backend="gloo", timeout_s={gloo})
    case = torch.load({case!r}, weights_only=False)
    model = AdaMVS(**case["cfg"])
    model.load_state_dict(case["state"] if pid == 0 else case["other_state"])
    mesh = make_mesh(data=2)
    state = create_train_state(model, make_optimizer(model.parameters(), lr=1e-3))
    tr = Trainer(state, model_loss("adamvs"), {out!r} + f"/log{{pid}}", dlossw={dlossw},
                 num_stages=3, summary_freq=1, ckpt_step_freq=0, log_fn=lambda m: None,
                 device="cpu", mesh=mesh)
    loss = tr.train_epoch(0, [shard_batch(case["batch"], mesh)])["loss"]
    torch.save({{"state": model.state_dict(),
                "grads": {{k: p.grad for k, p in model.named_parameters() if p.grad is not None}}}},
               {out!r} + f"/state{{pid}}.pt")
    print("RESULT" + json.dumps({{"pid": pid, "loss": loss}}))
""")


def run_workers(script: str, n: int, cwd: str) -> list[str]:
    """Run ``script`` in ``n`` processes (argument: the rank), each bounded
    by ``PROC_TIMEOUT``; returns their outputs, failing on any exit code but
    0. A process still running at its limit is killed with the others."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "JAX_COORDINATOR",
                        "NUM_PROCESSES", "PROCESS_ID")}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=cwd)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=PROC_TIMEOUT)
            outs.append(stdout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, stdout in zip(procs, outs):
        assert p.returncode == 0, stdout[-4000:]
    return outs


def results(outs: list[str]) -> dict:
    got = {}
    for stdout in outs:
        line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT")][0]
        d = json.loads(line[len("RESULT"):])
        got[d["pid"]] = d
    return got


def global_batch(H: int = H) -> dict:
    """Two samples at 32x64 (or ``H`` rows), V=3, with x-baselines, three stages; sample 1
    has its mask zero on the left half of every stage."""
    rng = np.random.RandomState(0)
    imgs = rng.randn(B, V, H, W, 3).astype(np.float32)
    proj = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    proj[:, :, 0, 0] = proj[:, :, 1, 1] = 40.0
    proj[:, :, 0, 2], proj[:, :, 1, 2] = W / 2, H / 2
    for v in range(V):
        proj[:, v, 0, 3] = 40.0 * 0.5 * v
    projs = {}
    for k in (1, 2, 3):
        p = proj.copy()
        p[:, :, :2, :] /= 2 ** (3 - k)
        projs[f"stage{k}"] = p
    gt = rng.uniform(12, 18, (B, H, W)).astype(np.float32)
    mask = np.ones((B, H, W), np.float32)
    mask[1, :, : W // 2] = 0.0
    return {
        "imgs": imgs, "proj_matrices": projs,
        "depth_values": np.tile(np.array([[10.0, 20.0, 1.0]], np.float32), (B, 1)),
        "depth": {"stage1": gt[:, ::4, ::4].copy(), "stage2": gt[:, ::2, ::2].copy(), "stage3": gt},
        "mask": {"stage1": mask[:, ::4, ::4].copy(), "stage2": mask[:, ::2, ::2].copy(),
                 "stage3": mask},
        "depth_interval": np.full((B,), 1.0, np.float32),
    }


def _port_model():
    model = AdaMVS(**CFG, sweep_impl="scan", reg_impl="scan")
    init_parameters(model, torch.Generator().manual_seed(0))
    return model


def _single(model, batch, logdir):
    state = create_train_state(model, make_optimizer(model.parameters(), lr=1e-3))
    tr = Trainer(state, model_loss("adamvs"), logdir, dlossw=DLOSSW, num_stages=3,
                 ckpt_step_freq=0, log_fn=lambda m: None, device="cpu")
    return tr.train_epoch(0, [batch])["loss"]


@pytest.fixture(scope="module")
def dp_case(tmp_path_factory):
    """The two ranks' losses and states after one step, and one process's
    on the global batch, from the same weights. Rank 1 starts from other
    weights: the Trainer must broadcast rank 0's."""
    root = tmp_path_factory.mktemp("dp")
    batch = global_batch()
    model = _port_model()
    other = AdaMVS(**CFG, sweep_impl="scan", reg_impl="scan")
    init_parameters(other, torch.Generator().manual_seed(1))
    case = str(root / "case.pt")
    torch.save({"cfg": dict(CFG, sweep_impl="scan", reg_impl="scan"), "state": model.state_dict(),
                "other_state": other.state_dict(), "batch": batch}, case)
    script = WORKER.format(repo=REPO, dlossw=DLOSSW, coord=f"localhost:{free_port()}", gloo=GLOO_TIMEOUT,
                           case=case, out=str(root))
    got = results(run_workers(script, 2, REPO))
    single = _port_model()
    loss1 = _single(single, batch, str(root / "single"))
    ranks = [torch.load(str(root / f"state{r}.pt")) for r in (0, 1)]
    grads = {k: p.grad for k, p in single.named_parameters() if p.grad is not None}
    return dict(got=got, loss1=loss1, single=single.state_dict(), grads=grads, root=root,
                states=[r["state"] for r in ranks], rank_grads=[r["grads"] for r in ranks],
                batch=batch)


def test_data_parallel_loss_matches_one_process(dp_case):
    got, loss1 = dp_case["got"], dp_case["loss1"]
    l0, l1 = got[0]["loss"], got[1]["loss"]
    assert abs(l0 - l1) <= 1e-6 * abs(l0), (l0, l1)
    assert abs(l0 - loss1) <= 1e-6 * abs(loss1), (l0, loss1)


def _rel_l2(got: dict, want: dict) -> float:
    g = torch.cat([got[k].flatten() for k in want])
    w = torch.cat([want[k].flatten() for k in want])
    return float((g - w).norm() / w.norm())


def test_data_parallel_gradient_matches_one_process(dp_case):
    """Each rank's gradient after the averaging, as one process's on the
    global batch, within 1e-3 relative L2: an AdaMVS gradient moves under
    float32 rounding alone, where a ReLU input within rounding of 0 flips
    (``chip_smoke.py --probe-parallel`` measures it); a gradient not divided
    by the 2 ranks lies 1.0 from it."""
    want = dp_case["grads"]
    for r, grads in enumerate(dp_case["rank_grads"]):
        assert grads.keys() == want.keys()
        rel = _rel_l2(grads, want)
        assert rel < 1e-3, f"rank {r}: gradient rel L2 {rel:.2e}"


def test_data_parallel_parameters_match_one_process(dp_case):
    """Parameters and BatchNorm statistics after the step, both ranks, as
    one process's on the global batch, up to what their gradients' rounding
    moves: RMSprop's first step is -lr g / (sqrt(1 - alpha) |g| + eps),
    about 3e-3 for a gradient well above eps = 1e-8, but a gradient of about
    eps (the regulariser heads' biases shift every depth's cost alike and get
    a gradient of about 0) turns rounding into up to 3e-3. So each rank's
    parameters, less one process's, must equal that step of the rank's
    gradient less that step of one process's gradient, within float32
    rounding; with the gradient check this holds the update exactly."""
    want, grads = dp_case["single"], dp_case["grads"]

    def step(g):
        return -1e-3 * g / ((0.1 * g * g).sqrt() + 1e-8)

    for r, (state, rgrads) in enumerate(zip(dp_case["states"], dp_case["rank_grads"])):
        for k, v in want.items():
            if k in grads:
                expect = step(rgrads[k]) - step(grads[k])
                torch.testing.assert_close(state[k] - v, expect, rtol=0, atol=1e-6,
                                           msg=lambda m: f"rank {r} {k}: {m}")
            elif v.is_floating_point():
                torch.testing.assert_close(state[k], v, rtol=1e-5, atol=1e-5,
                                           msg=lambda m: f"rank {r} {k}: {m}")
            else:
                assert torch.equal(state[k], v), (r, k)
    start = _port_model().state_dict()
    names = [k for k, _ in _port_model().named_parameters()]
    moved = [k for k in names if not torch.equal(start[k], want[k])]
    assert len(moved) > 0.9 * len(names)


def test_data_parallel_writes_records_on_rank_zero_only(dp_case):
    root = dp_case["root"]
    assert os.path.exists(root / "log0" / "metrics.jsonl")
    assert not os.path.exists(root / "log1" / "metrics.jsonl")


def test_one_process_loss_matches_jax_trainer(dp_case, tmp_path):
    """The port's one-process step on the global batch against JAX's
    ``Trainer`` on the same batch and weights (uneven masks, train-mode
    BatchNorm; the limit of tests/test_torch_port_train.py's loss check)."""
    batch = dp_case["batch"]
    model = _port_model()
    jmodel = JAdaMVS(**CFG)
    abstract = jax.eval_shape(lambda k: jmodel.init(k, batch["imgs"], batch["proj_matrices"],
                                                    batch["depth_values"]),
                              jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract)
    variables, _ = import_adamvs_state_dict(model.state_dict(), zeros)
    jtr = JTrainer(jmodel, jcas_mvs_vis_loss, jcreate_train_state(jmodel, variables,
                                                                  jmake_optimizer(lr=1e-3)),
                   str(tmp_path / "jax"), dlossw=DLOSSW, num_stages=3,
                   log_fn=lambda *a: None, ckpt_step_freq=0)
    jloss = jtr.train_epoch(0, [batch])["loss"]
    loss1 = dp_case["loss1"]
    assert abs(loss1 - jloss) <= 1e-5 * abs(jloss), (loss1, jloss)


def test_shard_batch_takes_contiguous_slices():
    """Without a process group this process is rank 0: the first half of the
    batch over data; over (data=1, tile=2) the first half of the rows of
    every view and of each stage's depth and mask (64 rows: bands of 32)."""
    batch = global_batch()
    cut = shard_batch(batch, Mesh(2, 1))
    np.testing.assert_array_equal(cut["imgs"], batch["imgs"][:1])
    np.testing.assert_array_equal(cut["mask"]["stage2"], batch["mask"]["stage2"][:1])
    batch = global_batch(64)
    cut = shard_batch(batch, Mesh(1, 2))
    np.testing.assert_array_equal(cut["imgs"], batch["imgs"][:, :, :32])
    for key in ("depth", "mask"):
        for k, v in batch[key].items():
            np.testing.assert_array_equal(cut[key][k], v[:, :v.shape[1] // 2])
    for k, v in batch["proj_matrices"].items():
        np.testing.assert_array_equal(cut["proj_matrices"][k], v)
    np.testing.assert_array_equal(cut["depth_values"], batch["depth_values"])
