"""The port's ``train``, ``test`` and ``profile`` commands on the CPU, at the
JAX CLI's defaults (AdaMVS scan form, float32) with the tiny flags of
tests/test_e2e.py, on a WHU_OMVS tree the JAX writer wrote:

- ``train`` writes what the JAX command writes (tests/test_e2e.py:35-53):
  checkpoints, ``metrics.jsonl`` with train and val records,
  ``train_record.txt``, and TensorBoard events whose scalar and image tags
  are the JAX Trainer's for the JAX train and eval steps' metrics;
- ``train --resume`` continues at the next epoch;
- ``test`` exports the maps (tests/test_e2e.py:56-73) and its metrics equal
  the last val record of the run it loads;
- ``profile`` writes a trace;
- the eval step's metrics on the trained weights against JAX
  ``make_eval_step`` on the same batch and weights;
- MS-REDNet trains through the command too; the flags the port does not
  take raise, naming their ROADMAP item."""

import json
import os
import struct

import jax
import numpy as np
import pytest
import torch

from adamvs_tpu.data.synthetic import write_whu_omvs_tree
from adamvs_tpu.models import AdaMVS as JAdaMVS
from adamvs_tpu.models import losses as jlosses
from adamvs_tpu.train.loop import make_eval_step as jmake_eval_step
from adamvs_tpu.train.loop import make_train_step as jmake_train_step
from adamvs_tpu.train.state import create_train_state as jcreate_train_state
from adamvs_tpu.train.state import make_optimizer as jmake_optimizer
from adamvs_tpu_torch.cli import main
from adamvs_tpu_torch.data.lists import build_sample_list
from adamvs_tpu_torch.data.pipeline import batch_train_samples, load_train_sample
from adamvs_tpu_torch.io.pfm import read_pfm
from adamvs_tpu_torch.models import AdaMVS, model_loss
from adamvs_tpu_torch.train.jax_import import from_jax_variables
from adamvs_tpu_torch.train.loop import make_eval_step, to_device
from adamvs_tpu_torch.train.state import create_train_state, make_optimizer

torch.set_num_threads(2)

TINY = ["--ndepths", "8,4", "--depth_inter_r", "4,2", "--cr_base_chs", "4,4", "--view_num", "3",
        "--dlossw", "0.5,1.0", "--device", "cpu"]
JCFG = dict(ndepths=(8, 4), depth_intervals_ratio=(4.0, 2.0), cr_base=(4, 4))
DLOSSW = (0.5, 1.0)


def _events(logdir: str) -> list:
    """Every TensorBoard event in ``logdir``'s event files (TFRecord frames:
    length, its CRC, the payload, its CRC)."""
    from tensorboardX.proto import event_pb2

    out = []
    for name in sorted(os.listdir(logdir)):
        if not name.startswith("events.out.tfevents"):
            continue
        data = open(os.path.join(logdir, name), "rb").read()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack_from("<Q", data, pos)
            ev = event_pb2.Event()
            ev.ParseFromString(data[pos + 12:pos + 12 + n])
            out.append(ev)
            pos += 12 + n + 4
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory, synthetic_scene):
    """A JAX-written tree, one epoch of training, a resumed second epoch,
    the test command and the profile command, with their outputs."""
    root = tmp_path_factory.mktemp("train_cli")
    tree = str(root / "whu")
    write_whu_omvs_tree(tree, synthetic_scene)
    logdir = str(root / "logs")
    train = ["train", *TINY, "--trainpath", tree, "--logdir", logdir, "--num_workers", "1",
             "--summary_freq", "1"]
    first = main(train + ["--epochs", "1"])
    events_first = _events(logdir)
    resumed = main(train + ["--epochs", "2", "--resume"])
    final = main(["test", *TINY, "--testpath", tree, "--logdir", logdir])
    trace = main(["profile", *TINY, "--testpath", tree, "--warmup", "1", "--iters", "2",
                  "--trace_dir", str(root / "trace")])
    return dict(tree=tree, logdir=logdir, first=first, resumed=resumed, final=final,
                trace=trace, events=events_first)


def test_train_writes_checkpoints_and_records(run):
    names = os.listdir(run["logdir"])
    assert any(n.startswith("model_000000_") and n.endswith(".ckpt") for n in names), names
    recs = [json.loads(ln) for ln in open(os.path.join(run["logdir"], "metrics.jsonl"))]
    assert any(r["kind"] == "train" for r in recs)
    vals = [r for r in recs if r["kind"] == "val"]
    assert len(vals) == 2 and np.isfinite(vals[-1]["abs_depth_error"])
    lines = open(os.path.join(run["logdir"], "train_record.txt")).read().splitlines()
    assert [ln.split()[0] for ln in lines] == ["0", "1"]
    assert len(run["first"].times["step_s"]) == 4 == len(run["first"].times["data_s"])


def test_resume_runs_the_next_epoch_only(run):
    assert run["resumed"].state.step == 8  # 4 steps per epoch, restored then continued
    assert any(n.startswith("model_000001_") for n in os.listdir(run["logdir"]))
    steps = [json.loads(ln)["step"] for ln in open(os.path.join(run["logdir"], "metrics.jsonl"))
             if json.loads(ln)["kind"] == "train"]
    assert steps == list(range(1, 9))


def test_tensorboard_tags_are_the_jax_trainers(run, synthetic_scene):
    """The scalar tags ``{kind}/{name}`` for the names of the JAX train
    step's metrics (from ``jax.eval_shape`` of ``make_train_step``) and of
    the JAX eval step's, and the three image tags, at every step."""
    specs = build_sample_list(run["tree"], "whu_omvs", 3)
    batch = batch_train_samples([load_train_sample(specs[0], mode="test")])
    jmodel = JAdaMVS(**JCFG)
    abstract = jax.eval_shape(lambda k: jmodel.init(k, batch["imgs"], batch["proj_matrices"],
                                                    batch["depth_values"]),
                              jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract)
    jstate = jcreate_train_state(jmodel, zeros, jmake_optimizer())
    _, train_metrics, _ = jax.eval_shape(
        jmake_train_step(jlosses.cas_mvs_vis_loss, DLOSSW), jstate, batch)
    eval_metrics, _, _ = jax.eval_shape(
        jmake_eval_step(jlosses.cas_mvs_vis_loss, DLOSSW, 2), jstate, batch)
    want = ({f"train/{k}" for k in train_metrics} | {f"val/{k}" for k in eval_metrics}
            | {"train/depth_est", "train/depth_gt", "train/errormap"})
    tags = {}
    for ev in run["events"]:
        for v in ev.summary.value:
            tags.setdefault(v.tag, []).append(ev.step)
    assert set(tags) == want
    for tag in ("train/loss", "train/depth_est"):
        assert tags[tag] == [1, 2, 3, 4]
    assert tags["val/abs_depth_error"] == [4]


def test_test_exports_and_restores(run):
    out_root = os.path.join(run["tree"], "depths_whu_omvs")
    vids = os.listdir(out_root)
    assert vids == ["images"]
    files = sorted(os.listdir(os.path.join(out_root, "images")))
    names = [f"view_{i:03d}" for i in range(4)]
    assert files == sorted([f"{n}{x}" for n in names for x in ("_init.pfm", "_prob.pfm", ".jpg")]
                           + ["color"])
    for n in names:
        depth, _ = read_pfm(os.path.join(out_root, "images", f"{n}_init.pfm"))
        assert depth.shape == (96, 128) and np.isfinite(depth).all()
    assert sorted(os.listdir(os.path.join(out_root, "images", "color"))) == sorted(
        f"{n}{x}" for n in names for x in ("_init.png", "_prob.png"))
    # the test command loads the latest checkpoint: its metrics are the last val record
    val = [json.loads(ln) for ln in open(os.path.join(run["logdir"], "metrics.jsonl"))][-1]
    for k, v in run["final"].items():
        assert abs(v - val[k]) <= 1e-5 * max(1.0, abs(v)), k


def test_profile_writes_a_trace(run):
    assert os.path.getsize(run["trace"]) > 0
    trace = json.load(open(run["trace"]))
    assert trace["traceEvents"]


def test_eval_step_matches_jax(run):
    """The eval step's metrics on one batch of the tree against JAX
    ``make_eval_step`` on the same batch and weights (the JAX init, carried
    to the port by ``from_jax_variables``): loss and errors within 1e-4
    relative, the threshold fractions within 1e-3 (a pixel at a threshold
    may fall on either side; one pixel of 48x64 is 3.3e-4), depth within
    1e-4 of the depth range."""
    specs = build_sample_list(run["tree"], "whu_omvs", 3)
    batch = batch_train_samples([load_train_sample(specs[2], mode="test")])
    jmodel = JAdaMVS(**JCFG)
    variables = jax.jit(lambda k: jmodel.init(k, batch["imgs"], batch["proj_matrices"],
                                              batch["depth_values"]))(jax.random.PRNGKey(0))
    jstate = jcreate_train_state(jmodel, variables, jmake_optimizer())
    want, jdepth, _ = jmake_eval_step(jlosses.cas_mvs_vis_loss, DLOSSW, 2)(jstate, batch)

    model = AdaMVS(**JCFG, sweep_impl="scan", reg_impl="scan")
    model.load_state_dict(from_jax_variables(variables))
    state = create_train_state(model, make_optimizer(model.parameters()))
    got, depth, _ = make_eval_step(model_loss("adamvs"), DLOSSW, 2)(
        state, to_device(batch, torch.device("cpu")))
    assert got.keys() == want.keys()
    for k in got:
        g, w = float(got[k]), float(want[k])
        limit = 1e-3 if k.startswith("thres") else 1e-4 * max(1.0, abs(w))
        assert abs(g - w) <= limit, (k, g, w)
    span = float(batch["depth_values"][0, 1] - batch["depth_values"][0, 0])
    assert np.abs(depth.numpy() - np.asarray(jdepth)).max() < 1e-4 * span


def test_msrednet_trains_through_the_command(tmp_path, synthetic_scene):
    tree = str(tmp_path / "whu")
    write_whu_omvs_tree(tree, synthetic_scene)
    logdir = str(tmp_path / "logs")
    trainer = main(["train", *TINY, "--model", "msrednet", "--trainpath", tree, "--logdir",
                    logdir, "--epochs", "1", "--num_workers", "1"])
    assert trainer.state.step == 4 and trainer.state.nan_steps == 0
    recs = [json.loads(ln) for ln in open(os.path.join(logdir, "metrics.jsonl"))]
    assert [r["kind"] for r in recs] == ["val"] and np.isfinite(recs[0]["abs_depth_error"])


@pytest.mark.parametrize("argv,item", [
    (["train", "--data_parallel", "2"], "parallel paths"),
    (["train", "--distributed"], "parallel paths"),
    # bf16 training runs (tests/test_torch_port_bf16_train.py); data parallelism does not
    (["train", "--compute_dtype", "bf16", "--data_parallel", "2"], "parallel paths"),
    (["test", "--distributed"], "parallel paths"),
], ids=["data_parallel", "distributed", "bf16", "test_distributed"])
def test_unported_train_flags_raise(tmp_path, synthetic_scene, argv, item):
    tree = str(tmp_path / "whu")
    write_whu_omvs_tree(tree, synthetic_scene)
    path = ["--trainpath", tree] if argv[0] == "train" else ["--testpath", tree]
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1") as err:
        main(argv[:1] + TINY + path + ["--logdir", str(tmp_path / "l")] + argv[1:])
    assert item in str(err.value)
