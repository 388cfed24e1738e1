"""Command line of the port (counterpart of adamvs_tpu/cli.py): ``train``,
``test``, ``predict`` and ``profile``, with the JAX CLI's flags and defaults
(cli.py:40-67, 352-440):

    python -m adamvs_tpu_torch.cli train   --trainpath ... [--testpath ...] --logdir ...
    python -m adamvs_tpu_torch.cli test    --testpath ... [--loadckpt ... | --logdir ...]
    python -m adamvs_tpu_torch.cli predict --data_folder ... --output_folder ... [--loadckpt ...]
    python -m adamvs_tpu_torch.cli profile --testpath ... [--warmup 5 --iters 5 --trace_dir ...]

Every command runs on the CUDA card unless ``--device`` names another device
(the counterpart of the JAX side's ``JAX_PLATFORMS``); with no card and no
``--device cpu`` it raises. Checkpoints are the reference-layout ``.ckpt``
files of ``train/checkpoint.py``, not orbax directories. ``profile`` writes
a ``torch.profiler`` Chrome trace (``trace.json``) under ``--trace_dir``.
``--compute_dtype bf16`` trains with float32 master weights and bf16
compute (flax's ``dtype=bf16``): parameters, optimizer state and checkpoints
stay float32, so a checkpoint of a bf16 run loads into a float32 one and the
other way round; ``test``, ``profile`` and ``predict`` cast the parameters to
bf16 once. ``--distributed``, ``--data_parallel`` other than 1 and
``--tiles`` above 1 are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .config import (
    REG_IMPLS,
    SWEEP_IMPLS,
    WARP_IMPLS,
    DataConfig,
    ModelConfig,
    PredictConfig,
    TrainConfig,
    not_ported,
    parse_float_list,
    parse_int_list,
)

PARALLEL = "parallel paths"


def _add_model_flags(p: argparse.ArgumentParser):
    p.add_argument("--model", default="adamvs", choices=sorted(REG_IMPLS))
    p.add_argument("--ndepths", default="48,32,8")
    p.add_argument("--depth_inter_r", default="4,2,1")
    p.add_argument("--cr_base_chs", default="8,8,8")
    p.add_argument("--share_cr", action="store_true")
    p.add_argument("--warp_impl", default="gather", choices=list(WARP_IMPLS),
                   help="every choice samples exactly, through the port's bilinear "
                        "sampler kernel; pallas2bf16 with --compute_dtype f32 rounds the scan "
                        "form's source features to bf16 and samples them into float32")
    p.add_argument("--sweep_impl", default="scan", choices=list(SWEEP_IMPLS),
                   help="scan: per-hypothesis warps inside the recurrence; fused: one "
                        "plane-sweep kernel per stage (fusedf32 is the same in the port, "
                        "whose sweeps sample in float32)")
    p.add_argument("--reg_impl", default="scan", choices=["scan", "pallas", "precomp"],
                   help="scan: the recurrent regulariser stepped per depth slice; pallas "
                        "(adamvs, needs --sweep_impl fused): the whole recurrence in one "
                        "kernel per stage; precomp (needs --sweep_impl fused): the "
                        "input-side convolutions batched over chunks of depths. pallas "
                        "and precomp are inference forms: training steps the regulariser")
    p.add_argument("--compute_dtype", default="f32", choices=["f32", "bf16"],
                   help="bf16: train with float32 master weights and bf16 compute; "
                        "test, profile and predict in bf16")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host runs are not ported yet")
    p.add_argument("--device", default="cuda",
                   help="the torch device to run on (default cuda; cpu runs the plain "
                        "PyTorch path)")


def _add_data_flags(p: argparse.ArgumentParser):
    p.add_argument("--set_name", default="whu_omvs")
    p.add_argument("--view_num", type=int, default=5)
    p.add_argument("--interval_scale", type=float, default=1.0)
    p.add_argument("--dlossw", default="0.5,1.0,2.0")
    p.add_argument("--batch_size", type=int, default=1)


def _model_config(args) -> ModelConfig:
    return ModelConfig(
        model=args.model,
        ndepths=parse_int_list(args.ndepths),
        depth_intervals_ratio=parse_float_list(args.depth_inter_r),
        cr_base_chs=parse_int_list(args.cr_base_chs),
        share_cr=args.share_cr,
        warp_impl=args.warp_impl,
        sweep_impl=args.sweep_impl,
        reg_impl=args.reg_impl,
        dtype=args.compute_dtype,
    )


def _data_config(args, **kw) -> DataConfig:
    return DataConfig(set_name=args.set_name, view_num=args.view_num,
                      interval_scale=args.interval_scale, batch_size=args.batch_size, **kw)


def _build(args, mc: ModelConfig, train: bool = False):
    """(device, model) of an evaluating or (``train``) a training command."""
    from .device import resolve_device

    if args.distributed:
        raise not_ported("--distributed", PARALLEL)
    device = resolve_device(args.device)
    return device, mc.build(device=device, seed=0, train=train)


def cmd_train(args):
    """Train for ``--epochs`` epochs from a fresh, resumed or loaded state,
    evaluating on the test split after each; returns the ``Trainer``."""
    from .data.lists import build_sample_list
    from .data.loader import batch_iterator
    from .models import model_loss
    from .train.loop import Trainer
    from .train.state import create_train_state, make_lr_schedule, make_optimizer, parse_lrepochs

    if args.data_parallel != 1:
        raise not_ported("--data_parallel other than 1", PARALLEL)
    data = _data_config(args, trainpath=args.trainpath, testpath=args.testpath or args.trainpath,
                        num_workers=args.num_workers)
    mc = _model_config(args)
    tc = TrainConfig(
        epochs=args.epochs, lr=args.lr, lrepochs=args.lrepochs, wd=args.wd,
        summary_freq=args.summary_freq, save_freq=args.save_freq, seed=args.seed,
        logdir=args.logdir, resume=args.resume, loadckpt=args.loadckpt,
        dlossw=parse_float_list(args.dlossw),
    )
    train_specs = build_sample_list(data.trainpath, data.set_name, data.view_num)
    test_specs = build_sample_list(data.testpath, data.set_name, data.view_num)
    steps_per_epoch = max(1, len(train_specs) // data.batch_size)
    device, model = _build(args, mc, train=True)
    milestones, gamma = parse_lrepochs(tc.lrepochs)
    state = create_train_state(
        model, make_optimizer(model.parameters(), lr=tc.lr, weight_decay=tc.wd),
        make_lr_schedule(tc.lr, milestones, gamma, steps_per_epoch))
    trainer = Trainer(state, model_loss(mc.model), tc.logdir, dlossw=tc.dlossw,
                      num_stages=len(mc.ndepths), summary_freq=tc.summary_freq,
                      save_freq=tc.save_freq, device=device)
    start_epoch = 0
    if tc.resume:
        start_epoch = trainer.resume()
    elif tc.loadckpt:
        trainer.load(tc.loadckpt)
    try:
        for epoch in range(start_epoch, tc.epochs):
            train_batches = batch_iterator(
                train_specs, data.batch_size, "train", shuffle=True, seed=tc.seed,
                num_workers=data.num_workers, interval_scale=data.interval_scale, epoch=epoch,
            )
            trainer.train_epoch(epoch, train_batches)
            val_batches = batch_iterator(
                test_specs, data.batch_size, "test", shuffle=False, seed=tc.seed,
                num_workers=data.num_workers, interval_scale=data.interval_scale,
                drop_last=False,
            )
            val = trainer.eval_epoch(epoch, val_batches)
            print(f"epoch {epoch} val: {val}")
            trainer.end_epoch(epoch, val)
    finally:
        trainer.close()
    return trainer


def _eval_state(args, mc: ModelConfig, ckpt: str):
    """(device, train state) of ``mc``'s model for evaluation, with the
    checkpoint ``ckpt`` restored when given."""
    from .train.checkpoint import restore_checkpoint
    from .train.state import create_train_state, make_optimizer

    device, model = _build(args, mc)
    state = create_train_state(model, make_optimizer(model.parameters()))
    if ckpt:
        restore_checkpoint(ckpt, state)
        print(f"loaded {ckpt}")
    return device, state


def cmd_test(args):
    """Evaluate on the test split and export each sample's depth,
    confidence, image and previews under ``{testpath}/depths_{set_name}/``
    (the reference's test(), train_whu.py:213-262); returns the mean
    metrics."""
    from PIL import Image

    from .data.lists import build_sample_list
    from .data.pipeline import batch_train_samples, load_train_sample
    from .io.pfm import write_pfm
    from .models import model_loss
    from .predict.engine import colorize_depth, colorize_prob
    from .train.checkpoint import latest_checkpoint
    from .train.loop import AverageMeter, make_eval_step, to_device

    data = _data_config(args, testpath=args.testpath)
    mc = _model_config(args)
    specs = build_sample_list(data.testpath, data.set_name, data.view_num)
    device, state = _eval_state(args, mc, args.loadckpt or latest_checkpoint(args.logdir))
    estep = make_eval_step(model_loss(mc.model), parse_float_list(args.dlossw), len(mc.ndepths))
    out_root = os.path.join(data.testpath, f"depths_{data.set_name}")
    meter = AverageMeter()
    bs = max(1, data.batch_size)
    for i0 in range(0, len(specs), bs):
        group = specs[i0:i0 + bs]
        samples = [load_train_sample(sp, mode="test", interval_scale=data.interval_scale)
                   for sp in group]
        t0 = time.time()
        metrics, depth, prob = estep(state, to_device(batch_train_samples(samples), device))
        scalars = {k: float(v) for k, v in metrics.items()}
        meter.update(scalars)
        print(f"Iter {i0}/{len(specs)} (batch {len(group)}), time={time.time() - t0:.3f}s, "
              f"{scalars}")
        depth, prob = depth.float().cpu().numpy(), prob.float().cpu().numpy()
        for j, s in enumerate(samples):
            folder = os.path.join(out_root, s.vid)
            os.makedirs(os.path.join(folder, "color"), exist_ok=True)
            d, p = np.float32(depth[j]), np.float32(prob[j])
            write_pfm(os.path.join(folder, f"{s.name}_init.pfm"), d)
            write_pfm(os.path.join(folder, f"{s.name}_prob.pfm"), p)
            Image.fromarray(s.out_image).save(os.path.join(folder, f"{s.name}.jpg"))
            Image.fromarray(colorize_depth(d)).save(
                os.path.join(folder, "color", f"{s.name}_init.png"))
            Image.fromarray(colorize_prob(p)).save(
                os.path.join(folder, "color", f"{s.name}_prob.png"))
    final = meter.mean()
    print("final:", final)
    return final


def cmd_profile(args):
    """``--warmup`` eval steps, then ``--iters`` eval steps under
    ``torch.profiler`` (CPU and, on the card, CUDA activities), written as a
    Chrome trace to ``{trace_dir}/trace.json`` (the reference's profile(),
    train_whu.py:345-373); returns the trace's path."""
    from .data.lists import build_sample_list
    from .data.loader import batch_iterator
    from .models import model_loss
    from .train.loop import make_eval_step, to_device

    data = _data_config(args, testpath=args.testpath)
    mc = _model_config(args)
    specs = build_sample_list(data.testpath, data.set_name, data.view_num)
    device, state = _eval_state(args, mc, "")
    estep = make_eval_step(model_loss(mc.model), parse_float_list(args.dlossw), len(mc.ndepths))
    batches = list(batch_iterator(specs, data.batch_size, "test", shuffle=False,
                                  drop_last=False, num_workers=2))

    def run(i: int, tag: str):
        t0 = time.time()
        _, depth, _ = estep(state, to_device(batches[i % len(batches)], device))
        float(depth.sum())  # waits for the device
        print(f"{tag} {i}: {time.time() - t0:.4f}s")

    for i in range(min(args.warmup, len(batches))):
        run(i, "warmup")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        for i in range(args.iters):
            run(i, "profile")
    os.makedirs(args.trace_dir, exist_ok=True)
    path = os.path.join(args.trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"trace written to {path} (open with Perfetto or chrome://tracing)")
    return path


def cmd_predict(args):
    """Predict every work item of ``--data_folder`` into ``--output_folder``;
    returns the ``PredictEngine`` (its feature-cache counts)."""
    from .data.lists import build_predict_list
    from .device import resolve_device
    from .predict.engine import PredictEngine

    if args.distributed:
        raise not_ported("--distributed", PARALLEL)
    if args.tiles > 1:
        raise not_ported("--tiles > 1", PARALLEL)
    device = resolve_device(args.device)
    pc = PredictConfig(
        data_folder=args.data_folder, output_folder=args.output_folder,
        loadckpt=args.loadckpt, view_num=args.view_num, numdepth=args.numdepth,
        max_w=args.max_w, max_h=args.max_h, resize_scale=args.resize_scale,
        sample_scale=args.sample_scale, display=args.display,
    )
    model = _model_config(args).build(device=device, seed=0)
    if pc.loadckpt:
        ckpt = torch.load(pc.loadckpt, map_location=device, weights_only=True)
        model.load_state_dict(ckpt["model"])
        print(f"loaded {pc.loadckpt}")
    source = build_predict_list(pc.data_folder, pc.view_num)
    engine = PredictEngine(model, num_depth=pc.numdepth, device=device,
                           feature_cache=args.feature_cache)
    engine.run(
        source, pc.output_folder, display=pc.display,
        load_kwargs=dict(resize_scale=pc.resize_scale, max_h=pc.max_h, max_w=pc.max_w,
                         sample_scale=pc.sample_scale),
        batch_size=args.predict_batch,
    )
    return engine


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="adamvs_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train")
    _add_model_flags(pt)
    _add_data_flags(pt)
    pt.add_argument("--dataset", default="cas_total_rscv")
    pt.add_argument("--trainpath", required=True)
    pt.add_argument("--testpath", default="")
    pt.add_argument("--logdir", default="./checkpoints/run")
    pt.add_argument("--loadckpt", default="", help="a .ckpt file to start from")
    pt.add_argument("--resume", action="store_true",
                    help="continue from the latest .ckpt in --logdir")
    pt.add_argument("--min_interval", type=float, default=0.1)
    pt.add_argument("--epochs", type=int, default=80)
    pt.add_argument("--lr", type=float, default=1e-3)
    pt.add_argument("--lrepochs", default="10,12,14:2")
    pt.add_argument("--wd", type=float, default=0.0)
    pt.add_argument("--summary_freq", type=int, default=50)
    pt.add_argument("--save_freq", type=int, default=1)
    pt.add_argument("--seed", type=int, default=1,
                    help="the loader's shuffle and augmentation; the weights are drawn "
                         "from seed 0 by the port's initialiser")
    pt.add_argument("--num_workers", type=int, default=2)
    pt.add_argument("--data_parallel", type=int, default=1,
                    help="data parallelism over several devices: not ported yet (only 1)")
    pt.set_defaults(fn=cmd_train)

    pe = sub.add_parser("test")
    _add_model_flags(pe)
    _add_data_flags(pe)
    pe.add_argument("--dataset", default="cas_total_rscv")
    pe.add_argument("--testpath", required=True)
    pe.add_argument("--logdir", default="./checkpoints/run",
                    help="its latest .ckpt is loaded unless --loadckpt names one")
    pe.add_argument("--loadckpt", default="")
    pe.set_defaults(fn=cmd_test)

    pp = sub.add_parser("predict")
    _add_model_flags(pp)
    pp.add_argument("--data_folder", required=True)
    pp.add_argument("--output_folder", required=True)
    pp.add_argument("--loadckpt", default="",
                    help="a .ckpt file in the reference layout (the port's "
                         "train/checkpoint.py writes it), not an orbax directory; weights "
                         "only. Without it the weights are drawn from seed 0 by the port's "
                         "initialiser, which differ from the JAX CLI's PRNGKey(0) init")
    pp.add_argument("--view_num", type=int, default=5)
    pp.add_argument("--numdepth", type=int, default=192)
    pp.add_argument("--max_w", type=int, default=3712)
    pp.add_argument("--max_h", type=int, default=5504)
    pp.add_argument("--min_interval", type=float, default=0.1)
    pp.add_argument("--resize_scale", type=float, default=0.5)
    pp.add_argument("--sample_scale", type=float, default=1.0)
    pp.add_argument("--interval_scale", type=float, default=1.0)
    pp.add_argument("--display", type=lambda s: s.lower() != "false", default=True)
    pp.add_argument("--feature_cache", type=int, default=0,
                    help="LRU size (in images) of the on-device feature cache; each "
                         "aerial image is a source view in several work items. 0 = off.")
    pp.add_argument("--predict_batch", type=int, default=1,
                    help="frames per forward")
    pp.add_argument("--tiles", type=int, default=1,
                    help="row bands over several devices: not ported yet (only 1)")
    pp.set_defaults(fn=cmd_predict)

    pf = sub.add_parser("profile")
    _add_model_flags(pf)
    _add_data_flags(pf)
    pf.add_argument("--testpath", required=True)
    pf.add_argument("--warmup", type=int, default=5)
    pf.add_argument("--iters", type=int, default=5)
    pf.add_argument("--trace_dir", default="./profile_trace")
    pf.set_defaults(fn=cmd_profile)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
