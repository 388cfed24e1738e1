"""Command line of the port (counterpart of adamvs_tpu/cli.py): ``predict``,
with the JAX CLI's predict flags and defaults (cli.py:40-67, 253-301,
384-404):

    python -m adamvs_tpu_torch.cli predict --data_folder ... --output_folder ... \\
        [--loadckpt model_000010.ckpt] [--device cpu]

It runs on the CUDA card unless ``--device`` names another device (the
counterpart of the JAX side's ``JAX_PLATFORMS``); with no card and no
``--device cpu`` it raises. ``train``, ``test`` and ``profile`` are not
ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import argparse

import torch

from .config import (
    REG_IMPLS,
    SWEEP_IMPLS,
    WARP_IMPLS,
    ModelConfig,
    PredictConfig,
    not_ported,
    parse_float_list,
    parse_int_list,
)


def _add_model_flags(p: argparse.ArgumentParser):
    p.add_argument("--model", default="adamvs", choices=sorted(REG_IMPLS))
    p.add_argument("--ndepths", default="48,32,8")
    p.add_argument("--depth_inter_r", default="4,2,1")
    p.add_argument("--cr_base_chs", default="8,8,8")
    p.add_argument("--share_cr", action="store_true")
    p.add_argument("--warp_impl", default="gather", choices=list(WARP_IMPLS),
                   help="every choice samples exactly, through the port's bilinear "
                        "sampler kernel; pallas2bf16 needs --compute_dtype bf16")
    p.add_argument("--sweep_impl", default="scan", choices=list(SWEEP_IMPLS),
                   help="scan: per-hypothesis warps inside the recurrence; fused: one "
                        "plane-sweep kernel per stage (fusedf32 is the same in the port, "
                        "whose sweeps sample in float32)")
    p.add_argument("--reg_impl", default="scan", choices=["scan", "pallas", "precomp"],
                   help="scan: the recurrent regulariser stepped per depth slice; pallas "
                        "(adamvs, needs --sweep_impl fused): the whole recurrence in one "
                        "kernel per stage; precomp is not ported yet")
    p.add_argument("--compute_dtype", default="f32", choices=["f32", "bf16"])
    p.add_argument("--distributed", action="store_true",
                   help="multi-host runs are not ported yet")


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


def cmd_predict(args):
    """Predict every work item of ``--data_folder`` into ``--output_folder``;
    returns the ``PredictEngine`` (its feature-cache counts)."""
    from .data.lists import build_predict_list
    from .device import resolve_device
    from .predict.engine import PredictEngine

    if args.distributed:
        raise not_ported("--distributed", "parallel paths, run()'s per-host split")
    if args.tiles > 1:
        raise not_ported("--tiles > 1", "parallel paths, the row bands of predict/tiled.py")
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
    pp.add_argument("--device", default="cuda",
                    help="the torch device to run on (default cuda; cpu runs the plain "
                         "PyTorch path)")
    pp.set_defaults(fn=cmd_predict)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
