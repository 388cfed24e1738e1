"""Model, data, train and predict configuration (counterpart of
adamvs_tpu/config.py).

``ModelConfig`` holds the JAX CLI's model flags with the same validity rules
(config.py:61-74) and builds the port's model. ``DataConfig``,
``TrainConfig`` and ``PredictConfig`` hold the other commands' flags with the
JAX defaults.
"""

from __future__ import annotations

import dataclasses

import torch

WARP_IMPLS = ("gather", "banded", "pallas", "pallas2", "pallas2bf16")
SWEEP_IMPLS = ("scan", "fused", "fusedf32")
REG_IMPLS = {"adamvs": ("scan", "pallas", "precomp"), "msrednet": ("scan", "precomp")}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def parse_int_list(s: str) -> tuple[int, ...]:
    return tuple(int(x) for x in s.split(",") if x)


def parse_float_list(s: str) -> tuple[float, ...]:
    return tuple(float(x) for x in s.split(",") if x)


@dataclasses.dataclass
class ModelConfig:
    model: str = "adamvs"  # adamvs | msrednet
    ndepths: tuple[int, ...] = (48, 32, 8)
    depth_intervals_ratio: tuple[float, ...] = (4.0, 2.0, 1.0)
    cr_base_chs: tuple[int, ...] = (8, 8, 8)
    share_cr: bool = False
    base_channels: int = 8
    # every choice is the exact bilinear sample through K6/K7 in the port;
    # the JAX choices differ only outside their band. pallas2bf16 on a float32
    # model rounds the scan form's sources to bf16 and samples into float32
    warp_impl: str = "gather"  # gather | banded | pallas | pallas2 | pallas2bf16
    # scan: per-depth warp inside the recurrence; fused/fusedf32: one sweep
    # kernel per stage (the port's sweeps sample exactly in float32, so
    # fusedf32 is fused)
    sweep_impl: str = "scan"
    # scan: the regulariser stepped per depth slice; adamvs 'pallas': K3 over
    # the fused volume; 'precomp': the recurrence over chunks of depths of the
    # fused volume (ada_precomp_depth, red_precomp_depth)
    reg_impl: str = "scan"
    dtype: str = "f32"  # f32 | bf16

    def build(self, device=None, seed: int = 0, train: bool = False):
        """The port's model computing in this config's dtype with weights
        drawn from ``seed`` (``models.build_model``), on ``device`` (CUDA
        unless given). For inference (``train=False``) the parameters are
        cast to the compute dtype; for training they stay float32, the
        master weights of a bf16 run, as flax keeps them. Raises
        ``ValueError`` for a combination the JAX package rejects."""
        from .models import build_model

        if self.model not in REG_IMPLS:
            raise ValueError(f"unknown model {self.model!r} (choose one of {sorted(REG_IMPLS)})")
        if self.warp_impl not in WARP_IMPLS:
            raise ValueError(f"unknown warp_impl {self.warp_impl!r}")
        if self.sweep_impl not in SWEEP_IMPLS:
            raise ValueError(f"unknown sweep_impl {self.sweep_impl!r}")
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}")
        valid_reg = REG_IMPLS[self.model]
        if self.reg_impl not in valid_reg:
            raise ValueError(
                f"reg_impl={self.reg_impl!r} is not valid for model "
                f"{self.model!r} (choices: {valid_reg})"
            )
        if self.reg_impl != "scan" and self.sweep_impl not in ("fused", "fusedf32"):
            raise ValueError(
                f"reg_impl={self.reg_impl!r} requires sweep_impl "
                f"'fused'/'fusedf32' (got {self.sweep_impl!r})"
            )
        if self.model == "msrednet" and self.share_cr:
            raise NotImplementedError(
                "share_cr is broken in the reference (msrednet.py:271) and unsupported here")
        dtype = DTYPES[self.dtype]
        # pallas2bf16 samples bf16 sources; a bf16 model's are bf16 already
        sample_dtype = (torch.bfloat16 if self.warp_impl == "pallas2bf16"
                        and dtype == torch.float32 else None)
        return build_model(self.model, seed=seed, device=device,
                           dtype=torch.float32 if train else dtype, compute_dtype=dtype,
                           sample_dtype=sample_dtype,
                           ndepths=self.ndepths, depth_intervals_ratio=self.depth_intervals_ratio,
                           base=self.base_channels, cr_base=self.cr_base_chs,
                           sweep_impl="scan" if self.sweep_impl == "scan" else "fused",
                           reg_impl=self.reg_impl)


@dataclasses.dataclass
class DataConfig:
    dataset: str = "cas_total_rscv"  # accepted for parity; loaders keyed by set_name
    set_name: str = "whu_omvs"
    trainpath: str = ""
    testpath: str = ""
    view_num: int = 5
    interval_scale: float = 1.0
    batch_size: int = 1
    num_workers: int = 2


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 80
    lr: float = 1e-3
    lrepochs: str = "10,12,14:2"
    wd: float = 0.0
    summary_freq: int = 50
    save_freq: int = 1
    seed: int = 1
    logdir: str = "./checkpoints/run"
    resume: bool = False
    loadckpt: str = ""
    dlossw: tuple[float, ...] = (0.5, 1.0, 2.0)


@dataclasses.dataclass
class PredictConfig:
    data_folder: str = ""
    output_folder: str = ""
    loadckpt: str = ""
    view_num: int = 5
    numdepth: int = 192
    max_w: int = 3712
    max_h: int = 5504
    min_interval: float = 0.1
    resize_scale: float = 0.5
    sample_scale: float = 1.0
    interval_scale: float = 1.0
    display: bool = True
