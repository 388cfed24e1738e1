"""Train and eval steps and the epoch-level Trainer (counterpart of
adamvs_tpu/train/loop.py).

A batch is a dict of numpy arrays in the JAX package's layout: ``imgs``
[B,V,H,W,3], ``proj_matrices`` {"stageK": [B,V,4,4]}, ``depth_values`` [B,3]
= [min,max,interval], ``depth`` and ``mask`` {"stageK": [B,h,w]} and
``depth_interval`` [B]. The Trainer moves it to its device.

The train step runs the model's training form (``train=True``, BatchNorm in
train mode), the loss and its backward, then the RMSprop update unless the
loss is non-finite (``apply_updates_if_finite``); BatchNorm statistics take
the step's values either way. The eval step runs the inference form (the
model's kernels on the card), resizes the final depth to the final GT and
computes the metrics.

The Trainer keeps the JAX Trainer's records (adamvs_tpu/train/loop.py:
139-200): ``metrics.jsonl``, ``train_record.txt`` and, when tensorboardX
imports, TensorBoard events in the log directory: every record's scalars
under ``{kind}/{name}`` and, with each train record, the images
``train/depth_est``, ``train/depth_gt`` and ``train/errormap`` (the first
sample, min-max normalised, the estimate resized to the GT's shape). Without
tensorboardX, ``metrics.jsonl`` stays the record, as in JAX.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops.regression import resize_bilinear
from ..parallel.distributed import data_parallel, rank
from ..parallel.halo import gather_rows_nograd, tile_rows
from ..parallel.mesh import average_gradients, replicate
from ..tracing import span
from .checkpoint import latest_checkpoint, next_epoch_after, restore_checkpoint, save_checkpoint
from .metrics import eval_metrics
from .state import TrainState, apply_updates_if_finite


def make_train_step(loss_fn: Callable, dlossw, group=None, tile_group=None) -> Callable:
    """``train_step(state, batch) -> (state, metrics, depth_est)`` on a
    batch of tensors; updates ``state`` in place. With a ``group`` (the
    mesh's ``stats_group``) the batch is this rank's part of the global
    batch and the step is one device's step on the global batch: BatchNorm
    statistics and the loss are the global batch's (``parallel.
    data_parallel``), and the gradients are summed over the ranks and
    divided by their number once. Each rank's gradient of the global loss is
    the group's size times its share, since the loss's sums reach every rank
    through the all-reduce. With a ``tile_group`` the part is one row band
    of a data slice (``shard_batch``) and the model runs under
    ``parallel.halo.tile_rows``: convolutions and resizes exchange halo rows
    and the sources are gathered per stage, each with its exact adjoint, so
    the argument holds for the mesh's every rank; ``depth_est`` is the
    band's."""
    def train_step(state: TrainState, batch):
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with data_parallel(group), tile_rows(tile_group), span("train.forward"):
            out = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"], train=True)
            loss, depth_loss = loss_fn(out, batch["depth"], batch["mask"], dlossw)
        with span("train.backward"):  # the host waits here while autograd's device thread runs
            loss.backward()
        if group is not None:
            average_gradients(model, group)
        apply_updates_if_finite(state, loss)
        metrics = {"loss": loss.detach(), "depth_loss": depth_loss.detach()}
        return state, metrics, out["depth"].detach()

    return train_step


def make_eval_step(loss_fn: Callable, dlossw, num_stages: int, group=None,
                   tile_group=None) -> Callable:
    """``eval_step(state, batch) -> (metrics, depth, confidence)`` on a
    batch of tensors. With a data ``group`` (every rank's batch of one size)
    the metrics are the global batch's: the loss through its global masked
    means, the per-image metrics averaged over the ranks. With a
    ``tile_group`` the batch is a row band: its rows are gathered over the
    group and the unbanded inference form runs on the whole frames, alike on
    every rank of the group (as XLA runs a custom call it cannot partition),
    so the kernels see the shapes they are checked at."""
    final = f"stage{num_stages}"

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        batch = gather_batch_rows(batch, tile_group)
        model = state.model.eval()
        with data_parallel(group):
            out = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
            loss, depth_loss = loss_fn(out, batch["depth"], batch["mask"], dlossw)
        metrics = {"loss": loss, "depth_loss": depth_loss}
        gt = batch["depth"][final]
        # an up-sampling last stage can emit depth above the final GT's resolution
        depth_est = resize_bilinear(out["depth"], gt.shape[-2], gt.shape[-1])
        per_image = eval_metrics(depth_est, gt, batch["mask"][final], batch["depth_interval"])
        if group is not None:
            vals = torch.stack(list(per_image.values()))
            dist.all_reduce(vals, group=group)
            per_image = dict(zip(per_image, (vals / dist.get_world_size(group)).unbind()))
        metrics.update(per_image)
        return metrics, out["depth"], out["photometric_confidence"]

    return eval_step


def gather_batch_rows(batch: dict, group) -> dict:
    """A row-banded batch (``shard_batch`` over a tile ``group``) with the
    rows of ``imgs`` and of every stage's ``depth`` and ``mask`` gathered
    over the group, the whole frames; ``batch`` itself without a group."""
    if group is None:
        return batch
    out = dict(batch, imgs=gather_rows_nograd(batch["imgs"], 2, group))
    for key in ("depth", "mask"):
        out[key] = {k: gather_rows_nograd(v, 1, group) for k, v in batch[key].items()}
    return out


def to_device(batch, device: torch.device):
    """A batch of numpy arrays (nested dicts) as float32 tensors on ``device``."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    return torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(device)


class AverageMeter:
    """Running mean of dicts of scalars."""

    def __init__(self):
        self.data: dict[str, float] = {}
        self.count = 0

    def update(self, scalars: dict[str, Any]):
        self.count += 1
        for k, v in scalars.items():
            self.data[k] = self.data.get(k, 0.0) + float(v)

    def mean(self) -> dict[str, float]:
        return {k: v / max(self.count, 1) for k, v in self.data.items()}


class Trainer:
    """Epochs of train and eval steps of ``state.model`` on ``device`` (CUDA
    unless given; raises when no CUDA device is present and none was given),
    with ``metrics.jsonl`` (train records every ``summary_freq`` steps, every
    eval), ``train_record.txt`` (one line per eval) and checkpoints every
    ``ckpt_step_freq`` steps and every ``save_freq`` epochs in ``logdir``.

    ``mesh`` (``parallel.make_mesh``): data-parallel training over its data
    group (JAX's ``mesh=``, adamvs_tpu/train/loop.py:111-155) and, with
    ``tile`` > 1, image rows sharded over its tile groups. Rank 0's
    parameters and buffers are broadcast at the start; each batch is this
    rank's part of the global batch (``parallel.shard_batch``: its data
    slice, and with row bands its band of the slice's rows), and a step
    equals one device's step on the global batch (``make_train_step``);
    scalar metrics are global. The eval step gathers a banded batch's rows
    and runs the unbanded inference form (``make_eval_step``). Only rank 0
    writes the records and the checkpoints."""

    def __init__(self, state: TrainState, loss_fn, logdir: str, dlossw=(0.5, 1.0, 2.0),
                 num_stages: int = 3, summary_freq: int = 50, save_freq: int = 1,
                 ckpt_step_freq: int = 3000, log_fn: Callable[[str], None] = print, device=None,
                 mesh=None):
        self.device = resolve_device(device)
        state.model.to(self.device)
        self.state = state
        self.logdir = logdir
        self.summary_freq = summary_freq
        self.save_freq = save_freq
        self.ckpt_step_freq = ckpt_step_freq
        self.log = log_fn
        group = mesh.stats_group if mesh is not None else None
        self.tile_group = mesh.tile_group if mesh is not None and mesh.tile > 1 else None
        if group is not None:
            replicate(state.model, mesh)
        self.is_primary = rank() == 0
        self.train_step = make_train_step(loss_fn, dlossw, group, self.tile_group)
        self.eval_step = make_eval_step(loss_fn, dlossw, num_stages,
                                        mesh.data_group if mesh is not None else None,
                                        self.tile_group)
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = os.path.join(logdir, "metrics.jsonl")
        # host seconds per train step: waiting for the batch, and the step itself
        self.times: dict[str, list[float]] = {"data_s": [], "step_s": []}
        self._tb = None
        if self.is_primary:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:  # optional, as in JAX: metrics.jsonl stays the record
                pass
            else:
                self._tb = SummaryWriter(logdir)

    def resume(self) -> int:
        """Restore the latest checkpoint; returns the epoch to run next."""
        path = latest_checkpoint(self.logdir)
        if path is None:
            return 0
        self.log(f"resuming from {path}")
        restore_checkpoint(path, self.state)
        return next_epoch_after(path)

    def load(self, path: str):
        self.log(f"loading checkpoint {path}")
        restore_checkpoint(path, self.state)

    def _record(self, kind: str, step: int, scalars: dict[str, float]):
        if not self.is_primary:
            return
        with open(self._jsonl, "a") as f:
            f.write(json.dumps({"kind": kind, "step": step, **scalars}) + "\n")
        if self._tb is not None:
            for k, val in scalars.items():
                self._tb.add_scalar(f"{kind}/{k}", val, step)

    def _record_images(self, kind: str, step: int, batch, depth_est: torch.Tensor):
        """Depth, GT and error images of the first sample (the reference's
        save_images, utils.py:127-147), each min-max normalised; a row-banded
        step's rows gathered over the tile group first, on every rank of
        it."""
        final = f"stage{len(batch['depth'])}"
        est, gt, mask = (gather_rows_nograd(t[:1].contiguous(), 1, self.tile_group)
                         for t in (depth_est, batch["depth"][final], batch["mask"][final]))
        if self._tb is None:
            return
        gt, est = gt[0].float(), est[0].float()
        if est.shape != gt.shape:
            est = resize_bilinear(est[None], gt.shape[0], gt.shape[1])[0]
        err = (est - gt).abs() * mask[0].float()

        def norm(img):
            img = img.cpu().numpy()
            lo, hi = float(img.min()), float(img.max())
            return (img - lo) / max(hi - lo, 1e-6)

        self._tb.add_image(f"{kind}/depth_est", norm(est)[None], step)
        self._tb.add_image(f"{kind}/depth_gt", norm(gt)[None], step)
        self._tb.add_image(f"{kind}/errormap", norm(err)[None], step)

    def close(self):
        """Flush and close the TensorBoard writer."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def train_epoch(self, epoch: int, batches) -> dict[str, float]:
        meter = AverageMeter()
        it = iter(batches)
        for i in itertools.count():
            t_wait = time.time()
            with span("train.data"):
                batch = next(it, None)
            if batch is None:
                break
            t0 = time.time()
            with span("train.step"):
                batch = to_device(batch, self.device)
                _, metrics, depth_est = self.train_step(self.state, batch)
                step = self.state.step
                with span("train.scalars"):  # a host sync on the step's metrics
                    scalars = {k: float(v) for k, v in metrics.items()}
                meter.update(scalars)
                if step % self.summary_freq == 0:
                    self._record("train", step, scalars)
                    self._record_images("train", step, batch, depth_est)
            t1 = time.time()
            self.times["data_s"].append(t0 - t_wait)
            self.times["step_s"].append(t1 - t0)
            self.log(f"Epoch {epoch}, iter {i}, loss={scalars['loss']:.4f}, "
                     f"time={t1 - t0:.3f}s, data={t0 - t_wait:.3f}s")
            if self.ckpt_step_freq and step % self.ckpt_step_freq == 0 and self.is_primary:
                save_checkpoint(self.logdir, self.state, epoch, tag=f"step{step}")
        return meter.mean()

    def eval_epoch(self, epoch: int, batches) -> dict[str, float]:
        meter = AverageMeter()
        for batch in batches:
            metrics, _, _ = self.eval_step(self.state, to_device(batch, self.device))
            meter.update({k: float(v) for k, v in metrics.items()})
        means = meter.mean()
        self._record("val", self.state.step, means)
        if self.is_primary:
            with open(os.path.join(self.logdir, "train_record.txt"), "a") as f:
                f.write(f"{epoch} {means}\n")
        return means

    def end_epoch(self, epoch: int, val_metrics: dict[str, float] | None):
        if (epoch + 1) % self.save_freq == 0 and self.is_primary:
            metric = val_metrics.get("abs_depth_error") if val_metrics else None
            save_checkpoint(self.logdir, self.state, epoch, metric=metric)
