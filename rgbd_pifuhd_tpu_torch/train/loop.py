"""Epoch-driven training drivers (port of ``train/loop.py``):

- ``train_fine``: the two-level model (netMR) with netG frozen, from a
  coarse checkpoint (``load_netG_checkpoint_path``, a JAX-package or port
  msgpack or a reference ``.pth``), optionally resumed
  (``continue_train`` / ``resume_epoch``);
- ``pretrain_coarse``: the coarse model (netG) alone.

Batches are shuffled per epoch with ``default_rng(seed + epoch)`` and
prefetched in order by background threads (``data.prefetch``); each goes
to the device once per step, and the loss comes back to the host once per
step.  Checkpoints keep the JAX package's names and layout
(``utils.checkpoint``); per-epoch losses go to ``train_result/<name>/``.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch

from ..data.datasets import TrainDataset
from ..models.blocks import init_flax
from ..models.coarse import CoarsePIFu
from ..models.multires import MultiResPIFu
from ..utils import checkpoint as ckpt
from ..utils.device import resolve_device
from ..utils.logging import TrainLogger
from ..utils.options import Options
from .trainers import (
    make_coarse_train_step,
    make_fine_train_step,
    make_lr_schedule,
    make_optimizer,
)


# ------------------------------------------------------------------ collate
def _stack(arrays) -> torch.Tensor:
    return torch.from_numpy(np.stack([np.asarray(a, np.float32)
                                      for a in arrays]))


def collate_fine(items: list[dict]) -> dict:
    """Dataset items -> fine-training batch (B1 = len(items), B2 = 1)."""
    return {
        "images_local": _stack(i["img"] for i in items),
        "images_global": _stack(i["img_512"] for i in items),
        "points": _stack(i["samples"][None] for i in items),
        "calib_local": _stack(i["calib_local"][None] for i in items),
        "calib_global": _stack(i["calib"] for i in items),
        "labels": _stack(i["labels"][None] for i in items),
    }


def collate_coarse(items: list[dict]) -> dict:
    return {
        "images": _stack(i["img_512"] for i in items),
        "points": _stack(i["samples"] for i in items),
        "calibs": _stack(i["calib"] for i in items),
        "labels": _stack(i["labels"] for i in items),
    }


def _batches(dataset, batch_size: int, collate: Callable, seed: int,
             shuffle: bool = True, num_threads: int = 2,
             drop_last: bool = True):
    """Shuffled, background-prefetched batches in a fixed order."""
    from ..data.prefetch import prefetch_batches

    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    yield from prefetch_batches(dataset, batch_size, collate, order,
                                num_threads=num_threads,
                                drop_last=drop_last)


def _to_device(batch: dict, dev: torch.device) -> dict:
    if dev.type == "cuda":
        return {k: v.pin_memory().to(dev, non_blocking=True)
                for k, v in batch.items()}
    return {k: v.to(dev) for k, v in batch.items()}


# -------------------------------------------------------------- fine train
def build_multires(opt: Options, device=None) -> MultiResPIFu:
    return MultiResPIFu(opt.netMR, opt.netG,
                        train_full_pifu=opt.train_full_pifu, device=device)


def init_multires_params(opt: Options, model: torch.nn.Module) -> None:
    """Flax's initialisers, drawn from a generator seeded by
    ``opt.seed``."""
    init_flax(model, torch.Generator().manual_seed(opt.seed))


def _load_netG(model: MultiResPIFu, path: str) -> None:
    """netG's parameters from a coarse checkpoint (its batch statistics
    stay as initialised, as the JAX loop keeps them); a reference ``.pth``
    has its narrower input convs widened to the model's."""
    from ..utils.torch_import import reconcile_input_channels

    g = ckpt.load_checkpoint(path, device="cpu")
    sub = g["params"]["params"]
    if g.get("torch_import"):
        sub = reconcile_input_channels(
            sub, ckpt.params_to_flax(model.netG)["params"])
    sd = ckpt.params_from_flax({"params": sub})
    missing, unexpected = model.netG.load_state_dict(sd, strict=False)
    buffers = {n for n, _ in model.netG.named_buffers()}
    if unexpected or set(missing) - buffers:
        raise ValueError(f"netG checkpoint {path} does not fit the model: "
                         f"missing {sorted(set(missing) - buffers)[:4]}, "
                         f"unexpected {sorted(unexpected)[:4]}")


def _run(opt: Options, dataset, model, step_fn, sched, collate, logger,
         max_steps, save) -> None:
    """The epoch loop shared by both stages."""
    dev = next(model.parameters()).device
    steps_per_epoch = max(len(dataset) // opt.batch_size, 1)
    global_step = 0
    for epoch in range(opt.num_epoch):
        batches = iter(_batches(dataset, opt.batch_size, collate,
                                opt.seed + epoch))
        while max_steps is None or global_step < max_steps:
            t0 = time.perf_counter()
            with logger.timer.phase("data"):
                batch = next(batches, None)
            if batch is None:
                break
            t1 = time.perf_counter()
            with logger.timer.phase("net"):
                metrics = step_fn(_to_device(batch, dev))
                loss = float(metrics["loss"])
            t2 = time.perf_counter()
            logger.record(loss)
            if global_step % opt.freq_show == 0:
                # this step's own times beside the running means
                logger.log_iter(epoch, global_step,
                                steps_per_epoch * opt.num_epoch, loss,
                                sched(global_step),
                                f"stepD: {(t1 - t0) * 1e3:.3f}ms "
                                f"stepN: {(t2 - t1) * 1e3:.3f}ms")
            global_step += 1
        logger.save_epoch_errors(epoch)
        save(epoch)
        if max_steps is not None and global_step >= max_steps:
            break


def train_fine(opt: Options, max_steps: int | None = None,
               use_crop: bool = False, params: dict | None = None,
               device=None) -> MultiResPIFu:
    """netMR training; ``params`` (a flax variables tree) replaces the
    initialisation and the checkpoint loads.  Returns the model."""
    dev = resolve_device(device)
    dataset = TrainDataset(opt, use_crop=use_crop, seed=opt.seed)
    if len(dataset) < opt.batch_size:
        raise RuntimeError(f"dataset too small: {len(dataset)}")
    model = build_multires(opt, dev)
    if params is not None:
        ckpt.load_params(model, params)
    else:
        # the JAX loop initialises from dataset[0]: that item's draws come
        # out of the reader's generator before the first batch's
        dataset[0]
        init_multires_params(opt, model)
        if opt.load_netG_checkpoint_path:
            _load_netG(model, opt.load_netG_checkpoint_path)
        if opt.continue_train:
            path = (ckpt.epoch_path(opt.checkpoints_path, opt.name,
                                    opt.resume_epoch)
                    if opt.resume_epoch >= 0
                    else ckpt.latest_path(opt.checkpoints_path, opt.name))
            if os.path.exists(path):
                ckpt.load_params(model,
                                 ckpt.load_checkpoint(path, dev)["params"])

    steps_per_epoch = max(len(dataset) // opt.batch_size, 1)
    sched = make_lr_schedule(opt.learning_rate, opt.schedule, opt.gamma,
                             steps_per_epoch)
    tx = make_optimizer(opt.optimizer, sched, model.parameters())
    step_fn = make_fine_train_step(model, tx)

    def save(epoch):
        tree = ckpt.params_to_flax(model)
        ckpt.save_checkpoint(ckpt.latest_path(opt.checkpoints_path,
                                              opt.name),
                             tree, opt, opt_netG=opt, epoch=epoch)
        if epoch % opt.freq_save == 0:
            ckpt.save_checkpoint(
                ckpt.epoch_path(opt.checkpoints_path, opt.name, epoch),
                tree, opt, opt_netG=opt, epoch=epoch)

    _run(opt, dataset, model, step_fn, sched, collate_fine,
         TrainLogger(f"{opt.name}_netMR"), max_steps, save)
    return model


# ----------------------------------------------------------- coarse pretrain
def pretrain_coarse(opt: Options, max_steps: int | None = None,
                    params: dict | None = None, device=None) -> CoarsePIFu:
    """netG pretraining; returns the model."""
    dev = resolve_device(device)
    dataset = TrainDataset(opt, seed=opt.seed)
    if len(dataset) < opt.batch_size:
        # drop_last batching would otherwise run no step and still write an
        # untrained checkpoint
        raise RuntimeError(
            f"dataset too small: {len(dataset)} items < batch_size "
            f"{opt.batch_size}")
    model = CoarsePIFu(opt.netG, device=dev)
    dataset[0]      # drawn by the JAX loop (its init item) in either case
    if params is not None:
        ckpt.load_params(model, params)
    else:
        init_flax(model, torch.Generator().manual_seed(opt.seed))
    steps_per_epoch = max(len(dataset) // opt.batch_size, 1)
    sched = make_lr_schedule(opt.learning_rate, opt.schedule, opt.gamma,
                             steps_per_epoch)
    tx = make_optimizer(opt.optimizer, sched, model.parameters())
    step_fn = make_coarse_train_step(
        model, tx, gamma=opt.gamma if opt.gamma < 1 else 0.5)

    def save(epoch):
        ckpt.save_checkpoint(
            ckpt.latest_path(opt.checkpoints_path, f"{opt.name}_netG"),
            ckpt.params_to_flax(model), opt, epoch=epoch)

    _run(opt, dataset, model, step_fn, sched, collate_coarse,
         TrainLogger(f"{opt.name}_netG"), max_steps, save)
    return model
