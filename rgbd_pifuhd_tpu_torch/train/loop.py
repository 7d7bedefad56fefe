"""Epoch-driven training drivers (port of ``train/loop.py``):

- ``train_fine``: the two-level model (netMR) with netG frozen, from a
  coarse checkpoint (``load_netG_checkpoint_path``, a JAX-package or port
  msgpack or a reference ``.pth``), optionally resumed
  (``continue_train`` / ``resume_epoch``);
- ``pretrain_coarse``: the coarse model (netG) alone;
- ``pretrain_normals``: netF then netB (``GlobalGenerator``), each from
  its own Adam at a constant rate, loss ``5 L1 + perceptual``
  (``select_perceptual``), with a montage PNG per save epoch;
- ``train_alternating``: the curriculum {normals -> coarse -> fine with
  crops} x cycles;
- ``evaluate_checkpoints``: the forward loss of every epoch checkpoint over
  the evaluation set.

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

from ..data.datasets import EvalDataset, TrainDataset
from ..models.blocks import init_flax
from ..models.coarse import CoarsePIFu
from ..models.multires import MultiResPIFu
from ..models.pix2pix import GlobalGenerator
from ..models.vgg import VGG16Features, make_perceptual_loss
from ..utils import checkpoint as ckpt
from ..utils.device import resolve_device
from ..utils.logging import TrainLogger
from ..utils.options import Options
from ..utils.png import write_png
from .trainers import (
    make_coarse_train_step,
    make_fine_train_step,
    make_lr_schedule,
    make_normal_train_step,
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


def make_collate_normals(target_key: str, style_key: str) -> Callable:
    """Batch for netF / netB pretraining: input image, target map, style
    image."""

    def collate(items: list[dict]) -> dict:
        return {"images": _stack(i["img"][0] for i in items),
                "target": _stack(i[target_key] for i in items),
                "style": _stack(i[style_key] for i in items)}

    return collate


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


# ----------------------------------------------------------- normal pretrain
def select_perceptual(use_vgg: bool | str = "auto", seed: int = 0,
                      device=None):
    """The normal-pretraining perceptual loss and its label, as the JAX
    package picks them: "auto" takes VGG16 only when weights are found
    locally, else L1 alone ("l1_only"); "native" the committed backbone
    (style weight 1e2, weight 0.3); True a VGG16 even with random
    features; False L1 alone."""
    if use_vgg == "auto":
        if VGG16Features.find_weights() is not None:
            return (make_perceptual_loss(
                VGG16Features.load_weights(rng_key=seed), device=device),
                "vgg16")
        return None, "l1_only"
    if use_vgg == "native":
        from ..models.perceptual import (
            CompactFeatures, find_backbone, load_backbone)
        bpath = find_backbone()
        if bpath:
            return (make_perceptual_loss(
                load_backbone(bpath), style_weight=1e2,
                feature_model=CompactFeatures(device="cpu"), weight=0.3,
                device=device), "native_backbone")
        return None, "l1_only"
    if use_vgg:
        return (make_perceptual_loss(
            VGG16Features.load_weights(rng_key=seed), device=device),
            "vgg16_forced")
    return None, "l1_only"


def pretrain_normals(opt: Options, coarse_params: dict | None = None,
                     max_steps: int | None = None,
                     use_vgg: bool | str = "auto", device=None) -> dict:
    """Train netF, then netB.  Given ``coarse_params`` (a coarse model's
    flax tree) the nets start from its ``netF`` / ``netB``, the tree comes
    back with them replaced and is written as ``<name>_netG``'s latest
    checkpoint; otherwise both start from ``opt.seed`` and
    ``{"netF": tree, "netB": tree}`` comes back, with no checkpoint.  The
    batch-statistics collection of ``coarse_params`` is carried along (the
    JAX package drops it, and its next coarse stage then fails on a
    batch-norm model)."""
    dev = resolve_device(device)
    dataset = TrainDataset(opt, load_mesh=False, seed=opt.seed)
    if len(dataset) < opt.batch_size:
        raise RuntimeError(
            f"dataset too small: {len(dataset)} items < batch_size "
            f"{opt.batch_size}")
    c = opt.netG
    # drawn by the JAX loop to size the initialisation
    in_ch = dataset[0]["img"].shape[-1]
    perceptual, choice = select_perceptual(use_vgg, seed=opt.seed,
                                           device=dev)
    print(f"[pretrain_normals] perceptual loss: {choice}", flush=True)

    out = None
    if coarse_params is not None:
        out = {**coarse_params, "params": dict(coarse_params["params"])}
    results = {}
    for net_name, target_key, style_key in (("netF", "imF", "Fstyle"),
                                            ("netB", "imB", "Bstyle")):
        gen = GlobalGenerator(in_ch, 3, c.nml_ngf, c.nml_n_downsampling,
                              c.nml_n_blocks, device=dev)
        if out is not None and net_name in out["params"]:
            ckpt.load_params(gen, {"params": out["params"][net_name]})
        else:
            init_flax(gen, torch.Generator().manual_seed(opt.seed))
        tx = make_optimizer("adam", opt.learning_rate, gen.parameters())
        step_fn = make_normal_train_step(gen, tx, perceptual)
        collate = make_collate_normals(target_key, style_key)
        montage_batch = collate([dataset[0]])     # fixed montage subject

        def save(epoch, gen=gen, batch=montage_batch, net_name=net_name):
            if epoch % opt.freq_save == 0:
                _save_normal_montage(opt, gen, batch, net_name, epoch)

        # the JAX loop tests max_steps after a step: 0 still runs one
        _run(opt, dataset, gen, step_fn, lambda _c: opt.learning_rate,
             collate, TrainLogger(f"{opt.name}_{net_name}"),
             None if max_steps is None else max(max_steps, 1), save)
        results[net_name] = ckpt.params_to_flax(gen)
        if out is not None:
            out["params"][net_name] = results[net_name]["params"]

    if out is not None:
        ckpt.save_checkpoint(
            ckpt.latest_path(opt.checkpoints_path, f"{opt.name}_netG"),
            out, opt, epoch=0)
        return out
    return results


def _save_normal_montage(opt, gen, batch, net_name, epoch) -> None:
    """``./train_result/<name>_<net>/sample_epoch_<N>.png``: input |
    predicted | target of the first item, uint8 RGB, as the JAX package
    writes it (``* 0.5 + 0.5``, ``* 255``, clipped, truncated)."""
    dev = next(gen.parameters()).device
    with torch.no_grad():
        fake = gen(batch["images"].to(dev)).float().cpu()
    panels = [batch["images"][0, ..., :3].numpy(), fake[0].numpy(),
              batch["target"][0].numpy()]
    img = np.concatenate(panels, axis=1) * 0.5 + 0.5
    out_dir = os.path.join("./train_result", f"{opt.name}_{net_name}")
    os.makedirs(out_dir, exist_ok=True)
    write_png(os.path.join(out_dir, f"sample_epoch_{epoch}.png"),
              (img * 255).clip(0, 255).astype(np.uint8))


# ------------------------------------------------------------- alternating
def train_alternating(opt: Options, cycles: int = 10, nml_epochs: int = 5,
                      coarse_epochs: int = 5, fine_epochs: int = 10,
                      max_steps: int | None = None, device=None) -> dict:
    """The curriculum {normals -> coarse -> fine with crops} x cycles;
    returns the fine model's flax tree.  Each cycle copies the coarse
    tree's ``params`` into the fine tree's ``netG`` (its batch statistics
    stay the fine tree's, as in the JAX package)."""
    import dataclasses

    dev = resolve_device(device)
    coarse = fine = None
    for _ in range(cycles):
        if coarse is None:
            coarse = ckpt.params_to_flax(pretrain_coarse(
                dataclasses.replace(opt, num_epoch=0), max_steps=0,
                device=dev))
        coarse = pretrain_normals(dataclasses.replace(opt,
                                                      num_epoch=nml_epochs),
                                  coarse, max_steps=max_steps, device=dev)
        coarse = ckpt.params_to_flax(pretrain_coarse(
            dataclasses.replace(opt, num_epoch=coarse_epochs),
            params=coarse, max_steps=max_steps, device=dev))
        o = dataclasses.replace(opt, num_epoch=fine_epochs)
        if fine is None:
            # the JAX loop initialises from a fresh reader's first item
            TrainDataset(o, seed=o.seed)[0]
            model = build_multires(o, "cpu")
            init_multires_params(o, model)
            fine = ckpt.params_to_flax(model)
            del model
        fine["params"]["netG"] = coarse["params"]
        fine = ckpt.params_to_flax(train_fine(o, use_crop=True, params=fine,
                                              max_steps=max_steps,
                                              device=dev))
    return fine


# ------------------------------------------------------------------ eval
def evaluate_checkpoints(opt: Options, max_items: int | None = None,
                         device=None) -> dict:
    """The fine loss (``occ_fine``, ``train=False``: the queries go through
    the kernels on the card) of ``<name>_train_epoch_<e>`` for ``e = 0,
    freq_save, 2 freq_save, ...`` until one is missing, over the evaluation
    set: every item once, the last batch shrunk, the item-weighted mean.
    Each epoch's batch losses go to ``<checkpoints_path>/<name>_eval_epoch_
    <e>.npy``.  Returns ``{epoch: loss}``."""
    dev = resolve_device(device)
    dataset = EvalDataset(opt)
    model = build_multires(opt, dev)
    n = min(len(dataset), max_items or len(dataset))
    batch_size = max(min(opt.batch_size, n), 1)
    results = {}
    epoch = 0
    while True:
        path = ckpt.epoch_path(opt.checkpoints_path, opt.name, epoch)
        if not os.path.exists(path):
            break
        ckpt.load_params(model, ckpt.load_checkpoint(path, dev)["params"])
        errs, weights = [], []
        count = 0
        for batch in _batches(dataset, batch_size, collate_fine, seed=0,
                              shuffle=False, drop_last=False):
            if count >= n:
                break
            bsz = min(int(batch["labels"].shape[0]), n - count)
            batch = {k: v[:bsz] for k, v in _to_device(batch, dev).items()}
            with torch.no_grad():
                err, _ = model(batch["images_local"],
                               batch["images_global"], batch["points"],
                               batch["calib_local"], batch["calib_global"],
                               batch["labels"], train=False)
            errs.append(float(err["occ_fine"]))
            weights.append(bsz)
            count += bsz
        if not errs:
            raise RuntimeError(f"eval dataset is empty ({opt.dataroot})")
        results[epoch] = float(np.average(errs, weights=weights))
        np.save(os.path.join(opt.checkpoints_path,
                             f"{opt.name}_eval_epoch_{epoch}.npy"),
                np.asarray(errs))
        epoch += opt.freq_save
    return results
