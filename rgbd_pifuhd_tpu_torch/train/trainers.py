"""Optimisers and train steps (port of ``train/trainers.py``).

- ``make_lr_schedule``: optax's ``piecewise_constant_schedule`` — the rate
  times ``gamma`` from each schedule epoch's first step on, in float32;
- ``make_optimizer``: ``rmsprop`` with optax's arithmetic (``RMSprop``
  below: ``nu = 0.99 nu + 0.01 g^2``, ``g rsqrt(nu + eps)`` with eps inside
  the root, nu from 0; ``torch.optim.RMSprop`` puts eps outside), and
  ``adam`` (b1 0.5 unless given, b2 0.999), ``torch.optim.Adam``, which
  matches ``optax.adam``.  Both take the rate from the schedule at the number of
  updates already applied;
- ``make_fine_train_step`` / ``make_coarse_train_step``: one step on a
  batch already on the model's device — the training forward, backward,
  optimiser update — returning the metrics as device tensors.  Parameters
  that received no gradient (netG in the fine stage, the normal nets) are
  left untouched, as optax leaves them for a zero gradient;
- ``make_normal_train_step``: netF or netB alone, loss ``5 L1 +
  perceptual(target, fake, style)``;
- ``make_gan_normal_train_step``: the same plus the lsgan term of a
  multiscale discriminator on ``(images, map)``, in the JAX step's order:
  the generator's loss against the discriminator as it was before the
  step, the generator updated first, then the discriminator on the real
  map and on the generator's output from before its update, detached;
- ``shard_train_step``: a step of the first three kinds, data-parallel
  over a device mesh's processes: equal to the one-process step on the
  global batch, as the JAX package's ``jit`` with a sharded batch is.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from ..ops.losses import l1, multiscale_gan_loss


def make_lr_schedule(base_lr: float, schedule_epochs: Sequence[int],
                     gamma: float, steps_per_epoch: int
                     ) -> Callable[[int], float]:
    """Piecewise-constant step decay: ``lr(count)``."""
    bounds = sorted({int(e) * steps_per_epoch for e in schedule_epochs})

    def schedule(count: int) -> float:
        v = np.float32(base_lr)
        for b in bounds:
            if count >= b:
                v = np.float32(np.float32(gamma) * v)
        return float(v)

    return schedule


class _Scheduled:
    """The rate of every group from ``schedule(updates applied)``."""

    def _apply_schedule(self) -> None:
        lr = self.schedule(self.count)
        for g in self.param_groups:
            g["lr"] = lr


class RMSprop(_Scheduled, torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay, eps)``: ``nu = decay nu + (1 - decay)
    g^2`` from 0, update ``-lr g rsqrt(nu + eps)``."""

    def __init__(self, params: Iterable, schedule: Callable[[int], float],
                 decay: float = 0.99, eps: float = 1e-8):
        super().__init__(params, dict(lr=schedule(0), decay=decay, eps=eps))
        self.schedule, self.count = schedule, 0

    @torch.no_grad()
    def step(self, closure=None):
        self._apply_schedule()
        for g in self.param_groups:
            ps = [p for p in g["params"] if p.grad is not None]
            if not ps:
                continue
            for p in ps:
                if "nu" not in self.state[p]:
                    self.state[p]["nu"] = torch.zeros_like(p)
            grads = [p.grad for p in ps]
            nus = [self.state[p]["nu"] for p in ps]
            # multi-tensor kernels: a few launches for all the tensors
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - g["decay"])
            torch._foreach_mul_(nus, g["decay"])
            torch._foreach_add_(nus, sq)
            den = torch._foreach_add(nus, g["eps"])
            torch._foreach_rsqrt_(den)
            torch._foreach_mul_(den, grads)
            torch._foreach_mul_(den, -g["lr"])
            torch._foreach_add_(ps, den)
        self.count += 1


class Adam(_Scheduled, torch.optim.Adam):
    """``torch.optim.Adam`` with the rate from ``schedule``."""

    def __init__(self, params: Iterable, schedule: Callable[[int], float],
                 b1: float = 0.5, b2: float = 0.999):
        super().__init__(params, lr=schedule(0), betas=(b1, b2))
        self.schedule, self.count = schedule, 0

    def step(self, closure=None):
        self._apply_schedule()
        out = super().step(closure)
        self.count += 1
        return out


def make_optimizer(kind: str, lr, params: Iterable, b1: float = 0.5
                   ) -> torch.optim.Optimizer:
    """``kind`` 'rmsprop' (decay 0.99, eps 1e-8) or 'adam' (``b1`` 0.5
    unless given, b2 0.999); ``lr`` a schedule or a constant."""
    schedule = lr if callable(lr) else (lambda _c, v=float(lr): v)
    if kind == "rmsprop":
        return RMSprop(params, schedule)
    if kind == "adam":
        return Adam(params, schedule, b1=b1)
    raise ValueError(f"unknown optimizer {kind!r}")


def make_fine_train_step(model, opt: torch.optim.Optimizer) -> Callable:
    """One fine-training step: loss = ``occ_fine`` (+ ``occ`` with
    ``train_full_pifu``)."""

    def step(batch: dict) -> dict:
        opt.zero_grad(set_to_none=True)
        err, _ = model(batch["images_local"], batch["images_global"],
                       batch["points"], batch["calib_local"],
                       batch["calib_global"], batch["labels"], train=True)
        total = err["occ_fine"]
        if "occ" in err:
            total = total + err["occ"]
        total.backward()
        opt.step()
        return {"loss": total.detach(),
                **{k: v.detach() for k, v in err.items()}}

    step.model, step.optimizer = model, opt
    return step


def make_coarse_train_step(model, opt: torch.optim.Optimizer,
                           gamma: float = 0.5) -> Callable:
    """One coarse-pretraining step (custom BCE over the hourglass
    stacks)."""

    def step(batch: dict) -> dict:
        opt.zero_grad(set_to_none=True)
        err, _ = model(batch["images"], batch["points"], batch["calibs"],
                       batch["labels"], gamma, train=True)
        err.backward()
        opt.step()
        return {"loss": err.detach()}

    step.model, step.optimizer = model, opt
    return step


def make_normal_train_step(gen, opt: torch.optim.Optimizer,
                           perceptual_fn: Callable | None = None,
                           l1_weight: float = 5.0) -> Callable:
    """One normal-net step: ``gen(images) -> map``; ``perceptual_fn(x, y,
    style) -> scalar`` or None (L1 alone)."""

    def step(batch: dict) -> dict:
        opt.zero_grad(set_to_none=True)
        fake = gen(batch["images"])
        loss = l1_weight * l1(fake, batch["target"])
        if perceptual_fn is not None:
            loss = loss + perceptual_fn(batch["target"], fake,
                                        batch["style"])
        loss.backward()
        opt.step()
        return {"loss": loss.detach()}

    step.model, step.optimizer = gen, opt
    return step


def shard_train_step(step_fn: Callable, mesh) -> Callable:
    """Data parallelism over ``mesh``'s processes (one device each): the
    wrapped step takes this process's equal share of the global batch
    (``parallel.shard_host_batch``) and computes the one-process step on
    the global batch — the gradients averaged over the ranks before the
    optimiser's update (which then runs the same on every rank), batch
    norm's statistics reduced over the ranks (``batch_stats_group``), the
    metrics the global means.  The parameters and buffers start as rank
    0's (a broadcast, here).  ``step_fn`` is one of this module's steps
    (its ``model`` and ``optimizer``); a mesh without a process group
    returns it unchanged."""
    from ..models.blocks import batch_stats_group
    from ..parallel.distributed import all_reduce_sum_, broadcast_

    if len(mesh.local_devices) != 1:
        raise ValueError("data-parallel training runs one process per "
                         f"device; this process holds {mesh.local_devices}")
    group, world = mesh.group, mesh.world
    if group is None:
        return step_fn
    opt = step_fn.optimizer
    with torch.no_grad():
        for t in list(step_fn.model.parameters()) + list(
                step_fn.model.buffers()):
            broadcast_(t, 0, group)
    params = [p for g in opt.param_groups for p in g["params"]]

    def average_grads(_opt, _args, _kwargs):
        by_dtype: dict = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            all_reduce_sum_(flat, group).div_(world)
            off = 0
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()

    def step(batch: dict) -> dict:
        hook = opt.register_step_pre_hook(average_grads)
        try:
            with batch_stats_group(group):
                metrics = step_fn(batch)
        finally:
            hook.remove()
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].float() for k in keys])
        all_reduce_sum_(vals, group).div_(world)
        return {k: vals[i].to(metrics[k].dtype) for i, k in enumerate(keys)}

    return step


def make_gan_normal_train_step(gen, disc: Callable,
                               opt_g: torch.optim.Optimizer,
                               opt_d: torch.optim.Optimizer,
                               perceptual_fn: Callable | None = None,
                               l1_weight: float = 5.0,
                               gan_weight: float = 1.0) -> Callable:
    """Adversarial normal-map step.  ``disc(images, maps) -> list[list]``
    (one list of layer outputs per scale); ``opt_g`` holds the
    generator's parameters, ``opt_d`` the discriminator's."""
    g_params = [p for grp in opt_g.param_groups for p in grp["params"]]

    def step(batch: dict) -> dict:
        opt_g.zero_grad(set_to_none=True)
        fake = gen(batch["images"])
        g_loss = l1_weight * l1(fake, batch["target"])
        if perceptual_fn is not None:
            g_loss = g_loss + perceptual_fn(batch["target"], fake,
                                            batch["style"])
        g_loss = g_loss + gan_weight * multiscale_gan_loss(
            disc(batch["images"], fake), True)
        # the discriminator's gradient of this loss is not its own
        g_loss.backward(inputs=g_params)
        opt_g.step()

        opt_d.zero_grad(set_to_none=True)
        d_loss = 0.5 * (
            multiscale_gan_loss(disc(batch["images"], batch["target"]),
                                True)
            + multiscale_gan_loss(disc(batch["images"], fake.detach()),
                                  False))
        d_loss.backward()
        opt_d.step()
        return {"g_loss": g_loss.detach(), "d_loss": d_loss.detach()}

    return step
