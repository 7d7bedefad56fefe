"""Optimisers and train steps (port of ``train/trainers.py``).

- ``make_lr_schedule``: optax's ``piecewise_constant_schedule`` — the rate
  times ``gamma`` from each schedule epoch's first step on, in float32;
- ``make_optimizer``: ``rmsprop`` with optax's arithmetic (``RMSprop``
  below: ``nu = 0.99 nu + 0.01 g^2``, ``g rsqrt(nu + eps)`` with eps inside
  the root, nu from 0; ``torch.optim.RMSprop`` puts eps outside), and
  ``adam`` (b1 0.5, b2 0.999), ``torch.optim.Adam``, which matches
  ``optax.adam``.  Both take the rate from the schedule at the number of
  updates already applied;
- ``make_fine_train_step`` / ``make_coarse_train_step``: one step on a
  batch already on the model's device — the training forward, backward,
  optimiser update — returning the metrics as device tensors.  Parameters
  that received no gradient (netG in the fine stage, the normal nets) are
  left untouched, as optax leaves them for a zero gradient.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch


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


def make_optimizer(kind: str, lr, params: Iterable
                   ) -> torch.optim.Optimizer:
    """``kind`` 'rmsprop' (decay 0.99, eps 1e-8) or 'adam' (b1 0.5,
    b2 0.999); ``lr`` a schedule or a constant."""
    schedule = lr if callable(lr) else (lambda _c, v=float(lr): v)
    if kind == "rmsprop":
        return RMSprop(params, schedule)
    if kind == "adam":
        return Adam(params, schedule)
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

    return step
