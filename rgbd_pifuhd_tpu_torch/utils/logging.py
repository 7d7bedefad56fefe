"""Timers, training logs, error histories and the profiler hook (port of
``utils/logging.py``): iteration lines in the JAX package's format, and
per-epoch loss arrays saved as ``train_result/<name>/error_epoch_<N>.npy``
under the working directory; ``profile_trace`` traces through
``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np


class Timer:
    """Accumulating phase timer: ``with t.phase('data'): ...``."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def mean(self, name: str) -> float:
        return self.totals.get(name, 0.0) / max(self.counts.get(name, 0), 1)

    def summary(self) -> str:
        return " ".join(
            f"{k}:{self.mean(k)*1e3:.0f}ms" for k in sorted(self.totals))


class TrainLogger:
    """Iteration logs and the error history of one training run."""

    def __init__(self, name: str, out_dir: str = "./train_result"):
        self.name = name
        self.out_dir = out_dir
        self.errors: list[float] = []
        self.timer = Timer()
        os.makedirs(out_dir, exist_ok=True)

    def log_iter(self, epoch: int, it: int, total: int, err: float,
                 lr: float, extra: str = "") -> None:
        data_t = self.timer.mean("data")
        net_t = self.timer.mean("net")
        eta = (total - it) * (data_t + net_t)
        print(
            f"Name: {self.name} | Epoch: {epoch} | {it}/{total} | "
            f"Err: {err:.6f} | LR: {lr:.6f} | dataT: {data_t:.3f} | "
            f"netT: {net_t:.3f} | "
            f"ETA: {int(eta // 60):02d}:{int(eta % 60):02d}"
            f" {extra}", flush=True)

    def record(self, err: float) -> None:
        self.errors.append(float(err))

    def save_epoch_errors(self, epoch: int) -> None:
        """``<out_dir>/<name>/error_epoch_<N>.npy``: every loss so far."""
        d = os.path.join(self.out_dir, self.name)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"error_epoch_{epoch}.npy"),
                np.asarray(self.errors))


def load_error_history(out_dir: str, name: str) -> list[np.ndarray]:
    d = os.path.join(out_dir, name)
    if not os.path.isdir(d):
        return []
    files = sorted(
        (f for f in os.listdir(d) if f.startswith("error_epoch_")),
        key=lambda f: int(f[len("error_epoch_"):-4]))
    return [np.load(os.path.join(d, f)) for f in files]


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """``torch.profiler`` trace of the block (CPU, and CUDA when present),
    written to ``log_dir`` as a Chrome / TensorBoard trace; a no-op when
    ``log_dir`` is None.  Yields the profiler (or None)."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
