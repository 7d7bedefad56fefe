"""Device-to-host copies of the reconstructor (``pipeline``, ``streamed``):
a copy's completion marker, the pinned copy itself, and the job that hands
out a mesh's vertex colours as their copies land."""

from __future__ import annotations

import numpy as np
import torch


class Landed:
    """Completion marker of work queued on the current stream (a CUDA
    event; on the CPU the work is already done)."""

    def __init__(self, device: torch.device):
        self._ev = None
        if device.type == "cuda":
            self._ev = torch.cuda.Event()
            self._ev.record()

    def wait(self) -> None:
        if self._ev is not None:
            self._ev.synchronize()


def to_host(t: torch.Tensor):
    """Queue a non-blocking copy into a pinned host buffer; returns the
    host tensor and its completion marker."""
    host = torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=t.device.type == "cuda")
    host.copy_(t, non_blocking=True)
    return host, Landed(t.device)


class ColorJob:
    """A mesh's ``V`` vertex colours in flight.  ``parts`` are, in row
    order, ``(host uint8 [rows, 3], landed)`` per group dispatched on the
    device (rows past ``V`` are padding), or a function computing all
    ``[V, 3]`` colours in [0, 1] on the host, run when they are first read
    (so on ``gen_mesh_many``'s worker).  ``xyz`` is the copy ``(host,
    landed)`` of the projected vertices the back-colour inpainting reads,
    or None."""

    def __init__(self, parts, V: int, xyz):
        self._parts, self._V, self._xyz = parts, V, xyz

    def groups(self):
        """``(row0, colours f32 [n, 3])`` as each group lands."""
        if callable(self._parts):
            c = np.asarray(self._parts(), np.float32)
            if len(c):
                yield 0, c
            return
        row = 0
        for host, landed in self._parts:
            landed.wait()
            a = host.numpy().reshape(-1, 3)
            n = min(len(a), self._V - row)
            if n <= 0:
                break
            out = a[:n].astype(np.float32)
            out *= np.float32(1.0 / 255.0)
            yield row, out
            row += n

    def __call__(self) -> np.ndarray:
        """All ``[V, 3]`` colours."""
        cols = [c for _, c in self.groups()]
        if not cols:
            return np.zeros((0, 3), np.float32)
        return cols[0] if len(cols) == 1 else np.concatenate(cols)

    def projected(self) -> np.ndarray:
        """The projected vertices ``[V, 3]``, once their copy has landed."""
        host, landed = self._xyz
        landed.wait()
        return host.numpy()
