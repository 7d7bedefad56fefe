"""Device meshes (port of ``parallel/mesh.py``).

A ``DeviceMesh`` is an ordered array of ``torch.device``s with named axes,
in the order of JAX's global device list: every process's local devices,
process after process.  Under a ``torch.distributed`` process group the
devices of the other ranks are labels (this process computes on its own);
without one the mesh is this process's devices alone.  A device may be
listed more than once: two shards on one card, or eight on the CPU.

``replicate`` places a module or tensor on every local device of the mesh
(the object itself where it already lies there); ``shard_batch`` splits a
batch's leading axis over the mesh's axis and places each of this
process's shards on its device.
"""

from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


class DeviceMesh:
    """``devices``: a NumPy object array of ``torch.device`` shaped like the
    mesh; ``axis_names``; ``group``: the process group the mesh spans (None
    for one process); ``rank`` / ``world``: this process's place in it.
    ``local_devices`` are this process's devices, in mesh order."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 group=None, rank: int = 0, world: int = 1):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} with axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.group, self.rank, self.world = group, rank, world
        flat = list(devices.reshape(-1))
        per = len(flat) // world
        self.local_devices = flat[rank * per:(rank + 1) * per]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_type(self) -> str:
        return self.local_devices[0].type

    def axis_devices(self, axis: str = "data") -> list:
        """The devices along ``axis`` (index 0 along every other axis:
        the work is replicated there, so one copy computes it)."""
        ax = self.axis_names.index(axis)
        d = np.moveaxis(self.devices, ax, 0)
        return list(d.reshape(d.shape[0], -1)[:, 0])

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.reshape(-1)]}, "
                f"rank {self.rank} of {self.world})")


def canonical(device) -> torch.device:
    """``device`` with its index (``cuda`` -> ``cuda:<current>``), so that
    equal devices compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _default_local_devices() -> list:
    """Every CUDA device of one process; under a process group the rank's
    own device (one process per device); the CPU without CUDA."""
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    if dist.is_available() and dist.is_initialized():
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_device_mesh(shape: Sequence[int] = (-1,),
                     axis_names: Sequence[str] = ("data",),
                     devices=None) -> DeviceMesh:
    """A mesh over ``devices`` (this process's devices; default: every
    CUDA device, the rank's own under a process group, else the CPU) times
    the ranks of the default process group, if one is initialised.  A -1
    in ``shape`` absorbs the remaining devices; a smaller mesh takes the
    first devices (of each rank, so every rank keeps as many)."""
    local = [canonical(d) for d in devices] if devices is not None \
        else _default_local_devices()
    if not local:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in local}) != 1:
        raise ValueError(f"a mesh mixes device types: {local}")
    group, rank, world = None, 0, 1
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        rank, world = dist.get_rank(), dist.get_world_size()
    shape = [int(s) for s in shape]
    total = len(local) * world
    known = int(np.prod([s for s in shape if s > 0])) or 1
    if -1 in shape:
        shape[shape.index(-1)] = total // known
    n = int(np.prod(shape))
    if n < 1 or n > total or n % world:
        raise ValueError(f"mesh shape {tuple(shape)} does not fit {total} "
                         f"devices over {world} processes")
    per = n // world
    flat = np.empty(n, dtype=object)
    for r in range(world):
        for i, d in enumerate(local[:per]):
            flat[r * per + i] = d
    return DeviceMesh(flat.reshape(shape), axis_names, group, rank, world)


def place(x, device: torch.device):
    """``x`` on ``device``: tensors and modules (a module is copied unless
    it already lies there), recursively through tuples and named tuples
    (the feature containers); anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, torch.nn.Module):
        p = next(x.parameters(), None)
        if p is None or p.device == canonical(device):
            return x
        return copy.deepcopy(x).to(device)
    if isinstance(x, tuple):
        vals = [place(v, device) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def replicate(mesh: DeviceMesh, x) -> list:
    """``x`` on every local device of ``mesh``, one entry per device (a
    device listed twice shares one copy)."""
    copies: dict = {}
    for d in mesh.local_devices:
        if d not in copies:
            copies[d] = place(x, d)
    return [copies[d] for d in mesh.local_devices]


def shard_batch(mesh: DeviceMesh, x: torch.Tensor,
                axis: str = "data") -> list:
    """This process's shards of ``x``'s leading axis, split into
    ``mesh.shape[axis]`` equal parts, each on its device."""
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} is not divisible by "
                         f"{n} shards")
    parts = torch.split(x, x.shape[0] // n)
    devs = mesh.axis_devices(axis)
    lo, hi = _own_shards(mesh, n)
    return [parts[i].to(devs[i]) for i in range(lo, hi)]


def _own_shards(mesh: DeviceMesh, n: int) -> tuple[int, int]:
    """The range of shards (of ``n`` along a 1-D mesh's axis) this process
    computes."""
    if mesh.world == 1:
        return 0, n
    if len(mesh.axis_names) != 1:
        raise ValueError("a mesh over several processes shards along one "
                         "axis only")
    per = n // mesh.world
    return mesh.rank * per, (mesh.rank + 1) * per
