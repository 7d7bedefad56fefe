"""Sharded evaluation over a device mesh (port of ``parallel/evaluator.py``):
the field query's point axis, and the vertex-colouring chunk axis, split
over the mesh's devices.

``shard_arg_axis(fn, mesh, arg_index, dim)`` splits one positional
argument along ``dim`` into ``mesh.shape[axis]`` equal shards and runs
``fn`` once per shard on the shard's device, every other argument
replicated there (tensors, modules and tuples of them: copied once per
device and kept while the same objects come back, so a reconstruction's
feature maps cross once, not once per call; on the caller's own device
nothing is copied).  The outputs come back to the caller's device,
concatenated along ``dim``.  Across processes each rank computes its own
shards and an ``all_gather`` over the group puts the result together.  A
CUDA shard runs with its device current, so the kernels launch there.

``fn`` runs once per shard, as ``shard_map`` runs it in the JAX package:
a GroupNorm MLP (``gn_scope=None``) takes its statistics over each shard,
not over the whole call, so a sharded query of such a model is not the
unsharded one — it is JAX's sharded one.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from .distributed import all_gather_cat
from .mesh import DeviceMesh, _own_shards, canonical, place


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def shard_arg_axis(fn: Callable, mesh: DeviceMesh, arg_index: int,
                   dim: int = 0, axis: str = "data") -> Callable:
    """Wrap ``fn`` (returning one tensor) to shard positional argument
    ``arg_index`` along ``dim`` over ``mesh``'s ``axis``; the sharded size
    must divide evenly."""
    n = mesh.shape[axis]
    devs = mesh.axis_devices(axis)
    lo, hi = _own_shards(mesh, n)
    cache: dict = {}        # (id, device) -> (source, its copy)
    used: set = set()

    def replicated(x, device):
        if not isinstance(x, (torch.Tensor, torch.nn.Module, tuple)):
            return x
        key = (id(x), device)
        hit = cache.get(key)
        if hit is None or hit[0] is not x:
            hit = cache[key] = (x, place(x, device))
        used.add(key)
        return hit[1]

    def wrapped(*args):
        x = args[arg_index]
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"sharded dimension {dim} of size {size} is "
                             f"not divisible by {n} devices")
        caller = canonical(x.device)
        parts = torch.split(x, size // n, dim)
        used.clear()
        outs = []
        for i in range(lo, hi):
            dev = devs[i]
            with _on(dev):
                a = [parts[i].to(dev) if j == arg_index else
                     replicated(a_, dev) for j, a_ in enumerate(args)]
                out = fn(*a)
            outs.append(out.to(caller))
        for key in [k for k in cache if k not in used]:
            del cache[key]      # a new call's objects replace the last's
        out = torch.cat(outs, dim)
        if mesh.world > 1:
            out = all_gather_cat(out, dim, mesh.group)
        return out

    return wrapped


def shard_points_query(query_fn: Callable, mesh: DeviceMesh,
                       axis: str = "data") -> Callable:
    """Wrap ``query_fn(points [M, 3], *args)`` to shard its point axis."""
    return shard_arg_axis(query_fn, mesh, 0, dim=0, axis=axis)
