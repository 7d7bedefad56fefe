"""Multi-process runtime on ``torch.distributed`` (port of
``parallel/distributed.py``).

One process owns one device: rank ``k`` computes on ``cuda:(k mod device
count)`` (``process_device``), or on the CPU.  The JAX package runs one
process per host over every local chip; the port starts one process per
GPU instead (``cli/run_train`` does so by itself on a host with several).

- ``initialize_distributed``: joins the process group from the arguments
  or the ``RGBD_COORDINATOR`` / ``RGBD_NUM_PROCESSES`` / ``RGBD_PROCESS_ID``
  variables; a no-op for one process.  The backend is ``nccl`` for CUDA and
  ``gloo`` for the CPU unless ``backend=`` says otherwise (gloo on CUDA:
  NCCL refuses two ranks on one device);
- ``is_primary``: the process that writes checkpoints, logs and montages;
- ``shard_host_batch``: every process reads the same seeded global batch
  and keeps its rows ``[pid B/P, (pid + 1) B/P)``;
- the collectives the port uses (``all_reduce_sum_``, ``broadcast_``,
  ``all_gather_cat`` and the differentiable ``all_reduce_mean``).  Under
  gloo a CUDA tensor goes through host memory, by the backend's name.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_ENV_COORD = "RGBD_COORDINATOR"
_ENV_NPROC = "RGBD_NUM_PROCESSES"
_ENV_PID = "RGBD_PROCESS_ID"


def process_device(device_type: str, process_id: int | None = None
                   ) -> torch.device:
    """The device a rank owns: ``cuda:(process_id mod device count)``, or
    the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    pid = process_index() if process_id is None else process_id
    return torch.device("cuda", pid % torch.cuda.device_count())


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None,
                           device=None) -> bool:
    """Join the process group at ``tcp://<coordinator_address>``; returns
    True when it did (False, and nothing done, for one process).
    ``device``: the device type the ranks compute on (default ``cuda``
    when CUDA is available); a CUDA rank is bound to its
    ``process_device``.  A failed rendezvous raises."""
    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if num_processes is None and os.environ.get(_ENV_NPROC):
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and os.environ.get(_ENV_PID):
        process_id = int(os.environ[_ENV_PID])
    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not one of "
                         f"{num_processes} processes")
    dev_type = torch.device(device).type if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu")
    if backend is None:
        backend = "nccl" if dev_type == "cuda" else "gloo"
    if dev_type == "cuda":
        torch.cuda.set_device(process_device("cuda", process_id))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns checkpoint / log / montage IO."""
    return process_index() == 0


def shard_host_batch(mesh, batch: dict, axis: str = "data") -> dict:
    """This process's rows of a global batch that every process built from
    the same seed: ``[pid B/P, (pid + 1) B/P)`` of every entry's leading
    axis.  One process returns ``batch`` itself."""
    del mesh, axis      # the rows follow the process, as in the JAX package
    nproc = process_count()
    if nproc == 1:
        return batch
    pid = process_index()
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % nproc:
            raise ValueError(f"global batch axis {B} of {k!r} is not "
                             f"divisible by {nproc} processes")
        per = B // nproc
        out[k] = v[pid * per:(pid + 1) * per]
    return out


# ------------------------------------------------------------ collectives
def _staged(t: torch.Tensor, group) -> bool:
    """gloo on a CUDA tensor: the collective runs on a host copy."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over the group's ranks."""
    if _staged(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In place: every rank gets rank ``src``'s values."""
    if _staged(t, group):
        h = t.cpu()
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


def all_gather_cat(t: torch.Tensor, dim: int = 0, group=None
                   ) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in
    rank order, on ``t``'s device."""
    src = t.cpu() if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; its gradient is the sum over ranks of the incoming
    gradients (each rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone(), ctx.group), None


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the group's ranks, differentiable (equal
    shards: the global mean of per-rank means)."""
    return _AllReduceSum.apply(x, group) / dist.get_world_size(group)
