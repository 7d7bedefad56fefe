"""Multi-device runs (port of ``parallel/``): device meshes, the sharded
field query and colouring, and the multi-process runtime on
``torch.distributed``.

- mesh.py        — ``make_device_mesh``, ``replicate``, ``shard_batch``
- evaluator.py   — ``shard_arg_axis`` / ``shard_points_query``: one
  argument's axis split over the mesh, one call per shard
- distributed.py — ``initialize_distributed``, ``is_primary``,
  ``shard_host_batch`` and the collectives (one process per device)

Data-parallel training is ``train/trainers.shard_train_step``.
"""

from .mesh import DeviceMesh, make_device_mesh, replicate, shard_batch
from .evaluator import shard_arg_axis, shard_points_query
from .distributed import (
    initialize_distributed,
    is_primary,
    process_device,
    shard_host_batch,
)
