"""What both entry points share: loading a checkpoint (the JAX package's
msgpack, or a reference ``.pth``) into a ``Reconstructor`` (sharded over
every local GPU when there are several, as the JAX CLIs shard over
``jax.device_count() > 1``), reading a subject, naming its mesh file, and
the kernel launch counters they report."""

from __future__ import annotations

import os

import torch

from ..models.multires import MultiResPIFu
from ..ops.fused_mlp import fused_point_mlp
from ..ops.fused_query import fused_gather_mlp, gather_concat
from ..parallel import make_device_mesh
from ..recon.pipeline import Reconstructor
from ..utils import checkpoint as ckpt
from ..utils.device import resolve_device
from ..utils.options import Options
from ..utils.torch_import import reconcile_with_model


def latest_path(checkpoints_path: str, name: str) -> str:
    return os.path.join(checkpoints_path, f"{name}_train_latest")


def local_mesh(dev: torch.device):
    """A mesh over every local GPU when ``dev`` is CUDA and there are
    several, else None."""
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        return make_device_mesh()
    return None


def load_reconstructor(opt: Options, device: str, full_opts: bool = False):
    """Checkpoint named by ``opt`` (the JAX package's msgpack or a reference
    ``.pth``) -> ``(Reconstructor, model options, checkpoint path)``.
    ``full_opts`` takes every option the checkpoint embeds (the trained
    demo); otherwise the command line keeps the run's fields
    (``Options.restore_from_checkpoint_dict``: ``normal_mode`` among them).
    ``--octree_levels`` and ``--no_octree`` always come from the command
    line."""
    dev = resolve_device(device)
    path = opt.load_netMR_checkpoint_path or latest_path(
        opt.checkpoints_path, opt.name)
    if not os.path.exists(path):
        raise SystemExit(f"checkpoint not found: {path}")
    state = ckpt.load_checkpoint(path, device=dev)
    if full_opts:
        opt_model = Options.from_dict(state["opt"])
    else:
        opt_model, _ = ckpt.restore_options(opt, state)
    # how this run evaluates the field is the command line's: the JAX
    # package's CLIs let the checkpoint's saved values win (so there
    # --octree_levels / --no_octree do nothing with a checkpoint)
    opt_model.octree_levels = opt.octree_levels
    opt_model.use_octree = opt.use_octree
    model = MultiResPIFu(opt_model.netMR, opt_model.netG, device=dev)
    sd = ckpt.params_from_flax(state["params"])
    if state.get("torch_import"):
        # a reference .pth: its 3-channel netF / netB stems widen to the
        # port's 6-channel input
        sd = reconcile_with_model(sd, model)
    model.load_state_dict(sd, strict=True)
    return (Reconstructor(model, opt_model, device=dev,
                          mesh=local_mesh(dev)), opt_model, path)


def load_item(dataset, i: int) -> dict:
    data = dict(dataset[i])
    if data["img_512"].ndim == 3:
        data["img_512"] = data["img_512"][None]
    return data


def mesh_path(out_dir: str, data: dict, opt: Options) -> str:
    ext = getattr(opt, "mesh_format", "obj")
    return os.path.join(out_dir,
                        f"result_{data['name']}_{opt.resolution}.{ext}")


def launch_counts(recon: Reconstructor) -> dict:
    """Kernel launches of this process and the field queries behind them
    (each query is one coarse-level and one fine-level kernel call)."""
    return {"query_calls": recon.total_query_calls,
            "fused_gather_mlp": fused_gather_mlp.launches,
            "fused_point_mlp": fused_point_mlp.launches,
            "gather_concat": gather_concat.launches}
